// The warp-level bf16 tile product on Hopper's tensor cores, shared by
// csrc/grouped_gemm.cu, csrc/region_map_reduce.cu and the bf16 body of
// csrc/flash_attention.cu.
//
// One warp multiplies a (16 MI) x K bf16 tile of A by a K x (8 NI) bf16
// tile of B, both in shared memory and row-major, into an fp32 register
// tile, with mma.sync.aligned.m16n8k16 (fp32 accumulation) over K in steps
// of 16, in order.  A is read with ldmatrix.x4, B with ldmatrix.x4.trans
// (two n8 tiles at a time) or .x2.trans (the odd one), so B stays in the
// (k, n) layout the global rows arrive in.  The callers pad their rows so
// that the eight row addresses of one 8 x 8 matrix fall in eight different
// 16-byte bank groups: a row stride of an odd number of 16-byte units.
//
// Register layout of an accumulator acc[i][j][0..3] (PTX ISA, "Matrix
// Fragments for mma.m16n8k16"): with g = lane / 4 and c = 2 (lane % 4),
// [0] and [1] are row 16 i + g, columns 8 j + c and + 1; [2] and [3] are
// row 16 i + g + 8, the same columns.  That is also the A fragment's
// layout, so an accumulator pair rounded to bf16 (a_from_acc) is the A
// operand of the next product without a trip through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The A fragment of the 16 x 16 tile at a (row stride lda elements).
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const __nv_bfloat16* a,
                                       int lda, int lane) {
  const __nv_bfloat16* p = a + (lane & 15) * lda + (lane >> 4) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The B fragments of the two 16 x 8 tiles at b and b + 8 (row stride ldb).
__device__ __forceinline__ void load_b2(uint32_t (&r)[4], const __nv_bfloat16* b,
                                        int ldb, int lane) {
  const __nv_bfloat16* p = b + (lane & 15) * ldb + (lane >> 4) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The B fragment of the 16 x 8 tile at b.
__device__ __forceinline__ void load_b1(uint32_t (&r)[2], const __nv_bfloat16* b,
                                        int ldb, int lane) {
  const __nv_bfloat16* p = b + (lane & 15) * ldb;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// The B fragments of the two 16 x 8 tiles whose transpose, (n, k), is
// stored row-major at bt (row stride ldb): rows n 0-15, columns k 0-15, as
// K (keys, d) holds the B of Q K^T.  Non-transposed ldmatrix: [0], [1] are
// n 0-7, [2], [3] n 8-15.
__device__ __forceinline__ void load_bt2(uint32_t (&r)[4], const __nv_bfloat16* bt,
                                         int ldb, int lane) {
  const __nv_bfloat16* p = bt + ((lane & 7) + ((lane >> 4) << 3)) * ldb
                           + ((lane >> 3) & 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The A fragment of a 16 x 16 tile held in registers as two fp32
// accumulators (lo: columns 0-7, hi: columns 8-15), each value rounded to
// the nearest bf16.
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[4], const float (&lo)[4],
                                           const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// d += a (16 x 16) . b (16 x 8), fp32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A . B for the warp: a at the warp's first row and k 0 (row stride
// lda), b at k 0 and the warp's first column (row stride ldb), K = k16 * 16.
template <int MI, int NI>
__device__ __forceinline__ void warp_product(float (&acc)[MI][NI][4],
                                             const __nv_bfloat16* a, int lda,
                                             const __nv_bfloat16* b, int ldb,
                                             int k16, int lane) {
  for (int kk = 0; kk < k16 * 16; kk += 16) {
    uint32_t af[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) load_a(af[i], a + i * 16 * lda + kk, lda, lane);
#pragma unroll
    for (int j = 0; j + 1 < NI; j += 2) {
      uint32_t bf[4];
      load_b2(bf, b + kk * ldb + j * 8, ldb, lane);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        mma(acc[i][j], af[i], bf[0], bf[1]);
        mma(acc[i][j + 1], af[i], bf[2], bf[3]);
      }
    }
    if (NI & 1) {
      uint32_t bf[2];
      load_b1(bf, b + kk * ldb + (NI - 1) * 8, ldb, lane);
#pragma unroll
      for (int i = 0; i < MI; ++i) mma(acc[i][NI - 1], af[i], bf[0], bf[1]);
    }
  }
}

}  // namespace mma_bf16
