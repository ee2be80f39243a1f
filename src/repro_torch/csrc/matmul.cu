// Pumped communication-avoiding matrix product C = A * B for Hopper, sm_90a
// (paper Table 3).
//
// Replaces src/repro/kernels/matmul.py::matmul_pallas (pl.pallas_call at
// :97; bodies _mm_kernel_t :35 and _mm_kernel_r :53).  There the (bm, bn)
// output tile stays in VMEM across a sequential K grid axis while (bm, kw)
// and (kw, bn) panels stream in: mode T widens the K panel to kw = bk * M
// and issues M dot passes of bk over it; mode R keeps kw = bk and issues an
// output sub-tile bn / M wide M times.
//
// Here one block owns one (BM, BN) output tile and walks K itself, since
// blocks run in no order.  Each K stage copies the (BM, KW) A panel and the
// (KW, BN) B panel into shared memory with cp.async (16-byte copies where a
// 4-element chunk is whole and aligned, 4-byte zero-filling copies at a
// ragged or unaligned edge), double-buffered so the next stage's copy is in
// flight while this one computes.  A thread owns a 4 x 4 micro-tile per
// output sub-tile: rows ty + r * BM / 4, columns tx * 4 .. tx * 4 + 3.
//   mode T: the threads cover the whole BM x BN tile; a stage is M passes of
//           BK over the KW = BK * M panel.
//   mode R: the threads cover BM x (BN / M); a stage (KW = BK) issues them M
//           times, once per column sub-tile, each thread keeping M
//           micro-tiles of accumulators.  The pump halves the block's
//           compute threads (the paper's DSP count) at an unchanged
//           transaction schedule; the A values of a k step are loaded once
//           and issued against the M sub-tiles.
// Every output sums its K products in k order with fp32 FMAs, so all pump
// cases give the same bits.  bf16 inputs are read with plain loads and
// widened into the same fp32 shared-memory panels.  Ragged M, N and K are
// masked: out-of-range panel entries are zero and out-of-range outputs are
// not stored.  C is written fp32 (the wrapper rounds once to a narrower
// output dtype).
//
// What bounds it on this card: operations.  2 * M * N * K FLOPs over 67
// TFLOP/s fp32 (CUDA cores; tensor cores are a later step) against
// (M K + K N + M N) * 4 bytes over 3.35 TB/s: at 4096^3 the FLOPs take 2.05
// ms and the bytes 0.06 ms.  The micro-tiles give 16 FMAs for 8 shared-memory
// reads per k step, which caps the kernel well below the FMA peak.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TM = 4, TN = 4, PAD_A = 4;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// 4-byte copy; src_bytes 0 writes a zero without reading src.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies rows [r0, r0 + ROWS) x cols [c0, c0 + COLS) of a row-major (nr, nc)
// matrix with leading dim ld into dst (row stride DST_LD), zero outside.
template <typename T, int ROWS, int COLS, int DST_LD, int NT>
__device__ __forceinline__ void load_panel(float* dst, const T* src, int nr,
                                           int nc, long long ld, int r0,
                                           int c0, bool vec, int tid) {
  constexpr int CHUNKS = ROWS * COLS / 4;
  for (int c = tid; c < CHUNKS; c += NT) {
    const int row = c / (COLS / 4), col = (c % (COLS / 4)) * 4;
    const int gr = r0 + row, gc = c0 + col;
    float* d = dst + row * DST_LD + col;
    if constexpr (std::is_same<T, float>::value) {
      const float* s = src + (long long)gr * ld + gc;
      if (vec && gr < nr && gc + 3 < nc) {
        cp_async16(d, s);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = gr < nr && gc + e < nc;
          cp_async4(d + e, in ? s + e : src, in ? 4 : 0);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = gr < nr && gc + e < nc;
        d[e] = in ? __bfloat162float(src[(long long)gr * ld + gc + e]) : 0.f;
      }
    }
  }
}

template <typename T, int BM, int BN, int BK, int PUMP, bool MODE_R>
struct Cfg {
  static constexpr int BNS = MODE_R ? BN / PUMP : BN;   // threads' columns
  static constexpr int SUB = MODE_R ? PUMP : 1;         // sub-tiles a thread holds
  static constexpr int KW = MODE_R ? BK : BK * PUMP;    // K panel of a stage
  static constexpr int TX = BNS / TN, TY = BM / TM;
  static constexpr int NT = TX * TY;
  static constexpr int A_LD = KW + PAD_A;
  static constexpr int A_SIZE = BM * A_LD, B_SIZE = KW * BN;
  static constexpr int SMEM = 2 * (A_SIZE + B_SIZE) * (int)sizeof(float);
};

template <typename T, int BM, int BN, int BK, int PUMP, bool MODE_R>
__global__ void __launch_bounds__((Cfg<T, BM, BN, BK, PUMP, MODE_R>::NT))
    matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  float* __restrict__ C, int M, int N, int K, bool vec_a,
                  bool vec_b, bool vec_c) {
  using G = Cfg<T, BM, BN, BK, PUMP, MODE_R>;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                   // [2][BM][A_LD]
  float* Bs = smem + 2 * G::A_SIZE;   // [2][KW][BN]

  const int tid = threadIdx.x, tx = tid % G::TX, ty = tid / G::TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int stages = (K + G::KW - 1) / G::KW;

  float acc[G::SUB][TM][TN];
#pragma unroll
  for (int s = 0; s < G::SUB; ++s)
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[s][r][c] = 0.f;

  auto load_stage = [&](int st, int buf) {
    const int k0 = st * G::KW;
    load_panel<T, BM, G::KW, G::A_LD, G::NT>(As + buf * G::A_SIZE, A, M, K,
                                             K, m0, k0, vec_a, tid);
    load_panel<T, G::KW, BN, BN, G::NT>(Bs + buf * G::B_SIZE, B, K, N, N, k0,
                                        n0, vec_b, tid);
  };

  if (stages > 0) load_stage(0, 0);
  cp_async_commit();
  for (int st = 0; st < stages; ++st) {
    const int buf = st & 1;
    if (st + 1 < stages) {
      load_stage(st + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* a = As + buf * G::A_SIZE;
    const float* b = Bs + buf * G::B_SIZE;
    // mode T: PUMP passes of BK over the wide panel; mode R: one pass of BK
    // issued PUMP times over the column sub-tiles
#pragma unroll
    for (int pass = 0; pass < (MODE_R ? 1 : PUMP); ++pass) {
#pragma unroll 4
      for (int kk = pass * BK; kk < (pass + 1) * BK; ++kk) {
        float av[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r) av[r] = a[(ty + r * G::TY) * G::A_LD + kk];
#pragma unroll
        for (int s = 0; s < G::SUB; ++s) {
          const float4 bv = *reinterpret_cast<const float4*>(
              b + kk * BN + s * G::BNS + tx * TN);
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            acc[s][r][0] = fmaf(av[r], bv.x, acc[s][r][0]);
            acc[s][r][1] = fmaf(av[r], bv.y, acc[s][r][1]);
            acc[s][r][2] = fmaf(av[r], bv.z, acc[s][r][2]);
            acc[s][r][3] = fmaf(av[r], bv.w, acc[s][r][3]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int s = 0; s < G::SUB; ++s) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = m0 + ty + r * G::TY;
      const int col = n0 + s * G::BNS + tx * TN;
      if (row >= M) continue;
      float* out = C + (long long)row * N + col;
      if (vec_c && col + 3 < N) {
        *reinterpret_cast<float4*>(out) =
            make_float4(acc[s][r][0], acc[s][r][1], acc[s][r][2], acc[s][r][3]);
      } else {
#pragma unroll
        for (int c = 0; c < TN; ++c)
          if (col + c < N) out[c] = acc[s][r][c];
      }
    }
  }
}

template <typename T, int BM, int BN, int BK, int PUMP, bool MODE_R>
int launch(const void* a, const void* b, float* c, int M, int N, int K,
           bool vec_a, bool vec_b, bool vec_c, cudaStream_t stream) {
  using G = Cfg<T, BM, BN, BK, PUMP, MODE_R>;
  auto kern = matmul_kernel<T, BM, BN, BK, PUMP, MODE_R>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, G::NT, G::SMEM, stream>>>(static_cast<const T*>(a),
                                         static_cast<const T*>(b), c, M, N, K,
                                         vec_a, vec_b, vec_c);
  return (int)cudaGetLastError();
}

template <typename T, int BM, int BN, int BK>
int by_pump(int pump, int mode_r, const void* a, const void* b, float* c,
            int M, int N, int K, bool va, bool vb, bool vc, cudaStream_t s) {
  if (!mode_r || pump == 1) {
    switch (pump) {
      case 1: return launch<T, BM, BN, BK, 1, false>(a, b, c, M, N, K, va, vb, vc, s);
      case 2: return launch<T, BM, BN, BK, 2, false>(a, b, c, M, N, K, va, vb, vc, s);
      case 4: return launch<T, BM, BN, BK, 4, false>(a, b, c, M, N, K, va, vb, vc, s);
    }
  } else {
    switch (pump) {
      case 2: return launch<T, BM, BN, BK, 2, true>(a, b, c, M, N, K, va, vb, vc, s);
      case 4: return launch<T, BM, BN, BK, 4, true>(a, b, c, M, N, K, va, vb, vc, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int by_tile(int bm, int bn, int bk, int pump, int mode_r, const void* a,
            const void* b, float* c, int M, int N, int K, bool va, bool vb,
            bool vc, cudaStream_t s) {
  if (bm == 64 && bn == 64 && bk == 32)
    return by_pump<T, 64, 64, 32>(pump, mode_r, a, b, c, M, N, K, va, vb, vc, s);
  if (bm == 64 && bn == 128 && bk == 32)
    return by_pump<T, 64, 128, 32>(pump, mode_r, a, b, c, M, N, K, va, vb, vc, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// A (M, K) and B (K, N) row-major, contiguous, both fp32 (dtype 0) or both
// bf16 (dtype 1); C (M, N) fp32.  Tiles (bm, bn, bk) in {(64, 64, 32),
// (64, 128, 32)}; pump 1, 2 or 4, mode_r 0 (T) or 1 (R).  vec_*: the
// matrix is 16-byte aligned with a row length that keeps every 4-element
// chunk 16-byte aligned.  Returns the launch's cudaError_t.
extern "C" int matmul_fwd(const void* a, const void* b, void* c, int M, int N,
                          int K, int dtype, int bm, int bn, int bk, int pump,
                          int mode_r, int vec_a, int vec_b, int vec_c,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* cf = static_cast<float*>(c);
  if (M == 0 || N == 0) return 0;
  return dtype ? by_tile<__nv_bfloat16>(bm, bn, bk, pump, mode_r, a, b, cf,
                                        M, N, K, vec_a, vec_b, vec_c, s)
               : by_tile<float>(bm, bn, bk, pump, mode_r, a, b, cf, M, N, K,
                                vec_a, vec_b, vec_c, s);
}
