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
// What bounds it on this card: operations.  2 * M * N * K FLOPs over 67
// TFLOP/s fp32 (CUDA cores: the k-ordered fp32 sums below rule out TF32 and
// the tensor cores) against (M K + K N + M N) * 4 bytes over 3.35 TB/s: at
// 4096^3 the FLOPs take 2.05 ms and the bytes 0.06 ms.  So the limit is
// how many of a thread's instructions are FMAs: every shared-memory read
// and address computation takes an issue slot from them.
//
// Design: one block owns one (BM, BN) output tile and walks K itself, since
// blocks run in no order; the blocks take the tiles in groups of 16 tile
// rows, so those in flight share their A and B panels in L2.  Each K stage
// copies the (BM, KW) A panel and the (KW, BN) B panel into shared memory
// with cp.async: a whole, aligned fp32 panel in 16-byte copies at offsets
// fixed a thread, with no masks (masked copies spend many of a thread's
// issue slots on index math), else 16-byte copies where a 4-element chunk
// is whole and aligned and 4-byte zero-filling copies at a ragged or
// unaligned edge.  The ring has two stages, so the next stage's copy is
// in flight while this one computes, with one barrier a stage.  A third
// stage would fit, but its 52 KB (at 64 x 64) leave four blocks an SM where
// two stages' 35 KB leave six, and this kernel needs the warps more than
// the deeper prefetch.  A thread keeps a register micro-tile of TM x TN =
// 8 x 4 outputs for each sub-tile it holds: one in mode T, M in mode R.
// (8 x 8 would not fit the paper's thread counts: R4 at 64 x 64 would run
// 16 threads, half a warp.)  A is read as one float4 of four consecutive k
// of each of its 8 rows, B as one float4 of 4 columns, and the four k are
// unrolled: per 4 k, 128 FMAs a sub-tile for 8 float4 reads of A (shared
// by the sub-tiles) and 4 of B.  The columns of a sub-tile are float4 groups, one a thread, so the
// 8 threads of a quarter warp read 128 contiguous bytes of B, and the row's
// A float4 is one broadcast.  C goes out through the ring's shared memory,
// transposed, in float4s, 16 bytes a thread, where N keeps them aligned.
//   mode T: the threads cover the whole BM x BN tile (128 threads at
//           64 x 64, 256 at 64 x 128); a stage is M passes of BK over the
//           KW = BK * M panel.
//   mode R: the threads cover BM x (BN / M); a stage (KW = BK) issues them M
//           times, once per column sub-tile.  The pump divides the block's
//           compute threads by M (the paper's DSP count,
//           compute_tile_bytes) at an unchanged transaction schedule: R2
//           runs half of T1's threads and R4 a quarter, each thread
//           holding M sub-tiles.  The A values of a k step are read once
//           and issued against the M sub-tiles.
// Every output sums its K products in k order with fp32 FMAs, so all pump
// cases and both tiles give the same bits, and integer-valued inputs stay
// exact.  bf16 inputs are read with plain loads and widened into the same
// fp32 shared-memory panels.  Ragged M, N and K are masked: out-of-range
// panel entries are zero and out-of-range outputs are not stored.  C is
// written fp32 (the wrapper rounds once to a narrower output dtype).
//
// Measured (chip_smoke.py phase 3f, median of 20 launches, L2 flushed, on
// NVIDIA H100 80GB HBM3, 700.00 W), fp32 4096^3: mmm_32PE_DP 3.0126 ms
// (45.6 TFLOP/s), mmm_32PE_O 3.1873, mmm_64PE_DP 3.0613, against
// torch.matmul's 2.6451.  The FMAs issue at about two thirds of the fp32
// peak; register-bank conflicts between B and the accumulators are one
// suspect for the rest.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int PAD_A = 4;
constexpr int MAX_SMEM = 227 * 1024;
constexpr int GROUP = 16;   // tile rows a group of blocks walks together

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
  constexpr int CPR = COLS / 4;   // 16-byte chunks of a row
  if constexpr (std::is_same<T, float>::value) {
    if (vec && r0 + ROWS <= nr && c0 + COLS <= nc) {
      // a whole, aligned panel: each thread copies the chunks at one column
      // of rows tid / CPR + i * NT / CPR, with no masks and no index math
      static_assert(NT % CPR == 0 && ROWS % (NT / CPR) == 0, "even split");
      constexpr int RPI = NT / CPR;
      const int r = tid / CPR, c = (tid % CPR) * 4;
      const float* s = src + (long long)(r0 + r) * ld + c0 + c;
      float* d = dst + r * DST_LD + c;
#pragma unroll
      for (int i = 0; i < ROWS / RPI; ++i)
        cp_async16(d + i * RPI * DST_LD, s + i * RPI * ld);
      return;
    }
  }
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
  static constexpr int TM = 8, TN = 4;                  // micro-tile of a sub-tile
  static constexpr int TX = BNS / TN, TY = BM / TM;
  static constexpr int NT = TX * TY;
  static constexpr int A_LD = KW + PAD_A;
  static constexpr int A_SIZE = BM * A_LD, B_SIZE = KW * BN;
  static constexpr int STAGE = A_SIZE + B_SIZE;         // floats
  static constexpr int STAGES = 2;   // three cost a third of the blocks an SM
  static constexpr int SMEM = STAGES * STAGE * (int)sizeof(float);
  static_assert(NT >= 32 && NT % 32 == 0, "whole warps");
  static_assert(SMEM <= MAX_SMEM, "the ring fits");
};

template <int Q>
__device__ __forceinline__ float lane4(const float4& v) {
  return Q == 0 ? v.x : Q == 1 ? v.y : Q == 2 ? v.z : v.w;
}

template <typename T, int BM, int BN, int BK, int PUMP, bool MODE_R>
__global__ void __launch_bounds__((Cfg<T, BM, BN, BK, PUMP, MODE_R>::NT))
    matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  float* __restrict__ C, int M, int N, int K, bool vec_a,
                  bool vec_b, bool vec_c) {
  using G = Cfg<T, BM, BN, BK, PUMP, MODE_R>;
  constexpr int TM = G::TM, TN = G::TN, SUB = G::SUB;
  extern __shared__ __align__(16) float smem[];   // [STAGES][A (BM, A_LD), B (KW, BN)]

  const int tid = threadIdx.x, tx = tid % G::TX, ty = tid / G::TX;
  // blocks take the tiles in groups of GROUP tile rows, down each column
  // of the group before the next, so the blocks in flight share their A
  // and B panels in L2 rather than sweeping all of B for each tile row
  const int gx = gridDim.x, gy = gridDim.y;
  const int pid = blockIdx.y * gx + blockIdx.x, per = GROUP * gx;
  const int first = pid / per * GROUP, rows = min(gy - first, GROUP);
  const int m0 = (first + pid % per % rows) * BM, n0 = pid % per / rows * BN;
  const int stages = (K + G::KW - 1) / G::KW;

  float acc[SUB][TM][TN];
#pragma unroll
  for (int s = 0; s < SUB; ++s)
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[s][r][c] = 0.f;

  auto load_stage = [&](int st) {
    float* buf = smem + (st % G::STAGES) * G::STAGE;
    const int k0 = st * G::KW;
    load_panel<T, BM, G::KW, G::A_LD, G::NT>(buf, A, M, K, K, m0, k0, vec_a,
                                             tid);
    load_panel<T, G::KW, BN, BN, G::NT>(buf + G::A_SIZE, B, K, N, N, k0, n0,
                                        vec_b, tid);
  };

  // the ring: stages st + 1 .. st + STAGES - 1 in flight while st computes
#pragma unroll
  for (int st = 0; st < G::STAGES - 1; ++st) {
    if (st < stages) load_stage(st);
    cp_async_commit();
  }
#pragma unroll 1
  for (int st = 0; st < stages; ++st) {
    cp_async_wait<G::STAGES - 2>();   // stage st has landed
    __syncthreads();                  // ... for every thread; st - 1 is read
    if (st + G::STAGES - 1 < stages) load_stage(st + G::STAGES - 1);
    cp_async_commit();
    const float* a = smem + (st % G::STAGES) * G::STAGE;
    const float* b = a + G::A_SIZE;
    // mode T: PUMP passes of BK over the wide panel; mode R: one pass of BK
    // issued against the PUMP column sub-tiles
#pragma unroll 1
    for (int pass = 0; pass < (MODE_R ? 1 : PUMP); ++pass) {
#pragma unroll 4
      for (int kk = pass * BK; kk < (pass + 1) * BK; kk += 4) {
        float4 av[TM];   // rows ty + r TY, k kk .. kk + 3
#pragma unroll
        for (int r = 0; r < TM; ++r)
          av[r] = *reinterpret_cast<const float4*>(a + (ty + r * G::TY) * G::A_LD + kk);
        auto step = [&](auto qc) {   // k = kk + Q
          constexpr int Q = decltype(qc)::value;
          float4 bv[SUB];
#pragma unroll
          for (int s = 0; s < SUB; ++s)
            bv[s] = *reinterpret_cast<const float4*>(
                b + (kk + Q) * BN + s * G::BNS + tx * 4);
#pragma unroll
          for (int s = 0; s < SUB; ++s)
#pragma unroll
            for (int r = 0; r < TM; ++r) {
              const float x = lane4<Q>(av[r]);
              acc[s][r][0] = fmaf(x, bv[s].x, acc[s][r][0]);
              acc[s][r][1] = fmaf(x, bv[s].y, acc[s][r][1]);
              acc[s][r][2] = fmaf(x, bv[s].z, acc[s][r][2]);
              acc[s][r][3] = fmaf(x, bv[s].w, acc[s][r][3]);
            }
        };
        step(std::integral_constant<int, 0>{});
        step(std::integral_constant<int, 1>{});
        step(std::integral_constant<int, 2>{});
        step(std::integral_constant<int, 3>{});
      }
    }
  }
  cp_async_wait<0>();

  // C through shared memory, transposed (Cs[col][row]), then out in
  // 16-byte rows: a thread's accumulators need no 16-byte register
  // alignment, which leaves the register allocator free to keep them off
  // the register bank of the B quad they meet in each FMA
  constexpr int LDC = BM + 1;
  static_assert(BN * LDC <= G::STAGES * G::STAGE, "C fits the ring");
  __syncthreads();
  float* Cs = smem;
#pragma unroll
  for (int s = 0; s < SUB; ++s)
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c)
        Cs[(s * G::BNS + tx * TN + c) * LDC + ty + r * G::TY] = acc[s][r][c];
  __syncthreads();
  for (int u = tid; u < BM * BN / 4; u += G::NT) {
    const int m = u / (BN / 4), n = (u % (BN / 4)) * 4;
    const int row = m0 + m, col = n0 + n;
    if (row >= M) continue;
    const float4 v = make_float4(Cs[n * LDC + m], Cs[(n + 1) * LDC + m],
                                 Cs[(n + 2) * LDC + m], Cs[(n + 3) * LDC + m]);
    float* out = C + (long long)row * N + col;
    if (vec_c && col + 3 < N) {
      *reinterpret_cast<float4*>(out) = v;
    } else {
      if (col < N) out[0] = v.x;
      if (col + 1 < N) out[1] = v.y;
      if (col + 2 < N) out[2] = v.z;
      if (col + 3 < N) out[3] = v.w;
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
