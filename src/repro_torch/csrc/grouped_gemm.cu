// Grouped (per-expert) GEMM for Hopper, sm_90a: each row tile of x times
// its expert's weight, out[rows of tile i] = x[rows] * w[expert(i)], over a
// tile table; the dense (E, C, D) form is the same kernel on a uniform table.
//
// Replaces src/repro/kernels/grouped_gemm.py::grouped_gemm_pallas
// (pl.pallas_call at :70; body _gg_kernel :28) and the single-output reduce
// form that src/repro/compiler/pallas_backend.py::emit_pallas (:826-857,
// pallas_call :847) emits over core/autopump.py::_grouped_gemm_graph
// (:656), whose group tables map each row tile to its expert slab and first
// row (:696-717).  There the expert (or tile) axis is an outer grid axis,
// the (bc, bf) output tile stays in VMEM across a sequential contraction
// axis, and the pump widens the contraction panel to bd * M (mode T, M
// accumulation passes over it) or narrows the issued bf tile M times (mode
// R); the ragged form's tables arrive as scalar prefetch.
//
// Here one block owns one (row tile, F tile) pair.  gridDim.x walks the
// tile table and gridDim.y the F tiles, so the blocks of one expert's row
// tiles that read the same weight panel are issued side by side and share
// it in L2.  A block loads its own table entry (expert, first row, row
// count): scalar prefetch becomes three loads.  A surplus entry (expert -1)
// writes zeros over its rows and exits, so a table sized on the device for
// the worst case never needs the host.  The block then walks D in stages of
// KW = BD * M (mode T: M beats of BD over the wide panel) or KW = BD (mode
// R: the BF columns issued as M sub-tiles of BF / M, each thread keeping M
// sub-tiles), with cp.async panels kept in the input dtype, 16-byte copies,
// an out-of-range chunk zero-filled by cp.async itself and a chunk cut by a
// ragged D or F copied element by element with zeros beyond.  Rows past the
// tile's count are zero and never stored.  Every output sums its products
// in k order, so T1, T2, T4, R2 and R4 give the same bits; the whole-D sum
// is fp32, rounded once to the output dtype at the store.
//
// bf16 operands run on the tensor cores: mma.sync.m16n8k16 with fp32
// accumulation through the warp tile product of csrc/mma_bf16.cuh, one
// kernel (gg_mma) for every tile.  Warps tile the block's rows and columns:
// bc 128 -> 2 x 4 warps of 64 x 32, bc 64 -> 2 x 2 of 32 x 64, bc 16 (a
// decode step) -> 1 x 4 of 16 x 32.  The panels go through a ring of
// cp.async stages (3 to 8, as many as fit: a 16-row decode tile keeps 8
// stages of weight rows in flight) in rows padded by 16 bytes, so ldmatrix
// reads them without bank conflicts.  wgmma, which needs 64-row tiles and
// the swizzled layouts TMA writes, is later work.  fp32 operands keep the
// CUDA-core kernel (gg_fma: fp32 FMAs, a 4 x 4 register tile a thread, a
// double-buffered panel); TF32 would lose the fp32 result.
//
// What bounds it on this card, at deepseek-v2-lite's shapes (D 2048, F 1408
// and back, 64 experts): in a decode step (48 routed rows, about 34 active
// experts) the bytes of the active experts' weights, about 0.06 ms a GEMM
// at 3.35 TB/s; in a prefill of 8 x 512 tokens (about 25,000 padded rows,
// tiles of 128 rows) the multiply-adds, 145 GFLOP a GEMM, 0.15 ms at the
// tensor cores' 989 TFLOP/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int TM = 4, TN = 4;

// 16-byte copy; src_bytes 0 writes zeros without reading src.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive fp32 panel elements (4-element aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four consecutive fp32 outputs (4-element aligned).
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Copies rows [r0, r0 + ROWS) x cols [c0, c0 + COLS) of a row-major matrix
// (rows below nr and columns below nc exist; leading dim ld) into dst (row
// stride DST_LD), zero outside.  vec: the matrix is 16-byte aligned and its
// rows are a whole number of 16-byte chunks.
template <typename T, int ROWS, int COLS, int DST_LD, int NT>
__device__ __forceinline__ void load_panel(T* dst, const T* src, int nr,
                                           int nc, long long ld, int r0,
                                           int c0, bool vec, int tid) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CHUNKS = ROWS * COLS / VEC;
  for (int c = tid; c < CHUNKS; c += NT) {
    const int row = c / (COLS / VEC), col = (c % (COLS / VEC)) * VEC;
    const int gr = r0 + row, gc = c0 + col;
    T* d = dst + row * DST_LD + col;
    if (gr >= nr || gc >= nc) {
      cp_async16(d, src, 0);
    } else if (vec && gc + VEC <= nc) {
      cp_async16(d, src + (long long)gr * ld + gc, 16);
    } else {
      const T* s = src + (long long)gr * ld + gc;
#pragma unroll
      for (int e = 0; e < VEC; ++e) d[e] = gc + e < nc ? s[e] : from_f<T>(0.f);
    }
  }
}

template <int BC, int BF, int BD, int PUMP, bool MODE_R>
struct FmaCfg {
  static constexpr int VEC = 4;                        // fp32: 16 bytes
  static constexpr int BNS = MODE_R ? BF / PUMP : BF;  // threads' columns
  static constexpr int SUB = MODE_R ? PUMP : 1;        // sub-tiles a thread holds
  static constexpr int KW = MODE_R ? BD : BD * PUMP;   // D panel of a stage
  static constexpr int TX = BNS / TN, TY = BC / TM;
  static constexpr int NT = TX * TY;
  static constexpr int X_LD = KW + VEC;                // skews rows across banks
  static constexpr int X_SIZE = BC * X_LD, W_SIZE = KW * BF;
  static constexpr int SMEM = 2 * (X_SIZE + W_SIZE) * (int)sizeof(float);
};

template <int BC, int BF, int BD, int PUMP, bool MODE_R>
__global__ void __launch_bounds__((FmaCfg<BC, BF, BD, PUMP, MODE_R>::NT))
    gg_fma(const float* __restrict__ X, const float* __restrict__ W,
           float* __restrict__ O, const int* __restrict__ tiles, int rows,
           int D, int F, bool vec_x, bool vec_w, bool vec_o) {
  using G = FmaCfg<BC, BF, BD, PUMP, MODE_R>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Xs = reinterpret_cast<float*>(smem_raw);   // [2][BC][X_LD]
  float* Ws = Xs + 2 * G::X_SIZE;                   // [2][KW][BF]

  const int tid = threadIdx.x, tx = tid % G::TX, ty = tid / G::TX;
  const int expert = tiles[3 * blockIdx.x];
  const int r0 = tiles[3 * blockIdx.x + 1];
  const int r_end = min(rows, r0 + min(tiles[3 * blockIdx.x + 2], BC));
  const int f0 = blockIdx.y * BF;
  if (r0 < 0 || r0 >= r_end) return;
  if (expert < 0) {   // surplus tile: its rows are zero
    for (int i = tid; i < BC * BF; i += G::NT) {
      const int row = r0 + i / BF, col = f0 + i % BF;
      if (row < r_end && col < F) O[(long long)row * F + col] = 0.f;
    }
    return;
  }
  const float* We = W + (long long)expert * D * F;
  const int stages = (D + G::KW - 1) / G::KW;

  float acc[G::SUB][TM][TN];
#pragma unroll
  for (int s = 0; s < G::SUB; ++s)
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[s][r][c] = 0.f;

  auto load_stage = [&](int st, int buf) {
    const int k0 = st * G::KW;
    load_panel<float, BC, G::KW, G::X_LD, G::NT>(Xs + buf * G::X_SIZE, X,
                                                 r_end, D, D, r0, k0, vec_x,
                                                 tid);
    load_panel<float, G::KW, BF, BF, G::NT>(Ws + buf * G::W_SIZE, We, D, F,
                                            F, k0, f0, vec_w, tid);
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
    const float* xp = Xs + buf * G::X_SIZE;
    const float* wp = Ws + buf * G::W_SIZE;
    // mode T: PUMP beats of BD over the wide panel; mode R: one pass of BD
    // issued PUMP times over the column sub-tiles
#pragma unroll
    for (int pass = 0; pass < (MODE_R ? 1 : PUMP); ++pass) {
#pragma unroll 4
      for (int kk = pass * BD; kk < (pass + 1) * BD; ++kk) {
        float av[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r) av[r] = xp[(ty + r * G::TY) * G::X_LD + kk];
#pragma unroll
        for (int s = 0; s < G::SUB; ++s) {
          const float4 bv = load4(wp + kk * BF + s * G::BNS + tx * TN);
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
      const int row = r0 + ty + r * G::TY;
      const int col = f0 + s * G::BNS + tx * TN;
      if (row >= r_end) continue;
      float* out = O + (long long)row * F + col;
      if (vec_o && col + TN <= F) {
        store4(out, acc[s][r]);
      } else {
#pragma unroll
        for (int c = 0; c < TN; ++c)
          if (col + c < F) out[c] = acc[s][r][c];
      }
    }
  }
}

// ------------------------------------------------ bf16: the tensor cores --
constexpr int RING_BYTES = 200 * 1024;  // the ring's share of shared memory

template <int BC, int BF, int BD, int PUMP, bool MODE_R>
struct MmaCfg {
  static constexpr int SUB = MODE_R ? PUMP : 1;        // sub-tiles issued
  static constexpr int BNS = BF / SUB;                 // columns of one
  static constexpr int KW = MODE_R ? BD : BD * PUMP;   // D panel of a stage
  static constexpr int WM = BC >= 64 ? 2 : 1;          // warps along rows
  static constexpr int WN = BC == 64 ? 2 : 4;          // warps along columns
  static constexpr int NT = 32 * WM * WN;
  static constexpr int MI = BC / WM / 16;              // m16 tiles a warp
  static constexpr int NI = BNS / WN / 8;              // n8 tiles a warp
  static constexpr int X_LD = KW + 8, W_LD = BF + 8;   // rows padded 16 bytes
  static constexpr int X_SIZE = BC * X_LD, W_SIZE = KW * W_LD;
  static constexpr int STAGE = (X_SIZE + W_SIZE) * 2;
  static constexpr int FIT = RING_BYTES / STAGE;
  static constexpr int MAX_STAGES = BC <= 16 ? 8 : 4;
  static constexpr int STAGES = FIT < 3 ? 3 : (FIT > MAX_STAGES ? MAX_STAGES : FIT);
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(MI >= 1 && NI >= 1 && BC % (16 * WM) == 0 &&
                    BNS % (8 * WN) == 0 && BD % 16 == 0,
                "tile does not split into m16n8k16 warp tiles");
  static_assert(SMEM <= 227 * 1024, "ring over shared memory");
};

template <int BC, int BF, int BD, int PUMP, bool MODE_R>
__global__ void __launch_bounds__((MmaCfg<BC, BF, BD, PUMP, MODE_R>::NT))
    gg_mma(const __nv_bfloat16* __restrict__ X, const __nv_bfloat16* __restrict__ W,
           __nv_bfloat16* __restrict__ O, const int* __restrict__ tiles, int rows,
           int D, int F, bool vec_x, bool vec_w, bool vec_o) {
  using G = MmaCfg<BC, BF, BD, PUMP, MODE_R>;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);   // [STAGES][BC][X_LD]
  bf16* Ws = Xs + G::STAGES * G::X_SIZE;          // [STAGES][KW][W_LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / G::WN, wn = warp % G::WN;
  const int expert = tiles[3 * blockIdx.x];
  const int r0 = tiles[3 * blockIdx.x + 1];
  const int r_end = min(rows, r0 + min(tiles[3 * blockIdx.x + 2], BC));
  const int f0 = blockIdx.y * BF;
  if (r0 < 0 || r0 >= r_end) return;
  if (expert < 0) {   // surplus tile: its rows are zero
    for (int i = tid; i < BC * BF; i += G::NT) {
      const int row = r0 + i / BF, col = f0 + i % BF;
      if (row < r_end && col < F) O[(long long)row * F + col] = __float2bfloat16_rn(0.f);
    }
    return;
  }
  const bf16* We = W + (long long)expert * D * F;
  const int stages = (D + G::KW - 1) / G::KW;

  float acc[G::SUB][G::MI][G::NI][4];
#pragma unroll
  for (int s = 0; s < G::SUB; ++s)
#pragma unroll
    for (int i = 0; i < G::MI; ++i)
#pragma unroll
      for (int j = 0; j < G::NI; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[s][i][j][c] = 0.f;

  // one commit per stage, empty past the last, so wait_group counts stay
  // uniform across the ring
  auto load_stage = [&](int st) {
    if (st < stages) {
      const int slot = st % G::STAGES, k0 = st * G::KW;
      load_panel<bf16, BC, G::KW, G::X_LD, G::NT>(Xs + slot * G::X_SIZE, X,
                                                  r_end, D, D, r0, k0, vec_x,
                                                  tid);
      load_panel<bf16, G::KW, BF, G::W_LD, G::NT>(Ws + slot * G::W_SIZE, We, D,
                                                  F, F, k0, f0, vec_w, tid);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < G::STAGES - 1; ++s) load_stage(s);
  for (int st = 0; st < stages; ++st) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();   // stage st landed; stage st - 1's slot is free
    load_stage(st + G::STAGES - 1);
    const bf16* xp = Xs + (st % G::STAGES) * G::X_SIZE + wm * G::MI * 16 * G::X_LD;
    const bf16* wp = Ws + (st % G::STAGES) * G::W_SIZE + wn * G::NI * 8;
    if (MODE_R) {
      // the BF columns as SUB narrowed sub-tiles, issued in turn
#pragma unroll
      for (int s = 0; s < G::SUB; ++s)
        mma_bf16::warp_product<G::MI, G::NI>(acc[s], xp, G::X_LD,
                                             wp + s * G::BNS, G::W_LD, BD / 16,
                                             lane);
    } else {
      // PUMP dependent beats of BD over the wide panel
#pragma unroll
      for (int beat = 0; beat < PUMP; ++beat)
        mma_bf16::warp_product<G::MI, G::NI>(acc[0], xp + beat * BD, G::X_LD,
                                             wp + beat * BD * G::W_LD, G::W_LD,
                                             BD / 16, lane);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int s = 0; s < G::SUB; ++s)
#pragma unroll
    for (int i = 0; i < G::MI; ++i)
#pragma unroll
      for (int j = 0; j < G::NI; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + (wm * G::MI + i) * 16 + g + 8 * h;
          const int col = f0 + s * G::BNS + (wn * G::NI + j) * 8 + c2;
          if (row >= r_end) continue;
          bf16* out = O + (long long)row * F + col;
          const float v0 = acc[s][i][j][2 * h], v1 = acc[s][i][j][2 * h + 1];
          if (vec_o && col + 1 < F) {
            *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (col < F) out[0] = __float2bfloat16_rn(v0);
            if (col + 1 < F) out[1] = __float2bfloat16_rn(v1);
          }
        }
}

struct Args {
  const void* x;
  const void* w;
  void* o;
  const int* tiles;
  int n_tiles, rows, D, F;
  bool vx, vw, vo;
  cudaStream_t stream;
};

template <typename T, int BC, int BF, int BD, int PUMP, bool MODE_R>
int launch(const Args& a) {
  const dim3 grid(a.n_tiles, (a.F + BF - 1) / BF);
  cudaError_t e;
  if constexpr (sizeof(T) == 2) {
    using G = MmaCfg<BC, BF, BD, PUMP, MODE_R>;
    auto kern = gg_mma<BC, BF, BD, PUMP, MODE_R>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::SMEM);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, G::NT, G::SMEM, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.x), static_cast<const __nv_bfloat16*>(a.w),
        static_cast<__nv_bfloat16*>(a.o), a.tiles, a.rows, a.D, a.F, a.vx, a.vw, a.vo);
  } else {
    using G = FmaCfg<BC, BF, BD, PUMP, MODE_R>;
    auto kern = gg_fma<BC, BF, BD, PUMP, MODE_R>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::SMEM);
    if (e != cudaSuccess) return (int)e;
    kern<<<grid, G::NT, G::SMEM, a.stream>>>(
        static_cast<const float*>(a.x), static_cast<const float*>(a.w),
        static_cast<float*>(a.o), a.tiles, a.rows, a.D, a.F, a.vx, a.vw, a.vo);
  }
  return (int)cudaGetLastError();
}

template <typename T, int BC, int BF, int BD>
int by_pump(int pump, int mode_r, const Args& a) {
  if (!mode_r || pump == 1) {
    switch (pump) {
      case 1: return launch<T, BC, BF, BD, 1, false>(a);
      case 2: return launch<T, BC, BF, BD, 2, false>(a);
      case 4: return launch<T, BC, BF, BD, 4, false>(a);
    }
  } else {
    switch (pump) {
      case 2: return launch<T, BC, BF, BD, 2, true>(a);
      case 4: return launch<T, BC, BF, BD, 4, true>(a);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int by_tile(int bc, int bf, int bd, int pump, int mode_r, const Args& a) {
  if (bc == 16 && bf == 128 && bd == 32)
    return by_pump<T, 16, 128, 32>(pump, mode_r, a);
  if (bc == 64 && bf == 128 && bd == 32)
    return by_pump<T, 64, 128, 32>(pump, mode_r, a);
  if constexpr (sizeof(T) == 2) {  // bf16 only: fp32 panels would not fit
    if (bc == 128 && bf == 128 && bd == 32)
      return by_pump<T, 128, 128, 32>(pump, mode_r, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (rows, D) and w (E, D, F) row-major, contiguous, both fp32 (dtype 0) or
// both bf16 (dtype 1); out (rows, F) in the same dtype.  tiles: n_tiles x 3
// int32 on the device, (expert, first row, row count <= bc) per row tile;
// expert -1 zero-fills the tile's rows.  Tiles (bc, bf, bd) in {(16, 128,
// 32), (64, 128, 32)}, and (128, 128, 32) for bf16; pump 1, 2 or 4, mode_r
// 0 (T) or 1 (R).  vec_x / vec_w: the matrix is 16-byte aligned with rows
// of whole 16-byte chunks; vec_o: out is 16-byte aligned and F % 4 == 0.  Returns the launch's
// cudaError_t.
extern "C" int grouped_gemm_fwd(const void* x, const void* w, void* out,
                                const void* tiles, int n_tiles, int rows,
                                int D, int F, int dtype, int bc, int bf,
                                int bd, int pump, int mode_r, int vec_x,
                                int vec_w, int vec_o, void* stream) {
  if (n_tiles == 0 || rows == 0 || F == 0) return 0;
  const Args a{x, w, out, static_cast<const int*>(tiles), n_tiles, rows, D,
               F, vec_x != 0, vec_w != 0, vec_o != 0,
               static_cast<cudaStream_t>(stream)};
  return dtype ? by_tile<__nv_bfloat16>(bc, bf, bd, pump, mode_r, a)
               : by_tile<float>(bc, bf, bd, pump, mode_r, a);
}
