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
// KW = BD * M (mode T: M passes of BD over the wide panel) or KW = BD (mode
// R: the threads cover BF / M columns and issue them M times, each thread
// keeping M sub-tiles), as csrc/matmul.cu walks K: cp.async double-buffered
// panels kept in the input dtype, 16-byte copies, an out-of-range chunk
// zero-filled by cp.async itself and a chunk cut by a ragged D or F copied
// element by element with zeros beyond.  Rows past the tile's count are
// zero and never stored.  Every output sums its products in k order with
// fp32 FMAs, so T1, T2, T4, R2 and R4 give the same bits; the whole-D sum
// is rounded once to the output dtype at the store.
//
// What bounds it on this card, at deepseek-v2-lite's shapes (D 2048, F 1408
// and back, 64 experts): in a decode step (48 routed rows, about 34 active
// experts) the bytes of the active experts' weights, about 0.06 ms a GEMM
// at 3.35 TB/s; in a prefill of 8 x 512 tokens (about 25,000 padded rows)
// the multiply-adds, here on the fp32 CUDA cores (67 TFLOP/s; tensor cores
// are a later step), with each of an expert's ~24 row tiles reading its
// weight panel again, mostly from L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive panel elements (4-element aligned) as floats.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Four consecutive outputs (4-element aligned), rounded once.
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
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

template <typename T, int BC, int BF, int BD, int PUMP, bool MODE_R>
struct Cfg {
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int BNS = MODE_R ? BF / PUMP : BF;   // threads' columns
  static constexpr int SUB = MODE_R ? PUMP : 1;         // sub-tiles a thread holds
  static constexpr int KW = MODE_R ? BD : BD * PUMP;    // D panel of a stage
  static constexpr int TX = BNS / TN, TY = BC / TM;
  static constexpr int NT = TX * TY;
  static constexpr int X_LD = KW + VEC;                 // skews rows across banks
  static constexpr int X_SIZE = BC * X_LD, W_SIZE = KW * BF;
  static constexpr int SMEM = 2 * (X_SIZE + W_SIZE) * (int)sizeof(T);
};

template <typename T, int BC, int BF, int BD, int PUMP, bool MODE_R>
__global__ void __launch_bounds__((Cfg<T, BC, BF, BD, PUMP, MODE_R>::NT))
    grouped_gemm_kernel(const T* __restrict__ X, const T* __restrict__ W,
                        T* __restrict__ O, const int* __restrict__ tiles,
                        int rows, int D, int F, bool vec_x, bool vec_w,
                        bool vec_o) {
  using G = Cfg<T, BC, BF, BD, PUMP, MODE_R>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Xs = reinterpret_cast<T*>(smem_raw);   // [2][BC][X_LD]
  T* Ws = Xs + 2 * G::X_SIZE;               // [2][KW][BF]

  const int tid = threadIdx.x, tx = tid % G::TX, ty = tid / G::TX;
  const int expert = tiles[3 * blockIdx.x];
  const int r0 = tiles[3 * blockIdx.x + 1];
  const int r_end = min(rows, r0 + min(tiles[3 * blockIdx.x + 2], BC));
  const int f0 = blockIdx.y * BF;
  if (r0 < 0 || r0 >= r_end) return;
  if (expert < 0) {   // surplus tile: its rows are zero
    for (int i = tid; i < BC * BF; i += G::NT) {
      const int row = r0 + i / BF, col = f0 + i % BF;
      if (row < r_end && col < F) O[(long long)row * F + col] = from_f<T>(0.f);
    }
    return;
  }
  const T* We = W + (long long)expert * D * F;
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
    load_panel<T, BC, G::KW, G::X_LD, G::NT>(Xs + buf * G::X_SIZE, X, r_end,
                                             D, D, r0, k0, vec_x, tid);
    load_panel<T, G::KW, BF, BF, G::NT>(Ws + buf * G::W_SIZE, We, D, F, F,
                                        k0, f0, vec_w, tid);
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
    const T* xp = Xs + buf * G::X_SIZE;
    const T* wp = Ws + buf * G::W_SIZE;
    // mode T: PUMP passes of BD over the wide panel; mode R: one pass of BD
    // issued PUMP times over the column sub-tiles
#pragma unroll
    for (int pass = 0; pass < (MODE_R ? 1 : PUMP); ++pass) {
#pragma unroll 4
      for (int kk = pass * BD; kk < (pass + 1) * BD; ++kk) {
        float av[TM];
#pragma unroll
        for (int r = 0; r < TM; ++r)
          av[r] = to_f(xp[(ty + r * G::TY) * G::X_LD + kk]);
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
      T* out = O + (long long)row * F + col;
      if (vec_o && col + TN <= F) {
        store4(out, acc[s][r]);
      } else {
#pragma unroll
        for (int c = 0; c < TN; ++c)
          if (col + c < F) out[c] = from_f<T>(acc[s][r][c]);
      }
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
  using G = Cfg<T, BC, BF, BD, PUMP, MODE_R>;
  auto kern = grouped_gemm_kernel<T, BC, BF, BD, PUMP, MODE_R>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.n_tiles, (a.F + BF - 1) / BF);
  kern<<<grid, G::NT, G::SMEM, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w),
      static_cast<T*>(a.o), a.tiles, a.rows, a.D, a.F, a.vx, a.vw, a.vo);
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
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (rows, D) and w (E, D, F) row-major, contiguous, both fp32 (dtype 0) or
// both bf16 (dtype 1); out (rows, F) in the same dtype.  tiles: n_tiles x 3
// int32 on the device, (expert, first row, row count <= bc) per row tile;
// expert -1 zero-fills the tile's rows.  Tiles (bc, bf, bd) in {(16, 128,
// 32), (64, 128, 32)}; pump 1, 2 or 4, mode_r 0 (T) or 1 (R).  vec_x /
// vec_w: the matrix is 16-byte aligned with rows of whole 16-byte chunks;
// vec_o: out is 16-byte aligned and F % 4 == 0.  Returns the launch's
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
