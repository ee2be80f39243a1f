// Flash attention (prefill) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// / flash_attention_pallas (pl.pallas_call at :103, the pump's fori_loop at
// :67) and the carry emission of src/repro/compiler/pallas_backend.py::
// emit_pallas (:784) over src/repro/core/autopump.py::_flash_graph, which
// computes the same o and also writes the final running max m and
// denominator l of every row.
//
// Computes o = softmax(q k^T * scale [causal: q_pos >= k_pos]) v per (b, h),
// with q (B, H, S, D), k/v (B, Hkv, T, D), kv head = h / (H / Hkv), the
// reference's NEG_INF = -1e30 masking and l == 0 -> 1.  m and l, when asked
// for, are fp32 (B, H, S).
//
// What bounds it on this card: at the serving prefill (B 8, S = T = 512,
// 16/8 heads x 128, bf16, causal) the bytes (q, k, v read once, o written
// once: 50 MB, 0.0150 ms at 3.35 TB/s) more than the 8.6 GFLOP of the two
// products (0.0087 ms at 989 TFLOP/s bf16).  A kernel on mma.sync falls
// well short of both: what it reaches is set by how much of each warp's
// instruction stream the products fill, against the softmax's exps and
// the copies' own instructions, and by how many warps an SM holds.
//
// Design: one block per (q tile of 64 rows, q head, batch).  The Pallas
// grid's sequential innermost KV axis becomes a loop inside the block; the
// online-softmax state (m, l, acc) lives in registers across it, as it
// lived in VMEM scratch across grid steps.  KV tiles wholly above the
// causal diagonal are skipped.  The ragged edges of S, T and D are masked
// here (D runs in a padded width DP of 16, 32, 64 or 128, zero-filled), so
// the wrapper pads nothing.  GQA reads the kv head through an index, never
// a repeated tensor; q, k and v come in through their strides.
//
// bf16 (flash_fwd_bf16), on the tensor cores.  Four warps, each owning 16
// q rows for the whole kernel.  q is staged once and held in registers as
// mma A fragments.  S = q k^T runs as mma.sync.m16n8k16 (bf16 in, fp32
// accumulators) over D in steps of 16, in order, K read from shared memory
// with non-transposed ldmatrix (K (keys, d) is the (n, k) layout of B^T).
// scale multiplies the fp32 scores after the product (a bf16 q times
// 2^-3.5 is not a bf16 value), folded with log2(e) into one multiply: the
// running max lives in log2 units and one ex2.approx gives each weight.
// The online softmax stays in registers: a row's 64 scores sit in one lane
// quad (csrc/mma_bf16.cuh), so the max reduces with two shuffles and each
// lane keeps its share of l until the end.  P is rounded to bf16 and its
// accumulator fragments are the A fragments of O += P V (V read with
// ldmatrix.trans), so P never touches shared memory.  l sums the fp32 p,
// before rounding: it is the reference's denominator to fp32 rounding,
// which the stats output is held to, and the rounding of P is then an
// error of at most 2^-9 relative on each weight of o, well inside the
// bf16 output's own.  K and V move by cp.async through a ring of two
// transactions (one where two do not fit: T4 at D 128), so the next one is
// in flight while this one computes, with one barrier a transaction.  A
// whole 64-row tile at D = DP with 16-byte aligned rows takes 16-byte
// copies at offsets fixed a thread and no masks; an edge tile, a D below
// DP or rows aligned to 8 bytes only take masked, zero-filling copies
// (8-byte where a stride is not a multiple of 8 elements).  The copies'
// instructions are a large share of a thread's, so the whole-tile path
// matters.  q is staged through the ring's last stage before a K/V panel
// lands there.  Rows are DP + 8 elements long, an odd number of 16-byte
// units, so the eight row addresses of one ldmatrix fall in eight
// different bank groups.  Where three blocks' rings fit an SM, registers
// are capped for three (168 a thread; T1, R2 and R4 at D 128).
//
// fp32 (flash_fwd_fp32) keeps the CUDA-core body, whose fp32 products
// the 1e-5 checks need (TF32 would fail them): q staged pre-scaled as fp32,
// 16 x 16 threads over (rows, keys / dims), K/V staged by cp.async in one
// panel per transaction, P through shared memory.
//
// The pump (template PUMP, MODE_R):
//  - mode T: the KV axis is walked in transactions of PUMP tiles: one
//    cp.async group stages the PUMP x 64-key panel of K and V, then the
//    block issues PUMP dependent beats over it, as the reference's
//    fori_loop over M beats;
//  - mode R: the narrow axis, the q rows, is cut into PUMP sub-tiles of
//    64 / PUMP rows, and each runs its own full sweep over the keys (the
//    _pump axis outside the carry, hopper_backend.py::_append_pump), one
//    after another; in bf16 a sub-tile's sweep runs on its 64 / (16 PUMP)
//    warps while the others only copy, so the pump divides the compute
//    units, as in the paper.
// Keys are visited in the same order and every row does the same sums (in
// bf16, the same mma sequence in the same lane layout) in every case, so
// T1, T2, T4, R2 and R4 give the same bits.
//
// Built set: a case is built where its shared memory fits 227 KB.  bf16:
// the ring, two (one where two do not fit) transactions of PUMP (mode T)
// or one (mode R) tiles of 64 x (DP + 8) K and V; every case fits (T4 at
// D 128: one 136 KB transaction).  fp32: q (64 x (DP + 4)), the scores
// (64 x 65) and the panel, PUMP (mode T) or one (mode R) tiles of
// 64 x (DP + 4) K and 64 x DP V; a tile is 66.5 KB at D 128, so T4 stops
// at D 64.  kernels/flash_attention.py::smem_bytes is the same sum.
//
// Measured (chip_smoke.py phase 3a, median of 20 launches, L2 flushed, the
// stream held busy while the host queues each call, on NVIDIA H100 80GB
// HBM3, 700.00 W): bf16 T1 0.0688 ms at the serving shape, 125.2
// TFLOP/s, 1.88x SDPA's 0.0367; T2 0.0975, T4 0.1025, R2 0.1017, R4
// 0.1699.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BKV = 64;             // keys per staged tile
constexpr int THREADS_FP32 = 256;   // 16 x 16: ty picks rows, tx picks keys / dims
constexpr int THREADS_BF16 = 128;   // 4 warps x 16 rows
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr size_t MAX_SMEM = 227 * 1024;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// Copy 4 consecutive fp32 (16 bytes) to shared memory; ok = false writes
// zeros without reading src.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int DP, int PUMP, bool MODE_R>
constexpr size_t smem_bytes_fp32() {
  constexpr int tiles = MODE_R ? 1 : PUMP;
  return sizeof(float) * (BQ * (DP + 4) + BQ * (BKV + 1)) +
         sizeof(float) * tiles * BKV * ((DP + 4) + DP);
}

// ------------------------------------------------------------------ fp32 --
template <int DP, int PUMP, bool MODE_R>
__global__ void __launch_bounds__(THREADS_FP32)
flash_fwd_fp32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ m_out, float* __restrict__ l_out,
               int S, int T_len, int D, int H, int G,
               long long qsb, long long qsh, long long qss,
               long long ksb, long long ksh, long long kss,
               long long vsb, long long vsh, long long vss,
               float scale, int causal) {
  using T = float;
  static_assert(DP % 16 == 0, "padded head dim must be a multiple of 16");
  constexpr int QS = DP + 4, KS = DP + 16 / (int)sizeof(T), PS = BKV + 1;
  constexpr int NV = DP / 16;                 // output dims per thread
  constexpr int TILES = MODE_R ? 1 : PUMP;    // K/V tiles of one transaction
  constexpr int SUBS = MODE_R ? PUMP : 1;     // q sub-tiles, each its own sweep
  constexpr int RI = 4 / SUBS;                // rows a thread keeps
  constexpr int SQ = BQ / SUBS;               // rows of one sub-tile
  constexpr int CPR = DP / 4;                 // 4-element chunks of a row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ps = Qs + BQ * QS;
  T* Ks = reinterpret_cast<T*>(Ps + BQ * PS);
  T* Vs = Ks + TILES * BKV * KS;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  // q is staged pre-scaled, as the reference scales q before the dot
  {
    const T* qb = q + b * qsb + h * qsh;
    constexpr int PER = BQ * CPR / THREADS_FP32;
    float4 buf[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = tid + i * THREADS_FP32;
      const int r = u / CPR, c = (u % CPR) * 4;
      buf[i] = q0 + r < S && c < D ? load4(qb + (long long)(q0 + r) * qss + c)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = tid + i * THREADS_FP32;
      const int r = u / CPR, c = (u % CPR) * 4;
      const float4 x = buf[i];
      *reinterpret_cast<float4*>(Qs + r * QS + c) =
          make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    }
  }

  const int all_tiles = (T_len + BKV - 1) / BKV;
#pragma unroll 1
  for (int sub = 0; sub < SUBS; ++sub) {
    const int r0 = sub * SQ;   // first row of the sub-tile in the block
    float acc[RI][NV];
    float m_run[RI], l_run[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      m_run[i] = NEG_INF;
      l_run[i] = 0.f;
#pragma unroll
      for (int n = 0; n < NV; ++n) acc[i][n] = 0.f;
    }
    int n_tiles = all_tiles;
    if (causal) n_tiles = min(n_tiles, (q0 + r0 + SQ - 1) / BKV + 1);

#pragma unroll 1
    for (int kt0 = 0; kt0 < n_tiles; kt0 += TILES) {
      const int nt = min(TILES, n_tiles - kt0);
      __syncthreads();  // the previous panel's reads are done; q is staged
      // one transaction: the panel of nt tiles of K and V
      for (int u = tid; u < nt * BKV * CPR; u += THREADS_FP32) {
        const int slot = u / (BKV * CPR), rem = u % (BKV * CPR);
        const int r = rem / CPR, c = (rem % CPR) * 4;
        const int kp = (kt0 + slot) * BKV + r;
        const bool ok = kp < T_len && c < D;
        cp_async4(Ks + (slot * BKV + r) * KS + c, kb + (ok ? kp * kss + c : 0), ok);
        cp_async4(Vs + (slot * BKV + r) * DP + c, vb + (ok ? kp * vss + c : 0), ok);
      }
      cp_async_commit_wait_all();
      __syncthreads();

#pragma unroll 1
      for (int beat = 0; beat < nt; ++beat) {  // the dependent beats
        const int k0 = (kt0 + beat) * BKV;
        const T* Kt = Ks + beat * BKV * KS;
        const T* Vt = Vs + beat * BKV * DP;
        if (beat > 0) __syncthreads();  // the previous beat's P reads are done

        // scores for rows r0 + ty + 16 i and keys tx + 16 j
        float s[RI][4];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < DP; d += 4) {
          float4 qv[RI], kv[4];
#pragma unroll
          for (int i = 0; i < RI; ++i)
            qv[i] = *reinterpret_cast<const float4*>(Qs + (r0 + ty + 16 * i) * QS + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) kv[j] = load4(Kt + (tx + 16 * j) * KS + d);
#pragma unroll
          for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float a = s[i][j];
              a = fmaf(qv[i].x, kv[j].x, a);
              a = fmaf(qv[i].y, kv[j].y, a);
              a = fmaf(qv[i].z, kv[j].z, a);
              a = fmaf(qv[i].w, kv[j].w, a);
              s[i][j] = a;
            }
        }

        // online softmax; a row's 64 keys live in the 16 lanes sharing its ty
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const int qp = q0 + r0 + ty + 16 * i;
          float mx = NEG_INF;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kp = k0 + tx + 16 * j;
            if (causal && qp < kp) s[i][j] = NEG_INF;
            if (kp < T_len) mx = fmaxf(mx, s[i][j]);
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m_run[i], mx);
          const float alpha = expf(m_run[i] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // keys past T do not exist: weight 0 (masked keys keep NEG_INF math)
            const float p = k0 + tx + 16 * j < T_len ? expf(s[i][j] - m_new) : 0.f;
            Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
            sum += p;
          }
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          l_run[i] = l_run[i] * alpha + sum;
          m_run[i] = m_new;
#pragma unroll
          for (int n = 0; n < NV; ++n) acc[i][n] *= alpha;
        }
        __syncthreads();

        // acc += P V for rows ty + 16 i and dims tx + 16 n
        const int kn = min(BKV, T_len - k0);
#pragma unroll 4
        for (int c = 0; c < kn; ++c) {
          float pv[RI];
#pragma unroll
          for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            const float vv = to_f(Vt[c * DP + tx + 16 * n]);
#pragma unroll
            for (int i = 0; i < RI; ++i) acc[i][n] = fmaf(pv[i], vv, acc[i][n]);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qp = q0 + r0 + ty + 16 * i;
      if (qp >= S) continue;
      const long long row = ((long long)b * H + h) * S + qp;
      const float l = l_run[i] == 0.f ? 1.f : l_run[i];
      T* orow = o + row * D;
#pragma unroll
      for (int n = 0; n < NV; ++n)
        if (tx + 16 * n < D) store1(orow + tx + 16 * n, acc[i][n] / l);
      if (m_out != nullptr && tx == 0) {
        m_out[row] = m_run[i];
        l_out[row] = l_run[i];
      }
    }
  }
}

// ------------------------------------------------------------------ bf16 --
using bf16 = __nv_bfloat16;

template <int DP, int PUMP, bool MODE_R>
struct Ring {
  static constexpr int LD = DP + 8;                       // row stride, elements
  static constexpr int TILES = MODE_R ? 1 : PUMP;         // tiles of a transaction
  static constexpr int TILE = BKV * LD;                   // one K or V tile
  static constexpr int STAGE = TILES * 2 * TILE;          // one transaction
  static constexpr size_t STAGE_BYTES = sizeof(bf16) * STAGE;
  static constexpr int STAGES = 2 * STAGE_BYTES <= MAX_SMEM ? 2 : 1;
  static constexpr size_t BYTES = STAGES * STAGE_BYTES;
  // three blocks an SM where their shared memory allows (228 KB, 1 KB of it
  // reserved a block): registers are then capped at 168 a thread
  static constexpr int MIN_BLOCKS = 3 * (BYTES + 1024) <= 228 * 1024 ? 3 : 1;
};

// Copy 8 bf16 (16 bytes) or 4 (8 bytes) to shared memory; the first n
// bytes come from src, the rest are zero (n = 0 reads nothing).
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, int n) {
  const uint32_t d = mma_bf16::smem_u32(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async8(bf16* dst, const bf16* src, int n) {
  const uint32_t d = mma_bf16::smem_u32(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

// Stage rows [r0, r0 + 64) of a (rows, D) bf16 matrix (row stride ld
// elements) into dst, DP columns at row stride LD, zero past rows and D.
template <int DP, int LD>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, long long ld,
                                           int r0, int rows, int D, bool vec16,
                                           int tid) {
  if (vec16 && r0 + BKV <= rows && D == DP) {   // a whole tile: no masks
    constexpr int CPR = DP / 8, RPI = THREADS_BF16 / CPR, PER = BKV / RPI;
    const int r = tid / CPR, c = (tid % CPR) * 8;
    const bf16* s = src + (r0 + r) * ld + c;
    bf16* d = dst + r * LD + c;
#pragma unroll
    for (int i = 0; i < PER; ++i) cp_async16(d + i * RPI * LD, s + i * RPI * ld, 16);
  } else if (vec16) {
    constexpr int CPR = DP / 8, PER = BKV * CPR / THREADS_BF16;
#pragma unroll 1
    for (int i = 0; i < PER; ++i) {
      const int u = tid + i * THREADS_BF16;
      const int r = u / CPR, c = (u % CPR) * 8;
      const int n = r0 + r < rows ? 2 * max(0, min(8, D - c)) : 0;
      cp_async16(dst + r * LD + c, n ? src + (r0 + r) * ld + c : src, n);
    }
  } else {
    constexpr int CPR = DP / 4, PER = BKV * CPR / THREADS_BF16;
#pragma unroll 1
    for (int i = 0; i < PER; ++i) {
      const int u = tid + i * THREADS_BF16;
      const int r = u / CPR, c = (u % CPR) * 4;
      const int n = r0 + r < rows && c < D ? 8 : 0;
      cp_async8(dst + r * LD + c, n ? src + (r0 + r) * ld + c : src, n);
    }
  }
}

// 2^x, flushing results below 2^-126 to zero (a weight that small is 0 to
// the fp32 sums it enters)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DP, int PUMP, bool MODE_R>
__global__ void __launch_bounds__(THREADS_BF16, (Ring<DP, PUMP, MODE_R>::MIN_BLOCKS))
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o,
               float* __restrict__ m_out, float* __restrict__ l_out,
               int S, int T_len, int D, int H, int G,
               long long qsb, long long qsh, long long qss,
               long long ksb, long long ksh, long long kss,
               long long vsb, long long vsh, long long vss,
               float scale, int causal, int vec16) {
  static_assert(DP % 16 == 0, "padded head dim must be a multiple of 16");
  using R = Ring<DP, PUMP, MODE_R>;
  constexpr int LD = R::LD, TILES = R::TILES, STAGES = R::STAGES;
  constexpr int SUBS = MODE_R ? PUMP : 1;          // q sub-tiles, one sweep each
  constexpr int WPS = THREADS_BF16 / 32 / SUBS;    // warps of one sub-tile
  constexpr int KD = DP / 16;                      // k-steps of q k^T
  constexpr int NO = DP / 8;                       // n8 tiles of o
  extern __shared__ float4 smem4[];
  bf16* ring = reinterpret_cast<bf16*>(smem4);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const bf16* kb = k + b * ksb + (h / G) * ksh;
  const bf16* vb = v + b * vsb + (h / G) * vsh;

  const int all_tiles = (T_len + BKV - 1) / BKV;
  // BKV == BQ: every row of the block (and of each sub-tile) sees tile q0 / BKV
  const int n_tiles = causal ? min(all_tiles, q0 / BKV + 1) : all_tiles;
  const int ntx = (n_tiles + TILES - 1) / TILES;   // transactions of a sweep
  const int total = SUBS * ntx;

  auto issue = [&](int u) {  // transaction u into ring stage u % STAGES
    const int kt0 = (u % ntx) * TILES, nt = min(TILES, n_tiles - kt0);
    bf16* st = ring + (u % STAGES) * R::STAGE;
    for (int j = 0; j < nt; ++j) {
      stage_tile<DP, LD>(st + 2 * j * R::TILE, kb, kss, (kt0 + j) * BKV, T_len,
                         D, vec16, tid);
      stage_tile<DP, LD>(st + (2 * j + 1) * R::TILE, vb, vss, (kt0 + j) * BKV,
                         T_len, D, vec16, tid);
    }
  };

  // q through the ring's last stage, into A fragments
  uint32_t qf[KD][4];
  {
    bf16* qs = ring + (STAGES - 1) * R::STAGE;
    stage_tile<DP, LD>(qs, q + b * qsb + h * qsh, qss, q0, S, D, vec16, tid);
    cp_async_commit();
    if constexpr (STAGES >= 2) {
#pragma unroll
      for (int i = 0; i < STAGES - 1; ++i) {   // into stages 0 .. STAGES - 2
        if (i < total) issue(i);
        cp_async_commit();
      }
      cp_async_wait<STAGES - 1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      mma_bf16::load_a(qf[kk], qs + w * 16 * LD + kk * 16, LD, lane);
  }

  // The scores are kept in log2 units, x = s * scale * log2(e), so one
  // ex2 gives exp(s * scale - m); m_run is in the same units.
  const float c = scale * LOG2E;
  // rows ra = q0 + 16 w + g ([0] of each pair) and ra + 8 ([1])
  const int ra = q0 + 16 * w + g;
  float acc[NO][4];
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

#pragma unroll 1
  for (int u = 0; u < total; ++u) {
    if constexpr (STAGES >= 2) {
      cp_async_wait<STAGES - 2>();   // transaction u has landed
      __syncthreads();      // ... for every thread; stage u - 1 (or q) is read
      if (u + STAGES - 1 < total) issue(u + STAGES - 1);
      cp_async_commit();
    } else {
      __syncthreads();      // the stage (or q) is read
      issue(u);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    const int sweep = u / ntx;
    if (w / WPS == sweep) {
      const int kt0 = (u % ntx) * TILES, nt = min(TILES, n_tiles - kt0);
      const bf16* st = ring + (u % STAGES) * R::STAGE;
#pragma unroll 1
      for (int beat = 0; beat < nt; ++beat) {  // the dependent beats
        const int k0 = (kt0 + beat) * BKV;
        const bf16* Kt = st + 2 * beat * R::TILE;
        const bf16* Vt = Kt + R::TILE;

        // S = q k^T: 16 rows x 64 keys, eight n8 tiles
        float s[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
#pragma unroll
          for (int j = 0; j < 8; j += 2) {
            uint32_t bf[4];
            mma_bf16::load_bt2(bf, Kt + j * 8 * LD + kk * 16, LD, lane);
            mma_bf16::mma(s[j], qf[kk], bf[0], bf[1]);
            mma_bf16::mma(s[j + 1], qf[kk], bf[2], bf[3]);
          }

        // scale, mask, online softmax; [e] is row ra + 8 (e >> 1), key
        // k0 + 8 j + c2 + (e & 1)
        const bool edge = k0 + BKV > T_len;
        const bool diag = causal && k0 + BKV - 1 > q0 + 16 * w;
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[j][e] * c;
            const int kp = k0 + 8 * j + c2 + (e & 1);
            if (diag && ra + 8 * (e >> 1) < kp) x = NEG_INF;
            s[j][e] = x;
            if (!edge || kp < T_len) mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m_run[i], mx[i]);
          alpha[i] = exp2_ftz(m_run[i] - m_new);
          m_run[i] = m_new;
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // keys past T do not exist: weight 0 (masked keys keep NEG_INF math)
            const int kp = k0 + 8 * j + c2 + (e & 1);
            const float p = !edge || kp < T_len
                                ? exp2_ftz(s[j][e] - m_run[e >> 1]) : 0.f;
            s[j][e] = p;
            sum[e >> 1] += p;
          }
        // l: this lane's share of its row's sum (the quad is summed at the end)
#pragma unroll
        for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + sum[i];
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[n][0] *= alpha[0];
          acc[n][1] *= alpha[0];
          acc[n][2] *= alpha[1];
          acc[n][3] *= alpha[1];
        }

        // O += P V: P (bf16) from the score registers, 16 keys a k-step
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          uint32_t pa[4];
          mma_bf16::a_from_acc(pa, s[2 * t], s[2 * t + 1]);
#pragma unroll
          for (int n = 0; n < NO; n += 2) {
            uint32_t vf[4];
            mma_bf16::load_b2(vf, Vt + t * 16 * LD + n * 8, LD, lane);
            mma_bf16::mma(acc[n], pa, vf[0], vf[1]);
            mma_bf16::mma(acc[n + 1], pa, vf[2], vf[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    const int qp = ra + 8 * i;
    if (qp >= S) continue;
    const long long row = ((long long)b * H + h) * S + qp;
    const float l = l_run[i] == 0.f ? 1.f : l_run[i];
    bf16* orow = o + row * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = 8 * n + c2;   // D is even, so col < D covers col + 1
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[n][2 * i] / l, acc[n][2 * i + 1] / l);
    }
    if (m_out != nullptr && c2 == 0) {
      m_out[row] = m_run[i] * LN2;   // back to the scaled logits' units
      l_out[row] = l_run[i];
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float *m, *l;
  int B, H, Hkv, S, T_len, D;
  const long long* st;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int DP, int PUMP, bool MODE_R>
cudaError_t launch_fp32(const Args& a) {
  constexpr size_t smem = smem_bytes_fp32<DP, PUMP, MODE_R>();
  if constexpr (smem > MAX_SMEM) {
    return cudaErrorInvalidValue;  // not built: the panel does not fit
  } else {
    auto kern = flash_fwd_fp32<DP, PUMP, MODE_R>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
    const long long* st = a.st;
    kern<<<grid, THREADS_FP32, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.o), a.m, a.l, a.S,
        a.T_len, a.D, a.H, a.H / a.Hkv, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], a.scale, a.causal);
    return cudaGetLastError();
  }
}

template <int DP, int PUMP, bool MODE_R>
cudaError_t launch_bf16(const Args& a) {
  constexpr size_t smem = Ring<DP, PUMP, MODE_R>::BYTES;
  static_assert(smem <= MAX_SMEM, "every bf16 case is built");
  auto kern = flash_fwd_bf16<DP, PUMP, MODE_R>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
  const long long* st = a.st;
  int vec16 = 1;
  for (int i = 0; i < 9; ++i) vec16 &= st[i] % 8 == 0;
  kern<<<grid, THREADS_BF16, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.m, a.l, a.S,
      a.T_len, a.D, a.H, a.H / a.Hkv, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], a.scale, a.causal, vec16);
  return cudaGetLastError();
}

template <bool BF16, int DP, int PUMP, bool MODE_R>
cudaError_t launch(const Args& a) {
  if constexpr (BF16)
    return launch_bf16<DP, PUMP, MODE_R>(a);
  else
    return launch_fp32<DP, PUMP, MODE_R>(a);
}

template <bool BF16, int DP>
cudaError_t by_pump(int pump, int mode_r, const Args& a) {
  if (!mode_r || pump == 1) {
    switch (pump) {
      case 1: return launch<BF16, DP, 1, false>(a);
      case 2: return launch<BF16, DP, 2, false>(a);
      case 4: return launch<BF16, DP, 4, false>(a);
    }
  } else {
    switch (pump) {
      case 2: return launch<BF16, DP, 2, true>(a);
      case 4: return launch<BF16, DP, 4, true>(a);
    }
  }
  return cudaErrorInvalidValue;
}

template <bool BF16>
cudaError_t by_dim(int pump, int mode_r, const Args& a) {
  if (a.D <= 16) return by_pump<BF16, 16>(pump, mode_r, a);
  if (a.D <= 32) return by_pump<BF16, 32>(pump, mode_r, a);
  if (a.D <= 64) return by_pump<BF16, 64>(pump, mode_r, a);
  return by_pump<BF16, 128>(pump, mode_r, a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  strides holds
// the (batch, head, seq) element strides of q, k and v in that order; the
// last dim is contiguous, every stride a multiple of 4 and every start
// 16-byte aligned; o is a contiguous (B, H, S, D) tensor.  m / l: fp32
// (B, H, S) outputs of the final running max and denominator, or both null.
// Needs D % 4 == 0, 4 <= D <= 128; pump 1, 2 or 4, mode_r 0 (T) or 1 (R).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* m, void* l, int dtype, int B, int H, int Hkv,
                                   int S, int T_len, int D, const long long* strides,
                                   float scale, int causal, int pump, int mode_r,
                                   void* stream) {
  if (D % 4 != 0 || D < 4 || D > 128 || Hkv < 1 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, o, static_cast<float*>(m), static_cast<float*>(l),
               B, H, Hkv, S, T_len, D, strides, scale, causal,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return by_dim<false>(pump, mode_r, a);
  if (dtype == 1) return by_dim<true>(pump, mode_r, a);
  return cudaErrorInvalidValue;
}
