// Mamba-2 SSD chunked scan (state-space duality) for Hopper, sm_90a.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan_pallas (pl.pallas_call at
// :97, body _ssd_kernel :35) and the carry-form kernel that
// src/repro/compiler/pallas_backend.py::emit_pallas writes over
// src/repro/core/autopump.py::_ssd_graph with its final_state output.
//
// Computes, per batch row b and head h (group g = h / (H / G)), over chunks of
// c steps with the (N, P) state S carried from chunk to chunk, S_0 = 0:
//   logP_t = cumsum_{s<=t} A_h * dt_s
//   y_t    = exp(logP_t) * (C_t . S) + sum_{s<=t} G[t, s] x_s,
//            G[t, s] = (C_t . B_s) * exp(logP_t - logP_s) * dt_s
//   S     <- S * exp(logP_last) + sum_t (B_t * w_t)^T x_t,
//            w_t = exp(logP_last - logP_t) * dt_t
// to fp32 accuracy, as the Pallas kernel does.  The cumsum accumulates in
// fp64 and rounds once to fp32 (kernels/ref.py::ssd_scan does the same), so
// the decay exponents agree with the plain version to the last bit wherever
// fp64 sums round alike.  x, dt, B and C are each read in their own dtype
// (fp32 or bf16) through their strides, with the last dim contiguous, so
// the model's strided views of the conv output go in without a copy; y is
// written contiguous (B, L, H, P) in x's dtype, the final state contiguous
// (B, H, N, P) in fp32 when its pointer is not null.  A ragged L is masked:
// steps past L read as dt = 0 and zeros, which leave S untouched, and their
// y is not written (the reference pads L to a bucket instead; the math is
// the same, the rounding of the padded sweep can differ).
//
// What bounds it on this card: at mamba2-1.3b's prefill (B 8, L 512, H 64,
// P 64, N 128, G 1, chunk 64, bf16 x, B and C) the bytes, 86.5 MB (x and y
// 33.5 MB each, the fp32 state 16.8 MB) or 0.026 ms at 3.35 TB/s.  The
// products are 9.71 GFLOP once C.B^T is shared by a group's heads and the
// causal halves are skipped; issued as the bf16 terms below they are 23.7
// GFLOP, 0.024 ms at the tensor cores' 989 TFLOP/s, and 0.145 ms as fp32
// FMAs.  The CUDA-core body ran them at 14% of the FMA rate, one block of
// 130 KB an SM.  So the serving body moves the products to the tensor
// cores, halves the staged panel and keeps the next one in flight; what
// holds it back now is each warp's chain of dependent products from one
// chunk to the next, with 8 warps an SM to hide it.
//
// Two bodies, picked by the input dtypes; both compute the same function.
//
// The tensor-core body (ssd_scan_tc: x, B and C all bf16, the serving
// path).  One block of 4 warps per (b, h), the chunks in a loop.  Warp w
// keeps rows p 16w..16w+15 of S^T (P x N, fp32) in registers as mma
// accumulators for the whole sweep, and owns the same rows of y^T, so S
// never touches shared memory:
//   - C.B^T (c x c over N): warp w computes t rows 16w..16w+15, their
//     causal s blocks only (bf16 in, exact products, fp32 sums), forms G
//     and writes it to shared memory as two bf16 terms;
//   - y^T = exp(logP) * (S^T . C^T) + x^T . G^T: S^T's accumulators are
//     the A fragments of the first product (csrc/mma_bf16.cuh), x^T comes
//     from x (t, p) with ldmatrix.trans, G^T's causal blocks only;
//   - S^T <- S^T * exp(logP_last) + (x * w)^T . B, accumulated onto the
//     decayed state.
// Every product runs on mma.sync.m16n8k16 (bf16 operands, fp32
// accumulation), a term's products over independent accumulators issued
// together before the next term's, so no mma waits on the one before it.
// Accuracy: a bf16 input is exact as one bf16 term, so C.B^T needs no
// split.  An fp32 operand is split into bf16 terms, each term a product of
// its own (its terms added in order into one accumulator): S and G into
// two (hi + lo, within about 2^-17 of the value), x * w into three (every
// bit of an fp32 value).  y is bf16 and held to 2^-7 of its largest value;
// the state is held to 1e-5, and two terms of x * w use over a tenth of
// that in tests/test_torch_ssd_tc.py's model of this rounding, three under
// a fiftieth, so the state's product takes the third.  The decay cumsum is a warp scan in fp64 (each warp keeps its own copy of
// logP, exp(logP) and w), so no thread waits on a serial sum.  x, B and C
// are staged as their bf16 bytes by 16-byte cp.async copies (element
// loads where a row or stride is not a multiple of 16 bytes), through a
// ring of two transactions: the next one is in flight while this one
// computes, with one barrier a transaction and two a chunk (G written, G
// read).  dt is one 2-byte element a step at a stride of H, which cp.async
// cannot move: each of the first 64 threads loads its step's dt into a
// register when the transaction is issued and stores it a transaction
// later.  Rows are padded to an odd number of 16-byte units so the eight
// row addresses of one ldmatrix fall in eight bank groups; rows and
// columns past c, N and P are zero.  At mamba2's widths (chunk 64, N 128,
// P 64, 16-byte rows) the body is built with them constant (FULL), every
// loop over tiles and pieces unrolled with no runtime bound.  A T1 block
// takes 107.5 KB, two an SM: the 512 blocks of the serving shape run in
// two waves.  Sharing C.B^T across a group's heads (G 1 has 64 heads of
// one group) would cost the blocks that fill the card; it is not done.
//
// The CUDA-core body (ssd_scan_fp32: any of x, B, C in fp32, the
// small-shape checks and the compiler's fp32 carry regions), the port's
// first design: one block of 256 threads per (b, h), a chunk's x, dt, B
// and C staged in shared memory as fp32 by ordinary loads, one thread
// taking the fp64 cumsum, every product a 16 x 16 grid of threads with a
// 4 x 4 (or 8 x 4) register tile of fp32 FMAs, S in shared memory.
//
// The pump (template PUMP, MODE_R), the reference's fori_loop over M beats
// (kernels/ssd_scan.py:74), in both bodies:
//  - mode T: the chunks are walked in transactions of PUMP chunks: the
//    panel of PUMP chunks of x, dt, B and C is staged at once, then PUMP
//    dependent beats run over it, each a chunk of the recurrence;
//  - mode R: the panel keeps its width (one chunk); the head dim p is cut
//    into PUMP sub-tiles of 64 / PUMP columns, and each runs its own full
//    sweep over the chunks with its own columns of y and S (C.B^T is
//    recomputed per sweep).  In the tensor-core body a sub-tile's rows of
//    S^T are its warps' (R4: one warp, R2: two), the others only form G.
// Every output sums the same terms in the same order in every case (a
// row of y or S is always its own warp's, with the same instructions), so
// T1, T2, R2 and R4 give the same bits.  Built set: T1, T2, R2, R4.  The
// tensor-core body's fixed buffers (G's two terms, the warps' decay
// vectors) take 21 KB and one chunk's slot 43.25 KB, a ring of two
// transactions 2 x PUMP slots: T1 and mode R 107.5 KB, T2 194 KB, T4 367
// KB (not built).  The CUDA-core body: 49 KB fixed and 81 KB a chunk, no
// ring: T1 and mode R 130 KB, T2 211 KB, T4 373 KB (not built).
// kernels/ssd_scan.py::smem_bytes is the same sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int CMAX = 64;      // chunk
constexpr int NMAX = 128;     // state dim
constexpr int PMAX = 64;      // head dim
constexpr size_t MAX_SMEM = 227 * 1024;

__device__ __forceinline__ float ld(const void* base, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i])
              : static_cast<const float*>(base)[i];
}

__device__ __forceinline__ void st(void* base, long long i, int bf16, float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(base)[i] = v;
}

struct Args {
  const void* x;
  const void* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* state;  // may be null
  int x_bf16, dt_bf16, b_bf16, c_bf16;
  int L, H, G, N, P, chunk;
  int vec;       // x, B and C rows move as 16-byte pieces (tensor-core body)
  long long sxb, sxl, sxh;  // x (B, L, H, P)
  long long sdb, sdl, sdh;  // dt (B, L, H)
  long long sbb, sbl, sbg;  // B (B, L, G, N)
  long long scb, scl, scg;  // C (B, L, G, N)
};

// ---------------------------------------------------------------------------
// The tensor-core body
namespace tensor_cores {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;   // 4 warps
constexpr int LDX = PMAX + 8;  // x rows: 144 bytes, 9 16-byte units
constexpr int LDN = NMAX + 8;  // B / C rows: 272 bytes, 17 units
constexpr int LDG = CMAX + 8;  // G rows: 144 bytes
constexpr size_t SLOT_BYTES = 2 * ((size_t)CMAX * LDX + 2 * (size_t)CMAX * LDN)
                              + 4 * (size_t)CMAX;                 // x, B, C; dt fp32
constexpr size_t FIXED_BYTES = 2 * 2 * (size_t)CMAX * LDG         // G: hi, lo
                               + 4 * 3 * 4 * (size_t)CMAX;       // per warp: logP, exp, w

constexpr size_t smem_bytes(int tiles) { return FIXED_BYTES + 2 * tiles * SLOT_BYTES; }

struct Slot {
  bf16* x;    // c x P, row stride LDX
  bf16* B;    // c x N, row stride LDN
  bf16* C;
  float* dt;  // CMAX
};

__device__ __forceinline__ Slot slot_at(unsigned char* ring, int i) {
  Slot s;
  s.x = reinterpret_cast<bf16*>(ring + (size_t)i * SLOT_BYTES);
  s.B = s.x + CMAX * LDX;
  s.C = s.B + CMAX * LDN;
  s.dt = reinterpret_cast<float*>(s.C + CMAX * LDN);
  return s;
}

// 16 bytes to shared memory; the first n bytes come from src, the rest are
// zero (n = 0 reads nothing)
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(mma_bf16::smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The A fragment of the 16 x 16 tile whose transpose, (k, m), is stored
// row-major at at (row stride ld): rows k 0-15, columns m 0-15, as x (t, p)
// holds the A of x^T.  Transposed ldmatrix, matrices in the A fragment's
// order: (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15).
__device__ __forceinline__ void load_at(uint32_t (&r)[4], const bf16* at, int ld, int lane) {
  const bf16* p = at + ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(mma_bf16::smem_u32(p)));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// v0, v1 as two bf16 terms each, a packed pair a term: hi = bf16(v),
// lo = bf16(v - hi)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = mma_bf16::pack_bf16(__fsub_rn(v0, f.x), __fsub_rn(v1, f.y));
}

// three terms, whose sum is the fp32 value itself
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& t0, uint32_t& t1,
                                       uint32_t& t2) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(h);
  const float r0 = __fsub_rn(v0, f.x), r1 = __fsub_rn(v1, f.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 g = __bfloat1622float2(m);
  t0 = bits(h);
  t1 = bits(m);
  t2 = mma_bf16::pack_bf16(__fsub_rn(r0, g.x), __fsub_rn(r1, g.y));
}

// Stage the rows t < c of the chunk starting at step t0 into slot s: x, B
// and C as their bf16 bytes, rows past L as zeros.  Returns the dt of step
// t0 + tid (0 past L and past c), an ordinary load the caller stores once
// it has arrived.  FULL: c 64, N 128, P 64 and 16-byte rows, as constants.
template <bool FULL>
__device__ __forceinline__ float stage_chunk(const Args& a, const Slot& s, const bf16* xg,
                                             const bf16* bg, const bf16* cg, long long db,
                                             int t0, int tid) {
  const int c = FULL ? CMAX : a.chunk, valid = min(c, a.L - t0);
  const int P = FULL ? PMAX : a.P, N = FULL ? NMAX : a.N;
  if (FULL || a.vec) {
    const int xp = P >> 3, np = N >> 3;  // 16-byte pieces a row
    for (int i = tid; i < c * xp; i += THREADS) {
      const int t = i / xp, k = (i - t * xp) * 8;
      const bool ok = t < valid;
      cp_async16(s.x + t * LDX + k, ok ? xg + (t0 + t) * a.sxl + k : xg, ok ? 16 : 0);
    }
    for (int i = tid; i < c * np; i += THREADS) {
      const int t = i / np, k = (i - t * np) * 8;
      const bool ok = t < valid;
      cp_async16(s.B + t * LDN + k, ok ? bg + (t0 + t) * a.sbl + k : bg, ok ? 16 : 0);
      cp_async16(s.C + t * LDN + k, ok ? cg + (t0 + t) * a.scl + k : cg, ok ? 16 : 0);
    }
  } else {
    const unsigned short* x16 = reinterpret_cast<const unsigned short*>(xg);
    const unsigned short* b16 = reinterpret_cast<const unsigned short*>(bg);
    const unsigned short* c16 = reinterpret_cast<const unsigned short*>(cg);
    unsigned short* xs = reinterpret_cast<unsigned short*>(s.x);
    unsigned short* bs = reinterpret_cast<unsigned short*>(s.B);
    unsigned short* cs = reinterpret_cast<unsigned short*>(s.C);
    for (int i = tid; i < c * P; i += THREADS) {
      const int t = i / P, k = i - t * P;
      xs[t * LDX + k] = t < valid ? x16[(t0 + t) * a.sxl + k] : 0;
    }
    for (int i = tid; i < c * N; i += THREADS) {
      const int t = i / N, k = i - t * N;
      const bool ok = t < valid;
      bs[t * LDN + k] = ok ? b16[(t0 + t) * a.sbl + k] : 0;
      cs[t * LDN + k] = ok ? c16[(t0 + t) * a.scl + k] : 0;
    }
  }
  return tid < valid ? ld(a.dt, db + (long long)(t0 + tid) * a.sdl, a.dt_bf16) : 0.f;
}

template <int PUMP, bool MODE_R, bool FULL>
__global__ void __launch_bounds__(THREADS) ssd_scan_tc(const Args a) {
  using mma_bf16::load_a;
  using mma_bf16::load_b2;
  using mma_bf16::load_bt2;
  using mma_bf16::mma;
  constexpr int TILES = MODE_R ? 1 : PUMP;  // chunks of one transaction
  constexpr int SUBS = MODE_R ? PUMP : 1;   // p sub-tiles, each its own sweep
  constexpr int PW = PMAX / SUBS;           // columns of one sub-tile
  constexpr int NK_MAX = NMAX / 16, CT_MAX = CMAX / 16;
  extern __shared__ float4 smem4[];
  bf16* Ghi = reinterpret_cast<bf16*>(smem4);  // c x c, row stride LDG
  bf16* Glo = Ghi + CMAX * LDG;
  unsigned char* ring = reinterpret_cast<unsigned char*>(Glo + CMAX * LDG)
                        + 4 * 3 * 4 * CMAX;   // 2 TILES slots

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, q4 = lane & 3;
  const int grp = h / (a.H / a.G);
  // the widths, and their 16-wide tiles: compile-time at the full widths
  const int c = FULL ? CMAX : a.chunk, N = FULL ? NMAX : a.N, P = FULL ? PMAX : a.P;
  const int L = a.L;
  const int CT = (c + 15) >> 4, NK = (N + 15) >> 4;
  const float A = a.A[h];
  const bf16* xg = static_cast<const bf16*>(a.x) + (b * a.sxb + h * a.sxh);
  const bf16* bg = static_cast<const bf16*>(a.B) + (b * a.sbb + grp * a.sbg);
  const bf16* cg = static_cast<const bf16*>(a.C) + (b * a.scb + grp * a.scg);
  const long long db = b * a.sdb + h * a.sdh;
  // this warp's logP, exp(logP) and w of the current chunk
  float* lp = reinterpret_cast<float*>(Glo + CMAX * LDG) + warp * 3 * CMAX;
  float* elp = lp + CMAX;
  float* wv = elp + CMAX;
  const int nch = (L + c - 1) / c;
  const int per_sweep = (nch + TILES - 1) / TILES;
  const int ntx = SUBS * per_sweep;

  {  // rows and columns past c, N and P stay zero in every slot
    uint4* z = reinterpret_cast<uint4*>(ring);
    for (int i = tid; i < (int)(2 * TILES * SLOT_BYTES / 16); i += THREADS)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  float dtr[TILES];  // the dt of the transaction in flight
#pragma unroll
  for (int i = 0; i < TILES; ++i)
    dtr[i] = i < nch ? stage_chunk<FULL>(a, slot_at(ring, i), xg, bg, cg, db, i * c, tid) : 0.f;
  cp_async_commit();

  float sacc[2 * NK_MAX][4];  // S^T rows 16 warp + (g8, g8 + 8), n tiles of 8

#pragma unroll 1
  for (int tx = 0; tx < ntx; ++tx) {
    const int half = tx & 1;
    const int sub = tx / per_sweep, ci0 = (tx - sub * per_sweep) * TILES;
    const int nt = min(TILES, nch - ci0);
    const int p0 = sub * PW;
    const bool active = 16 * warp >= p0 && 16 * warp < p0 + PW && 16 * warp < P;
    if (tid < CMAX) {
#pragma unroll
      for (int i = 0; i < TILES; ++i) slot_at(ring, half * TILES + i).dt[tid] = dtr[i];
    }
    cp_async_wait_all();
    __syncthreads();  // this transaction landed; every read of the other half done
    if (tx + 1 < ntx) {  // the next transaction, into the other half
      const int s1 = (tx + 1) / per_sweep, c1 = (tx + 1 - s1 * per_sweep) * TILES;
#pragma unroll
      for (int i = 0; i < TILES; ++i)
        dtr[i] = c1 + i < nch ? stage_chunk<FULL>(a, slot_at(ring, (half ^ 1) * TILES + i), xg, bg,
                                            cg, db, (c1 + i) * c, tid)
                              : 0.f;
    }
    cp_async_commit();
    if (ci0 == 0) {
#pragma unroll
      for (int j = 0; j < 2 * NK_MAX; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
    }

#pragma unroll 1
    for (int beat = 0; beat < nt; ++beat) {  // the dependent beats
      const Slot s = slot_at(ring, half * TILES + beat);
      const int t0 = (ci0 + beat) * c;
      const int valid = min(c, L - t0);
      if (beat > 0) __syncthreads();  // every read of the last beat's G done

      // the decay cumsum, a warp scan in fp64 (lane l: steps 2l, 2l + 1)
      float decay;
      {
        const float d0 = s.dt[2 * lane], d1 = s.dt[2 * lane + 1];
        const double v0 = (double)__fmul_rn(A, d0), v1 = (double)__fmul_rn(A, d1);
        double inc = v0 + v1;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, inc, off);
          if (lane >= off) inc += u;
        }
        double ex = __shfl_up_sync(0xffffffffu, inc, 1);
        if (lane == 0) ex = 0.0;
        const float l0 = (float)(ex + v0), l1 = (float)inc;
        const float last = __shfl_sync(0xffffffffu, ((c - 1) & 1) ? l1 : l0, (c - 1) >> 1);
        lp[2 * lane] = l0;
        lp[2 * lane + 1] = l1;
        elp[2 * lane] = expf(l0);
        elp[2 * lane + 1] = expf(l1);
        wv[2 * lane] = __fmul_rn(expf(__fsub_rn(last, l0)), d0);
        wv[2 * lane + 1] = __fmul_rn(expf(__fsub_rn(last, l1)), d1);
        decay = expf(last);
        __syncwarp();
      }

      // C . B^T for t rows 16 warp.., its causal s blocks; then G as two
      // bf16 terms
      if (warp < CT) {
        float cb[2 * CT_MAX][4];
#pragma unroll
        for (int j = 0; j < 2 * CT_MAX; ++j) cb[j][0] = cb[j][1] = cb[j][2] = cb[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NK_MAX; ++kk) {
          if (kk < NK) {
            uint32_t af[4], bf[CT_MAX][4];
            load_a(af, s.C + 16 * warp * LDN + 16 * kk, LDN, lane);
#pragma unroll
            for (int sb = 0; sb < CT_MAX; ++sb)
              if (sb <= warp) load_bt2(bf[sb], s.B + 16 * sb * LDN + 16 * kk, LDN, lane);
#pragma unroll
            for (int sb = 0; sb < CT_MAX; ++sb) {
              if (sb <= warp) {
                mma(cb[2 * sb], af, bf[sb][0], bf[sb][1]);
                mma(cb[2 * sb + 1], af, bf[sb][2], bf[sb][3]);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 2 * CT_MAX; ++j) {
          if (j < 2 * (warp + 1)) {
#pragma unroll
            for (int r2 = 0; r2 < 2; ++r2) {
              const int t = 16 * warp + g8 + 8 * r2, s0 = 8 * j + 2 * q4;
              float gv[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int ss = s0 + e;
                gv[e] = ss <= t ? __fmul_rn(__fmul_rn(cb[j][2 * r2 + e],
                                                      expf(__fsub_rn(lp[t], lp[ss]))),
                                            s.dt[ss])
                                : 0.f;
              }
              uint32_t hi, lo;
              split2(gv[0], gv[1], hi, lo);
              *reinterpret_cast<uint32_t*>(Ghi + t * LDG + s0) = hi;
              *reinterpret_cast<uint32_t*>(Glo + t * LDG + s0) = lo;
            }
          }
        }
      }

      // y^T = S^T . C^T (S^T as two bf16 terms), before G is complete
      float y[2 * CT_MAX][4];
      if (active) {
#pragma unroll
        for (int j = 0; j < 2 * CT_MAX; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NK_MAX; ++kk) {
          if (kk < NK) {
            uint32_t sh[4], sl[4];
            split2(sacc[2 * kk][0], sacc[2 * kk][1], sh[0], sl[0]);
            split2(sacc[2 * kk][2], sacc[2 * kk][3], sh[1], sl[1]);
            split2(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1], sh[2], sl[2]);
            split2(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3], sh[3], sl[3]);
            uint32_t bf[CT_MAX][4];
#pragma unroll
            for (int tt = 0; tt < CT_MAX; ++tt)
              if (tt < CT) load_bt2(bf[tt], s.C + 16 * tt * LDN + 16 * kk, LDN, lane);
#pragma unroll
            for (int tt = 0; tt < CT_MAX; ++tt) {
              if (tt < CT) {
                mma(y[2 * tt], sh, bf[tt][0], bf[tt][1]);
                mma(y[2 * tt + 1], sh, bf[tt][2], bf[tt][3]);
              }
            }
#pragma unroll
            for (int tt = 0; tt < CT_MAX; ++tt) {
              if (tt < CT) {
                mma(y[2 * tt], sl, bf[tt][0], bf[tt][1]);
                mma(y[2 * tt + 1], sl, bf[tt][2], bf[tt][3]);
              }
            }
          }
        }
      }
      __syncthreads();  // G complete

      if (active) {
        // y^T = exp(logP) * y^T + x^T . G^T (G^T's causal blocks, two terms)
#pragma unroll
        for (int j = 0; j < 2 * CT_MAX; ++j) {
          const int t = 8 * j + 2 * q4;
          const float e0 = elp[t], e1 = elp[t + 1];
          y[j][0] = __fmul_rn(e0, y[j][0]);
          y[j][1] = __fmul_rn(e1, y[j][1]);
          y[j][2] = __fmul_rn(e0, y[j][2]);
          y[j][3] = __fmul_rn(e1, y[j][3]);
        }
#pragma unroll
        for (int ks = 0; ks < CT_MAX; ++ks) {
          if (ks < CT) {
            uint32_t ax[4];
            load_at(ax, s.x + 16 * ks * LDX + 16 * warp, LDX, lane);
            uint32_t gh[CT_MAX][4], gl[CT_MAX][4];
#pragma unroll
            for (int tt = ks; tt < CT_MAX; ++tt) {
              if (tt < CT) {
                load_bt2(gh[tt], Ghi + 16 * tt * LDG + 16 * ks, LDG, lane);
                load_bt2(gl[tt], Glo + 16 * tt * LDG + 16 * ks, LDG, lane);
              }
            }
#pragma unroll
            for (int tt = ks; tt < CT_MAX; ++tt) {
              if (tt < CT) {
                mma(y[2 * tt], ax, gh[tt][0], gh[tt][1]);
                mma(y[2 * tt + 1], ax, gh[tt][2], gh[tt][3]);
              }
            }
#pragma unroll
            for (int tt = ks; tt < CT_MAX; ++tt) {
              if (tt < CT) {
                mma(y[2 * tt], ax, gl[tt][0], gl[tt][1]);
                mma(y[2 * tt + 1], ax, gl[tt][2], gl[tt][3]);
              }
            }
          }
        }
        bf16* yo = static_cast<bf16*>(a.y);
#pragma unroll
        for (int j = 0; j < 2 * CT_MAX; ++j) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int t = 8 * j + 2 * q4 + (r & 1), p = 16 * warp + g8 + 8 * (r >> 1);
            if (t < valid && p < P)
              yo[(((long long)b * L + t0 + t) * a.H + h) * P + p] = __float2bfloat16(y[j][r]);
          }
        }

        // S^T <- S^T * exp(logP_last) + (x * w)^T . B (x * w as three terms)
#pragma unroll
        for (int j = 0; j < 2 * NK_MAX; ++j) {
          sacc[j][0] = __fmul_rn(sacc[j][0], decay);
          sacc[j][1] = __fmul_rn(sacc[j][1], decay);
          sacc[j][2] = __fmul_rn(sacc[j][2], decay);
          sacc[j][3] = __fmul_rn(sacc[j][3], decay);
        }
#pragma unroll
        for (int kt = 0; kt < CT_MAX; ++kt) {
          if (kt < CT) {
            uint32_t ax[4];
            load_at(ax, s.x + 16 * kt * LDX + 16 * warp, LDX, lane);
            const int t = 16 * kt + 2 * q4;
            const float w0 = wv[t], w1 = wv[t + 1], w8 = wv[t + 8], w9 = wv[t + 9];
            uint32_t x0[4], x1[4], x2[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {  // [0], [1]: steps t, t + 1; [2], [3]: t + 8, t + 9
              const float2 v = unpack(ax[i]);
              split3(__fmul_rn(v.x, i < 2 ? w0 : w8), __fmul_rn(v.y, i < 2 ? w1 : w9), x0[i],
                     x1[i], x2[i]);
            }
#pragma unroll
            for (int n0 = 0; n0 < NK_MAX; n0 += 4) {  // 8 accumulators a round
              uint32_t bf[4][4];
#pragma unroll
              for (int q = 0; q < 4; ++q)
                if (n0 + q < NK) load_b2(bf[q], s.B + 16 * kt * LDN + 16 * (n0 + q), LDN, lane);
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                if (n0 + q < NK) {
                  mma(sacc[2 * (n0 + q)], x0, bf[q][0], bf[q][1]);
                  mma(sacc[2 * (n0 + q) + 1], x0, bf[q][2], bf[q][3]);
                }
              }
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                if (n0 + q < NK) {
                  mma(sacc[2 * (n0 + q)], x1, bf[q][0], bf[q][1]);
                  mma(sacc[2 * (n0 + q) + 1], x1, bf[q][2], bf[q][3]);
                }
              }
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                if (n0 + q < NK) {
                  mma(sacc[2 * (n0 + q)], x2, bf[q][0], bf[q][1]);
                  mma(sacc[2 * (n0 + q) + 1], x2, bf[q][2], bf[q][3]);
                }
              }
            }
          }
        }
      }
    }

    if (a.state && active && ci0 + nt == nch) {  // the sweep's final state
      float* out = a.state + ((long long)b * a.H + h) * N * P;
#pragma unroll
      for (int j = 0; j < 2 * NK_MAX; ++j) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 8 * j + 2 * q4 + (r & 1), p = 16 * warp + g8 + 8 * (r >> 1);
          if (n < N && p < P) out[n * P + p] = sacc[j][r];
        }
      }
    }
  }
}

}  // namespace tensor_cores

// ---------------------------------------------------------------------------
// The CUDA-core body
namespace cuda_cores {

constexpr int THREADS = 256;  // a 16 x 16 thread grid for every product
constexpr int LDB = NMAX + 1; // B / C rows: padded, so column reads spread over banks
constexpr int LDG = CMAX + 1;

constexpr size_t FIXED_FLOATS = (size_t)NMAX * PMAX     // S
                                + (size_t)CMAX * LDG    // G
                                + 3 * (size_t)CMAX;     // logP, exp(logP), w
constexpr size_t CHUNK_FLOATS = (size_t)CMAX * PMAX     // x
                                + 2 * (size_t)CMAX * LDB  // B, C
                                + (size_t)CMAX;         // dt

constexpr size_t smem_bytes(int chunks) {
  return (FIXED_FLOATS + chunks * CHUNK_FLOATS) * sizeof(float);
}

template <int PUMP, bool MODE_R>
__global__ void __launch_bounds__(THREADS) ssd_scan_fp32(const Args a) {
  constexpr int TILES = MODE_R ? 1 : PUMP;  // chunks of one transaction
  constexpr int SUBS = MODE_R ? PUMP : 1;   // p sub-tiles, each its own sweep
  constexpr int JN = 4 / SUBS;              // columns a thread keeps
  constexpr int PW = PMAX / SUBS;           // columns of one sub-tile
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);  // N x P, row stride PMAX
  float* Gm = S + NMAX * PMAX;                 // c x c, row stride LDG
  float* lp = Gm + CMAX * LDG;
  float* elp = lp + CMAX;
  float* w = elp + CMAX;
  float* panel = w + CMAX;                     // TILES chunks, each:
  // x (c x P, row stride PMAX), B and C (c x N, row stride LDB), dt (c)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int grp = h / (a.H / a.G);
  const int c = a.chunk, N = a.N, P = a.P;
  const float A = a.A[h];
  const long long xb = b * a.sxb + h * a.sxh, db = b * a.sdb + h * a.sdh;
  const long long bb = b * a.sbb + grp * a.sbg, cb = b * a.scb + grp * a.scg;
  const int nch = (a.L + c - 1) / c;

#pragma unroll 1
  for (int sub = 0; sub < SUBS; ++sub) {
    const int p0 = sub * PW;   // the sub-tile's first column
    if (sub > 0) __syncthreads();  // the previous sweep's state is written out
    for (int i = tid; i < NMAX * PMAX; i += THREADS) S[i] = 0.f;

#pragma unroll 1
    for (int ci0 = 0; ci0 < nch; ci0 += TILES) {
      const int nt = min(TILES, nch - ci0);
      // one transaction: nt chunks as fp32; steps past L read as zeros
      // (dt = 0), and so do columns past P
      for (int slot = 0; slot < nt; ++slot) {
        float* xs = panel + slot * CHUNK_FLOATS;
        float* Bs = xs + CMAX * PMAX;
        float* Cs = Bs + CMAX * LDB;
        float* dts = Cs + CMAX * LDB;
        const int t0 = (ci0 + slot) * c;
        const int valid = min(c, a.L - t0);
        for (int i = tid; i < c * PW; i += THREADS) {
          const int t = i / PW, q = p0 + i % PW;
          xs[t * PMAX + q] = t < valid && q < P
              ? ld(a.x, xb + (t0 + t) * a.sxl + q, a.x_bf16) : 0.f;
        }
        for (int i = tid; i < c * N; i += THREADS) {
          const int t = i / N, k = i - t * N;
          const bool ok = t < valid;
          Bs[t * LDB + k] = ok ? ld(a.B, bb + (t0 + t) * a.sbl + k, a.b_bf16) : 0.f;
          Cs[t * LDB + k] = ok ? ld(a.C, cb + (t0 + t) * a.scl + k, a.c_bf16) : 0.f;
        }
        for (int t = tid; t < c; t += THREADS)
          dts[t] = t < valid ? ld(a.dt, db + (t0 + t) * a.sdl, a.dt_bf16) : 0.f;
      }
      __syncthreads();

#pragma unroll 1
      for (int beat = 0; beat < nt; ++beat) {  // the dependent beats
        float* xs = panel + beat * CHUNK_FLOATS;
        float* Bs = xs + CMAX * PMAX;
        float* Cs = Bs + CMAX * LDB;
        float* dts = Cs + CMAX * LDB;
        const int t0 = (ci0 + beat) * c;
        const int valid = min(c, a.L - t0);

        // warp 0: the decay cumsum (fp64, in order), then exp(logP) and w
        if (tid < 32) {
          if (tid == 0) {
            double acc = 0.0;
            for (int t = 0; t < c; ++t) {
              acc += (double)(A * dts[t]);
              lp[t] = (float)acc;
            }
          }
          __syncwarp();
          const float last = lp[c - 1];
          for (int t = tid; t < c; t += 32) {
            elp[t] = expf(lp[t]);
            w[t] = __fmul_rn(expf(__fsub_rn(last, lp[t])), dts[t]);
          }
        }

        // C . B^T (c x c), contraction over N
        float acc[4][4] = {};
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          float av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = Cs[(ty + 16 * i) * LDB + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * LDB + k];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();  // logP ready; every read of B done

        // G = mask(C.B^T * exp(logP_t - logP_s) * dt_s); B rows scaled by w
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = tx + 16 * j;
            if (t < c && s < c)
              Gm[t * LDG + s] = s <= t
                  ? __fmul_rn(__fmul_rn(acc[i][j], expf(__fsub_rn(lp[t], lp[s]))), dts[s])
                  : 0.f;
          }
        }
        for (int i = tid; i < c * N; i += THREADS) {
          const int t = i / N, k = i - t * N;
          Bs[t * LDB + k] = __fmul_rn(Bs[t * LDB + k], w[t]);
        }
        __syncthreads();

        // y = exp(logP) * (C . S) + G . x  (c x the sub-tile's columns)
        float yc[4][JN] = {}, yi[4][JN] = {};
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          float av[4], sv[JN];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = Cs[(ty + 16 * i) * LDB + k];
#pragma unroll
          for (int j = 0; j < JN; ++j) sv[j] = S[k * PMAX + p0 + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < JN; ++j) yc[i][j] = fmaf(av[i], sv[j], yc[i][j]);
        }
#pragma unroll 4
        for (int k = 0; k < c; ++k) {
          float gv[4], xv[JN];
#pragma unroll
          for (int i = 0; i < 4; ++i) gv[i] = Gm[(ty + 16 * i) * LDG + k];
#pragma unroll
          for (int j = 0; j < JN; ++j) xv[j] = xs[k * PMAX + p0 + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < JN; ++j) yi[i][j] = fmaf(gv[i], xv[j], yi[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = ty + 16 * i;
          if (t >= valid) continue;
          const long long row = (((long long)b * a.L + t0 + t) * a.H + h) * P;
#pragma unroll
          for (int j = 0; j < JN; ++j) {
            const int q = p0 + tx + 16 * j;
            if (q < P)
              st(a.y, row + q, a.x_bf16, __fadd_rn(__fmul_rn(elp[t], yc[i][j]), yi[i][j]));
          }
        }
        __syncthreads();  // every read of S done

        // S <- S * exp(logP_last) + (B * w)^T . x  (N x the sub-tile's
        // columns), contraction over c
        float sa[8][JN] = {};
#pragma unroll 4
        for (int k = 0; k < c; ++k) {
          float bv[8], xv[JN];
#pragma unroll
          for (int i = 0; i < 8; ++i) bv[i] = Bs[k * LDB + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < JN; ++j) xv[j] = xs[k * PMAX + p0 + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < JN; ++j) sa[i][j] = fmaf(bv[i], xv[j], sa[i][j]);
        }
        const float decay = expf(lp[c - 1]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int n = ty + 16 * i;
#pragma unroll
          for (int j = 0; j < JN; ++j) {
            const int q = p0 + tx + 16 * j;
            if (n < N && q < P)
              S[n * PMAX + q] = __fadd_rn(__fmul_rn(S[n * PMAX + q], decay), sa[i][j]);
          }
        }
        __syncthreads();  // S updated; the chunk's buffers free
      }
    }

    if (a.state) {
      float* out = a.state + ((long long)b * a.H + h) * N * P;
      for (int i = tid; i < N * PW; i += THREADS) {
        const int n = i / PW, q = p0 + i % PW;
        if (q < P) out[n * P + q] = S[n * PMAX + q];
      }
    }
  }
}

}  // namespace cuda_cores

// The bodies: the CUDA-core one; the tensor-core one at any widths, and at
// mamba2's (chunk 64, N 128, P 64, rows of 16-byte pieces), where every
// loop over tiles, rows and pieces has a constant count: fewer registers
// and a shorter time than the same code with runtime counts.
enum Body { CUDA_CORES = 0, TENSOR_CORES = 1, TENSOR_CORES_FULL = 2 };

// The kernel of one pump case and body: its shared memory, and either the
// blocks an SM holds (blocks_per_sm not null) or the launch.
template <int PUMP, bool MODE_R, int BODY>
cudaError_t run(const Args& a, int Bsz, cudaStream_t stream, int* blocks_per_sm) {
  constexpr int TILES = MODE_R ? 1 : PUMP;
  constexpr size_t smem = BODY == CUDA_CORES ? cuda_cores::smem_bytes(TILES)
                                             : tensor_cores::smem_bytes(TILES);
  if constexpr (smem > MAX_SMEM) {
    return cudaErrorInvalidValue;  // not built: the panel does not fit
  } else {
    constexpr int threads = BODY == CUDA_CORES ? cuda_cores::THREADS : tensor_cores::THREADS;
    void (*kernel)(Args) = BODY == CUDA_CORES ? cuda_cores::ssd_scan_fp32<PUMP, MODE_R>
                           : BODY == TENSOR_CORES
                               ? tensor_cores::ssd_scan_tc<PUMP, MODE_R, false>
                               : tensor_cores::ssd_scan_tc<PUMP, MODE_R, true>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    if (blocks_per_sm)
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, smem);
    kernel<<<dim3(a.H, Bsz), threads, smem, stream>>>(a);
    return cudaGetLastError();
  }
}

template <int BODY>
cudaError_t by_pump(const Args& a, int Bsz, int pump, int mode_r, cudaStream_t stream,
                    int* blocks_per_sm) {
  if (!mode_r || pump == 1) {
    switch (pump) {
      case 1: return run<1, false, BODY>(a, Bsz, stream, blocks_per_sm);
      case 2: return run<2, false, BODY>(a, Bsz, stream, blocks_per_sm);
      case 4: return run<4, false, BODY>(a, Bsz, stream, blocks_per_sm);
    }
  } else {
    switch (pump) {
      case 2: return run<2, true, BODY>(a, Bsz, stream, blocks_per_sm);
      case 4: return run<4, true, BODY>(a, Bsz, stream, blocks_per_sm);
    }
  }
  return cudaErrorInvalidValue;
}

// Rows of a bf16 tensor move as 16-byte pieces: its base, its row length
// and every stride of a dim longer than 1 are multiples of 16 bytes.
bool rows16(const void* p, int row, long long s0, int d0, long long s1, int d1, long long s2,
            int d2) {
  auto ok = [](long long s, int d) { return d == 1 || (s * 2) % 16 == 0; };
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (row * 2) % 16 == 0 && ok(s0, d0) &&
         ok(s1, d1) && ok(s2, d2);
}

}  // namespace

// Blocks one SM holds at once for a pump case of the tensor-core body at
// the full widths (tensor_cores 1) or of the CUDA-core body (0), as the
// runtime computes it from the kernel's registers, threads and shared
// memory.  Returns a cudaError_t.
extern "C" int ssd_scan_blocks_per_sm(int tensor_cores, int pump, int mode_r, int* out) {
  Args a = {};
  return tensor_cores ? (int)by_pump<TENSOR_CORES_FULL>(a, 0, pump, mode_r, nullptr, out)
                      : (int)by_pump<CUDA_CORES>(a, 0, pump, mode_r, nullptr, out);
}

// Dtype codes: 0 = float32, 1 = bfloat16.  x (B, L, H, P), dt (B, L, H) and
// B / C (B, L, G, N) through the given element strides (last dim of x, B, C
// contiguous); A (H,) fp32; y (B, L, H, P) contiguous in x's dtype; state
// (B, H, N, P) contiguous fp32 or null.  Needs chunk <= 64, N <= 128,
// P <= 64 and H % G == 0; pump 1, 2 or 4, mode_r 0 (T) or 1 (R).  x, B and
// C all bf16 take the tensor-core body, any of them fp32 the CUDA-core one.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, void* y, void* state, int x_dtype, int dt_dtype,
                            int b_dtype, int c_dtype, int Bsz, int L, int H, int G, int N,
                            int P, int chunk, const long long* strides, int pump,
                            int mode_r, void* stream) {
  if (chunk < 1 || chunk > CMAX || N < 1 || N > NMAX || P < 1 || P > PMAX || G < 1 ||
      H % G != 0 || L < 1)
    return cudaErrorInvalidValue;
  Args a;
  a.x = x; a.dt = dt; a.A = static_cast<const float*>(A); a.B = Bm; a.C = Cm;
  a.y = y; a.state = static_cast<float*>(state);
  a.x_bf16 = x_dtype; a.dt_bf16 = dt_dtype; a.b_bf16 = b_dtype; a.c_bf16 = c_dtype;
  a.L = L; a.H = H; a.G = G; a.N = N; a.P = P; a.chunk = chunk;
  a.sxb = strides[0]; a.sxl = strides[1]; a.sxh = strides[2];
  a.sdb = strides[3]; a.sdl = strides[4]; a.sdh = strides[5];
  a.sbb = strides[6]; a.sbl = strides[7]; a.sbg = strides[8];
  a.scb = strides[9]; a.scl = strides[10]; a.scg = strides[11];
  a.vec = rows16(x, P, a.sxb, Bsz, a.sxl, L, a.sxh, H) &&
          rows16(Bm, N, a.sbb, Bsz, a.sbl, L, a.sbg, G) &&
          rows16(Cm, N, a.scb, Bsz, a.scl, L, a.scg, G);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype != 1 || b_dtype != 1 || c_dtype != 1)
    return (int)by_pump<CUDA_CORES>(a, Bsz, pump, mode_r, s, nullptr);
  return chunk == CMAX && N == NMAX && P == PMAX && a.vec
             ? (int)by_pump<TENSOR_CORES_FULL>(a, Bsz, pump, mode_r, s, nullptr)
             : (int)by_pump<TENSOR_CORES>(a, Bsz, pump, mode_r, s, nullptr);
}
