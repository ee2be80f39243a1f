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
// in fp32, as the Pallas kernel does.  The cumsum accumulates in fp64 and
// rounds once to fp32 (kernels/ref.py::ssd_scan does the same), so the decay
// exponents agree with the plain version to the last bit wherever fp64 sums
// round alike.  x, dt, B and C are each read in their own dtype (fp32 or
// bf16) through their strides, with the last dim contiguous, so the model's
// strided views of the conv output go in without a copy; y is written
// contiguous (B, L, H, P) in x's dtype, the final state contiguous
// (B, H, N, P) in fp32 when its pointer is not null.  A ragged L is masked:
// steps past L read as dt = 0 and zeros, which leave S untouched, and their
// y is not written (the reference pads L to a bucket instead; the math is
// the same, the rounding of the padded sweep can differ).
//
// What bounds it on this card: operations.  Three (c x c x N)-, (c x P x N)-
// and (N x P x c)-sized products per chunk, about 3.7 MFLOP per (b, h, chunk)
// at c 64, N 128, P 64 against about 21 KB of input, far above fp32's ~20
// FLOP per byte on the H100.
//
// Design: one block of 256 threads per (b, h).  The Pallas grid's sequential
// chunk axis becomes one loop over chunks inside the block, with S in
// shared memory for the whole sweep.  A chunk's x, dt, B and C are staged
// in shared memory as fp32, one warp takes the fp64 cumsum, and every
// product is a 16 x 16 grid of threads, each holding a 4 x 4 (or 8 x 4)
// register tile with interleaved rows and columns so that the
// shared-memory reads are broadcasts or hit 16 distinct banks (B and C rows
// padded to N + 1).  The math is fp32 FMA on CUDA cores, as the reference;
// tensor cores and sharing C.B^T across the heads of a group are later
// work.  Shared memory is sized for c <= 64, N <= 128, P <= 64.
//
// The pump (template PUMP, MODE_R), the reference's fori_loop over M beats
// (kernels/ssd_scan.py:74):
//  - mode T: the chunks are walked in transactions of PUMP chunks: the
//    panel of PUMP chunks of x, dt, B and C is staged at once (ordinary
//    loads, all issued before one barrier: the operands arrive in mixed
//    dtypes through strides, and dt is one 2-byte element a step, which
//    cp.async cannot move), then PUMP dependent beats run over it, each a
//    chunk of the recurrence;
//  - mode R: the builder's narrow axis p is cut into PUMP sub-tiles of
//    64 / PUMP columns, and each runs its own full sweep over the chunks
//    with its own columns of x, y and S (C.B^T is recomputed per sweep).
// Every output sums the same terms in the same order in every case, so T1,
// T2, R2 and R4 give the same bits.  Built set: the fixed buffers (S, the
// c x c matrix, the decay vectors) take 49 KB and one chunk's panel 81 KB,
// so T2 (211 KB) is the widest mode-T transaction that fits 227 KB; T4
// (373 KB) is not built.  Mode R stages one chunk (130 KB).
// kernels/ssd_scan.py::built is the same sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 thread grid for every product
constexpr int CMAX = 64;      // chunk
constexpr int NMAX = 128;     // state dim
constexpr int PMAX = 64;      // head dim
constexpr int LDB = NMAX + 1; // B / C rows: padded, so column reads spread over banks
constexpr int LDG = CMAX + 1;

constexpr size_t FIXED_FLOATS = (size_t)NMAX * PMAX     // S
                                + (size_t)CMAX * LDG    // G
                                + 3 * (size_t)CMAX;     // logP, exp(logP), w
constexpr size_t CHUNK_FLOATS = (size_t)CMAX * PMAX     // x
                                + 2 * (size_t)CMAX * LDB  // B, C
                                + (size_t)CMAX;         // dt
constexpr size_t MAX_SMEM = 227 * 1024;

constexpr size_t smem_floats(int chunks) {
  return FIXED_FLOATS + chunks * CHUNK_FLOATS;
}

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
  long long sxb, sxl, sxh;  // x (B, L, H, P)
  long long sdb, sdl, sdh;  // dt (B, L, H)
  long long sbb, sbl, sbg;  // B (B, L, G, N)
  long long scb, scl, scg;  // C (B, L, G, N)
};

template <int PUMP, bool MODE_R>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(const Args a) {
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

template <int PUMP, bool MODE_R>
cudaError_t launch(const Args& a, int Bsz, cudaStream_t stream) {
  constexpr size_t smem = smem_floats(MODE_R ? 1 : PUMP) * sizeof(float);
  if constexpr (smem > MAX_SMEM) {
    return cudaErrorInvalidValue;  // not built: the panel does not fit
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<PUMP, MODE_R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    ssd_scan_kernel<PUMP, MODE_R><<<dim3(a.H, Bsz), THREADS, smem, stream>>>(a);
    return cudaGetLastError();
  }
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16.  x (B, L, H, P), dt (B, L, H) and
// B / C (B, L, G, N) through the given element strides (last dim of x, B, C
// contiguous); A (H,) fp32; y (B, L, H, P) contiguous in x's dtype; state
// (B, H, N, P) contiguous fp32 or null.  Needs chunk <= 64, N <= 128,
// P <= 64 and H % G == 0; pump 1, 2 or 4, mode_r 0 (T) or 1 (R).
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!mode_r || pump == 1) {
    switch (pump) {
      case 1: return launch<1, false>(a, Bsz, s);
      case 2: return launch<2, false>(a, Bsz, s);
      case 4: return launch<4, false>(a, Bsz, s);
    }
  } else {
    switch (pump) {
      case 2: return launch<2, true>(a, Bsz, s);
      case 4: return launch<4, true>(a, Bsz, s);
    }
  }
  return cudaErrorInvalidValue;
}
