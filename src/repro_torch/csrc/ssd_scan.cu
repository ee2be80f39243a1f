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
// chunk axis, and the pump's fori_loop inside it, become one loop over chunks
// inside the block, with S in shared memory for the whole sweep.  Each chunk
// stages x, dt, B and C in shared memory as fp32, one warp takes the fp64
// cumsum, and every product is a 16 x 16 grid of threads, each holding a
// 4 x 4 (or 8 x 4) register tile with interleaved rows and columns so that
// the shared-memory reads are broadcasts or hit 16 distinct banks (B and C
// rows padded to N + 1).  The math is fp32 FMA on CUDA cores, as the
// reference; tensor cores, sharing C.B^T across the heads of a group, and
// prefetching the next chunk while this one computes are later work.
// Shared memory is sized for c <= 64, N <= 128, P <= 64 (about 129 KB, one
// block per SM).
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

constexpr size_t SMEM_FLOATS = (size_t)NMAX * PMAX      // S
                               + (size_t)CMAX * PMAX    // x
                               + 2 * (size_t)CMAX * LDB // B, C
                               + (size_t)CMAX * LDG     // G
                               + 4 * (size_t)CMAX;      // logP, exp(logP), dt, w

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

__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);  // N x P, row stride PMAX
  float* xs = S + NMAX * PMAX;                 // c x P, row stride PMAX
  float* Bs = xs + CMAX * PMAX;                // c x N, row stride LDB
  float* Cs = Bs + CMAX * LDB;
  float* Gm = Cs + CMAX * LDB;                 // c x c, row stride LDG
  float* lp = Gm + CMAX * LDG;
  float* elp = lp + CMAX;
  float* dts = elp + CMAX;
  float* w = dts + CMAX;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int grp = h / (a.H / a.G);
  const int c = a.chunk, N = a.N, P = a.P;
  const float A = a.A[h];
  const long long xb = b * a.sxb + h * a.sxh, db = b * a.sdb + h * a.sdh;
  const long long bb = b * a.sbb + grp * a.sbg, cb = b * a.scb + grp * a.scg;

  for (int i = tid; i < NMAX * PMAX; i += THREADS) S[i] = 0.f;

  const int nch = (a.L + c - 1) / c;
  for (int ci = 0; ci < nch; ++ci) {
    const int t0 = ci * c;
    const int valid = min(c, a.L - t0);

    // stage the chunk as fp32; steps past L read as zeros (dt = 0)
    for (int i = tid; i < c * P; i += THREADS) {
      const int t = i / P, q = i - t * P;
      xs[t * PMAX + q] = t < valid ? ld(a.x, xb + (t0 + t) * a.sxl + q, a.x_bf16) : 0.f;
    }
    for (int i = tid; i < c * N; i += THREADS) {
      const int t = i / N, k = i - t * N;
      const bool ok = t < valid;
      Bs[t * LDB + k] = ok ? ld(a.B, bb + (t0 + t) * a.sbl + k, a.b_bf16) : 0.f;
      Cs[t * LDB + k] = ok ? ld(a.C, cb + (t0 + t) * a.scl + k, a.c_bf16) : 0.f;
    }
    for (int t = tid; t < c; t += THREADS)
      dts[t] = t < valid ? ld(a.dt, db + (t0 + t) * a.sdl, a.dt_bf16) : 0.f;
    __syncthreads();

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

    // y = exp(logP) * (C . S) + G . x  (c x P)
    float yc[4][4] = {}, yi[4][4] = {};
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      float av[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = Cs[(ty + 16 * i) * LDB + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) sv[j] = S[k * PMAX + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yc[i][j] = fmaf(av[i], sv[j], yc[i][j]);
    }
#pragma unroll 4
    for (int k = 0; k < c; ++k) {
      float gv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = Gm[(ty + 16 * i) * LDG + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = xs[k * PMAX + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yi[i][j] = fmaf(gv[i], xv[j], yi[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
      if (t >= valid) continue;
      const long long row = (((long long)b * a.L + t0 + t) * a.H + h) * P;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = tx + 16 * j;
        if (q < P) st(a.y, row + q, a.x_bf16, __fadd_rn(__fmul_rn(elp[t], yc[i][j]), yi[i][j]));
      }
    }
    __syncthreads();  // every read of S done

    // S <- S * exp(logP_last) + (B * w)^T . x  (N x P), contraction over c
    float sa[8][4] = {};
#pragma unroll 4
    for (int k = 0; k < c; ++k) {
      float bv[8], xv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) bv[i] = Bs[k * LDB + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = xs[k * PMAX + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sa[i][j] = fmaf(bv[i], xv[j], sa[i][j]);
    }
    const float decay = expf(lp[c - 1]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = tx + 16 * j;
        if (n < N && q < P)
          S[n * PMAX + q] = __fadd_rn(__fmul_rn(S[n * PMAX + q], decay), sa[i][j]);
      }
    }
    __syncthreads();  // S updated; the chunk's buffers free for the next
  }

  if (a.state) {
    float* out = a.state + ((long long)b * a.H + h) * N * P;
    for (int i = tid; i < N * P; i += THREADS) {
      const int n = i / P, q = i - n * P;
      out[i] = S[n * PMAX + q];
    }
  }
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16.  x (B, L, H, P), dt (B, L, H) and
// B / C (B, L, G, N) through the given element strides (last dim of x, B, C
// contiguous); A (H,) fp32; y (B, L, H, P) contiguous in x's dtype; state
// (B, H, N, P) contiguous fp32 or null.  Needs chunk <= 64, N <= 128,
// P <= 64 and H % G == 0.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, void* y, void* state, int x_dtype, int dt_dtype,
                            int b_dtype, int c_dtype, int Bsz, int L, int H, int G, int N,
                            int P, int chunk, const long long* strides, void* stream) {
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
  const int smem = (int)(SMEM_FLOATS * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<<<dim3(H, Bsz), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
