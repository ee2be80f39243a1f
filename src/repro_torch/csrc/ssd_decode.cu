// One-token Mamba-2 SSD step (the recurrent decode form) for Hopper, sm_90a.
//
// Replaces the multi-output map kernel that
// src/repro/compiler/pallas_backend.py::emit_pallas writes (pl.pallas_call at
// :814) over src/repro/core/autopump.py::_ssd_decode_graph (:564).  No
// hand-written Pallas version of it exists; the emitter wrote it.
//
// Computes, per batch row b and head h (group g = h / (H / G)):
//   state'[n, p] = state[n, p] * exp(A_h * dt) + (B[n] * dt) * x[p]
//   y[p]         = sum_n C[n] * state'[n, p]
// in fp32.  The state is read and written fp32, out of place (the reference
// returns a new state).  x, dt, B and C are each read in their own dtype
// (fp32 or bf16) through their strides, last dim contiguous, so the model's
// views of the conv output go in without a copy.  y is written fp32: the
// reference's emitted kernel rounds y to the graph dtype
// (pallas_backend.py:996) and its model casts it straight back to fp32
// (models/ssm.py:159), while its plain route keeps y fp32 throughout; the
// port keeps the fp32 y of the plain route.
//
// What bounds it on this card: bytes.  Each state element is read once and
// written once for five FLOPs (the update and the C product), so the step
// moves 2 * N * P * 4 bytes per (b, h) and the bound is that over 3.35 TB/s.
//
// Design: one block of 256 threads per (b, h), 512 blocks at B 8, H 64.  A
// thread owns four consecutive p columns and walks the rows n with 16-byte
// loads and stores (P / 4 threads cover a row, 256 / (P / 4) rows per pass),
// keeping its partial y in registers; the partial sums over n then meet in
// shared memory and are added in row order.
//
// The pump of the compiler's region plan (compiler/hopper_backend.py) is
// realized without changing a value: mode R at M > 1 (`sub`) makes the
// block walk P in M narrowed sub-tiles in turn, one column per thread and
// slot, with the same rows per pass and the same order of every sum as the
// 16-byte path; mode T at M > 1 (`heads`) makes one block walk M
// consecutive heads.  A P the 16-byte path cannot tile takes the sub-tile
// path with one sub-tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float ld(const void* base, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i])
              : static_cast<const float*>(base)[i];
}

__device__ __forceinline__ float upd(float s, float decay, float bdt, float x) {
  return __fadd_rn(__fmul_rn(s, decay), __fmul_rn(bdt, x));
}

struct Args {
  const float* state;
  const void* x;
  const void* dt;
  const float* A;
  const void* B;
  const void* C;
  float* y;
  float* state_out;
  int x_bf16, dt_bf16, b_bf16, c_bf16;
  int H, G, N, P, sub, heads;
  long long sxb, sxh, sdb, sdh, sbb, sbg, scb, scg;
};

__global__ void __launch_bounds__(THREADS) ssd_decode_kernel(const Args a) {
  __shared__ float4 part4[THREADS];  // rows-per-pass x P partial sums of y
  float* part = reinterpret_cast<float*>(part4);

  const int b = blockIdx.y, tid = threadIdx.x;
  const bool vec = a.sub == 1 && a.P % 4 == 0 && THREADS % (a.P / 4) == 0;
  const int rows = 4 * THREADS / a.P;  // the 16-byte path's rows per pass
  const int pm = a.P / a.sub;          // columns of one sub-tile

  for (int hh = 0; hh < a.heads; ++hh) {
    const int h = blockIdx.x * a.heads + hh;
    const int grp = h / (a.H / a.G);
    const float dt = ld(a.dt, b * a.sdb + h * a.sdh, a.dt_bf16);
    const float decay = expf(__fmul_rn(a.A[h], dt));
    const long long bo = b * a.sbb + grp * a.sbg, co = b * a.scb + grp * a.scg;
    const long long xb = b * a.sxb + h * a.sxh;
    const long long se = ((long long)b * a.H + h) * a.N * a.P;

    if (vec) {
      const int cols4 = a.P / 4;
      const int c4 = tid % cols4, r0 = tid / cols4;
      const long long xo = xb + 4 * c4;
      const float x0 = ld(a.x, xo, a.x_bf16), x1 = ld(a.x, xo + 1, a.x_bf16);
      const float x2 = ld(a.x, xo + 2, a.x_bf16), x3 = ld(a.x, xo + 3, a.x_bf16);
      const float4* s4 = reinterpret_cast<const float4*>(a.state + se);
      float4* o4 = reinterpret_cast<float4*>(a.state_out + se);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int n = r0; n < a.N; n += rows) {
        const float4 s = s4[(long long)n * cols4 + c4];
        const float bdt = __fmul_rn(ld(a.B, bo + n, a.b_bf16), dt);
        const float cn = ld(a.C, co + n, a.c_bf16);
        float4 s2;
        s2.x = upd(s.x, decay, bdt, x0);
        s2.y = upd(s.y, decay, bdt, x1);
        s2.z = upd(s.z, decay, bdt, x2);
        s2.w = upd(s.w, decay, bdt, x3);
        o4[(long long)n * cols4 + c4] = s2;
        acc.x = fmaf(cn, s2.x, acc.x);
        acc.y = fmaf(cn, s2.y, acc.y);
        acc.z = fmaf(cn, s2.z, acc.z);
        acc.w = fmaf(cn, s2.w, acc.w);
      }
      part4[r0 * cols4 + c4] = acc;
    } else {
      for (int m = 0; m < a.sub; ++m) {
        for (int slot = tid; slot < rows * pm; slot += THREADS) {
          const int r = slot / pm, q = m * pm + slot % pm;
          const float xq = ld(a.x, xb + q, a.x_bf16);
          float acc = 0.f;
          for (int n = r; n < a.N; n += rows) {
            const float bdt = __fmul_rn(ld(a.B, bo + n, a.b_bf16), dt);
            const float cn = ld(a.C, co + n, a.c_bf16);
            const float s2 = upd(a.state[se + (long long)n * a.P + q], decay,
                                 bdt, xq);
            a.state_out[se + (long long)n * a.P + q] = s2;
            acc = fmaf(cn, s2, acc);
          }
          part[r * a.P + q] = acc;
        }
      }
    }
    __syncthreads();
    const int used = min(rows, a.N);
    float* yo = a.y + ((long long)b * a.H + h) * a.P;
    for (int q = tid; q < a.P; q += THREADS) {
      float sum = 0.f;
      for (int r = 0; r < used; ++r) sum += part[r * a.P + q];
      yo[q] = sum;
    }
    __syncthreads();  // the next head reuses part
  }
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16.  state / state_out (B, H, N, P)
// contiguous fp32, 16-byte aligned; x (B, H, P), dt (B, H), B / C (B, G, N)
// through the given element strides (last dim of x, B, C contiguous); A (H,)
// fp32; y (B, H, P) contiguous fp32.  Needs 1 <= P <= 1024, H % G == 0, and
// the pump dividing its axis: P % sub == 0 (mode R), H % heads == 0 (mode
// T).
extern "C" int ssd_decode_fwd(const void* state, const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, void* y, void* state_out,
                              int x_dtype, int dt_dtype, int b_dtype, int c_dtype, int Bsz,
                              int H, int G, int N, int P, int sub, int heads,
                              const long long* strides, void* stream) {
  if (P < 1 || P > 4 * THREADS || N < 1 || G < 1 || H % G != 0 || sub < 1 ||
      P % sub != 0 || heads < 1 || H % heads != 0)
    return cudaErrorInvalidValue;
  Args a;
  a.state = static_cast<const float*>(state); a.x = x; a.dt = dt;
  a.A = static_cast<const float*>(A); a.B = Bm; a.C = Cm;
  a.y = static_cast<float*>(y); a.state_out = static_cast<float*>(state_out);
  a.x_bf16 = x_dtype; a.dt_bf16 = dt_dtype; a.b_bf16 = b_dtype; a.c_bf16 = c_dtype;
  a.H = H; a.G = G; a.N = N; a.P = P; a.sub = sub; a.heads = heads;
  a.sxb = strides[0]; a.sxh = strides[1];
  a.sdb = strides[2]; a.sdh = strides[3];
  a.sbb = strides[4]; a.sbg = strides[5];
  a.scb = strides[6]; a.scg = strides[7];
  ssd_decode_kernel<<<dim3(H / heads, Bsz), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
