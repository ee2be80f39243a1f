// One pumped stage of a 7-point 3-D stencil for Hopper, sm_90a (paper
// Tables 4-5).
//
// Replaces src/repro/kernels/stencil.py::stencil_step_pallas (pl.pallas_call
// at :77; body _stencil_kernel :35), which stencil_chain_pallas (:88) calls
// once per stage.  There one grid step takes a slab of M interior planes,
// fed as three plane-shifted views x[p-1], x[p], x[p+1] built by the
// wrapper, and updates the M planes one after another; the boundary planes
// are concatenated back on.
//
// Here one block takes a slab of M interior planes and one TH x TW tile of
// the (d1, d2) plane.  Planes p0-1 .. p0+M of the tile, with a one-cell
// halo, are copied into shared memory once: that is the wide transaction,
// M + 2 planes of halo tile for M planes of output (the reference feeds
// 3 M).  The block then updates its M planes from shared memory.  Boundary
// rows and columns of each plane are copied, and the first and last slabs
// also copy boundary planes 0 and d0-1, so a stage writes the whole volume
// in one launch and a chain alternates between two buffers.
//
// Each cell is summed in the Pallas body's order (stencil.py:40-51): plane
// before + plane after + row above + row below + column left + column
// right, then jacobi (sum + c) * (1/7) or diffusion c + coef * (sum - 6 c),
// with round-to-nearest intrinsics so no FMA contraction changes a bit
// against the plain PyTorch version.
//
// What bounds it on this card: bytes.  A stage reads the volume once and
// writes it once for 7 (jacobi) or 9 (diffusion) fp32 operations per
// cell: at (514, 512, 512) that is 539 MB, 0.32 ms at 3.35 TB/s, against
// 0.04 ms of operations.  The halo planes a slab shares with its
// neighbours are read again, mostly from L2, since blocks of neighbouring
// tiles of one slab run together.
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32, TH = 32, THREADS_Y = 8;
constexpr int HW = TW + 2, HH = TH + 2;    // the halo tile

__global__ void __launch_bounds__(TW * THREADS_Y)
    stencil_kernel(const float* __restrict__ src, float* __restrict__ dst,
                   int d0, int d1, int d2, int pump, int diffusion,
                   float coef, float inv7) {
  extern __shared__ float tile[];   // [pump + 2][HH][HW]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int slab = blockIdx.z, p0 = 1 + slab * pump;   // first output plane
  const long long plane = (long long)d1 * d2;

  const int cells = (pump + 2) * HH * HW;
  for (int i = tid; i < cells; i += TW * THREADS_Y) {
    const int q = i / (HH * HW), rem = i % (HH * HW);
    const int gy = y0 - 1 + rem / HW, gx = x0 - 1 + rem % HW;
    const int p = p0 - 1 + q;
    tile[i] = (gy >= 0 && gy < d1 && gx >= 0 && gx < d2)
                  ? src[p * plane + (long long)gy * d2 + gx]
                  : 0.f;
  }
  __syncthreads();

  auto at = [&](int q, int y, int x) { return tile[(q * HH + y) * HW + x]; };
  const bool first = slab == 0, last = p0 + pump == d0 - 1;
#pragma unroll
  for (int r = 0; r < TH / THREADS_Y; ++r) {
    const int y = ty + r * THREADS_Y, gy = y0 + y, gx = x0 + tx;
    if (gy >= d1 || gx >= d2) continue;
    const long long cell = (long long)gy * d2 + gx;
    const bool edge = gy == 0 || gy == d1 - 1 || gx == 0 || gx == d2 - 1;
    if (first) dst[cell] = at(0, y + 1, tx + 1);
    if (last) dst[(d0 - 1) * plane + cell] = at(pump + 1, y + 1, tx + 1);
    for (int m = 0; m < pump; ++m) {
      const int q = m + 1;
      const float c = at(q, y + 1, tx + 1);
      float out = c;
      if (!edge) {
        float s = __fadd_rn(at(q - 1, y + 1, tx + 1), at(q + 1, y + 1, tx + 1));
        s = __fadd_rn(s, at(q, y, tx + 1));
        s = __fadd_rn(s, at(q, y + 2, tx + 1));
        s = __fadd_rn(s, at(q, y + 1, tx));
        s = __fadd_rn(s, at(q, y + 1, tx + 2));
        out = diffusion
                  ? __fadd_rn(c, __fmul_rn(coef, __fsub_rn(s, __fmul_rn(6.f, c))))
                  : __fmul_rn(__fadd_rn(s, c), inv7);
      }
      dst[(p0 + m) * plane + cell] = out;
    }
  }
}

}  // namespace

// One stage over a contiguous fp32 (d0, d1, d2) volume, src -> dst (not in
// place).  (d0 - 2) % pump == 0 and d0 > 2.  coef and inv7 are the fp32
// constants of the plain version.  Returns the launch's cudaError_t.
extern "C" int stencil_fwd(const float* src, float* dst, int d0, int d1,
                           int d2, int pump, int diffusion, float coef,
                           float inv7, void* stream) {
  const int smem = (pump + 2) * HH * HW * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      stencil_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((d2 + TW - 1) / TW, (d1 + TH - 1) / TH, (d0 - 2) / pump);
  stencil_kernel<<<grid, dim3(TW, THREADS_Y), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      src, dst, d0, d1, d2, pump, diffusion, coef, inv7);
  return (int)cudaGetLastError();
}
