// One pumped stage of a 7-point 3-D stencil for Hopper, sm_90a (paper
// Tables 4-5), streamed down the volume.
//
// Replaces src/repro/kernels/stencil.py::stencil_step_pallas (pl.pallas_call
// at :77; body _stencil_kernel :35), which stencil_chain_pallas (:88) calls
// once per stage.  There one grid step takes a slab of M interior planes,
// fed as three plane-shifted views x[p-1], x[p], x[p+1] built by the
// wrapper, and updates the M planes one after another; the boundary planes
// are concatenated back on.
//
// What bounds it on this card: bytes.  A stage reads the volume once and
// writes it once for 7 (jacobi) or 9 (diffusion) fp32 operations per
// cell: at (514, 512, 512) that is 539 MB, 0.32 ms at 3.35 TB/s, against
// 0.04 ms of operations.  So every plane should cross device memory once
// each way, and the copies should overlap the arithmetic.
//
// Design (2.5-D streaming).  A block of 512 threads owns one 256-wide
// tile of the (d1, d2) plane and marches down d0 over a segment of
// interior planes; the grid is (tiles in x, tiles in y, segments), and the
// wrapper picks the segment length so that the grid fits the card's
// resident blocks in one wave (kernels/stencil.py::plan).  Each plane of
// the segment is staged once, with its one-cell halo, into a ring of NT *
// M + 1 plane slots in shared memory:
//  - the pump is the transaction: one cp.async group stages the next M
//    planes of the tile, and the block then runs M dependent beats over
//    them, one output plane each, with no barrier between beats;
//  - NT = 2 transactions are in flight, so the next group loads while the
//    block computes this one; two barriers a transaction guard the ring;
//  - the tile has 32 rows, or 16 or 8 where the ring of M's planes needs
//    the room (tile_rows): M 1 and 2 take 32, M 4 16, M 8 8; M 16 and up
//    do not fit 227 KB;
//  - the centre column below and at the current plane rotates through
//    registers (prev, cur), the plane above is read from its slot, and the
//    current plane's slot gives the four in-plane neighbours;
//  - a tile row's 256 interior floats are staged as 16-byte copies (the
//    tile's x origin is a multiple of 256 floats), its two halo cells as
//    4-byte copies; a tile that is ragged in x, or a volume whose rows are
//    not 16-byte aligned, takes 4-byte copies throughout.  No divide or
//    modulo in the copy loops (the divides are by powers of two);
//  - two neighbouring segments both read the two planes at their border,
//    so S segments read 2 (S - 1) planes more a stage: 1.2% more at (514,
//    512, 512) in 4 segments; the plan keeps segments of at least 40
//    planes.
// The first segment also copies boundary plane 0 and the last plane d0-1,
// and boundary rows and columns of each plane are copied, so a stage
// writes the whole volume in one launch and a chain alternates between two
// buffers.
//
// Each cell is summed in the Pallas body's order (stencil.py:40-51): plane
// before + plane after + row above + row below + column left + column
// right, then jacobi (sum + c) * (1/7) or diffusion c + coef * (sum - 6 c),
// with round-to-nearest intrinsics so no FMA contraction changes a bit
// against the plain PyTorch version: the two agree exactly.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 256;                    // the tile's x extent
constexpr int TY = 2;                      // threads: TW columns x TY rows
constexpr int THREADS = TW * TY;
constexpr int CPR = TW / 4;                // 16-byte chunks of a tile row
constexpr int X0 = 4;                      // smem column of the tile's x0
constexpr int RS = TW + 8;                 // smem row stride: [3][halo][TW][halo][3]
constexpr int NT = 2;                      // transactions in the ring
constexpr size_t MAX_SMEM = 227 * 1024;

// Shared memory of a block with TH-row tiles: NT transactions of M staged
// planes and the slot of the plane the next beat updates.
size_t smem_bytes(int th, int pump) {
  return (size_t)(NT * pump + 1) * (th + 2) * RS * sizeof(float);
}

// The tile's rows: the most of 32, 16 and 8 whose ring fits; 0 if none.
int tile_rows(int pump) {
  for (int th = 32; th >= 8; th /= 2)
    if (smem_bytes(th, pump) <= MAX_SMEM) return th;
  return 0;
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Stage plane `src_plane` of the tile at (x0, y0), rows y0-1 .. y0+TH and
// columns x0-1 .. x0+TW, into `slot`; cells outside the volume are zero
// (only boundary cells, which copy their centre, sit next to them).
template <int TH>
__device__ __forceinline__ void stage(float* slot, const float* src_plane,
                                      int x0, int y0, int d1, int d2,
                                      bool vec, int tid) {
  if (vec) {
    for (int i = tid; i < (TH + 2) * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * 4, gy = y0 - 1 + r;
      const bool ok = gy >= 0 && gy < d1;
      cp16(slot + r * RS + X0 + c,
           ok ? src_plane + (long long)gy * d2 + x0 + c : src_plane, ok);
    }
    for (int i = tid; i < (TH + 2) * 2; i += THREADS) {
      const int r = i >> 1, side = i & 1, gy = y0 - 1 + r;
      const int gx = side ? x0 + TW : x0 - 1;
      const bool ok = gy >= 0 && gy < d1 && gx >= 0 && gx < d2;
      cp4(slot + r * RS + (side ? X0 + TW : X0 - 1),
          ok ? src_plane + (long long)gy * d2 + gx : src_plane, ok);
    }
  } else {
    const int tx = threadIdx.x, ty = threadIdx.y;
    for (int r = ty; r < TH + 2; r += TY) {
      const int gy = y0 - 1 + r;
      for (int c = tx; c < TW + 2; c += TW) {
        const int gx = x0 - 1 + c;
        const bool ok = gy >= 0 && gy < d1 && gx >= 0 && gx < d2;
        cp4(slot + r * RS + X0 - 1 + c,
            ok ? src_plane + (long long)gy * d2 + gx : src_plane, ok);
      }
    }
  }
}

template <int TH>
__global__ void __launch_bounds__(THREADS)
    stencil_kernel(const float* __restrict__ src, float* __restrict__ dst,
                   int d0, int d1, int d2, int pump, int seg, int diffusion,
                   float coef, float inv7) {
  constexpr int RPT = TH / TY;               // rows of the tile per thread
  constexpr int PLANE = (TH + 2) * RS;       // floats of one staged plane
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int nslots = NT * pump + 1;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TW + tx;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int s0 = 1 + blockIdx.z * seg;               // first output plane
  const int len = min(seg, d0 - 1 - s0);             // a multiple of pump
  const int ntx = len / pump;
  const long long plane = (long long)d1 * d2;
  const bool vec = (d2 & 3) == 0 && x0 + TW <= d2 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int gx = x0 + tx;

  // the centre column of plane s0 - 1, straight into registers; the first
  // segment copies it as boundary plane 0
  float prev[RPT], cur[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int gy = y0 + ty + r * TY;
    const bool in = gy < d1 && gx < d2;
    prev[r] = in ? src[(s0 - 1) * plane + (long long)gy * d2 + gx] : 0.f;
    if (in && blockIdx.z == 0) dst[(long long)gy * d2 + gx] = prev[r];
  }

  // staged plane q (q = 0 is plane s0) sits in slot q % nslots;
  // transaction x stages planes q = 1 + x * pump .. (x + 1) * pump, the
  // planes after each output plane of its beats.  Group 0 also stages q = 0.
  auto slot_of = [&](int q) { return ring + (q % nslots) * PLANE; };
  auto stage_tx = [&](int x) {
    for (int m = 1; m <= pump; ++m) {
      const int q = x * pump + m;
      stage<TH>(slot_of(q), src + (s0 + q) * plane, x0, y0, d1, d2, vec, tid);
    }
  };
  stage<TH>(slot_of(0), src + s0 * plane, x0, y0, d1, d2, vec, tid);
  stage_tx(0);
  commit();
#pragma unroll
  for (int x = 1; x < NT; ++x) {
    if (x < ntx) stage_tx(x);
    commit();
  }

  for (int x = 0; x < ntx; ++x) {
    // groups 0..x have landed; x + 1 .. x + NT - 1 may still be in flight
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NT - 1));
    __syncthreads();
    if (x == 0) {
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        cur[r] = slot_of(0)[(ty + r * TY + 1) * RS + X0 + tx];
    }
    for (int m = 0; m < pump; ++m) {   // the dependent beats
      const int q = x * pump + m, p = s0 + q;
      const float* cs = slot_of(q);
      const float* ns = slot_of(q + 1);
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int y = ty + r * TY + 1, gy = y0 + y - 1;
        const int at = y * RS + X0 + tx;
        const float nxt = ns[at], c = cur[r];
        if (gy < d1 && gx < d2) {
          float out = c;
          if (gy > 0 && gy < d1 - 1 && gx > 0 && gx < d2 - 1) {
            float s = __fadd_rn(prev[r], nxt);
            s = __fadd_rn(s, cs[at - RS]);
            s = __fadd_rn(s, cs[at + RS]);
            s = __fadd_rn(s, cs[at - 1]);
            s = __fadd_rn(s, cs[at + 1]);
            out = diffusion
                      ? __fadd_rn(c, __fmul_rn(coef, __fsub_rn(s, __fmul_rn(6.f, c))))
                      : __fmul_rn(__fadd_rn(s, c), inv7);
          }
          dst[p * plane + (long long)gy * d2 + gx] = out;
        }
        prev[r] = c;
        cur[r] = nxt;
      }
    }
    __syncthreads();   // every beat of x done: its slots may be restaged
    if (x + NT < ntx) stage_tx(x + NT);
    commit();
  }

  // cur now holds plane s0 + len; the last segment copies it as d0 - 1
  if (s0 + len == d0 - 1) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int gy = y0 + ty + r * TY;
      if (gy < d1 && gx < d2) dst[(d0 - 1) * plane + (long long)gy * d2 + gx] = cur[r];
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

template <int TH>
cudaError_t run(const float* src, float* dst, int d0, int d1, int d2, int pump,
                int seg, int diffusion, float coef, float inv7, cudaStream_t stream,
                int* blocks_per_sm) {
  const size_t smem = smem_bytes(TH, pump);
  cudaError_t e = cudaFuncSetAttribute(stencil_kernel<TH>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (blocks_per_sm)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, stencil_kernel<TH>,
                                                         THREADS, smem);
  dim3 grid((d2 + TW - 1) / TW, (d1 + TH - 1) / TH, (d0 - 2 + seg - 1) / seg);
  stencil_kernel<TH><<<grid, dim3(TW, TY), smem, stream>>>(src, dst, d0, d1, d2, pump, seg,
                                                           diffusion, coef, inv7);
  return cudaGetLastError();
}

cudaError_t by_rows(const float* src, float* dst, int d0, int d1, int d2, int pump, int seg,
                    int diffusion, float coef, float inv7, cudaStream_t stream,
                    int* blocks_per_sm) {
  switch (tile_rows(pump)) {
    case 32: return run<32>(src, dst, d0, d1, d2, pump, seg, diffusion, coef, inv7, stream,
                            blocks_per_sm);
    case 16: return run<16>(src, dst, d0, d1, d2, pump, seg, diffusion, coef, inv7, stream,
                            blocks_per_sm);
    case 8: return run<8>(src, dst, d0, d1, d2, pump, seg, diffusion, coef, inv7, stream,
                          blocks_per_sm);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Blocks of M = pump that one SM holds at once, as the runtime computes it
// from the kernel's registers, threads and shared memory; the wrapper plans
// its segments from it.  Returns a cudaError_t.
extern "C" int stencil_blocks_per_sm(int pump, int* out) {
  if (pump < 1) return (int)cudaErrorInvalidValue;
  return (int)by_rows(nullptr, nullptr, 0, 0, 0, pump, 0, 0, 0.f, 0.f, nullptr, out);
}

// One stage over a contiguous fp32 (d0, d1, d2) volume, src -> dst (not in
// place), in segments of `seg` interior planes (a multiple of pump), with
// tiles of tile_rows(pump) rows.  (d0 - 2) % pump == 0 and d0 > 2.  coef
// and inv7 are the fp32 constants of the plain version.  Returns the
// launch's cudaError_t.
extern "C" int stencil_fwd(const float* src, float* dst, int d0, int d1,
                           int d2, int pump, int seg, int diffusion,
                           float coef, float inv7, void* stream) {
  if (pump < 1 || seg < pump || seg % pump || (d0 - 2) % pump)
    return (int)cudaErrorInvalidValue;
  return (int)by_rows(src, dst, d0, d1, d2, pump, seg, diffusion, coef, inv7,
                      static_cast<cudaStream_t>(stream), nullptr);
}
