// Pumped vector addition z = x + y for Hopper, sm_90a (paper Table 2).
//
// Replaces src/repro/kernels/vecadd.py::vecadd_pallas (pl.pallas_call at
// :64; body _vecadd_kernel :27).  There one grid step is one wide HBM->VMEM
// transaction of V*M elements (mode T) or V elements (mode R), and an
// in-kernel loop issues it to the adder in M beats of V (T) or V/M (R) lanes.
//
// What bounds it on this card: bytes.  Each element of x and y is read once
// and each of z written once for one add, so the bound is 3 * n * itemsize
// over 3.35 TB/s; the pump changes how many elements one lane holds per
// transaction, not how many bytes the kernel moves.  So the design's only
// job is to keep device memory busy with whole 128-byte lines:
//
//   * A transaction of W elements a lane (W = V*M in mode T, V in mode R) is
//     moved by a warp's 32 lanes together as one panel of 32 * W elements.
//     Access a of the panel is one vector of ACCESS bytes a lane (16 at
//     most), lane l taking bytes a * 32 * ACCESS + l * ACCESS, so every
//     access instruction covers 32 * ACCESS contiguous bytes (512 at 16)
//     and no line is split between two instructions.
//   * Each lane then holds W elements in registers and issues them to the
//     adds as M beats of L lanes (L = V in mode T, V/M in mode R), which
//     keeps the meaning of (W, L).  The adds are one __fadd_rn an element
//     (in fp32, then rounded once for bf16), so every output bit is the
//     plain version's.
//   * Loads and stores are plain: the streaming hints (ld.global.cs,
//     st.global.cs) were measured slower here.  A warp loads IN_FLIGHT
//     panels before it adds any of them.
//   * The grid is one pass: each warp takes IN_FLIGHT panels and exits.  A
//     persistent grid (every block the SMs hold, a grid-stride loop) and the
//     earlier two-wave grid were measured slower; see PERF.md.
//   * The ragged tail past the last whole panel is masked, one element a
//     thread, where the reference pads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARP = 32;           // lanes moving one panel
constexpr int MAX_TX_BYTES = 128;  // the widest transaction a lane holds

template <int BYTES> struct Word;
template <> struct Word<2> { using type = uint16_t; };
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// Panels a warp loads before it adds: at least two, and at least 32 bytes
// a lane an operand; one at 128 bytes a lane, which is eight accesses an
// operand already (two such panels spilled registers in bf16).
template <typename T, int W>
__host__ __device__ constexpr int in_flight() {
  constexpr int BYTES = W * (int)sizeof(T);
  return BYTES >= 128 ? 1 : BYTES >= 16 ? 2 : 32 / BYTES;
}

// Panels of 32 lanes x W elements, each lane's W issued in W / L beats of
// L lanes.  Warp g of the grid takes panels g + u * (the grid's warps) for
// u < IN_FLIGHT, which the one-pass grid makes cover every whole panel.
template <typename T, int W, int L>
__global__ void __launch_bounds__(THREADS)
    vecadd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  T* __restrict__ z, long long n) {
  constexpr int BYTES = W * sizeof(T);                // a lane's transaction
  constexpr int ACCESS = BYTES < 16 ? BYTES : 16;     // bytes per access
  constexpr int ACCESSES = BYTES / ACCESS;
  constexpr int PER = ACCESS / sizeof(T);             // elements per access
  constexpr int IN_FLIGHT = in_flight<T, W>();
  using V = typename Word<ACCESS>::type;
  const int lane = threadIdx.x % WARP;
  const long long panel = (long long)WARP * W;        // elements
  const long long npanels = n / panel;
  const long long warps = (long long)gridDim.x * (THREADS / WARP);
  const long long p0 = (long long)blockIdx.x * (THREADS / WARP)
                       + threadIdx.x / WARP;
  V xa[IN_FLIGHT][ACCESSES], ya[IN_FLIGHT][ACCESSES];
#pragma unroll
  for (int u = 0; u < IN_FLIGHT; ++u) {
    const long long p = p0 + u * warps;
    if (p < npanels) {
      const V* xv = reinterpret_cast<const V*>(x + p * panel) + lane;
      const V* yv = reinterpret_cast<const V*>(y + p * panel) + lane;
#pragma unroll
      for (int a = 0; a < ACCESSES; ++a) {
        xa[u][a] = xv[a * WARP];
        ya[u][a] = yv[a * WARP];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < IN_FLIGHT; ++u) {
    const long long p = p0 + u * warps;
    if (p >= npanels) break;
    T* xe = reinterpret_cast<T*>(xa[u]);  // z takes x's registers
    const T* ye = reinterpret_cast<const T*>(ya[u]);
#pragma unroll
    for (int beat = 0; beat < W / L; ++beat) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const int e = beat * L + l;
        xe[e] = from_f<T>(__fadd_rn(to_f(xe[e]), to_f(ye[e])));
      }
    }
    V* zv = reinterpret_cast<V*>(z + p * panel) + lane;
#pragma unroll
    for (int a = 0; a < ACCESSES; ++a) zv[a * WARP] = xa[u][a];
  }
  static_assert(ACCESSES * PER == W, "a lane's accesses hold its W elements");
  // the ragged tail, n % (32 * W) elements, masked one per thread
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = npanels * panel + (long long)blockIdx.x * THREADS
                     + threadIdx.x;
       i < n; i += stride)
    z[i] = from_f<T>(__fadd_rn(to_f(x[i]), to_f(y[i])));
}

// One pass: every warp takes IN_FLIGHT panels once.
template <typename T, int W, int L>
int launch(const void* x, const void* y, void* z, long long n,
           cudaStream_t stream) {
  constexpr long long PER_BLOCK =
      (long long)(THREADS / WARP) * in_flight<T, W>();
  const long long panels = n / ((long long)WARP * W);
  int blocks = (int)((panels + PER_BLOCK - 1) / PER_BLOCK);
  if (blocks == 0) blocks = 1;  // the tail alone
  vecadd_kernel<T, W, L><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(z),
      n);
  return (int)cudaGetLastError();
}

template <typename T, int W>
int by_lanes(int lanes, const void* x, const void* y, void* z, long long n,
             cudaStream_t s) {
  switch (lanes) {
    case 1: return launch<T, W, 1>(x, y, z, n, s);
    case 2: if constexpr (W >= 2) return launch<T, W, 2>(x, y, z, n, s); break;
    case 4: if constexpr (W >= 4) return launch<T, W, 4>(x, y, z, n, s); break;
    case 8: if constexpr (W >= 8) return launch<T, W, 8>(x, y, z, n, s); break;
    case 16: if constexpr (W >= 16) return launch<T, W, 16>(x, y, z, n, s); break;
    case 32: if constexpr (W >= 32) return launch<T, W, 32>(x, y, z, n, s); break;
    case 64: if constexpr (W >= 64) return launch<T, W, 64>(x, y, z, n, s); break;
  }
  return (int)cudaErrorInvalidValue;
}

// Widths of at most MAX_TX_BYTES a lane, as the wrapper allows.
template <typename T>
int by_width(int width, int lanes, const void* x, const void* y, void* z,
             long long n, cudaStream_t s) {
  constexpr int MAX_W = MAX_TX_BYTES / (int)sizeof(T);
  switch (width) {
    case 1: return by_lanes<T, 1>(lanes, x, y, z, n, s);
    case 2: return by_lanes<T, 2>(lanes, x, y, z, n, s);
    case 4: return by_lanes<T, 4>(lanes, x, y, z, n, s);
    case 8: return by_lanes<T, 8>(lanes, x, y, z, n, s);
    case 16: return by_lanes<T, 16>(lanes, x, y, z, n, s);
    case 32: if constexpr (MAX_W >= 32) return by_lanes<T, 32>(lanes, x, y, z, n, s); break;
    case 64: if constexpr (MAX_W >= 64) return by_lanes<T, 64>(lanes, x, y, z, n, s); break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, y, z: n contiguous elements, aligned to the lane's access (at most 16
// bytes).  dtype 0 = fp32, 1 = bf16.  width = W and lanes = L, powers of
// two, L <= W <= 64.  Returns the launch's cudaError_t.
extern "C" int vecadd_fwd(const void* x, const void* y, void* z, long long n,
                          int dtype, int width, int lanes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  return dtype ? by_width<__nv_bfloat16>(width, lanes, x, y, z, n, s)
               : by_width<float>(width, lanes, x, y, z, n, s);
}
