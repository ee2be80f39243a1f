// Pumped vector addition z = x + y for Hopper, sm_90a (paper Table 2).
//
// Replaces src/repro/kernels/vecadd.py::vecadd_pallas (pl.pallas_call at
// :64; body _vecadd_kernel :27).  There one grid step is one wide HBM->VMEM
// transaction of V*M elements (mode T) or V elements (mode R), and an
// in-kernel loop issues it to the adder in M beats of V (T) or V/M (R) lanes.
//
// Here a thread's transaction is W contiguous elements (W = V*M in mode T,
// V in mode R), loaded and stored with the widest vector accesses W allows
// (16 bytes at most per access), and issued to the adds as M beats of L
// lanes (L = V in mode T, V/M in mode R).  Threads walk the transactions in
// a grid-stride loop; the ragged tail past the last whole transaction is
// masked here, one element per thread, where the reference pads.
//
// What bounds it on this card: bytes.  Each element of x and y is read once
// and each of z written once for one add, so the bound is 3 * n * itemsize
// over 3.35 TB/s; the pump changes how many bytes one thread moves per
// transaction, not how many the kernel moves.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

// One transaction of W elements in M = W / L beats of L lanes.
template <typename T, int W, int L>
__global__ void __launch_bounds__(THREADS)
    vecadd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  T* __restrict__ z, long long n) {
  constexpr int BYTES = W * sizeof(T);
  constexpr int ACCESS = BYTES < 16 ? BYTES : 16;  // bytes per vector access
  constexpr int ACCESSES = BYTES / ACCESS;
  using V = typename Word<ACCESS>::type;
  const long long ntx = n / W;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x; t < ntx;
       t += stride) {
    V xa[ACCESSES], ya[ACCESSES], za[ACCESSES];
    const V* xv = reinterpret_cast<const V*>(x + t * W);
    const V* yv = reinterpret_cast<const V*>(y + t * W);
#pragma unroll
    for (int a = 0; a < ACCESSES; ++a) {
      xa[a] = __ldcs(xv + a);
      ya[a] = __ldcs(yv + a);
    }
    const T* xe = reinterpret_cast<const T*>(xa);
    const T* ye = reinterpret_cast<const T*>(ya);
    T* ze = reinterpret_cast<T*>(za);
#pragma unroll
    for (int beat = 0; beat < W / L; ++beat) {
#pragma unroll
      for (int lane = 0; lane < L; ++lane) {
        const int e = beat * L + lane;
        ze[e] = from_f<T>(__fadd_rn(to_f(xe[e]), to_f(ye[e])));
      }
    }
    V* zv = reinterpret_cast<V*>(z + t * W);
#pragma unroll
    for (int a = 0; a < ACCESSES; ++a) __stcs(zv + a, za[a]);
  }
  // the ragged tail, n % W elements, masked one per thread
  const long long tail0 = ntx * W;
  for (long long i = tail0 + (long long)blockIdx.x * THREADS + threadIdx.x;
       i < n; i += stride)
    z[i] = from_f<T>(__fadd_rn(to_f(x[i]), to_f(y[i])));
}

template <typename T, int W, int L>
int launch(const void* x, const void* y, void* z, long long n, int blocks,
           cudaStream_t stream) {
  vecadd_kernel<T, W, L><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(z),
      n);
  return (int)cudaGetLastError();
}

template <typename T, int W>
int by_lanes(int lanes, const void* x, const void* y, void* z, long long n,
             int blocks, cudaStream_t s) {
  switch (lanes) {
    case 1: return launch<T, W, 1>(x, y, z, n, blocks, s);
    case 2: if constexpr (W >= 2) return launch<T, W, 2>(x, y, z, n, blocks, s); break;
    case 4: if constexpr (W >= 4) return launch<T, W, 4>(x, y, z, n, blocks, s); break;
    case 8: if constexpr (W >= 8) return launch<T, W, 8>(x, y, z, n, blocks, s); break;
    case 16: if constexpr (W >= 16) return launch<T, W, 16>(x, y, z, n, blocks, s); break;
    case 32: if constexpr (W >= 32) return launch<T, W, 32>(x, y, z, n, blocks, s); break;
    case 64: if constexpr (W >= 64) return launch<T, W, 64>(x, y, z, n, blocks, s); break;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int by_width(int width, int lanes, const void* x, const void* y, void* z,
             long long n, int blocks, cudaStream_t s) {
  switch (width) {
    case 1: return by_lanes<T, 1>(lanes, x, y, z, n, blocks, s);
    case 2: return by_lanes<T, 2>(lanes, x, y, z, n, blocks, s);
    case 4: return by_lanes<T, 4>(lanes, x, y, z, n, blocks, s);
    case 8: return by_lanes<T, 8>(lanes, x, y, z, n, blocks, s);
    case 16: return by_lanes<T, 16>(lanes, x, y, z, n, blocks, s);
    case 32: return by_lanes<T, 32>(lanes, x, y, z, n, blocks, s);
    case 64: return by_lanes<T, 64>(lanes, x, y, z, n, blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, y, z: n contiguous elements, aligned to the transaction's bytes (at
// most 16).  dtype 0 = fp32, 1 = bf16.  width = W and lanes = L, powers of
// two, L <= W <= 64.  Returns the launch's cudaError_t.
extern "C" int vecadd_fwd(const void* x, const void* y, void* z, long long n,
                          int dtype, int width, int lanes, int blocks,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  return dtype ? by_width<__nv_bfloat16>(width, lanes, x, y, z, n, blocks, s)
               : by_width<float>(width, lanes, x, y, z, n, blocks, s);
}
