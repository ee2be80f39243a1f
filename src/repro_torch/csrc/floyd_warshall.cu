// Pumped Floyd-Warshall all-pairs shortest paths for Hopper, sm_90a (paper
// Table 6).
//
// Replaces src/repro/kernels/floyd_warshall.py::floyd_warshall_pallas
// (pl.pallas_call at :63; body _fw_kernel :32).  There the whole (n, n)
// matrix stays in VMEM across a sequential grid of n / M steps, and step i
// relaxes d <- min(d, d[:, k] + d[k, :]) for its M pivots k = i M .. i M +
// M - 1, one after another.
//
// GPU blocks run in no order and the matrix does not fit in a block's 227
// KB of shared memory (64 MB at n = 4096), so here the sequential grid
// becomes a sequence of launches, one per slab of M pivots: n / M launches,
// as many as the reference's transactions.  A launch reads the matrix from
// one buffer and writes it to the other, so no block reads a row another
// block of the same launch has already updated.  Each block:
//   1. copies the M x n pivot panel (rows k0 .. k0 + M - 1) into shared
//      memory: the wide transaction;
//   2. relaxes the panel among its own rows, pivot by pivot, so that panel
//      row m ends as row k0 + m stands before step m (rows past m take step
//      m; row m is left as step m found it);
//   3. for each of its ROWS rows i, walks d[i][k0 .. k0 + M - 1] through the
//      same M steps to get d[i][k] as it stands before each step k;
//   4. streams its rows once, applying the M steps to each element in order.
// Every value is the same min of the same sum, in the same order, as the
// sequential reference computes, so the result is bit-exact.  The min
// propagates NaN as torch.minimum does.
//
// What bounds it on this card: operations.  n^3 adds and n^3 mins at 33.5
// Top/s (fp32, one op per instruction) take 4.1 ms at n = 4096, against
// 2 n^2 * 4 bytes once (0.04 ms).  This kernel instead moves the whole
// matrix through device memory once per slab, 2 n^2 * 4 * n / M bytes, so
// it is bytes-bound at some n / M * 0.04 ms: pumping M halves the passes.
// A blocked Floyd-Warshall that keeps tiles in shared memory across pivots
// would approach the bound; it is a later step.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256, ROWS = 8;

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

template <int PUMP>
__global__ void __launch_bounds__(THREADS)
    fw_slab_kernel(const float* __restrict__ src, float* __restrict__ dst,
                   int n, int k0) {
  extern __shared__ float smem[];
  float* panel = smem;                       // [PUMP][n]
  float* coef = smem + PUMP * n;             // [ROWS][PUMP]: d[i][k] per step
  __shared__ float pcol[PUMP];
  const int tid = threadIdx.x, i0 = blockIdx.x * ROWS;

  for (int e = tid; e < PUMP * n; e += THREADS)
    panel[e] = src[(long long)(k0 + e / n) * n + e % n];
  __syncthreads();

  // panel rows relaxed among themselves: before step m, rows past m take
  // their pivot-column entry; then they take step m
#pragma unroll
  for (int m = 0; m < PUMP - 1; ++m) {
    if (tid > m && tid < PUMP) pcol[tid] = panel[tid * n + k0 + m];
    __syncthreads();
    for (int e = tid; e < (PUMP - 1 - m) * n; e += THREADS) {
      const int r = m + 1 + e / n, j = e % n;
      panel[r * n + j] =
          min_nan(panel[r * n + j], __fadd_rn(pcol[r], panel[m * n + j]));
    }
    __syncthreads();
  }

  // each own row's pivot-column entries through the M steps
  if (tid < ROWS && i0 + tid < n) {
    const float* row = src + (long long)(i0 + tid) * n + k0;
    float c[PUMP];
#pragma unroll
    for (int m = 0; m < PUMP; ++m) c[m] = row[m];
#pragma unroll
    for (int m = 0; m < PUMP; ++m) {
      coef[tid * PUMP + m] = c[m];
#pragma unroll
      for (int q = m + 1; q < PUMP; ++q)
        c[q] = min_nan(c[q], __fadd_rn(c[m], panel[m * n + k0 + q]));
    }
  }
  __syncthreads();

  for (int r = 0; r < ROWS && i0 + r < n; ++r) {
    const long long base = (long long)(i0 + r) * n;
    float a[PUMP];
#pragma unroll
    for (int m = 0; m < PUMP; ++m) a[m] = coef[r * PUMP + m];
#pragma unroll 4
    for (int j = tid; j < n; j += THREADS) {
      float v = src[base + j];
#pragma unroll
      for (int m = 0; m < PUMP; ++m)
        v = min_nan(v, __fadd_rn(a[m], panel[m * n + j]));
      dst[base + j] = v;
    }
  }
}

template <int PUMP>
int run(const float* dist, float* buf0, float* buf1, int n,
        cudaStream_t stream) {
  const int smem = (PUMP * n + ROWS * PUMP) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fw_slab_kernel<PUMP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + ROWS - 1) / ROWS;
  const float* src = dist;
  for (int slab = 0; slab < n / PUMP; ++slab) {
    float* dst = (slab & 1) ? buf1 : buf0;
    fw_slab_kernel<PUMP><<<blocks, THREADS, smem, stream>>>(src, dst, n,
                                                            slab * PUMP);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    src = dst;
  }
  return 0;
}

}  // namespace

// All pairs over a contiguous fp32 (n, n) matrix: n / pump launches, the
// first reading dist, each writing buf0 and buf1 in turn (the result is in
// buf0 if n / pump is odd, else buf1).  pump in {1, 2, 4, 8, 16}, n % pump
// == 0, n > 0.  Returns the first failed launch's cudaError_t, else 0.
extern "C" int floyd_warshall_fwd(const float* dist, float* buf0, float* buf1,
                                  int n, int pump, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pump) {
    case 1: return run<1>(dist, buf0, buf1, n, s);
    case 2: return run<2>(dist, buf0, buf1, n, s);
    case 4: return run<4>(dist, buf0, buf1, n, s);
    case 8: return run<8>(dist, buf0, buf1, n, s);
    case 16: return run<16>(dist, buf0, buf1, n, s);
  }
  return (int)cudaErrorInvalidValue;
}
