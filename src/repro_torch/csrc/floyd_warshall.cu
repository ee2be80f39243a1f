// Pumped Floyd-Warshall all-pairs shortest paths for Hopper, sm_90a (paper
// Table 6).
//
// Replaces src/repro/kernels/floyd_warshall.py::floyd_warshall_pallas
// (pl.pallas_call at :63; body _fw_kernel :32).  There the whole (n, n)
// matrix stays in VMEM across a sequential grid of n / M steps, and step i
// relaxes d <- min(d, d[:, k] + d[k, :]) for its M pivots k = i M .. i M +
// M - 1, one after another.
//
// What bounds it on this card: operations.  n^3 adds and n^3 mins at 33.5
// Top/s (fp32, one op per instruction) take 4.1 ms at n = 4096, against
// 2 n^2 * 4 bytes once (0.04 ms).  The matrix (64 MB at n = 4096) does not
// fit in shared memory or L2, so a kernel that relaxes the whole matrix once
// per pivot, or once per slab of M pivots, moves 2 n^2 * 4 bytes that often
// and is bound by bytes instead (n / M passes of 128 MB at n = 4096).  Here
// the pivots go in rounds of ROUND = 64, and each round reads and writes
// every element of d once: 64 rounds of 128 MB at n = 4096, about 2.4 ms of
// bytes under 4.1 ms of min / add issue.  Two launches a round:
//   fw_panels (phases 1-2): the round's pivot strips, 64 x n each, walked
//     through the round's 64 steps in registers, SPLIT threads a strip;
//     every block first walks the 64 x 64 diagonal tile (one barrier a
//     step), whose records the strips need.  A serial chain of 2 x 64
//     steps, so its time is latency, about the same at n = 500 as at 4096.
//   fw_update (phase 3): the min-plus product of the recorded panels into
//     every 128 x 128 tile, 8 x 8 elements a thread in registers.  It is
//     bound by its instruction issue: each element-pivot is one __fadd_rn
//     and one min, and the tile's loads and stores hide under them.
// PERF.md has the measured split.
//
// Why it stays bit-exact.  Sequential step k sets
//     d[i][j] <- min(d[i][j], D_{k-1}[i][k] + D_{k-1}[k][j]),
// so within a round the candidates element (i, j) sees depend only on
//     R[k][j] = pivot row k as it stands before step k, and
//     C[i][k] = entry (i, k) as it stands before step k.
// Phases 1-2 record exactly these for the round's pivots K; phase 3 then
// folds min(d, C[i][k] + R[k][j]) over k in K, in k order, into every
// element, which is the same min of the same __fadd_rn sum in the same
// order as the sequential plain version computes: the result is bit-exact,
// with inf, negative weights and NaN (the min propagates NaN, as
// torch.minimum does, as a canonical NaN).  The textbook blocked schedule
// instead reads the panels as they stand after the whole round, which is
// the same shortest path summed in another order, and differs in the last
// bits (tests/test_torch_fw_blocked.py pins an input where it does).
//
// The pump keeps the paper's meaning in phase 3: one staged transaction of
// the C / R chunks carries M pivots (M pivot columns of C, M pivot rows of
// R), and the program applies them as M dependent beats in k order.  So M
// sets how many barriers and copy groups a round costs a tile (64 / M), not
// how many passes over the matrix.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROUND = 64;      // pivots a round: a multiple of every pump
constexpr int TILE = 128;      // the update's tile; scratch rows pad to it
constexpr int UTHREADS = 256;  // the update: 16 x 16 threads, 8 x 8 each
constexpr int PTHREADS = 512;  // the panels kernel
constexpr int SPLIT = 8;       // panels: threads a strip, and a column
constexpr int PART = ROUND / SPLIT;      // entries of a strip a thread
constexpr int STRIPS = PTHREADS / SPLIT;  // strips a panels block
static_assert(PTHREADS == ROUND * SPLIT, "phase 1: SPLIT threads a column");
static_assert(TILE % STRIPS == 0, "panel blocks tile the padded rows");

// torch.minimum's min: NaN if either input is NaN, else the smaller.
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Phases 1-2 of the round of kb pivots k0 .. k0 + kb - 1 (K below): R
// (kb x n, rbuf[k][j]) and C (n x kb, stored transposed, cbuf[k][i]), rows
// of ld floats; padded entries (j or i in [n, ld)) are written too.  d is
// only read.  Blocks [0, ld / STRIPS) record R for STRIPS columns each, the
// rest C for STRIPS rows each.
__global__ void __launch_bounds__(PTHREADS)
    fw_panels(const float* __restrict__ d, float* __restrict__ rbuf,
              float* __restrict__ cbuf, int n, int ld, int k0, int kb) {
  __shared__ float rkk[ROUND * ROUND];      // [k][j]: R[k][k0 + j]
  __shared__ float ckk[ROUND * ROUND];      // [k][i]: C[k0 + i][k]
  const int tid = threadIdx.x;

  // The strip this thread walks in phase 2, loaded first so that its
  // latency hides under phase 1: column x of the round's pivot rows (the
  // first ld / STRIPS blocks) or row x of its pivot columns (the rest).
  // SPLIT neighbouring lanes share a strip, PART entries each.
  const int blocks = ld / STRIPS;
  const bool row_panel = blockIdx.x < blocks;
  const int q = tid % SPLIT;
  const int x = (row_panel ? blockIdx.x : blockIdx.x - blocks) * STRIPS
                + tid / SPLIT;
  float v[PART];
#pragma unroll
  for (int a = 0; a < PART; ++a) {
    const int r = q * PART + a;
    v[a] = (r >= kb || x >= n) ? 0.f
           : row_panel ? d[(long long)(k0 + r) * n + x]
                       : d[(long long)x * n + k0 + r];
  }

  // Phase 1, in every block (it is small, and saves a launch): walk the
  // diagonal tile d[K][K] through the round's steps in order, recording
  // its pivot row before each step (rkk) and its pivot column before each
  // step (ckk).  Thread (j, h) holds rows h * PART .. h * PART + PART - 1
  // of column j in registers; after step k the threads holding row k + 1
  // and column k + 1 record them for step k + 1, so one barrier a step
  // suffices.
  {
    const int j = tid % ROUND, h = tid / ROUND;
    float tc[PART];
#pragma unroll
    for (int a = 0; a < PART; ++a) {
      const int i = h * PART + a;
      tc[a] = (i < kb && j < kb) ? d[(long long)(k0 + i) * n + k0 + j] : 0.f;
      if (j == 0) ckk[i] = tc[a];
    }
    if (h == 0) rkk[j] = tc[0];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ROUND; ++k) {
      if (k >= kb) break;
      const float rk = rkk[k * ROUND + j];
#pragma unroll
      for (int a = 0; a < PART; ++a)
        tc[a] = min_nan(tc[a], __fadd_rn(ckk[k * ROUND + h * PART + a], rk));
      if (k + 1 < ROUND) {
        if (h == (k + 1) / PART) rkk[(k + 1) * ROUND + j] = tc[(k + 1) % PART];
        if (j == k + 1) {
#pragma unroll
          for (int a = 0; a < PART; ++a)
            ckk[(k + 1) * ROUND + h * PART + a] = tc[a];
        }
      }
      __syncthreads();
    }
  }

  // Phase 2: the SPLIT threads of a strip walk it through the round's
  // steps.  At step k the holder of entry k hands it to the others (a
  // shuffle): it is the record, R[k][x] or C[x][k], as it stands before
  // step k.  Then every entry takes step k.  Entries before k take it too:
  // their records are written and they are read no more, so this keeps
  // the strip's threads in step without changing a record.
  const int first = (tid % 32) & ~(SPLIT - 1);  // the strip's first lane
  if (row_panel) {
    // row r takes min(d[r][x], C[r][k] + R[k][x]), C[r][k] from phase 1
#pragma unroll
    for (int k = 0; k < ROUND; ++k) {
      if (k >= kb) break;
      const float rk = __shfl_sync(0xffffffffu, v[k % PART], first + k / PART);
      if (q == 0) rbuf[(long long)k * ld + x] = rk;
#pragma unroll
      for (int a = 0; a < PART; ++a)
        v[a] = min_nan(v[a], __fadd_rn(ckk[k * ROUND + q * PART + a], rk));
    }
  } else {
    // entry (x, c) takes min(d[x][c], C[x][k] + R[k][c]), R[k][c] from
    // phase 1
#pragma unroll
    for (int k = 0; k < ROUND; ++k) {
      if (k >= kb) break;
      const float ck = __shfl_sync(0xffffffffu, v[k % PART], first + k / PART);
      if (q == 0) cbuf[(long long)k * ld + x] = ck;
#pragma unroll
      for (int a = 0; a < PART; ++a)
        v[a] = min_nan(v[a], __fadd_rn(ck, rkk[k * ROUND + q * PART + a]));
    }
  }
}

// The update's ring: STAGES transactions of PUMP pivots, at most 32 KB.
template <int PUMP>
__host__ __device__ constexpr int stages() {
  return PUMP >= 16 ? 2 : 4;
}

template <int PUMP>
__host__ __device__ constexpr int update_smem() {
  return stages<PUMP>() * PUMP * 2 * TILE * (int)sizeof(float);
}

// Phase 3: dst[I][J] = the fold of min(d, C[i][k] + R[k][j]) over the
// round's kb pivots, in k order, for one TILE x TILE tile of src a block
// (src may be dst: a block reads and writes only its own tile).  A thread
// holds 8 x 8 elements in registers: rows ty*4 + {0..3} and 64 + ty*4 +
// {0..3}, columns tx*4 + {0..3} and 64 + tx*4 + {0..3}.  The C and R chunks
// come through a ring of STAGES transactions of PUMP pivots each (PUMP
// rows of cbuf, which holds C transposed, and PUMP rows of rbuf, TILE
// floats each), by cp.async, one barrier a transaction; the program
// applies a transaction's pivots as PUMP dependent beats in k order.  vec:
// n % 4 == 0 and src 16-byte aligned, so d moves in float4s.
template <int PUMP>
__global__ void __launch_bounds__(UTHREADS, 2)
    fw_update(const float* src, float* dst, const float* __restrict__ rbuf,
              const float* __restrict__ cbuf, int n, int ld, int kb,
              int vec) {
  constexpr int STAGES = stages<PUMP>();
  constexpr int SLOT = PUMP * 2 * TILE;
  extern __shared__ __align__(16) float ring[];  // [STAGES][PUMP][C, R][TILE]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  const int ntx = kb / PUMP;

  auto stage = [&](int t) {
    float* slot = ring + (t % STAGES) * SLOT;
    for (int f = tid; f < SLOT / 4; f += UTHREADS) {
      const int p = f / (TILE / 2), rest = f % (TILE / 2);
      const int which = rest / (TILE / 4), c = rest % (TILE / 4);
      const float* g = (which ? rbuf + j0 : cbuf + i0)
                       + (long long)(t * PUMP + p) * ld + c * 4;
      cp_async16(slot + p * 2 * TILE + which * TILE + c * 4, g);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntx) stage(s);
    cp_async_commit();
  }

  float v[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = i0 + (a < 4 ? ty * 4 + a : 64 + ty * 4 + a - 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + h * 64 + tx * 4;
      const float* s = src + (long long)i * n + j;
      if (vec) {
        const float4 q = (i < n && j < n)
                             ? *reinterpret_cast<const float4*>(s)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        v[a][h * 4 + 0] = q.x;
        v[a][h * 4 + 1] = q.y;
        v[a][h * 4 + 2] = q.z;
        v[a][h * 4 + 3] = q.w;
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          v[a][h * 4 + b] = (i < n && j + b < n) ? s[b] : 0.f;
      }
    }
  }

  for (int t = 0; t < ntx; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // transaction t landed; slot (t - 1) % STAGES is free
    if (t + STAGES - 1 < ntx) stage(t + STAGES - 1);
    cp_async_commit();
    const float* slot = ring + (t % STAGES) * SLOT;
#pragma unroll
    for (int p = 0; p < PUMP; ++p) {  // the M beats, in k order
      const float* cs = slot + p * 2 * TILE;
      const float* rs = cs + TILE;
      const float4 c0 = *reinterpret_cast<const float4*>(cs + ty * 4);
      const float4 c1 = *reinterpret_cast<const float4*>(cs + 64 + ty * 4);
      const float4 r0 = *reinterpret_cast<const float4*>(rs + tx * 4);
      const float4 r1 = *reinterpret_cast<const float4*>(rs + 64 + tx * 4);
      const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      const float r[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b)
          v[a][b] = min_nan(v[a][b], __fadd_rn(c[a], r[b]));
    }
  }

#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = i0 + (a < 4 ? ty * 4 + a : 64 + ty * 4 + a - 4);
    if (i >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j0 + h * 64 + tx * 4;
      float* o = dst + (long long)i * n + j;
      if (vec) {
        if (j < n)
          *reinterpret_cast<float4*>(o) =
              make_float4(v[a][h * 4], v[a][h * 4 + 1], v[a][h * 4 + 2],
                          v[a][h * 4 + 3]);
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (j + b < n) o[b] = v[a][h * 4 + b];
      }
    }
  }
}

template <int PUMP>
int run(const float* dist, float* out, float* rbuf, float* cbuf, int n,
        cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fw_update<PUMP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      update_smem<PUMP>());
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n + TILE - 1) / TILE, ld = tiles * TILE;
  const int vec0 = n % 4 == 0 && reinterpret_cast<uintptr_t>(dist) % 16 == 0;
  for (int k0 = 0; k0 < n; k0 += ROUND) {
    const int kb = n - k0 < ROUND ? n - k0 : ROUND;
    const float* src = k0 == 0 ? dist : out;
    fw_panels<<<2 * ld / STRIPS, PTHREADS, 0, stream>>>(src, rbuf, cbuf, n,
                                                        ld, k0, kb);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    fw_update<PUMP><<<dim3(tiles, tiles), UTHREADS, update_smem<PUMP>(),
                      stream>>>(src, out, rbuf, cbuf, n, ld, kb,
                                k0 == 0 ? vec0 : n % 4 == 0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// All pairs over a contiguous fp32 (n, n) matrix dist, written to out (n x
// n, 16-byte aligned; dist is not written).  rbuf and cbuf: scratch of 64 x
// ld floats each, ld = n rounded up to 128, 16-byte aligned.  Two launches
// a round of 64 pivots: 2 * ceil(n / 64).  pump in {1, 2, 4, 8, 16}, n %
// pump == 0, n > 0.  Returns the first failed launch's cudaError_t, else 0.
extern "C" int floyd_warshall_fwd(const float* dist, float* out, float* rbuf,
                                  float* cbuf, int n, int pump, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pump) {
    case 1: return run<1>(dist, out, rbuf, cbuf, n, s);
    case 2: return run<2>(dist, out, rbuf, cbuf, n, s);
    case 4: return run<4>(dist, out, rbuf, cbuf, n, s);
    case 8: return run<8>(dist, out, rbuf, cbuf, n, s);
    case 16: return run<16>(dist, out, rbuf, cbuf, n, s);
  }
  return (int)cudaErrorInvalidValue;
}
