// The fused-region map/reduce kernel of the temporal-vectorization compiler,
// for Hopper, sm_90a.
//
// Replaces the single-output map/reduce kernel that
// src/repro/compiler/pallas_backend.py::emit_pallas writes for any region
// plan it accepts (pl.pallas_call at :847, body :826-843): over the plan's
// grid,
//   out[block(g_map)] = sum over the reduce grid points of
//                       tile_op(in0[block0(g)], in1[block1(g)])
// with tile_op `add` (elementwise) or `dot` (a block product over the last
// two block dims).  There the grid runs in order on one core and the output
// block accumulates in VMEM across the reduce steps (`o_ref[...] += tile`,
// rounded per step).  Here the map points run in parallel, the reduce
// points run inside a thread (add) or a block (dot) in the plan's order,
// innermost last, into an fp32 accumulator zeroed on the first visit, and
// the output is rounded once to its dtype.
//
// The plan comes in as a descriptor (kernels/region_map_reduce.py): grid
// extents, reduce flags and the `_pump` axis; per operand and output the
// block's rows x cols, its row and column strides, and its element offset
// as a constant plus a coefficient per grid axis plus group-table lookups
// (the ragged grouped GEMM's row and expert tables, one packed device
// buffer).  No shape is baked into the kernel.
//
// The pump (ROADMAP.md's north star on Hopper).  The `_pump` axis is
//  - a beat axis when it reduces (mode T over a reduction, as matmul's K):
//    one transaction stages the same K-slice of the M consecutive blocks
//    with cp.async (when a block's K fits one slice, the stage is the panel
//    M blocks wide), then M dependent beats accumulate over it;
//  - a sub-tile axis when it maps (mode R, or mode T over a map axis): the
//    left panel keeps its width and is staged once, and one block walks the
//    M narrowed output sub-tiles in turn (dot); one thread walks them in
//    turn (add).
// Any M the plan gives is taken: the K-slice narrows until two stages fit.
//
// What bounds it on this card.  `add` is bytes: each element is read once
// from each operand and written once for one add.  It assigns one map
// point (with its sub-tiles) to a thread, never to a CUDA block: vecadd at
// V 8 has 2^25 points of 8 elements, with 16-byte accesses where the
// descriptor proves them aligned.  `dot` at the matmul and grouped-GEMM
// shapes is operations on fp32 CUDA cores (no wgmma or TMA here): one
// CUDA block of up to 256 threads (16 columns x up to 16 rows, fewer rows
// for a short tile so a thread keeps four rows or more) owns one output
// tile of at most 128 x 128, each thread an RM x RN register tile, and the
// operand slices are double-buffered in shared memory by cp.async, the next
// slice's copy in flight while the current one is multiplied; the left
// slice's rows are padded by 16 bytes against bank conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int MAXG = 8, MAXT = 4, THREADS = 256, SIDE = 16;

struct Opnd {
  int rows, cols, rs, cs, base;
  int coef[MAXG];
  int ntab;
  int tsym[MAXT];
  int toff[MAXT];
};

struct Desc {
  int op, dtype, ndim, pump, kc;
  int gran[3];  // add: [0] = 4 for 4-element vector accesses; dot: cp.async
                // bytes for the left [0] and right [1] slices (16, 4, 0 =
                // plain loads)
  int ext[MAXG];
  int red[MAXG];
  Opnd o[3];    // in0, in1, out
};
static_assert(sizeof(Desc) == (24 + 3 * 22) * 4, "descriptor layout");

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

// Element offset of operand o's block at grid coordinates g.
__device__ __forceinline__ long long offset_of(const Opnd& o, const int* g,
                                               const int* tables, int ndim) {
  long long off = o.base;
#pragma unroll
  for (int s = 0; s < MAXG; ++s)
    if (s < ndim) off += (long long)o.coef[s] * g[s];
  for (int t = 0; t < o.ntab; ++t) off += tables[o.toff[t] + g[o.tsym[t]]];
  return off;
}

// ------------------------------------------------------------------ add --
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };

template <typename T>
__global__ void __launch_bounds__(THREADS)
    region_add(const __grid_constant__ Desc d, const T* __restrict__ in0,
               const T* __restrict__ in1, T* __restrict__ out,
               const int* __restrict__ tables, long long units) {
  using V = typename Vec4<T>::type;
  const Opnd& oa = d.o[0];
  const Opnd& ob = d.o[1];
  const Opnd& oo = d.o[2];
  const int pm = (d.pump >= 0 && !d.red[d.pump]) ? d.pump : -1;
  const int P = pm >= 0 ? d.ext[pm] : 1;
  int R = 1;  // reduce points (< 2^31, checked on the host)
  for (int s = 0; s < d.ndim; ++s)
    if (d.red[s]) R *= d.ext[s];
  const int nel = oo.rows * oo.cols;
  const bool vec = d.gran[0] == 4;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long u = (long long)blockIdx.x * THREADS + threadIdx.x; u < units;
       u += stride) {
    int g[MAXG];
    unsigned rem = (unsigned)u;  // units < 2^31: 32-bit decode
    for (int s = d.ndim - 1; s >= 0; --s) {
      if (d.red[s] || s == pm) {
        g[s] = 0;
        continue;
      }
      g[s] = (int)(rem % (unsigned)d.ext[s]);
      rem /= (unsigned)d.ext[s];
    }
    for (int p = 0; p < P; ++p) {  // the sub-tiles of this point, in turn
      if (pm >= 0) g[pm] = p;
      const long long o_off = offset_of(oo, g, tables, d.ndim);
      if (vec) {  // rows == 1, unit column strides, 4-element aligned
        for (int e = 0; e < nel; e += 4) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          for (int r = 0; r < R; ++r) {
            unsigned rr = (unsigned)r;
            for (int s = d.ndim - 1; s >= 0; --s)
              if (d.red[s]) {
                g[s] = (int)(rr % (unsigned)d.ext[s]);
                rr /= (unsigned)d.ext[s];
              }
            const V va = __ldg(reinterpret_cast<const V*>(
                in0 + offset_of(oa, g, tables, d.ndim) + e));
            const V vb = __ldg(reinterpret_cast<const V*>(
                in1 + offset_of(ob, g, tables, d.ndim) + e));
            const T* ea = reinterpret_cast<const T*>(&va);
            const T* eb = reinterpret_cast<const T*>(&vb);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[j] = __fadd_rn(acc[j], __fadd_rn(to_f(ea[j]), to_f(eb[j])));
          }
          V vo;
          T* eo = reinterpret_cast<T*>(&vo);
#pragma unroll
          for (int j = 0; j < 4; ++j) eo[j] = from_f<T>(acc[j]);
          __stcs(reinterpret_cast<V*>(out + o_off + e), vo);
        }
      } else {
        for (int e = 0; e < nel; ++e) {
          const int row = oo.rows == 1 ? 0 : e / oo.cols;
          const int col = oo.rows == 1 ? e : e % oo.cols;
          float acc = 0.f;
          for (int r = 0; r < R; ++r) {
            unsigned rr = (unsigned)r;
            for (int s = d.ndim - 1; s >= 0; --s)
              if (d.red[s]) {
                g[s] = (int)(rr % (unsigned)d.ext[s]);
                rr /= (unsigned)d.ext[s];
              }
            const float va = to_f(in0[offset_of(oa, g, tables, d.ndim) +
                                      (long long)row * oa.rs +
                                      (long long)col * oa.cs]);
            const float vb = to_f(in1[offset_of(ob, g, tables, d.ndim) +
                                      (long long)row * ob.rs +
                                      (long long)col * ob.cs]);
            acc = __fadd_rn(acc, __fadd_rn(va, vb));
          }
          out[o_off + (long long)row * oo.rs + (long long)col * oo.cs] =
              from_f<T>(acc);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ dot --
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy a rows x cols slice (global element strides rs, cs) into shared
// memory, row-major with row stride ld, in granules of `gran` bytes (0:
// plain loads).
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, int rows,
                                      int cols, int rs, int cs, int gran) {
  if (gran == 0) {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, c = i % cols;
      dst[r * ld + c] = src[(long long)r * rs + (long long)c * cs];
    }
    return;
  }
  const int per = gran / (int)sizeof(T);  // elements of one granule
  const int chunks = cols / per;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i % chunks) * per;
    const T* s = src + (long long)r * rs + (long long)c * cs;
    if (gran == 16)
      cp_async16(dst + r * ld + c, s);
    else
      cp_async4(dst + r * ld + c, s);
  }
}

__host__ __device__ __forceinline__ int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

template <typename T, int RM, int RN>
__global__ void __launch_bounds__(THREADS)
    region_dot(const __grid_constant__ Desc d, const T* __restrict__ in0,
               const T* __restrict__ in1, T* __restrict__ out,
               const int* __restrict__ tables) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Opnd& oa = d.o[0];
  const Opnd& ob = d.o[1];
  const Opnd& oo = d.o[2];
  const int pm = (d.pump >= 0 && !d.red[d.pump]) ? d.pump : -1;  // sub-tiles
  const int pr = (d.pump >= 0 && d.red[d.pump]) ? d.pump : -1;   // beats
  const int P = pm >= 0 ? d.ext[pm] : 1;
  const int M = pr >= 0 ? d.ext[pr] : 1;
  const int bm = oa.rows, bk = oa.cols, bn = ob.cols, kc = d.kc;
  const int slices = bk / kc;
  int R = 1;  // reduce points besides the beats (< 2^31, host-checked)
  for (int s = 0; s < d.ndim; ++s)
    if (d.red[s] && s != pr) R *= d.ext[s];
  const int steps = R * slices;

  // this block's map point
  int gmap[MAXG];
  unsigned rem = blockIdx.x;
  for (int s = d.ndim - 1; s >= 0; --s) {
    if (d.red[s] || s == pm) {
      gmap[s] = 0;
      continue;
    }
    gmap[s] = (int)(rem % (unsigned)d.ext[s]);
    rem /= (unsigned)d.ext[s];
  }

  // the left slices' rows are padded by 16 bytes, so the two rows a warp
  // reads at one k fall in different banks
  const int lda = kc + 16 / (int)sizeof(T);
  const int a_bytes = round16(M * bm * lda * (int)sizeof(T));
  const int b_bytes = round16(M * P * kc * bn * (int)sizeof(T));
  T* sa[2];
  T* sb[2];
  for (int i = 0; i < 2; ++i) {
    sa[i] = reinterpret_cast<T*>(smem + i * (a_bytes + b_bytes));
    sb[i] = reinterpret_cast<T*>(smem + i * (a_bytes + b_bytes) + a_bytes);
  }

  // stage the K-slice of step `step` of every beat (and sub-tile) into buf
  auto load = [&](int step, int buf) {
    int g[MAXG];
#pragma unroll
    for (int s = 0; s < MAXG; ++s) g[s] = gmap[s];
    const int sl = step % slices;
    unsigned rr = (unsigned)(step / slices);
    for (int s = d.ndim - 1; s >= 0; --s)
      if (d.red[s] && s != pr) {
        g[s] = (int)(rr % (unsigned)d.ext[s]);
        rr /= (unsigned)d.ext[s];
      }
    for (int t = 0; t < M; ++t) {
      if (pr >= 0) g[pr] = t;
      if (pm >= 0) g[pm] = 0;  // the left panel does not move with pm
      const long long ao = offset_of(oa, g, tables, d.ndim) +
                           (long long)sl * kc * oa.cs;
      stage(sa[buf] + t * bm * lda, lda, in0 + ao, bm, kc, oa.rs, oa.cs,
            d.gran[0]);
      for (int m = 0; m < P; ++m) {
        if (pm >= 0) g[pm] = m;
        const long long bo = offset_of(ob, g, tables, d.ndim) +
                             (long long)sl * kc * ob.rs;
        stage(sb[buf] + (t * P + m) * kc * bn, bn, in1 + bo, kc, bn, ob.rs,
              ob.cs, d.gran[1]);
      }
    }
    cp_async_commit();
  };

  // threads: SIDE columns x ny rows of RM x RN register tiles, ny sized to
  // the tile's rows (blockDim.x = SIDE * ny)
  const int tx = threadIdx.x % SIDE, ty = threadIdx.x / SIDE;
  const int ny = blockDim.x / SIDE;
  const int wide = P * bn;
  int bcol[RN];     // this thread's columns in the right slices
  bool bval[RN];
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    const int c = tx + SIDE * j;
    bval[j] = c < wide;
    bcol[j] = bval[j] ? (c / bn) * kc * bn + c % bn : 0;
  }
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  if (steps > 0) load(0, 0);
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) {
      load(step + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int t = 0; t < M; ++t) {  // the M dependent beats
      const T* at = sa[buf] + t * bm * lda;
      const T* bt = sb[buf] + t * P * kc * bn;
      for (int kk = 0; kk < kc; ++kk) {
        float av[RM], bv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int row = ty + ny * i;
          av[i] = row < bm ? to_f(at[row * lda + kk]) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < RN; ++j)
          bv[j] = bval[j] ? to_f(bt[bcol[j] + kk * bn]) : 0.f;
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // write the tile (each sub-tile at its own offset), rounded once
  int g[MAXG];
#pragma unroll
  for (int s = 0; s < MAXG; ++s) g[s] = gmap[s];
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    if (!bval[j]) continue;
    const int c = tx + SIDE * j;
    if (pm >= 0) g[pm] = c / bn;
    const long long base = offset_of(oo, g, tables, d.ndim) +
                           (long long)(c % bn) * oo.cs;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = ty + ny * i;
      if (row < bm) out[base + (long long)row * oo.rs] = from_f<T>(acc[i][j]);
    }
  }
}

int per_thread(int n, int threads) {  // a power of two >= n / threads, <= 8
  int r = 1;
  while (r * threads < n && r < 8) r *= 2;
  return r;
}

template <typename T, int RM, int RN>
cudaError_t launch_dot(const Desc& d, const void* a, const void* b, void* o,
                       const int* tables, long long units, int smem, int ny,
                       cudaStream_t stream) {
  auto k = region_dot<T, RM, RN>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k<<<(unsigned)units, SIDE * ny, smem, stream>>>(
      d, static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(o), tables);
  return cudaGetLastError();
}

template <typename T, int RM>
cudaError_t launch_dot_rn(int rn, const Desc& d, const void* a, const void* b,
                          void* o, const int* tables, long long units, int smem,
                          int ny, cudaStream_t stream) {
  switch (rn) {
    case 1: return launch_dot<T, RM, 1>(d, a, b, o, tables, units, smem, ny, stream);
    case 2: return launch_dot<T, RM, 2>(d, a, b, o, tables, units, smem, ny, stream);
    case 4: return launch_dot<T, RM, 4>(d, a, b, o, tables, units, smem, ny, stream);
    default: return launch_dot<T, RM, 8>(d, a, b, o, tables, units, smem, ny, stream);
  }
}

template <typename T>
cudaError_t launch(const Desc& d, const void* a, const void* b, void* o,
                   const int* tables, cudaStream_t stream) {
  const int pm = (d.pump >= 0 && !d.red[d.pump]) ? d.pump : -1;
  const int pr = (d.pump >= 0 && d.red[d.pump]) ? d.pump : -1;
  long long units = 1;
  for (int s = 0; s < d.ndim; ++s)
    if (!d.red[s] && s != pm) units *= d.ext[s];
  if (units == 0) return cudaSuccess;
  if (d.op == 0) {
    const long long want = (units + THREADS - 1) / THREADS;
    const unsigned blocks = (unsigned)(want < 132 * 64 ? want : 132 * 64);
    region_add<T><<<blocks, THREADS, 0, stream>>>(
        d, static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(o), tables, units);
    return cudaGetLastError();
  }
  const int P = pm >= 0 ? d.ext[pm] : 1;
  const int M = pr >= 0 ? d.ext[pr] : 1;
  const int bm = d.o[0].rows, bn = d.o[1].cols, kc = d.kc;
  if (kc < 1 || d.o[0].cols % kc != 0 || units > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int lda = kc + 16 / (int)sizeof(T);
  const int smem = 2 * (round16(M * bm * lda * (int)sizeof(T)) +
                        round16(M * P * kc * bn * (int)sizeof(T)));
  // rows of threads: 16 for a tile of 64 rows or more, fewer for a short
  // tile, so each thread keeps at least 4 rows (16 x 128: 64 threads of
  // 4 x 8 outputs instead of 256 of 1 x 8)
  int ny = SIDE;
  while (ny > 1 && ny * 4 > bm) ny /= 2;
  const int rm = per_thread(bm, ny), rn = per_thread(P * bn, SIDE);
  if (rm * ny < bm || rn * SIDE < P * bn) return cudaErrorInvalidValue;
  switch (rm) {
    case 1: return launch_dot_rn<T, 1>(rn, d, a, b, o, tables, units, smem, ny, stream);
    case 2: return launch_dot_rn<T, 2>(rn, d, a, b, o, tables, units, smem, ny, stream);
    case 4: return launch_dot_rn<T, 4>(rn, d, a, b, o, tables, units, smem, ny, stream);
    default: return launch_dot_rn<T, 8>(rn, d, a, b, o, tables, units, smem, ny, stream);
  }
}

}  // namespace

// desc: the descriptor's int32 words on the host (layout: struct Desc; see
// kernels/region_map_reduce.py).  in0 / in1 / out: contiguous memories of the
// descriptor's dtype (0 = float32, 1 = bfloat16); tables: the packed group
// tables on the device.  The output's blocks must cover it (the compiler
// only sends plans that do).  Returns the launch's CUDA error code.
extern "C" int region_map_reduce_fwd(const int* desc, const void* in0, const void* in1,
                                     void* out, const int* tables, void* stream) {
  Desc d;
  memcpy(&d, desc, sizeof(Desc));
  if (d.ndim < 1 || d.ndim > MAXG || d.op < 0 || d.op > 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d.dtype == 0) return launch<float>(d, in0, in1, out, tables, s);
  return launch<__nv_bfloat16>(d, in0, in1, out, tables, s);
}
