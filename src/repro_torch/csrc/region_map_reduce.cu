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
// shapes is operations.  One CUDA block owns one output tile of at most
// 128 x 128, and the operand slices are double-buffered in shared memory
// by cp.async, the next slice's copy in flight while the current one is
// multiplied; the slices' rows are padded by 16 bytes (the right ones in
// bf16 only) against bank conflicts.  In bf16, a tile whose rows and
// K-slice are multiples of 16 and whose columns are a multiple of 8 runs
// on the tensor cores: one warp per 16 rows and per NI n8 column tiles,
// each a warp tile product of csrc/mma_bf16.cuh (mma.sync.m16n8k16, fp32
// accumulation), over a ring of eight slices where four times the plan's
// two stages fit (seven copies in flight), with each operand's map-point
// offset (group tables included) computed once a block and every reduce
// point's offsets once into shared memory, so a step costs a few adds and
// its copies; the ragged GEMM's 16 x 32 by 32 x 128 blocks become one m16
// row of sixteen n8 tiles over four warps, two k16 steps per slice.
// Every other tile, and every fp32 one, runs fp32 FMAs on the CUDA cores:
// up to 256 threads (16 columns x up to 16 rows, fewer rows for a short
// tile so a thread keeps four rows or more), each an RM x RN register
// tile.  The dispatch is made at launch from the descriptor; nothing falls
// back at run time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "mma_bf16.cuh"

namespace {

constexpr int MAXG = 8, MAXT = 4, THREADS = 256, SIDE = 16;
constexpr int MAX_SMEM = 227 * 1024;

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

// g[s] and g[s] = v for a run-time s, by unrolled selects, so that g stays
// in registers (a run-time index would move the array to local memory).
__device__ __forceinline__ int get_at(const int* g, int s) {
  int v = 0;
#pragma unroll
  for (int i = 0; i < MAXG; ++i)
    if (i == s) v = g[i];
  return v;
}
__device__ __forceinline__ void set_at(int* g, int s, int v) {
#pragma unroll
  for (int i = 0; i < MAXG; ++i)
    if (i == s) g[i] = v;
}

// Decode `index` into the grid coordinates of the axes `pick` selects,
// innermost last (the plan's order).
template <typename Pick>
__device__ __forceinline__ void decode(int* g, unsigned index, const Desc& d,
                                       Pick pick) {
#pragma unroll
  for (int s = MAXG - 1; s >= 0; --s)
    if (s < d.ndim && pick(s)) {
      g[s] = (int)(index % (unsigned)d.ext[s]);
      index /= (unsigned)d.ext[s];
    }
}

// Element offset of operand o's block at grid coordinates g.
__device__ __forceinline__ long long offset_of(const Opnd& o, const int* g,
                                               const int* tables, int ndim) {
  long long off = o.base;
#pragma unroll
  for (int s = 0; s < MAXG; ++s)
    if (s < ndim) off += (long long)o.coef[s] * g[s];
#pragma unroll
  for (int t = 0; t < MAXT; ++t)
    if (t < o.ntab) off += tables[o.toff[t] + get_at(g, o.tsym[t])];
  return off;
}

// The part of offset_of that the walked axes (reduce axes and the sub-tile
// axis pm) contribute (WALKED), or the rest (the block's map point, and
// the constant): their sum is offset_of.  A dot block computes the map part
// once, so a step adds only its walked terms (no table loads for tables of
// map axes, such as the ragged GEMM's row and expert tables).
template <bool WALKED>
__device__ __forceinline__ long long offset_part(const Opnd& o, const int* g,
                                                 const int* tables,
                                                 const Desc& d, int pm) {
  long long off = WALKED ? 0 : o.base;
#pragma unroll
  for (int s = 0; s < MAXG; ++s)
    if (s < d.ndim && (d.red[s] || s == pm) == WALKED)
      off += (long long)o.coef[s] * g[s];
#pragma unroll
  for (int t = 0; t < MAXT; ++t)
    if (t < o.ntab) {
      const int s = o.tsym[t];
      if ((d.red[s] || s == pm) == WALKED)
        off += tables[o.toff[t] + get_at(g, s)];
    }
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
#pragma unroll
    for (int s = 0; s < MAXG; ++s) g[s] = 0;
    // units < 2^31: 32-bit decode
    decode(g, (unsigned)u, d, [&](int s) { return !d.red[s] && s != pm; });
    for (int p = 0; p < P; ++p) {  // the sub-tiles of this point, in turn
      if (pm >= 0) set_at(g, pm, p);
      const long long o_off = offset_of(oo, g, tables, d.ndim);
      if (vec) {  // rows == 1, unit column strides, 4-element aligned
        for (int e = 0; e < nel; e += 4) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          for (int r = 0; r < R; ++r) {
            decode(g, (unsigned)r, d, [&](int s) { return d.red[s] != 0; });
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
            decode(g, (unsigned)r, d, [&](int s) { return d.red[s] != 0; });
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
  if (blockDim.x % chunks == 0) {  // each thread keeps one column of chunks
    const int c = (threadIdx.x % chunks) * per, step = blockDim.x / chunks;
    for (int r = threadIdx.x / chunks; r < rows; r += step) {
      const T* s = src + (long long)r * rs + (long long)c * cs;
      if (gran == 16)
        cp_async16(dst + r * ld + c, s);
      else
        cp_async4(dst + r * ld + c, s);
    }
    return;
  }
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

// Row strides of the staged slices: both padded by 16 bytes in bf16 (the
// right one only there, where ldmatrix reads it), the left one in fp32.
__host__ __device__ __forceinline__ int lda_of(int kc, int isz) {
  return kc + 16 / isz;
}
__host__ __device__ __forceinline__ int ldb_of(int bn, int isz) {
  return isz == 2 ? bn + 8 : bn;
}

// NI = 0: fp32 FMAs, RM x RN outputs a thread, two stages.  NI > 0 (bf16
// only): the tensor cores, one warp per 16 rows x 8 NI columns of one
// sub-tile, over a ring of ST stages.
template <typename T, int RM, int RN, int NI, int ST = 2>
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
#pragma unroll
  for (int s = 0; s < MAXG; ++s) gmap[s] = 0;
  decode(gmap, blockIdx.x, d, [&](int s) { return !d.red[s] && s != pm; });

  const int lda = lda_of(kc, (int)sizeof(T)), ldb = ldb_of(bn, (int)sizeof(T));
  const int a_bytes = round16(M * bm * lda * (int)sizeof(T));
  const int b_bytes = round16(M * P * kc * ldb * (int)sizeof(T));
  // stage `buf` of the ring: its left slices, then its right slices
  auto sa = [&](int buf) {
    return reinterpret_cast<T*>(smem + buf * (a_bytes + b_bytes));
  };
  auto sb = [&](int buf) {
    return reinterpret_cast<T*>(smem + buf * (a_bytes + b_bytes) + a_bytes);
  };

  const long long a_map = offset_part<false>(oa, gmap, tables, d, pm);
  const long long b_map = offset_part<false>(ob, gmap, tables, d, pm);

  // stage the K-slice of step `step` of every beat (and sub-tile) into buf
  auto load = [&](int step, int buf) {
    int g[MAXG];
#pragma unroll
    for (int s = 0; s < MAXG; ++s) g[s] = gmap[s];
    const int sl = step % slices;
    decode(g, (unsigned)(step / slices), d,
           [&](int s) { return d.red[s] && s != pr; });
    for (int t = 0; t < M; ++t) {
      if (pr >= 0) set_at(g, pr, t);
      if (pm >= 0) set_at(g, pm, 0);  // the left panel does not move with pm
      const long long ao = a_map + offset_part<true>(oa, g, tables, d, pm) +
                           (long long)sl * kc * oa.cs;
      stage(sa(buf) + t * bm * lda, lda, in0 + ao, bm, kc, oa.rs, oa.cs,
            d.gran[0]);
      for (int m = 0; m < P; ++m) {
        if (pm >= 0) set_at(g, pm, m);
        const long long bo = b_map + offset_part<true>(ob, g, tables, d, pm) +
                             (long long)sl * kc * ob.rs;
        stage(sb(buf) + (t * P + m) * kc * ldb, ldb, in1 + bo, kc, bn, ob.rs,
              ob.cs, d.gran[1]);
      }
    }
    cp_async_commit();
  };

  // The fast load (d.gran[2], set at launch where it applies): the reduce
  // part of both operands' offsets for every reduce point is computed
  // once, into shared memory behind the ring, and each thread copies the
  // same 16- or 4-byte column of its rows at every step, so a step costs
  // a few adds and its copies instead of a walk of the descriptor.
  const bool fast = d.gran[2] != 0;
  long long* soff = reinterpret_cast<long long*>(smem + ST * (a_bytes + b_bytes));
  const int pa = d.gran[0] / (int)sizeof(T), pb = d.gran[1] / (int)sizeof(T);
  const int cha = fast ? kc / pa : 1, chb = fast ? bn / pb : 1;
  const int ra = threadIdx.x / cha, ca = (threadIdx.x % cha) * pa;
  const int rb = threadIdx.x / chb, cb = (threadIdx.x % chb) * pb;
  const int sra = blockDim.x / cha, srb = blockDim.x / chb;
  const long long a_pr = pr >= 0 ? oa.coef[pr] : 0;
  const long long b_pr = pr >= 0 ? ob.coef[pr] : 0;
  const long long b_pm = pm >= 0 ? ob.coef[pm] : 0;
  if (fast) {
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      int g[MAXG];
#pragma unroll
      for (int s = 0; s < MAXG; ++s) g[s] = gmap[s];
      decode(g, (unsigned)r, d, [&](int s) { return d.red[s] && s != pr; });
      soff[2 * r] = offset_part<true>(oa, g, tables, d, pm);
      soff[2 * r + 1] = offset_part<true>(ob, g, tables, d, pm);
    }
    __syncthreads();
  }
  auto copy = [&](T* dst, const T* src, int gran) {
    if (gran == 16) cp_async16(dst, src);
    else cp_async4(dst, src);
  };
  auto load_fast = [&](int step, int buf) {
    const int r = step / slices, sl = step - r * slices;
    const long long ao = a_map + soff[2 * r] + (long long)sl * kc * oa.cs;
    const long long bo = b_map + soff[2 * r + 1] + (long long)sl * kc * ob.rs;
    for (int t = 0; t < M; ++t) {
      T* da = sa(buf) + t * bm * lda;
      const T* ga = in0 + ao + a_pr * t + (long long)ca * oa.cs;
      for (int rr = ra; rr < bm; rr += sra)
        copy(da + rr * lda + ca, ga + (long long)rr * oa.rs, d.gran[0]);
      for (int m = 0; m < P; ++m) {
        T* db = sb(buf) + (t * P + m) * kc * ldb;
        const T* gb = in1 + bo + b_pr * t + b_pm * m + (long long)cb * ob.cs;
        for (int rr = rb; rr < kc; rr += srb)
          copy(db + rr * ldb + cb, gb + (long long)rr * ob.rs, d.gran[1]);
      }
    }
    cp_async_commit();
  };
  auto load_any = [&](int step, int buf) {
    if (fast) load_fast(step, buf);
    else load(step, buf);
  };

  if constexpr (NI > 0) {
    // warps: wm picks 16 rows, wn picks 8 NI columns of the P * bn wide
    // tile, all inside one sub-tile (NI * 8 divides bn)
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wn_count = P * bn / (8 * NI);
    const int wm = warp / wn_count, col0 = (warp % wn_count) * 8 * NI;
    const int sub = col0 / bn, c0 = col0 % bn;
    float acc[1][NI][4];
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[0][j][c] = 0.f;

    // a ring of ST stages, ST - 1 slices in flight; one commit group per
    // slice, empty past the last, so the wait counts stay uniform
#pragma unroll
    for (int s = 0; s < ST - 1; ++s) {
      if (s < steps) load_any(s, s);
      else cp_async_commit();
    }
    for (int step = 0; step < steps; ++step) {
      const int buf = step % ST;
      cp_async_wait<ST - 2>();
      __syncthreads();  // slice `step` landed; slice step - 1's slot is free
      const int next = step + ST - 1;
      if (next < steps) load_any(next, next % ST);
      else cp_async_commit();
      for (int t = 0; t < M; ++t)  // the M dependent beats
        mma_bf16::warp_product<1, NI>(
            acc, reinterpret_cast<const __nv_bfloat16*>(sa(buf)) +
                     (t * bm + wm * 16) * lda,
            lda,
            reinterpret_cast<const __nv_bfloat16*>(sb(buf)) +
                (t * P + sub) * kc * ldb + c0,
            ldb, kc / 16, lane);
    }
    cp_async_wait<0>();

    // write the warp's tile, rounded once
    int g[MAXG];
#pragma unroll
    for (int s = 0; s < MAXG; ++s) g[s] = gmap[s];
    if (pm >= 0) set_at(g, pm, sub);
    const long long base = offset_of(oo, g, tables, d.ndim);
    const int r = wm * 16 + (lane >> 2), cl = c0 + (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long o = base + (long long)(r + 8 * (e >> 1)) * oo.rs +
                            (long long)(cl + 8 * j + (e & 1)) * oo.cs;
        out[o] = from_f<T>(acc[0][j][e]);
      }
    return;
  } else {
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
    bcol[j] = bval[j] ? (c / bn) * kc * ldb + c % bn : 0;
  }
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  if (steps > 0) load_any(0, 0);
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) {
      load_any(step + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int t = 0; t < M; ++t) {  // the M dependent beats
      const T* at = sa(buf) + t * bm * lda;
      const T* bt = sb(buf) + t * P * kc * ldb;
      for (int kk = 0; kk < kc; ++kk) {
        float av[RM], bv[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int row = ty + ny * i;
          av[i] = row < bm ? to_f(at[row * lda + kk]) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < RN; ++j)
          bv[j] = bval[j] ? to_f(bt[bcol[j] + kk * ldb]) : 0.f;
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
    if (pm >= 0) set_at(g, pm, c / bn);
    const long long base = offset_of(oo, g, tables, d.ndim) +
                           (long long)(c % bn) * oo.cs;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = ty + ny * i;
      if (row < bm) out[base + (long long)row * oo.rs] = from_f<T>(acc[i][j]);
    }
  }
  }
}

int per_thread(int n, int threads) {  // a power of two >= n / threads, <= 8
  int r = 1;
  while (r * threads < n && r < 8) r *= 2;
  return r;
}

template <typename T, int RM, int RN, int NI = 0, int ST = 2>
cudaError_t launch_dot(const Desc& d, const void* a, const void* b, void* o,
                       const int* tables, long long units, int smem,
                       int threads, cudaStream_t stream) {
  auto k = region_dot<T, RM, RN, NI, ST>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k<<<(unsigned)units, threads, smem, stream>>>(
      d, static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(o), tables);
  return cudaGetLastError();
}

template <typename T, int RM>
cudaError_t launch_dot_rn(int rn, const Desc& d, const void* a, const void* b,
                          void* o, const int* tables, long long units, int smem,
                          int ny, cudaStream_t stream) {
  switch (rn) {
    case 1: return launch_dot<T, RM, 1>(d, a, b, o, tables, units, smem, SIDE * ny, stream);
    case 2: return launch_dot<T, RM, 2>(d, a, b, o, tables, units, smem, SIDE * ny, stream);
    case 4: return launch_dot<T, RM, 4>(d, a, b, o, tables, units, smem, SIDE * ny, stream);
    default: return launch_dot<T, RM, 8>(d, a, b, o, tables, units, smem, SIDE * ny, stream);
  }
}

// Whether a dot launch of `threads` threads over a ring of `ring` bytes
// takes the fast load (both operands copied in granules, a whole number of
// granule columns per row that the threads tile, at most 1024 reduce
// points, their offsets fitting behind the ring): sets df.gran[2] and
// returns the extra shared memory, 16 bytes a reduce point, or 0.
int fast_load(Desc& df, int threads, int ring, int isz) {
  const int pr = (df.pump >= 0 && df.red[df.pump]) ? df.pump : -1;
  long long red = 1;
  for (int s = 0; s < df.ndim; ++s)
    if (df.red[s] && s != pr) red *= df.ext[s];
  const int ga = df.gran[0] / isz, gb = df.gran[1] / isz;
  const int kc = df.kc, bn = df.o[1].cols;
  const bool fast = ga > 0 && gb > 0 && kc % ga == 0 && bn % gb == 0 &&
                    threads % (kc / ga) == 0 && threads % (bn / gb) == 0 &&
                    red <= 1024 && ring + 16 * red <= MAX_SMEM;
  df.gran[2] = fast ? 1 : 0;
  return fast ? (int)(16 * red) : 0;
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
  const int isz = (int)sizeof(T);
  const int smem = 2 * (round16(M * bm * lda_of(kc, isz) * isz) +
                        round16(M * P * kc * ldb_of(bn, isz) * isz));
  if constexpr (sizeof(T) == 2) {
    // the tensor cores: 16-row warps, NI n8 tiles each, NI * 8 dividing bn
    // (a warp stays in one sub-tile), at most 4 warps along the columns; a
    // ring of 8 stages where it fits, else the 2 the plan was sized for
    const int nn = P * bn / 8;
    if (bm % 16 == 0 && kc % 16 == 0 && bn % 8 == 0) {
      for (int ni = 1; ni <= 16; ni *= 2) {
        if ((bn / 8) % ni || nn / ni > 4 || (bm / 16) * (nn / ni) * 32 > THREADS)
          continue;
        const int threads = (bm / 16) * (nn / ni) * 32;
        Desc df = d;
        const int extra = fast_load(df, threads, 4 * smem, isz);
        if (4 * smem + extra <= MAX_SMEM) {
          const int sm = 4 * smem + extra;
          switch (ni) {
            case 1: return launch_dot<T, 1, 1, 1, 8>(df, a, b, o, tables, units, sm, threads, stream);
            case 2: return launch_dot<T, 1, 1, 2, 8>(df, a, b, o, tables, units, sm, threads, stream);
            case 4: return launch_dot<T, 1, 1, 4, 8>(df, a, b, o, tables, units, sm, threads, stream);
            case 8: return launch_dot<T, 1, 1, 8, 8>(df, a, b, o, tables, units, sm, threads, stream);
            default: return launch_dot<T, 1, 1, 16, 8>(df, a, b, o, tables, units, sm, threads, stream);
          }
        }
        df.gran[2] = 0;
        switch (ni) {
          case 1: return launch_dot<T, 1, 1, 1>(df, a, b, o, tables, units, smem, threads, stream);
          case 2: return launch_dot<T, 1, 1, 2>(df, a, b, o, tables, units, smem, threads, stream);
          case 4: return launch_dot<T, 1, 1, 4>(df, a, b, o, tables, units, smem, threads, stream);
          case 8: return launch_dot<T, 1, 1, 8>(df, a, b, o, tables, units, smem, threads, stream);
          default: return launch_dot<T, 1, 1, 16>(df, a, b, o, tables, units, smem, threads, stream);
        }
      }
    }
  }
  // rows of threads: 16 for a tile of 64 rows or more, fewer for a short
  // tile, so each thread keeps at least 4 rows (16 x 128: 64 threads of
  // 4 x 8 outputs instead of 256 of 1 x 8)
  int ny = SIDE;
  while (ny > 1 && ny * 4 > bm) ny /= 2;
  const int rm = per_thread(bm, ny), rn = per_thread(P * bn, SIDE);
  if (rm * ny < bm || rn * SIDE < P * bn) return cudaErrorInvalidValue;
  Desc df = d;
  const int extra = fast_load(df, SIDE * ny, smem, isz);
  const int sm = smem + extra;
  switch (rm) {
    case 1: return launch_dot_rn<T, 1>(rn, df, a, b, o, tables, units, sm, ny, stream);
    case 2: return launch_dot_rn<T, 2>(rn, df, a, b, o, tables, units, sm, ny, stream);
    case 4: return launch_dot_rn<T, 4>(rn, df, a, b, o, tables, units, sm, ny, stream);
    default: return launch_dot_rn<T, 8>(rn, df, a, b, o, tables, units, sm, ny, stream);
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
