// Flash attention (prefill) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// / flash_attention_pallas (and the carry emission of
// src/repro/compiler/pallas_backend.py::emit_pallas over
// src/repro/core/autopump.py::_flash_graph, which computes the same o).
//
// Computes o = softmax(q k^T * scale [causal: q_pos >= k_pos]) v per (b, h),
// with q (B, H, S, D), k/v (B, Hkv, T, D), kv head = h / (H / Hkv).  All
// arithmetic is fp32, as in the reference (inputs are cast up on load), with
// its NEG_INF = -1e30 masking and l == 0 -> 1.
//
// What bounds it on this card: at the serving prefill (S = T = 512, D = 128,
// bf16) the bytes (q, k, v read once, o written once) and the tensor-core
// FLOPs are both a few microseconds of work, so the real limit of this
// first version is the SM's fp32 FMA and shared-memory issue rate: it does
// the reference's fp32 math on CUDA cores, not bf16 on the tensor cores.
//
// Design: one block per (q tile of 64 rows, q head, batch).  The Pallas
// grid's sequential innermost KV axis becomes a loop inside the block; the
// online-softmax state (m, l, acc) lives in registers across it, as it
// lived in VMEM scratch across grid steps.  Each 64-key K/V tile is staged
// once in shared memory as fp32 and reused by all 64 query rows.  KV tiles
// wholly above the causal diagonal are skipped.  The ragged edges of S and T
// are masked here, so the wrapper pads nothing.  GQA reads the kv head
// through an index, never a repeated tensor.  Later work: mma.sync / wgmma
// on bf16 tiles, TMA staging.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per staged tile
constexpr int THREADS = 256;  // 16 x 16: ty picks rows, tx picks keys / dims
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Stage rows [row0, row0 + 64) of a row-major (rows, D) slice with the given
// row stride into shared memory as fp32 times `mul`; rows >= nrows are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride, const T* src,
                                          long long row_stride, int row0, int nrows,
                                          float mul) {
  constexpr int VPR = D / 4;
  constexpr int PER = 64 * VPR / THREADS;
  float4 buf[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int u = threadIdx.x + i * THREADS;
    const int r = u / VPR, c = (u % VPR) * 4;
    buf[i] = row0 + r < nrows ? load4(src + (long long)(row0 + r) * row_stride + c)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int u = threadIdx.x + i * THREADS;
    const int r = u / VPR, c = (u % VPR) * 4;
    const float4 x = buf[i];
    *reinterpret_cast<float4*>(dst + r * dst_stride + c) =
        make_float4(x.x * mul, x.y * mul, x.z * mul, x.w * mul);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 4) + BKV * (D + 4) + BKV * D + BQ * (BKV + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int S, int T_len, int H, int G,
          long long qsb, long long qsh, long long qss,
          long long ksb, long long ksh, long long kss,
          long long vsb, long long vsh, long long vss,
          float scale, int causal) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int QS = D + 4, KS = D + 4, VS = D, PS = BKV + 1;
  constexpr int NV = D / 16;  // output dims per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BKV * KS;
  float* Ps = Vs + BKV * VS;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  // q is staged pre-scaled, as the reference scales q before the dot
  load_tile<T, D>(Qs, QS, q + b * qsb + h * qsh, qss, q0, S, scale);

  float acc[4][NV];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NV; ++n) acc[i][n] = 0.f;
  }

  int n_tiles = (T_len + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BKV + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the previous tile's K/V/P reads are done
    load_tile<T, D>(Ks, KS, kb, kss, k0, T_len, 1.f);
    load_tile<T, D>(Vs, VS, vb, vss, k0, T_len, 1.f);
    __syncthreads();

    // scores for rows ty + 16 i and keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * KS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // online softmax; a row's 64 keys live in the 16 lanes sharing its ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (causal && qp < kp) s[i][j] = NEG_INF;
        if (kp < T_len) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], mx);
      const float alpha = expf(m_run[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // keys past T do not exist: weight 0 (masked keys keep NEG_INF math)
        const float p = k0 + tx + 16 * j < T_len ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_new;
#pragma unroll
      for (int n = 0; n < NV; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();

    // acc += P V for rows ty + 16 i and dims tx + 16 n
    const int kn = min(BKV, T_len - k0);
#pragma unroll 4
    for (int c = 0; c < kn; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const float vv = Vs[c * VS + tx + 16 * n];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][n] = fmaf(pv[i], vv, acc[i][n]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
    const float l = l_run[i] == 0.f ? 1.f : l_run[i];
    T* orow = o + (((long long)b * H + h) * S + qp) * D;
#pragma unroll
    for (int n = 0; n < NV; ++n) store1(orow + tx + 16 * n, acc[i][n] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int Hkv, int S, int T_len, const long long* st, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, T_len, H, H / Hkv, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
                       int H, int Hkv, int S, int T_len, int D, const long long* st,
                       float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, Hkv, S, T_len, st, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Hkv, S, T_len, st, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Hkv, S, T_len, st, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  strides holds
// the (batch, head, seq) element strides of q, k and v in that order; the
// last dim is contiguous and o is a contiguous (B, H, S, D) tensor.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int H, int Hkv, int S, int T_len,
                                   int D, const long long* strides, float scale,
                                   int causal, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, H, Hkv, S, T_len, D, strides, scale, causal, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S, T_len, D, strides, scale,
                                     causal, s);
  return cudaErrorInvalidValue;
}
