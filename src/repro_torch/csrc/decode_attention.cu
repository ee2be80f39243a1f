// Decode attention (one query token against the KV cache) for Hopper, sm_90a.
//
// Replaces the TPU kernel that src/repro/compiler/pallas_backend.py::emit_pallas
// emits in its carry form (pl.pallas_call in :730-795) over
// src/repro/core/autopump.py::_decode_attention_graph.  No hand-written Pallas
// version of it exists; the emitter wrote it.
//
// Computes, per batch row b and q head h (kv head h / G, G = H / Hkv):
//   o[b, h] = softmax(q[b, h] * scale . k[b, h/G, t]  for t <= pos[b]) . v
// with the reference's online softmax in fp32, NEG_INF = -1e30 for masked
// keys and l == 0 -> 1.  q is bf16 or fp32; k and v are fp32 or bf16, each
// read in its own dtype; o takes q's dtype.  The reference's emitted kernel
// casts every input to the graph dtype, which is q's (pallas_backend.py:996),
// so under bf16 it reads an fp32 cache rounded to bf16; this kernel reads
// the cache as it is.  In fp32 the two agree; in bf16 they differ by that
// rounding only.
//
// What bounds it on this card: bytes.  Each cache element is used for two
// FMAs, so the step reads (pos + 1) * Hkv * D * 2 elements per row and does
// almost no arithmetic per byte; the bound is that read over 3.35 TB/s.
//
// Design: one block per (kv head, batch row).  The block's G q heads share
// every K/V tile, staged once in shared memory (G = 2 for qwen3), so the
// cache is read once, not G times.  The Pallas grid's sequential KV axis is
// a loop inside the block.  The loop stops at the last tile that holds
// pos[b] and loads only rows <= pos[b], so the step reads only valid bytes;
// the reference's jitted step reads the whole max_len cache.  Known gap:
// B * Hkv blocks (64 at B = 8) under-fill the 132 SMs; a split-KV design with
// a combine pass is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BKV = 64;       // keys per staged tile (2 per lane in the softmax)
constexpr int THREADS = 256;
constexpr int MAXP = 4;       // (g, d) output pairs per thread: G * D <= 1024
constexpr int CHUNK = 4;      // float4 loads in flight per thread per tensor
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void put4(float* dst, float4 x) {
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
decode_attn(const TQ* __restrict__ q, const TKV* __restrict__ k,
            const TKV* __restrict__ v, const int* __restrict__ pos,
            TQ* __restrict__ o, int H, int Hkv, int T, int D, float scale) {
  extern __shared__ float4 smem4[];
  const int G = H / Hkv;
  const int KS = D + 1;  // padded: lanes read consecutive key rows
  float* qs = reinterpret_cast<float*>(smem4);  // G * D, pre-scaled
  float* ks = qs + G * D;                        // BKV * KS
  float* vs = ks + BKV * KS;                     // BKV * D
  float* sc = vs + BKV * D;                      // G * BKV scores, then weights
  float* st = sc + G * BKV;                      // m[G], l[G], alpha[G]

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = pos[b];
  // the reference masks k_pos <= pos over the whole cache: pos >= T leaves
  // every key valid; pos < 0 masks them all, which NEG_INF turns into a
  // uniform average over T keys, so those rows walk all T keys as it does
  const int n_keys = (p < 0 || p >= T) ? T : p + 1;

  const TQ* qb = q + ((long long)b * H + (long long)hk * G) * D;
  for (int i = tid; i < G * D; i += THREADS) qs[i] = to_f(qb[i]) * scale;
  for (int g = tid; g < G; g += THREADS) {
    st[g] = NEG_INF;
    st[G + g] = 0.f;
  }
  float acc[MAXP];
#pragma unroll
  for (int r = 0; r < MAXP; ++r) acc[r] = 0.f;

  const long long base = ((long long)b * Hkv + hk) * (long long)T * D;
  const TKV* kb = k + base;
  const TKV* vb = v + base;
  const int vpr = D / 4;

  for (int t0 = 0; t0 < n_keys; t0 += BKV) {
    const int kn = min(BKV, n_keys - t0);
    const int units = kn * vpr;
    __syncthreads();  // previous tile fully consumed; q / state staged
    for (int u0 = tid; u0 < units; u0 += CHUNK * THREADS) {
      float4 kr[CHUNK], vr[CHUNK];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        const int u = u0 + c * THREADS;
        if (u < units) {
          const long long off = (long long)(t0 + u / vpr) * D + (u % vpr) * 4;
          kr[c] = load4(kb + off);
          vr[c] = load4(vb + off);
        }
      }
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        const int u = u0 + c * THREADS;
        if (u < units) {
          const int r = u / vpr, col = (u % vpr) * 4;
          put4(ks + r * KS + col, kr[c]);
          *reinterpret_cast<float4*>(vs + r * D + col) = vr[c];
        }
      }
    }
    __syncthreads();

    for (int i = tid; i < G * BKV; i += THREADS) {
      const int g = i / BKV, j = i % BKV;
      float s = NEG_INF;
      if (j < kn && t0 + j <= p) {
        const float* qg = qs + g * D;
        const float* kr = ks + j * KS;
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qg[d], kr[d], a);
        s = a;
      }
      sc[i] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += THREADS / 32) {
      float* sg = sc + g * BKV;
      const bool has0 = lane < kn, has1 = lane + 32 < kn;
      const float s0 = sg[lane], s1 = sg[lane + 32];
      float mx = fmaxf(has0 ? s0 : NEG_INF, has1 ? s1 : NEG_INF);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = st[g];
      const float m_new = fmaxf(m_old, mx);
      // rows past the tile's kn do not exist here: weight 0
      const float p0 = has0 ? expf(s0 - m_new) : 0.f;
      const float p1 = has1 ? expf(s1 - m_new) : 0.f;
      sg[lane] = p0;
      sg[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        st[g] = m_new;
        st[G + g] = st[G + g] * alpha + sum;
        st[2 * G + g] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < MAXP; ++r) {
      const int i = tid + r * THREADS;
      if (i < G * D) {
        const int g = i / D, d = i % D;
        const float* pg = sc + g * BKV;
        float a = acc[r] * st[2 * G + g];
        for (int j = 0; j < kn; ++j) a = fmaf(pg[j], vs[j * D + d], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();

  TQ* ob = o + ((long long)b * H + (long long)hk * G) * D;
#pragma unroll
  for (int r = 0; r < MAXP; ++r) {
    const int i = tid + r * THREADS;
    if (i < G * D) {
      const float l = st[G + i / D];
      store1(ob + i, acc[r] / (l == 0.f ? 1.f : l));
    }
  }
}

size_t smem_bytes(int G, int D) {
  return sizeof(float) * ((size_t)G * D + (size_t)BKV * (D + 1) + (size_t)BKV * D +
                          (size_t)G * BKV + 3 * (size_t)G);
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos, void* o,
                   int B, int H, int Hkv, int T, int D, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, D);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_attn<TQ, TKV><<<dim3(Hkv, B), THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int*>(pos), static_cast<TQ*>(o), H, Hkv, T, D, scale);
  return cudaGetLastError();
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16.  q (B, H, D), k / v
// (B, Hkv, T, D), pos (B,) int32 and o (B, H, D) are contiguous.  Needs
// D % 4 == 0 and (H / Hkv) * D <= 1024.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* pos, void* o, int q_dtype, int kv_dtype,
                                    int B, int H, int Hkv, int T, int D, float scale,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 != 0 || H % Hkv != 0 || (H / Hkv) * D > MAXP * THREADS)
    return cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0)
    return launch<float, float>(q, k, v, pos, o, B, H, Hkv, T, D, scale, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch<float, __nv_bfloat16>(q, k, v, pos, o, B, H, Hkv, T, D, scale, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return launch<__nv_bfloat16, float>(q, k, v, pos, o, B, H, Hkv, T, D, scale, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, pos, o, B, H, Hkv, T, D, scale, s);
  return cudaErrorInvalidValue;
}
