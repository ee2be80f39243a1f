// Decode attention (one query token against the KV cache) for Hopper, sm_90a.
//
// Replaces the TPU kernel that src/repro/compiler/pallas_backend.py::emit_pallas
// emits in its carry form (pl.pallas_call at :784) over
// src/repro/core/autopump.py::_decode_attention_graph (:456).  No
// hand-written Pallas version of it exists; the emitter wrote it.
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
// every K/V tile, staged once in shared memory by cp.async in the cache's
// dtype (G = 2 for qwen3), so the cache is read once, not G times.  The
// Pallas grid's sequential KV axis is a loop inside the block.  The loop
// stops at the last tile that holds pos[b] and loads only rows <= pos[b],
// so the step reads only valid bytes; the reference's jitted step reads the
// whole max_len cache.  Known gap: B * Hkv blocks (64 at B = 8) under-fill
// the 132 SMs; a split-KV design with a combine pass is later work.
//
// The pump (template PUMP, MODE_R):
//  - mode T: the keys are walked in transactions of PUMP 64-key tiles: one
//    cp.async group stages the panel of K and V, then PUMP dependent beats
//    run over it (the reference's _apply_temporal, hopper_backend.py:429);
//  - mode R: the builder's narrow axis d, on the value path only (the
//    scores contract the full head dim), is cut into PUMP sub-tiles of
//    D / PUMP dims; each runs its own full sweep over the keys, staging all
//    of K and its own columns of V.
// Every output sums the same terms in the same order in every case, so T1,
// T2, T4, R2 and R4 give the same bits.  Built set: a case is built where
// its shared memory fits 227 KB; at D 128 a 64-key tile of K (rows padded
// by 16 bytes) and V is 66.5 KB in fp32 and 33.8 KB in bf16, so T4 is
// built for a bf16 cache, and for an fp32 one only up to D 64 (qwen3's
// fp32 cache at D 128 takes T1, T2, R2 and R4).  Mode R needs D % (4 M)
// == 0.  kernels/decode_attention.py::built is the same sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BKV = 64;       // keys per staged tile (2 per lane in the softmax)
constexpr int THREADS = 256;
constexpr int MAXP = 4;       // (g, d) output pairs per thread: G * D <= 1024
constexpr float NEG_INF = -1e30f;
constexpr size_t MAX_SMEM = 227 * 1024;

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

// Copy 4 consecutive elements (16 bytes fp32, 8 bytes bf16) to shared
// memory; ok = false writes zeros without reading src.
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 8 : 0));
}

// Shared memory of a case: the K panel (rows padded by 16 bytes) and the V
// panel (its sub-tile's columns) in the cache dtype, then q, the scores and
// the softmax state in fp32.
size_t smem_bytes(int G, int D, int isz, int pump, bool mode_r) {
  const size_t tiles = mode_r ? 1 : pump, dv = mode_r ? D / pump : D;
  return tiles * BKV * ((D + 16 / isz) + dv) * isz +
         sizeof(float) * ((size_t)G * D + (size_t)G * BKV + 3 * (size_t)G);
}

template <typename TQ, typename TKV, int PUMP, bool MODE_R>
__global__ void __launch_bounds__(THREADS)
decode_attn(const TQ* __restrict__ q, const TKV* __restrict__ k,
            const TKV* __restrict__ v, const int* __restrict__ pos,
            TQ* __restrict__ o, int H, int Hkv, int T, int D, float scale) {
  constexpr int TILES = MODE_R ? 1 : PUMP;   // K/V tiles of one transaction
  constexpr int SUBS = MODE_R ? PUMP : 1;    // value sub-tiles, each a sweep
  extern __shared__ float4 smem4[];
  const int G = H / Hkv;
  const int KS = D + 16 / (int)sizeof(TKV);  // padded: float4 reads of 8 rows
  const int DV = D / SUBS;                   // value columns of a sub-tile
  TKV* ks = reinterpret_cast<TKV*>(smem4);   // TILES x BKV x KS
  TKV* vs = ks + TILES * BKV * KS;           // TILES x BKV x DV
  float* qs = reinterpret_cast<float*>(vs + TILES * BKV * DV);  // G * D, pre-scaled
  float* sc = qs + G * D;                    // G * BKV scores, then weights
  float* st = sc + G * BKV;                  // m[G], l[G], alpha[G]

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = pos[b];
  // the reference masks k_pos <= pos over the whole cache: pos >= T leaves
  // every key valid; pos < 0 masks them all, which NEG_INF turns into a
  // uniform average over T keys, so those rows walk all T keys as it does
  const int n_keys = (p < 0 || p >= T) ? T : p + 1;

  const TQ* qb = q + ((long long)b * H + (long long)hk * G) * D;
  for (int i = tid; i < G * D; i += THREADS) qs[i] = to_f(qb[i]) * scale;

  const long long base = ((long long)b * Hkv + hk) * (long long)T * D;
  const TKV* kb = k + base;
  const TKV* vb = v + base;
  const int kc = D / 4, vc = DV / 4;   // 4-element chunks of a K / V row
  TQ* ob = o + ((long long)b * H + (long long)hk * G) * D;

#pragma unroll 1
  for (int sub = 0; sub < SUBS; ++sub) {
    const int d0 = sub * DV;   // the sub-tile's first value column
    if (sub > 0) __syncthreads();  // the previous sweep's state is read
    for (int g = tid; g < G; g += THREADS) {
      st[g] = NEG_INF;
      st[G + g] = 0.f;
    }
    float acc[MAXP];
#pragma unroll
    for (int r = 0; r < MAXP; ++r) acc[r] = 0.f;

#pragma unroll 1
    for (int t0 = 0; t0 < n_keys; t0 += TILES * BKV) {
      const int span = min(TILES * BKV, n_keys - t0);
      __syncthreads();  // the previous panel fully consumed; q / state staged
      // one transaction: the panel's K rows and V columns, rows past the
      // valid keys zero
      for (int u = tid; u < span * kc; u += THREADS) {
        const int r = u / kc, c = (u % kc) * 4;
        cp_async4(ks + r * KS + c, kb + (long long)(t0 + r) * D + c, true);
      }
      for (int u = tid; u < span * vc; u += THREADS) {
        const int r = u / vc, c = (u % vc) * 4;
        cp_async4(vs + r * DV + c, vb + (long long)(t0 + r) * D + d0 + c, true);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();

#pragma unroll 1
      for (int beat = 0; beat * BKV < span; ++beat) {  // the dependent beats
        const int tb = t0 + beat * BKV;
        const int kn = min(BKV, n_keys - tb);
        const TKV* kt = ks + beat * BKV * KS;
        const TKV* vt = vs + beat * BKV * DV;
        if (beat > 0) __syncthreads();  // the previous beat's weights are read

        for (int i = tid; i < G * BKV; i += THREADS) {
          const int g = i / BKV, j = i % BKV;
          float s = NEG_INF;
          if (j < kn && tb + j <= p) {
            const float* qg = qs + g * D;
            const TKV* kr = kt + j * KS;
            float a = 0.f;
            for (int d = 0; d < D; d += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qg + d);
              const float4 kv = load4(kr + d);
              a = fmaf(qv.x, kv.x, a);
              a = fmaf(qv.y, kv.y, a);
              a = fmaf(qv.z, kv.z, a);
              a = fmaf(qv.w, kv.w, a);
            }
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
          if (i < G * DV) {
            const int g = i / DV, d = i % DV;
            const float* pg = sc + g * BKV;
            float a = acc[r] * st[2 * G + g];
            for (int j = 0; j < kn; ++j) a = fmaf(pg[j], to_f(vt[j * DV + d]), a);
            acc[r] = a;
          }
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < MAXP; ++r) {
      const int i = tid + r * THREADS;
      if (i < G * DV) {
        const int g = i / DV, d = i % DV;
        const float l = st[G + g];
        store1(ob + g * D + d0 + d, acc[r] / (l == 0.f ? 1.f : l));
      }
    }
  }
}

template <typename TQ, typename TKV, int PUMP, bool MODE_R>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos, void* o,
                   int B, int H, int Hkv, int T, int D, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, D, (int)sizeof(TKV), PUMP, MODE_R);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;  // not built
  cudaError_t err = cudaFuncSetAttribute(decode_attn<TQ, TKV, PUMP, MODE_R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  decode_attn<TQ, TKV, PUMP, MODE_R><<<dim3(Hkv, B), THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<const int*>(pos), static_cast<TQ*>(o), H, Hkv, T, D, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t by_pump(int pump, int mode_r, const void* q, const void* k, const void* v,
                    const void* pos, void* o, int B, int H, int Hkv, int T, int D,
                    float scale, cudaStream_t s) {
  if (!mode_r || pump == 1) {
    switch (pump) {
      case 1: return launch<TQ, TKV, 1, false>(q, k, v, pos, o, B, H, Hkv, T, D, scale, s);
      case 2: return launch<TQ, TKV, 2, false>(q, k, v, pos, o, B, H, Hkv, T, D, scale, s);
      case 4: return launch<TQ, TKV, 4, false>(q, k, v, pos, o, B, H, Hkv, T, D, scale, s);
    }
  } else if (D % (4 * pump) == 0) {
    switch (pump) {
      case 2: return launch<TQ, TKV, 2, true>(q, k, v, pos, o, B, H, Hkv, T, D, scale, s);
      case 4: return launch<TQ, TKV, 4, true>(q, k, v, pos, o, B, H, Hkv, T, D, scale, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16.  q (B, H, D), k / v
// (B, Hkv, T, D), pos (B,) int32 and o (B, H, D) are contiguous and 16-byte
// aligned.  Needs D % 4 == 0 and (H / Hkv) * D <= 1024; pump 1, 2 or 4,
// mode_r 0 (T) or 1 (R, which needs D % (4 pump) == 0).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* pos, void* o, int q_dtype, int kv_dtype,
                                    int B, int H, int Hkv, int T, int D, float scale,
                                    int pump, int mode_r, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 != 0 || Hkv < 1 || H % Hkv != 0 || (H / Hkv) * D > MAXP * THREADS)
    return cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0)
    return by_pump<float, float>(pump, mode_r, q, k, v, pos, o, B, H, Hkv, T, D, scale, s);
  if (q_dtype == 0 && kv_dtype == 1)
    return by_pump<float, __nv_bfloat16>(pump, mode_r, q, k, v, pos, o, B, H, Hkv, T, D,
                                         scale, s);
  if (q_dtype == 1 && kv_dtype == 0)
    return by_pump<__nv_bfloat16, float>(pump, mode_r, q, k, v, pos, o, B, H, Hkv, T, D,
                                         scale, s);
  if (q_dtype == 1 && kv_dtype == 1)
    return by_pump<__nv_bfloat16, __nv_bfloat16>(pump, mode_r, q, k, v, pos, o, B, H, Hkv,
                                                 T, D, scale, s);
  return cudaErrorInvalidValue;
}
