// Flash attention (prefill) for Hopper, sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// / flash_attention_pallas (pl.pallas_call at :103, the pump's fori_loop at
// :67) and the carry emission of src/repro/compiler/pallas_backend.py::
// emit_pallas (:784) over src/repro/core/autopump.py::_flash_graph, which
// computes the same o and also writes the final running max m and
// denominator l of every row.
//
// Computes o = softmax(q k^T * scale [causal: q_pos >= k_pos]) v per (b, h),
// with q (B, H, S, D), k/v (B, Hkv, T, D), kv head = h / (H / Hkv).  All
// arithmetic is fp32, as in the reference (inputs are cast up on load), with
// its NEG_INF = -1e30 masking and l == 0 -> 1.  m and l, when asked for,
// are fp32 (B, H, S).
//
// What bounds it on this card: at the serving prefill (S = T = 512, D = 128,
// bf16) the bytes (q, k, v read once, o written once) and the tensor-core
// FLOPs are both a few microseconds of work, so the real limit of this
// version is the SM's fp32 FMA and shared-memory issue rate: it does the
// reference's fp32 math on CUDA cores, not bf16 on the tensor cores (the
// next redesign).
//
// Design: one block per (q tile of 64 rows, q head, batch).  The Pallas
// grid's sequential innermost KV axis becomes a loop inside the block; the
// online-softmax state (m, l, acc) lives in registers across it, as it
// lived in VMEM scratch across grid steps.  q is staged once, pre-scaled,
// as fp32.  K and V are staged in their own dtype by cp.async (4-element
// chunks, zero-filled past T and past D) and read as fp32.  KV tiles wholly
// above the causal diagonal are skipped.  The ragged edges of S, T and D
// are masked here (D runs in a padded width DP of 16, 32, 64 or 128), so
// the wrapper pads nothing.  GQA reads the kv head through an index, never
// a repeated tensor.
//
// The pump (template PUMP, MODE_R):
//  - mode T: the KV axis is walked in transactions of PUMP tiles: one
//    cp.async group stages the PUMP x 64-key panel of K and V, then the
//    block issues PUMP dependent beats over it, as the reference's
//    fori_loop over M beats;
//  - mode R: the narrow axis, the q rows, is cut into PUMP sub-tiles of
//    64 / PUMP rows, and each runs its own full sweep over the keys (the
//    _pump axis outside the carry, hopper_backend.py::_append_pump).
// Keys are visited in the same order and each row's sums run in the same
// lanes in every case, so T1, T2, T4, R2 and R4 give the same bits.
// Built set: a case is built where its shared memory fits 227 KB: q (64 x
// (DP + 4) fp32), the scores (64 x 65 fp32) and the panel, PUMP (mode T) or
// one (mode R) tiles of 64 x (DP + 16 B) K and 64 x DP V in the input
// dtype.  At D 128 a tile is 66.5 KB in fp32 and 33.8 KB in bf16, so T4
// is built for bf16 (186 KB) and for fp32 only up to D 64; every other
// case fits.  kernels/flash_attention.py::built is the same sum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BKV = 64;       // keys per staged tile
constexpr int THREADS = 256;  // 16 x 16: ty picks rows, tx picks keys / dims
constexpr float NEG_INF = -1e30f;
constexpr size_t MAX_SMEM = 227 * 1024;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

__device__ __forceinline__ void cp_async_commit_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <typename T, int DP, int PUMP, bool MODE_R>
constexpr size_t smem_bytes() {
  constexpr int tiles = MODE_R ? 1 : PUMP;
  return sizeof(float) * (BQ * (DP + 4) + BQ * (BKV + 1)) +
         sizeof(T) * tiles * BKV * ((DP + 16 / sizeof(T)) + DP);
}

template <typename T, int DP, int PUMP, bool MODE_R>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
          int S, int T_len, int D, int H, int G,
          long long qsb, long long qsh, long long qss,
          long long ksb, long long ksh, long long kss,
          long long vsb, long long vsh, long long vss,
          float scale, int causal) {
  static_assert(DP % 16 == 0, "padded head dim must be a multiple of 16");
  constexpr int QS = DP + 4, KS = DP + 16 / (int)sizeof(T), PS = BKV + 1;
  constexpr int NV = DP / 16;                 // output dims per thread
  constexpr int TILES = MODE_R ? 1 : PUMP;    // K/V tiles of one transaction
  constexpr int SUBS = MODE_R ? PUMP : 1;     // q sub-tiles, each its own sweep
  constexpr int RI = 4 / SUBS;                // rows a thread keeps
  constexpr int SQ = BQ / SUBS;               // rows of one sub-tile
  constexpr int CPR = DP / 4;                 // 4-element chunks of a row
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ps = Qs + BQ * QS;
  T* Ks = reinterpret_cast<T*>(Ps + BQ * PS);
  T* Vs = Ks + TILES * BKV * KS;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  // q is staged pre-scaled, as the reference scales q before the dot
  {
    const T* qb = q + b * qsb + h * qsh;
    constexpr int PER = BQ * CPR / THREADS;
    float4 buf[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = tid + i * THREADS;
      const int r = u / CPR, c = (u % CPR) * 4;
      buf[i] = q0 + r < S && c < D ? load4(qb + (long long)(q0 + r) * qss + c)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = tid + i * THREADS;
      const int r = u / CPR, c = (u % CPR) * 4;
      const float4 x = buf[i];
      *reinterpret_cast<float4*>(Qs + r * QS + c) =
          make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
    }
  }

  const int all_tiles = (T_len + BKV - 1) / BKV;
#pragma unroll 1
  for (int sub = 0; sub < SUBS; ++sub) {
    const int r0 = sub * SQ;   // first row of the sub-tile in the block
    float acc[RI][NV];
    float m_run[RI], l_run[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      m_run[i] = NEG_INF;
      l_run[i] = 0.f;
#pragma unroll
      for (int n = 0; n < NV; ++n) acc[i][n] = 0.f;
    }
    int n_tiles = all_tiles;
    if (causal) n_tiles = min(n_tiles, (q0 + r0 + SQ - 1) / BKV + 1);

#pragma unroll 1
    for (int kt0 = 0; kt0 < n_tiles; kt0 += TILES) {
      const int nt = min(TILES, n_tiles - kt0);
      __syncthreads();  // the previous panel's reads are done; q is staged
      // one transaction: the panel of nt tiles of K and V
      for (int u = tid; u < nt * BKV * CPR; u += THREADS) {
        const int slot = u / (BKV * CPR), rem = u % (BKV * CPR);
        const int r = rem / CPR, c = (rem % CPR) * 4;
        const int kp = (kt0 + slot) * BKV + r;
        const bool ok = kp < T_len && c < D;
        cp_async4(Ks + (slot * BKV + r) * KS + c, kb + (ok ? kp * kss + c : 0), ok);
        cp_async4(Vs + (slot * BKV + r) * DP + c, vb + (ok ? kp * vss + c : 0), ok);
      }
      cp_async_commit_wait_all();
      __syncthreads();

#pragma unroll 1
      for (int beat = 0; beat < nt; ++beat) {  // the dependent beats
        const int k0 = (kt0 + beat) * BKV;
        const T* Kt = Ks + beat * BKV * KS;
        const T* Vt = Vs + beat * BKV * DP;
        if (beat > 0) __syncthreads();  // the previous beat's P reads are done

        // scores for rows r0 + ty + 16 i and keys tx + 16 j
        float s[RI][4];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < DP; d += 4) {
          float4 qv[RI], kv[4];
#pragma unroll
          for (int i = 0; i < RI; ++i)
            qv[i] = *reinterpret_cast<const float4*>(Qs + (r0 + ty + 16 * i) * QS + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) kv[j] = load4(Kt + (tx + 16 * j) * KS + d);
#pragma unroll
          for (int i = 0; i < RI; ++i)
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
        for (int i = 0; i < RI; ++i) {
          const int qp = q0 + r0 + ty + 16 * i;
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
          float pv[RI];
#pragma unroll
          for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
          for (int n = 0; n < NV; ++n) {
            const float vv = to_f(Vt[c * DP + tx + 16 * n]);
#pragma unroll
            for (int i = 0; i < RI; ++i) acc[i][n] = fmaf(pv[i], vv, acc[i][n]);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qp = q0 + r0 + ty + 16 * i;
      if (qp >= S) continue;
      const long long row = ((long long)b * H + h) * S + qp;
      const float l = l_run[i] == 0.f ? 1.f : l_run[i];
      T* orow = o + row * D;
#pragma unroll
      for (int n = 0; n < NV; ++n)
        if (tx + 16 * n < D) store1(orow + tx + 16 * n, acc[i][n] / l);
      if (m_out != nullptr && tx == 0) {
        m_out[row] = m_run[i];
        l_out[row] = l_run[i];
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float *m, *l;
  int B, H, Hkv, S, T_len, D;
  const long long* st;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int DP, int PUMP, bool MODE_R>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = smem_bytes<T, DP, PUMP, MODE_R>();
  if constexpr (smem > MAX_SMEM) {
    return cudaErrorInvalidValue;  // not built: the panel does not fit
  } else {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, DP, PUMP, MODE_R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.S + BQ - 1) / BQ, a.H, a.B);
    const long long* st = a.st;
    flash_fwd<T, DP, PUMP, MODE_R><<<grid, THREADS, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.o), a.m, a.l, a.S, a.T_len,
        a.D, a.H, a.H / a.Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
        st[7], st[8], a.scale, a.causal);
    return cudaGetLastError();
  }
}

template <typename T, int DP>
cudaError_t by_pump(int pump, int mode_r, const Args& a) {
  if (!mode_r || pump == 1) {
    switch (pump) {
      case 1: return launch<T, DP, 1, false>(a);
      case 2: return launch<T, DP, 2, false>(a);
      case 4: return launch<T, DP, 4, false>(a);
    }
  } else {
    switch (pump) {
      case 2: return launch<T, DP, 2, true>(a);
      case 4: return launch<T, DP, 4, true>(a);
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_dim(int pump, int mode_r, const Args& a) {
  if (a.D <= 16) return by_pump<T, 16>(pump, mode_r, a);
  if (a.D <= 32) return by_pump<T, 32>(pump, mode_r, a);
  if (a.D <= 64) return by_pump<T, 64>(pump, mode_r, a);
  return by_pump<T, 128>(pump, mode_r, a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  strides holds
// the (batch, head, seq) element strides of q, k and v in that order; the
// last dim is contiguous, every stride a multiple of 4 and every start
// 16-byte aligned; o is a contiguous (B, H, S, D) tensor.  m / l: fp32
// (B, H, S) outputs of the final running max and denominator, or both null.
// Needs D % 4 == 0, 4 <= D <= 128; pump 1, 2 or 4, mode_r 0 (T) or 1 (R).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* m, void* l, int dtype, int B, int H, int Hkv,
                                   int S, int T_len, int D, const long long* strides,
                                   float scale, int causal, int pump, int mode_r,
                                   void* stream) {
  if (D % 4 != 0 || D < 4 || D > 128 || Hkv < 1 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, o, static_cast<float*>(m), static_cast<float*>(l),
               B, H, Hkv, S, T_len, D, strides, scale, causal,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return by_dim<float>(pump, mode_r, a);
  if (dtype == 1) return by_dim<__nv_bfloat16>(pump, mode_r, a);
  return cudaErrorInvalidValue;
}
