// Decode attention (one query token against the KV cache) for Hopper, sm_90a,
// split over the keys.
//
// Replaces the TPU kernel that src/repro/compiler/pallas_backend.py::emit_pallas
// emits in its carry form (pl.pallas_call at :784) over
// src/repro/core/autopump.py::_decode_attention_graph (:456).  No
// hand-written Pallas version of it exists; the emitter wrote it.
//
// Computes, per batch row b and q head h (kv head h / G, G = H / Hkv):
//   o[b, h] = softmax(q[b, h] * scale . k[b, h/G, t]  for t <= pos[b]) . v
// with an online softmax in fp32, NEG_INF = -1e30 for masked keys and
// l == 0 -> 1.  pos >= T keeps every key; pos < 0 masks them all, which
// NEG_INF turns into a uniform average over T keys, as in the reference.
// q is bf16 or fp32; k and v are fp32 or bf16, each read in its own dtype;
// o takes q's dtype.  The reference's emitted kernel casts every input to
// the graph dtype, which is q's (pallas_backend.py:996), so under bf16 it
// reads an fp32 cache rounded to bf16; this kernel reads the cache as it
// is.  In fp32 the two agree; in bf16 they differ by that rounding only.
//
// What bounds it on this card: bytes.  Each cache element is used for two
// FMAs, so the step reads (pos + 1) * Hkv * D * 2 elements per row and does
// almost no arithmetic per byte; the bound is that read over 3.35 TB/s
// (qwen3's serving step, B 8, 8 kv heads, 576 keys, D 128, fp32: 37.7 MB,
// 11.3 us).
//
// Design: split-KV ("flash-decoding") in one launch.
//  - A (kv head, batch row) pair's ceil(T / 64) key tiles are cut into S
//    splits of whole tiles, S = splits(B, Hkv, T, D, cache dtype), a
//    function of the shape alone (never of the pump or of pos), chosen so
//    that B * Hkv * S blocks fill the card's 132 SMs in one wave at the
//    blocks an SM holds (qwen3's step: S 2, 128 blocks, one an SM).  The S
//    blocks of a pair form a thread block cluster; block s walks split s.
//    Its G q heads share every staged K / V tile, so the cache is read
//    once, not G times.  Only keys t <= pos[b] are loaded; a split that
//    starts past pos loads nothing and leaves an empty partial (m =
//    NEG_INF, l = 0).
//  - Within a block, a ring of two cp.async transactions: the next one
//    loads while this one's tiles are computed; two barriers a transaction
//    and none inside it.
//  - Each of the 8 warps takes 8 keys of every tile and keeps its own
//    online-softmax state (m, l, acc) for the G heads, in base-2 units (q
//    is scaled by scale * log2 e, the weights are exp2), stepping 16 / NI
//    keys at a time: lanes run across D, 4 elements a (head, chunk) slot
//    and NI = 2 or 8 slots a lane (a head of fewer than 32 chunks takes a
//    power-of-two group of lanes), and a key's score is a shuffle sum over
//    the head's lanes.  The softmax needs no barrier across warps.
//  - The combine: each block folds its 8 warp partials in warp order in
//    shared memory; after cluster.sync() the cluster's rank 0 reads the S
//    block partials through distributed shared memory, folds them in split
//    order and writes o.  No workspace, no atomics; the same bits every run.
// The sums are taken in another order than the plain version's (per warp,
// then folded), so the two agree to fp32 rounding, not bit for bit.
//
// The pump (template PUMP, MODE_R):
//  - mode T: a transaction stages up to PUMP 64-key tiles of one split,
//    and the block runs one dependent beat per tile over it;
//  - mode R: a transaction stages one tile, and the value path, cut into
//    PUMP sub-tiles of D / PUMP dims, runs one dependent beat per sub-tile,
//    the lanes spread over the sub-tile (4 / PUMP dims each); the scores
//    contract the full head dim.
// Splits are fixed per shape, every warp sees the same keys of the same
// tiles, and every output element sums the same terms in the same order,
// so T1, T2, T4, R2 and R4 give the same bits.  Built set: a case is built
// where its ring fits 227 KB and a lane's slots fit NI = 8; at D 128 a T1
// ring is 128 KB for an fp32 cache and 64 KB for bf16, so T2 is built for
// a bf16 cache only and T4 from D 64 down; mode R needs D % (4 M) == 0.
// kernels/decode_attention.py::built, ::smem_bytes, ::lane_slots and
// ::splits mirror this file.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BKV = 64;       // keys per tile
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int KPW = BKV / WARPS;   // keys of a tile per warp
constexpr int RING = 2;            // transactions in flight
constexpr int MAX_SPLITS = 8;      // the portable cluster size
constexpr int SMS = 132;
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

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Copy 4 consecutive elements (16 bytes fp32, 8 bytes bf16) to shared
// memory.
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, __fmul_rn(a.x, b.x))));
}

// W consecutive elements as fp32 (W = 4, 2 or 1).
template <int W>
__device__ __forceinline__ void loadw(const float* p, float* out) {
  if constexpr (W == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (W == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void loadw(const __nv_bfloat16* p, float* out) {
  if constexpr (W == 4) {
    const float4 x = load4(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (W == 2) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = __bfloat162float(*p);
  }
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s),
                     __fmul_rn(a.w, s));
}

// Splits of a (kv head, batch row) pair: as many as fill the card's SMs
// in one wave at the blocks an SM holds with T1's ring (two tiles of K and
// V), at most MAX_SPLITS and one per tile, then evened out so every split
// holds ceil(tiles / S) tiles but the last.
int splits(int B, int Hkv, int T, int D, int isz) {
  const long long tiles = (T + BKV - 1) / BKV;
  const long long ring = (long long)RING * BKV * 2 * D * isz;
  const long long per_sm = ring > (long long)MAX_SMEM ? 1 : (long long)MAX_SMEM / ring;
  long long s = SMS * per_sm / ((long long)B * Hkv > 0 ? (long long)B * Hkv : 1);
  s = s < MAX_SPLITS ? s : MAX_SPLITS;
  s = s < tiles ? s : tiles;
  s = s > 1 ? s : 1;
  const long long tps = (tiles + s - 1) / s;
  return (int)((tiles + tps - 1) / tps);
}

// Shared memory of a case: the ring (two transactions of K and V panels
// in the cache dtype), which the partials reuse after the walk: the eight
// warps' (acc [G][D], then m and l [G][2]) and the block's (m, l [G][2]),
// in fp32.
size_t smem_bytes(int G, int D, int isz, int pump, bool mode_r) {
  const size_t tiles = mode_r ? 1 : pump;
  const size_t ring = RING * tiles * BKV * 2 * (size_t)D * isz;
  const size_t part = sizeof(float) * ((size_t)WARPS * G * (D + 2) + 2 * (size_t)G);
  return ring > part ? ring : part;
}

// The (head, chunk) slots a lane owns: G * P / 32 rounded up, P the
// head's 4-element chunks rounded up to a power of two.
int lane_slots(int G, int D) {
  int P = 1;
  while (P < D / 4) P <<= 1;
  return (G * P + 31) / 32;
}

// NI: slots a lane owns (2 or 8); KB: keys of a warp's online-softmax
// step, so that a batch's scores take NI * KB = 16 registers.  Scores are
// kept in base-2 units (q is scaled by scale * log2 e), so the weights are
// exp2 of them.
template <typename TKV, int PUMP, bool MODE_R, int NI>
__global__ void __launch_bounds__(THREADS)
decode_split(const void* __restrict__ q, const TKV* __restrict__ k,
             const TKV* __restrict__ v, const int* __restrict__ pos,
             void* __restrict__ o, int q_bf16, int H, int Hkv, int T, int D,
             float qscale, int nsplit) {
  constexpr int TILES = MODE_R ? 1 : PUMP;   // K / V tiles of one transaction
  constexpr int SUBS = MODE_R ? PUMP : 1;    // value sub-tiles, one beat each
  constexpr int W = 4 / SUBS;                // elements a lane takes a beat
  constexpr int KB = 16 / NI;
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = H / Hkv;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C4 = D / 4;                      // 4-element chunks of a row
  const int DV = D / SUBS;                   // dims of a value sub-tile
  int P = 1;
  while (P < C4) P <<= 1;                    // chunk slots a head takes
  const int LP = __ffs(P) - 1;
  const int LG = P < 32 ? P : 32;            // lanes a head's sum runs over
  const int PER = P > 32 ? P >> 5 : 1;       // slots of one head in a lane
  const size_t slot_elems = (size_t)TILES * BKV * D;   // K (or V) of a slot
  TKV* ring = reinterpret_cast<TKV*>(smem4);

  // this split's tiles, cut at the last one that holds a valid key
  const int p = pos[b];
  const int n_keys = (p < 0 || p >= T) ? T : p + 1;
  const int tiles = (T + BKV - 1) / BKV;
  const int tps = (tiles + nsplit - 1) / nsplit;
  const int tile_lo = split * tps;
  const int tile_hi = min(min(tile_lo + tps, tiles), (n_keys + BKV - 1) / BKV);
  const int ntx = tile_hi > tile_lo ? (tile_hi - tile_lo + TILES - 1) / TILES : 0;
  const long long base = ((long long)b * Hkv + hk) * (long long)T * D;

  // one transaction: the K rows and V rows of its valid keys, contiguous in
  // the cache and in the slot
  auto stage = [&](int x) {
    TKV* ks = ring + (x % RING) * 2 * slot_elems;
    TKV* vs = ks + slot_elems;
    const int t0 = (tile_lo + x * TILES) * BKV;
    const int t1 = min(min(t0 + TILES * BKV, tile_hi * BKV), n_keys);
    const int n4 = (t1 - t0) * C4;
    const TKV* kg = k + base + (long long)t0 * D;
    const TKV* vg = v + base + (long long)t0 * D;
    for (int u = tid; u < n4; u += THREADS) {
      cp_async4(ks + 4 * u, kg + 4 * u);
      cp_async4(vs + 4 * u, vg + 4 * u);
    }
  };
#pragma unroll
  for (int x = 0; x < RING - 1; ++x) {
    if (x < ntx) stage(x);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // slot i of this lane: flat index u = lane + 32 i over (head, chunk) with
  // chunk pitch P: head g = u >> LP, chunk c = u & (P - 1).  Its query
  // elements are 4c .. 4c + 3; its output elements, in beat sub, e < W, are
  // sub * DV + c * W + e, accumulated in acc[i][sub * W + e].
  const long long qo = ((long long)b * H + (long long)hk * G) * D;
  float4 qr[NI];
  float acc[NI][4];
  float m[NI], l[NI];
  bool live[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int u = lane + 32 * i, g = u >> LP, c = u & (P - 1);
    live[i] = g < G && c < C4;
    const long long at = qo + g * D + 4 * c;
    qr[i] = !live[i] ? make_float4(0.f, 0.f, 0.f, 0.f)
            : scale4(q_bf16 ? load4(static_cast<const __nv_bfloat16*>(q) + at)
                            : load4(static_cast<const float*>(q) + at), qscale);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  const int c0 = lane & (P - 1);   // the chunk of every slot when P <= 32

#pragma unroll 1
  for (int x = 0; x < ntx; ++x) {
    // the slot of transaction x - 1 takes x + RING - 1; x has landed after
    if (x + RING - 1 < ntx) stage(x + RING - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 1));
    __syncthreads();   // transaction x has landed for every thread
    const TKV* ks = ring + (x % RING) * 2 * slot_elems;
    const TKV* vs = ks + slot_elems;
#pragma unroll 1
    for (int beat = 0; beat < TILES; ++beat) {   // one beat per 64-key tile
      const int tb = (tile_lo + x * TILES + beat) * BKV;
      if (tb >= tile_hi * BKV || tb >= n_keys) break;
      const int nk = max(0, min(KPW, min(BKV, n_keys - tb) - warp * KPW));
      const TKV* kt = ks + (size_t)(beat * BKV + warp * KPW) * D;
      const TKV* vt = vs + (size_t)(beat * BKV + warp * KPW) * D;
#pragma unroll 1
      for (int k0 = 0; k0 < nk; k0 += KB) {   // one online-softmax step
        // the scores of KB keys: each lane's partial dot products, then a
        // shuffle sum over the lanes of each head
        float s[KB][NI];
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          const bool ok = k0 + j < nk;
          const TKV* row = kt + (size_t)(k0 + j) * D;
          const float4 kv0 = ok && c0 < C4 ? load4(row + 4 * c0) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            const int c = (lane + 32 * i) & (P - 1);
            const float4 kv = P <= 32 ? kv0
                              : (ok && c < C4 ? load4(row + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f));
            s[j][i] = dot4(qr[i], kv);
          }
          // a head wider than 32 chunks: its slots summed in order first
#pragma unroll
          for (int i = 1; i < NI; ++i)
            if (i & (PER - 1)) s[j][i] = __fadd_rn(s[j][i - 1], s[j][i]);
        }
        for (int off = LG >> 1; off > 0; off >>= 1) {
#pragma unroll
          for (int j = 0; j < KB; ++j)
#pragma unroll
            for (int i = 0; i < NI; ++i)
              s[j][i] = __fadd_rn(s[j][i], __shfl_xor_sync(0xffffffffu, s[j][i], off));
        }
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          // the head's sum sits in its last slot: copy it down the group
#pragma unroll
          for (int i = NI - 2; i >= 0; --i)
            if ((i + 1) & (PER - 1)) s[j][i] = s[j][i + 1];
          if (tb + warp * KPW + k0 + j > p)
#pragma unroll
            for (int i = 0; i < NI; ++i) s[j][i] = NEG_INF;
        }

        // the online-softmax step: scores become weights, keys past the
        // tile's valid ones weigh 0
        float alpha[NI];
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          float mt = NEG_INF;
#pragma unroll
          for (int j = 0; j < KB; ++j)
            if (k0 + j < nk) mt = fmaxf(mt, s[j][i]);
          const float mn = fmaxf(m[i], mt);
          alpha[i] = exp2f(m[i] - mn);
          m[i] = mn;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            s[j][i] = k0 + j < nk ? exp2f(s[j][i] - mn) : 0.f;
            sum = __fadd_rn(sum, s[j][i]);
          }
          l[i] = fmaf(l[i], alpha[i], sum);
        }

        // the value path: one beat per sub-tile of DV dims, W of them a
        // lane; with one chunk a lane (P <= 32) every slot reads the same
        // values
#pragma unroll
        for (int sub = 0; sub < SUBS; ++sub) {
          float vv[KB][W];
#pragma unroll
          for (int j = 0; j < KB; ++j)
            if (k0 + j < nk && c0 < C4)
              loadw<W>(vt + (size_t)(k0 + j) * D + sub * DV + c0 * W, vv[j]);
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            if (!live[i]) continue;
            const int c = (lane + 32 * i) & (P - 1);
#pragma unroll
            for (int e = 0; e < W; ++e) acc[i][sub * W + e] = __fmul_rn(acc[i][sub * W + e], alpha[i]);
#pragma unroll
            for (int j = 0; j < KB; ++j) {
              if (k0 + j >= nk) continue;
              float w[W];
              if (P <= 32) {
#pragma unroll
                for (int e = 0; e < W; ++e) w[e] = vv[j][e];
              } else {
                loadw<W>(vt + (size_t)(k0 + j) * D + sub * DV + c * W, w);
              }
#pragma unroll
              for (int e = 0; e < W; ++e)
                acc[i][sub * W + e] = fmaf(s[j][i], w[e], acc[i][sub * W + e]);
            }
          }
        }
      }
    }
    __syncthreads();   // every warp is done with slot x % RING
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // the warp partials, over the ring: acc [WARPS][G][D], m and l
  // [WARPS][G][2], then the block's m and l [G][2]
  float* pa = reinterpret_cast<float*>(smem4);
  float* pml = pa + WARPS * G * D;
  float* bml = pml + WARPS * G * 2;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int u = lane + 32 * i, g = u >> LP, c = u & (P - 1);
    if (!live[i]) continue;
    float* dst = pa + (warp * G + g) * D;
#pragma unroll
    for (int sub = 0; sub < SUBS; ++sub)
#pragma unroll
      for (int e = 0; e < W; ++e) dst[sub * DV + c * W + e] = acc[i][sub * W + e];
    if (c == 0) {
      pml[(warp * G + g) * 2] = m[i];
      pml[(warp * G + g) * 2 + 1] = l[i];
    }
  }
  __syncthreads();

  // the block's partial: the warps' folded in warp order, acc into warp
  // 0's place
  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, pml[(w * G + g) * 2]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(pml[(w * G + g) * 2] - mx);
      lsum = fmaf(pml[(w * G + g) * 2 + 1], f, lsum);
      a = fmaf(pa[w * G * D + e], f, a);
    }
    pa[e] = a;
    if (e == g * D) {
      bml[2 * g] = mx;
      bml[2 * g + 1] = lsum;
    }
  }
  cluster.sync();   // every split's partial is visible to the cluster

  if (split == 0) {
    // the splits' partials folded in split order
    for (int e = tid; e < G * C4; e += THREADS) {
      const int g = e / C4, c = e - g * C4;
      float mx = NEG_INF;
      for (int r = 0; r < nsplit; ++r)
        mx = fmaxf(mx, cluster.map_shared_rank(bml, r)[2 * g]);
      float lsum = 0.f;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = 0; r < nsplit; ++r) {
        const float* rml = cluster.map_shared_rank(bml, r);
        const float f = exp2f(rml[2 * g] - mx);
        lsum = fmaf(rml[2 * g + 1], f, lsum);
        const float4 x = load4(cluster.map_shared_rank(pa, r) + g * D + 4 * c);
        a = make_float4(fmaf(x.x, f, a.x), fmaf(x.y, f, a.y), fmaf(x.z, f, a.z),
                        fmaf(x.w, f, a.w));
      }
      const float inv = lsum == 0.f ? 1.f : lsum;
      const float4 out = make_float4(__fdiv_rn(a.x, inv), __fdiv_rn(a.y, inv),
                                     __fdiv_rn(a.z, inv), __fdiv_rn(a.w, inv));
      const long long at = qo + g * D + 4 * c;
      if (q_bf16)
        store4(static_cast<__nv_bfloat16*>(o) + at, out);
      else
        store4(static_cast<float*>(o) + at, out);
    }
  }
  cluster.sync();   // rank 0 has read every block's shared memory
}

template <typename TKV, int PUMP, bool MODE_R, int NI>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos, void* o,
                   int q_bf16, int B, int H, int Hkv, int T, int D, float scale,
                   cudaStream_t stream) {
  const int isz = (int)sizeof(TKV);
  const size_t smem = smem_bytes(H / Hkv, D, isz, PUMP, MODE_R);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;  // not built
  auto kernel = decode_split<TKV, PUMP, MODE_R, NI>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int S = splits(B, Hkv, T, D, isz);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, Hkv, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, q, static_cast<const TKV*>(k),
                           static_cast<const TKV*>(v), static_cast<const int*>(pos), o,
                           q_bf16, H, Hkv, T, D, scale * 1.4426950408889634f, S);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TKV, int PUMP, bool MODE_R>
cudaError_t by_width(const void* q, const void* k, const void* v, const void* pos, void* o,
                     int q_bf16, int B, int H, int Hkv, int T, int D, float scale,
                     cudaStream_t s) {
  const int ni = lane_slots(H / Hkv, D);
  if (ni <= 2)
    return launch<TKV, PUMP, MODE_R, 2>(q, k, v, pos, o, q_bf16, B, H, Hkv, T, D, scale, s);
  if (ni <= 8)
    return launch<TKV, PUMP, MODE_R, 8>(q, k, v, pos, o, q_bf16, B, H, Hkv, T, D, scale, s);
  return cudaErrorInvalidValue;
}

template <typename TKV>
cudaError_t by_pump(int pump, int mode_r, const void* q, const void* k, const void* v,
                    const void* pos, void* o, int q_bf16, int B, int H, int Hkv, int T,
                    int D, float scale, cudaStream_t s) {
  if (!mode_r || pump == 1) {
    switch (pump) {
      case 1: return by_width<TKV, 1, false>(q, k, v, pos, o, q_bf16, B, H, Hkv, T, D, scale, s);
      case 2: return by_width<TKV, 2, false>(q, k, v, pos, o, q_bf16, B, H, Hkv, T, D, scale, s);
      case 4: return by_width<TKV, 4, false>(q, k, v, pos, o, q_bf16, B, H, Hkv, T, D, scale, s);
    }
  } else if (D % (4 * pump) == 0) {
    switch (pump) {
      case 2: return by_width<TKV, 2, true>(q, k, v, pos, o, q_bf16, B, H, Hkv, T, D, scale, s);
      case 4: return by_width<TKV, 4, true>(q, k, v, pos, o, q_bf16, B, H, Hkv, T, D, scale, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The splits the kernel takes for a shape (kv_dtype 0 = float32, 1 =
// bfloat16); kernels/decode_attention.py::splits is the same function.
extern "C" int decode_attention_splits(int B, int Hkv, int T, int D, int kv_dtype) {
  return splits(B, Hkv, T, D, kv_dtype ? 2 : 4);
}

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16.  q (B, H, D), k / v
// (B, Hkv, T, D), pos (B,) int32 and o (B, H, D) are contiguous and 16-byte
// aligned.  Needs D % 4 == 0 and lane_slots(H / Hkv, D) <= 8; pump 1, 2 or
// 4, mode_r 0 (T) or 1 (R, which needs D % (4 pump) == 0).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* pos, void* o, int q_dtype, int kv_dtype,
                                    int B, int H, int Hkv, int T, int D, float scale,
                                    int pump, int mode_r, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 != 0 || Hkv < 1 || H % Hkv != 0 || T < 1 || q_dtype < 0 || q_dtype > 1)
    return cudaErrorInvalidValue;
  if (kv_dtype == 0)
    return by_pump<float>(pump, mode_r, q, k, v, pos, o, q_dtype, B, H, Hkv, T, D, scale, s);
  if (kv_dtype == 1)
    return by_pump<__nv_bfloat16>(pump, mode_r, q, k, v, pos, o, q_dtype, B, H, Hkv, T, D,
                                  scale, s);
  return cudaErrorInvalidValue;
}
