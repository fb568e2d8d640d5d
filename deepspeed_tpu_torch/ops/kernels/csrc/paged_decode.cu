// Paged decode attention for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/attention/paged_pallas.py::_paged_kernel
// (pallas_call in paged_attention): one query token per row attends over
// its block table into a flat multi-layer K/V pool [NBt, bs, nkv, d], plus
// E "extra" columns of not-yet-cached K/V [T, E, nkv, d], with an fp32
// online softmax. Semantics kept exactly:
//   * pool key at position kpos is valid iff its block is not the trash id
//     and, with a pool limit, kpos < limit[t] && qpos >= 0, without one,
//     kpos <= qpos; with a window, also qpos - kpos < window;
//   * extra column e is valid iff epos >= 0 && epos <= qpos (and in window);
//   * q is scaled in fp32 (scale, else d^-0.5) before the dot product;
//   * GQA: query head h reads kv head h / (nh / nkv);
//   * a row with no valid key emits exactly 0;
//   * an int8 pool (dstt_paged_decode_int8) carries fp32 scale planes
//     [NBt, bs, nkv], one scalar per (token, kv head): key K = codes * scale
//     and likewise V; the extras stay in q's dtype.
//
// Bound: memory. Per row and kv head the kernel reads the valid keys' K and
// V once (2 * d * bytes each, plus two 4-byte scales for an int8 pool) and
// does 4 * group * d FLOPs per key: at group 4 that is ~4 FLOP/byte in
// bf16 (~8 in int8), far below the ~295 FLOP/byte ridge. The least time is
// the valid K/V bytes over HBM bandwidth.
//
// Design (simple first; split-K, TMA and wgmma come later):
//   * one block of 128 threads per (row, kv head, chunk of <= 8 query heads
//     of the group), so K/V of a kv head are read once for its whole group;
//   * the block computes the valid key range [lo, hi) from qpos, the limit
//     and the window, and walks only the table blocks that intersect it,
//     skipping trash blocks: masked keys are never read. Skipping them is
//     exact, since a masked key adds exp(-1e30 - m) = 0 to the softmax;
//   * keys go in tiles of up to 64 (16 KB of K and of V): all threads copy
//     the tile's K and V rows into shared memory with 16-byte loads, every
//     load of the tile in flight at once (a per-key load from device memory
//     in the inner loop left each thread waiting on one load at a time);
//     then 8 lanes score each key (a warp scores 4 keys at once, reduced
//     with 3 shuffles), one warp per query head updates the running max and
//     sum, and every thread folds the tile's P @ V into fp32 accumulators
//     for the head dims it owns;
//   * all pool offsets are 64-bit: the flat pool at Mistral-7B width holds
//     more than 2^31 elements;
//   * int8 pools: the tile keeps the int8 rows in shared memory (a tile of
//     codes is half a bf16 tile; dequantizing into fp32 would take 64 KB per
//     tile at d 128) and loads each key's two scales (stride nkv in their
//     planes) beside them. The K scale multiplies the key's score after the
//     dot product, the V scale the key's probability before P @ V, and the
//     softmax sum takes the probability unscaled: the same arithmetic as the
//     Pallas body's dequantize-then-dot up to fp32 rounding. Pool tiles and
//     extra-column tiles (q's dtype) share the shared memory as a union,
//     since they take turns; each has its own 16-byte loader.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 128;  // threads per block
constexpr int NW = NT / 32;
constexpr int GB = 8;   // query heads per block
constexpr int LPK = 8;  // lanes per key when scoring

// keys per tile: 16 KB of K (and of V) in shared memory, at most 64
template <typename T, int D>
constexpr int tile_keys() {
  return (16384 / (D * (int)sizeof(T))) < 64 ? 16384 / (D * (int)sizeof(T)) : 64;
}

template <typename E, int KT, int D>
struct Tile {
  E k[KT * D];  // the tile's K rows
  E v[KT * D];  // the tile's V rows
};

// T: q, extras and output; P: the pool (T, or int8 with scale planes)
template <typename T, typename P, int D>
struct Shared {
  static constexpr int KT = tile_keys<T, D>();
  union {
    Tile<T, KT, D> x;     // extra columns
    Tile<P, KT, D> pool;  // pool keys
  };
  float q[GB * D];   // scaled queries
  float p[GB * KT];  // scores, then probabilities (times the V scale)
  float ks[KT];      // K and V scales of the tile's keys (int8 pools)
  float vs[KT];
  int ok[KT];        // key valid
  float m[GB];       // running max
  float l[GB];       // running sum
  float a[GB];       // rescale factor of the current tile
};

// the pool tile or the extras tile of the shared memory
template <bool POOL, typename T, typename P, int D>
__device__ __forceinline__ auto& tile_of(Shared<T, P, D>& sh) {
  if constexpr (POOL) {
    return sh.pool;
  } else {
    return sh.x;
  }
}

// Copy nk rows of D elements (row stride `stride` elements) into the pool
// tile (POOL) or the extras tile with 16-byte loads; rows of invalid keys
// are zero-filled (their scores are masked, and P @ V must not meet NaN
// bit patterns). An int8 pool tile also takes each key's K and V scale
// (row stride `sstride` in the planes).
template <bool POOL, typename T, typename P, int D, typename E>
__device__ __forceinline__ void load_tile(Shared<T, P, D>& sh, const E* kbase, const E* vbase,
                                          int64_t stride, int nk, const int* epos_t, int qp,
                                          int window, const float* kscale, const float* vscale,
                                          int64_t sstride) {
  constexpr bool SCALED = POOL && std::is_same<P, int8_t>::value;
  constexpr int KT = Shared<T, P, D>::KT;
  constexpr int VPR = D * (int)sizeof(E) / 16;  // 16-byte vectors per row
  auto& tile = tile_of<POOL>(sh);
  const int tid = threadIdx.x;
  for (int kk = tid; kk < nk; kk += NT) {
    bool ok = true;
    if (epos_t != nullptr) {
      const int ep = epos_t[kk];
      ok = ep >= 0 && ep <= qp && !(window > 0 && qp - ep >= window);
    }
    sh.ok[kk] = ok;
    if constexpr (SCALED) {
      sh.ks[kk] = ok ? kscale[kk * sstride] : 0.f;
      sh.vs[kk] = ok ? vscale[kk * sstride] : 0.f;
    }
  }
  __syncthreads();
  // every load of this thread first, then every store: the loads of the
  // tile are all in flight together
  constexpr int ITER = (KT * VPR + NT - 1) / NT;
  uint4 kr[ITER], vr[ITER];
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int i = tid + it * NT;
    const int kk = i / VPR, c = i % VPR;
    kr[it] = make_uint4(0, 0, 0, 0);
    vr[it] = make_uint4(0, 0, 0, 0);
    if (i < nk * VPR && sh.ok[kk]) {
      kr[it] = reinterpret_cast<const uint4*>(kbase + kk * stride)[c];
      vr[it] = reinterpret_cast<const uint4*>(vbase + kk * stride)[c];
    }
  }
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int i = tid + it * NT;
    if (i < nk * VPR) {
      const int kk = i / VPR, c = i % VPR;
      reinterpret_cast<uint4*>(tile.k + kk * D)[c] = kr[it];
      reinterpret_cast<uint4*>(tile.v + kk * D)[c] = vr[it];
    }
  }
  __syncthreads();
}

template <bool POOL, typename T, typename P, int D>
__device__ __forceinline__ void run_tile(Shared<T, P, D>& sh,
                                         float (&acc)[GB][(D + NT - 1) / NT], int nk, int gc) {
  constexpr bool SCALED = POOL && std::is_same<P, int8_t>::value;
  constexpr int KT = Shared<T, P, D>::KT;
  const auto& tile = tile_of<POOL>(sh);
  constexpr int EPL = D / LPK;  // elements of a key row per lane
  constexpr int DPT = (D + NT - 1) / NT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane % LPK;

  // scores: 8 lanes per key, 4 keys per warp per pass
  for (int kk0 = warp * (32 / LPK); kk0 < nk; kk0 += NW * (32 / LPK)) {
    const int kk = kk0 + lane / LPK;
    // kk0 < nk <= KT and KT is a multiple of 4, so kk < KT; rows past nk
    // hold stale data whose scores are never written
    const bool ok = kk < nk && sh.ok[kk];
    float kf[EPL];
#pragma unroll
    for (int j = 0; j < EPL; j += 8) dstt::load_vec<8>(tile.k + kk * D + sub * EPL + j, kf + j);
    const float kscale = SCALED && kk < nk ? sh.ks[kk] : 1.f;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < gc) {
        const float* qg = sh.q + g * D + sub * EPL;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < EPL; ++j) s += qg[j] * kf[j];
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (sub == 0 && kk < nk) sh.p[g * KT + kk] = ok ? s * kscale : NEG_INF;
      }
    }
  }
  __syncthreads();

  // online-softmax statistics: one warp per query head
  for (int g = warp; g < gc; g += NW) {
    float s[2], pr[2];
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = lane + 32 * i;
      s[i] = j < nk ? sh.p[g * KT + j] : NEG_INF;
      mx = fmaxf(mx, s[i]);
    }
    const float m_old = sh.m[g];
    const float m_new = fmaxf(m_old, dstt::warp_max(mx));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      pr[i] = s[i] > 0.5f * NEG_INF ? expf(s[i] - m_new) : 0.f;
      sum += pr[i];
      const int j = lane + 32 * i;
      // the V scale rides on the probability; the sum takes it unscaled
      if (j < KT) sh.p[g * KT + j] = SCALED ? (j < nk ? pr[i] * sh.vs[j] : 0.f) : pr[i];
    }
    sum = dstt::warp_sum(sum);
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      sh.a[g] = alpha;
      sh.l[g] = sh.l[g] * alpha + sum;
      sh.m[g] = m_new;
    }
  }
  __syncthreads();

  // P @ V: each thread owns head dims tid, tid + NT, ...
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int c = tid + i * NT;
    if (c < D) {
#pragma unroll
      for (int g = 0; g < GB; ++g)
        if (g < gc) acc[g][i] *= sh.a[g];
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk) {
        const float vv = dstt::to_f(tile.v[kk * D + c]);
#pragma unroll
        for (int g = 0; g < GB; ++g)
          if (g < gc) acc[g][i] += sh.p[g * KT + kk] * vv;
      }
    }
  }
  __syncthreads();
}

template <typename T, typename P, int D>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const T* __restrict__ q, const P* __restrict__ kpool, const P* __restrict__ vpool,
    const float* __restrict__ kscale, const float* __restrict__ vscale,
    const int* __restrict__ tables, const int* __restrict__ qpos,
    const int* __restrict__ limit, const T* __restrict__ ke, const T* __restrict__ ve,
    const int* __restrict__ epos, T* __restrict__ out, int nh, int nkv, int bs, int B,
    int E, int trash, int window, float scale) {
  constexpr int KT = Shared<T, P, D>::KT;
  constexpr int DPT = (D + NT - 1) / NT;
  __shared__ __align__(16) Shared<T, P, D> sh;
  const int t = blockIdx.x, n = blockIdx.y;
  const int group = nh / nkv;
  const int g0 = blockIdx.z * GB;
  const int gc = min(GB, group - g0);
  const int head0 = n * group + g0;
  const int tid = threadIdx.x;
  const int qp = qpos[t];

  for (int i = tid; i < gc * D; i += NT) {
    sh.q[i] = dstt::to_f(q[((int64_t)t * nh + head0) * D + i]) * scale;
  }
  if (tid < gc) {
    sh.m[tid] = NEG_INF;
    sh.l[tid] = 0.f;
  }
  float acc[GB][DPT];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[g][i] = 0.f;
  __syncthreads();

  const int64_t stride = (int64_t)nkv * D;  // one token row of the pool
  // valid pool positions [lo, hi)
  int hi = limit != nullptr ? (qp >= 0 ? limit[t] : 0) : qp + 1;
  hi = min(hi, B * bs);
  const int lo = window > 0 ? max(0, qp - window + 1) : 0;
  if (lo < hi) {
    for (int j = lo / bs; j * bs < hi; ++j) {
      const int blk = tables[(int64_t)t * B + j];
      if (blk == trash) continue;
      const int k0 = max(lo, j * bs), k1 = min(hi, (j + 1) * bs);
      for (int kt = k0; kt < k1; kt += KT) {
        const int64_t key0 = (int64_t)blk * bs + (kt - j * bs);  // the tile's first token row
        const int64_t off = key0 * stride + (int64_t)n * D;
        const int64_t soff = key0 * nkv + n;
        const int nk = min(KT, k1 - kt);
        load_tile<true>(sh, kpool + off, vpool + off, stride, nk, nullptr, qp, window,
                        kscale == nullptr ? nullptr : kscale + soff,
                        vscale == nullptr ? nullptr : vscale + soff, (int64_t)nkv);
        run_tile<true>(sh, acc, nk, gc);
      }
    }
  }
  for (int e0 = 0; e0 < E; e0 += KT) {
    const int64_t off = ((int64_t)t * E + e0) * stride + (int64_t)n * D;
    const int nk = min(KT, E - e0);
    load_tile<false>(sh, ke + off, ve + off, stride, nk, epos + (int64_t)t * E + e0, qp, window,
                     nullptr, nullptr, 0);
    run_tile<false>(sh, acc, nk, gc);
  }

#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int c = tid + i * NT;
    if (c < D) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g < gc) {
          const bool any_valid = sh.m[g] > 0.5f * NEG_INF;
          const float o = any_valid ? acc[g][i] / fmaxf(sh.l[g], 1e-30f) : 0.f;
          out[((int64_t)t * nh + head0 + g) * D + c] = dstt::from_f<T>(o);
        }
      }
    }
  }
}

template <typename T, typename P, int D>
void launch(const void* q, const void* k, const void* v, const float* ks, const float* vs,
            const int* tables, const int* qpos, const int* limit, const void* ke,
            const void* ve, const int* epos, void* out, int n_tok, int nh, int nkv, int bs,
            int B, int E, int trash, int window, float scale, cudaStream_t stream) {
  const int group = nh / nkv;
  const dim3 grid((unsigned)n_tok, (unsigned)nkv, (unsigned)((group + GB - 1) / GB));
  paged_decode_kernel<T, P, D><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k), static_cast<const P*>(v), ks, vs,
      tables, qpos, limit, static_cast<const T*>(ke), static_cast<const T*>(ve), epos,
      static_cast<T*>(out), nh, nkv, bs, B, E, trash, window, scale);
}

// P = T (bf16/fp32 pool) or int8_t (with scale planes)
template <typename P>
int dispatch(int bf16, int d, const void* q, const void* k, const void* v, const float* ks,
             const float* vs, const int* tables, const int* qpos, const int* limit,
             const void* ke, const void* ve, const int* epos, void* out, int n_tok, int nh,
             int nkv, int bs, int B, int E, int trash, int window, float scale,
             cudaStream_t s) {
#define DSTT_PAGED_LAUNCH(T, D)                                                            \
  launch<T, std::conditional_t<std::is_same<P, int8_t>::value, int8_t, T>, D>(             \
      q, k, v, ks, vs, tables, qpos, limit, ke, ve, epos, out, n_tok, nh, nkv, bs, B, E,   \
      trash, window, scale, s)
  if (d != 64 && d != 128 && d != 256) return (int)cudaErrorInvalidValue;
  if (bf16) {
    if (d == 64) DSTT_PAGED_LAUNCH(__nv_bfloat16, 64);
    if (d == 128) DSTT_PAGED_LAUNCH(__nv_bfloat16, 128);
    if (d == 256) DSTT_PAGED_LAUNCH(__nv_bfloat16, 256);
  } else {
    if (d == 64) DSTT_PAGED_LAUNCH(float, 64);
    if (d == 128) DSTT_PAGED_LAUNCH(float, 128);
    if (d == 256) DSTT_PAGED_LAUNCH(float, 256);
  }
#undef DSTT_PAGED_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [n_tok, nh, d]; k, v: flat pool [NBt, bs, nkv, d]; tables:
// [n_tok, B] int32 block ids (layer-offset by the caller); qpos: [n_tok];
// limit: [n_tok] or null; ke, ve: [n_tok, E, nkv, d] and epos: [n_tok, E],
// or null with E = 0. All contiguous, one dtype (bf16=1 or fp32), pointers
// 16-byte aligned. window 0 = none. Returns cudaGetLastError() after launch
// (cudaErrorInvalidValue for an unsupported d).
extern "C" int dstt_paged_decode(const void* q, const void* k, const void* v,
                                 const int* tables, const int* qpos, const int* limit,
                                 const void* ke, const void* ve, const int* epos, void* out,
                                 int n_tok, int nh, int nkv, int d, int bs, int B, int E,
                                 int trash, int window, float scale, int bf16, void* stream) {
  return dispatch<void>(bf16, d, q, k, v, nullptr, nullptr, tables, qpos, limit, ke, ve, epos,
                        out, n_tok, nh, nkv, bs, B, E, trash, window, scale,
                        static_cast<cudaStream_t>(stream));
}

// The int8 pool form: k, v: int8 codes [NBt, bs, nkv, d]; ks, vs: fp32
// scale planes [NBt, bs, nkv]; q, out, ke, ve in bf16 (bf16=1) or fp32.
// Otherwise as dstt_paged_decode.
extern "C" int dstt_paged_decode_int8(const void* q, const void* k, const void* v,
                                      const float* ks, const float* vs, const int* tables,
                                      const int* qpos, const int* limit, const void* ke,
                                      const void* ve, const int* epos, void* out, int n_tok,
                                      int nh, int nkv, int d, int bs, int B, int E, int trash,
                                      int window, float scale, int bf16, void* stream) {
  return dispatch<int8_t>(bf16, d, q, k, v, ks, vs, tables, qpos, limit, ke, ve, epos, out,
                          n_tok, nh, nkv, bs, B, E, trash, window, scale,
                          static_cast<cudaStream_t>(stream));
}
