// Splash (scheduled block-sparse) attention backward for Hopper (sm_90a):
// two kernels, dq and dk/dv.
//
// Replaces: deepspeed_tpu/ops/sparse_attention/splash_pallas.py::
// _splash_bwd_dq_kernel and ::_splash_bwd_dkv_kernel (the two pallas_calls
// in _splash_vjp_bwd). Both recompute p = exp(q k^T * scale - lse) from the
// forward's fp32 log-sum-exp over the scheduled steps only, with the
// forward's rule for a kept pair, and take delta = sum(do * o) in the
// kernel; ds = p * (do v^T - delta) is rounded to bf16 before its products.
//
// Bound: operations. dq does 3 products of 2 * d FLOPs per kept (query, key)
// pair (q k^T, do v^T, ds k), dk/dv 4 (q k^T, do v^T, p^T do, ds^T q); the
// bytes are a few reads of q, k, v, o, do.
//
// Design:
//  * dq (flash_common.cuh's per-tile body dq_tile with splash's rule for a
//    kept pair; CTAs of 4 warps on mma.sync, each warp owning 16 rows): one
//    CTA per (64-query tile, b * h); walks the kv blocks of its schedule row
//    (kind-0 steps skipped, each block as 64-key tiles); dQ += dS K; scaled
//    once at the end.
//  * dk/dv: the flash dk/dv CTA body (flash_hopper_bwd.cuh's dkv_cta: a
//    producer warp's TMA loads into a ring of query-tile stages, two warps
//    taking delta per stage, two consumer warpgroups on wgmma summing dV +=
//    P^T dO and dK += dS^T Q over the GQA group in fp32, rounded once) on a
//    scheduled walk (SplashWalk below): one CTA per (KV_BK keys, b * h_kv)
//    walks, query tile outer and the group's heads inner as flash does, the
//    query blocks its rows of the transposed schedule (q_index,
//    step_kind_t) list, each as 64-row tiles in ascending order. The kv
//    block of each 64-key half of the CTA's keys has its own rows (blocks of
//    64 keys put two in a 128-key CTA), a per-head schedule one row per
//    head: the producer warp merges them, a lane a row, and hands over each
//    (tile, head) some row lists with the step kind of each half. Kind-0
//    steps, and PARTIAL tiles the causal bound or the band leave empty, are
//    dropped before any copy; a head whose rows skip the tile skips it. The
//    consumers apply the kept-pair rule (splash_common.cuh's kept) only on
//    PARTIAL steps and for runtime segment ids; a FULL step has no
//    predicate. Over a schedule shared by the heads, the walk visits a
//    superset of flash's query tiles for the same window, in flash's order,
//    and a tile the mask leaves dead adds exactly 0: dk and dv equal flash
//    dk/dv's. The flash kernels instantiate the same body with FlashWalk.
#include "flash_hopper_bwd.cuh"
#include "splash_common.cuh"

namespace {

using namespace dstt::flash;
using SplashProblem = dstt::splash::Problem;
using dstt::splash::Schedule;
using dstt::splash::PARTIAL;
using dstt::splash::SKIP;

template <int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(bf16) * 4 * TILE * (D + PAD_H) + sizeof(float) * 2 * TILE +
         sizeof(int) * 2 * TILE;
}

// ---------------------------------------------------------------------------
// At d <= 128 the register cap of 3 CTAs per SM (168 a thread, what
// flash_dq_kernel takes uncapped) keeps a third tile's loads in flight; left
// to itself ptxas gives this kernel ~244 registers and 2 CTAs per SM.
template <int D>
__global__ void __launch_bounds__(NTHREADS, D <= 128 ? 3 : 1) splash_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    bf16* __restrict__ dq, SplashProblem p, Schedule sc) {
  constexpr int LD = D + PAD_H;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + TILE * LD;
  bf16* Ks = dOs + TILE * LD;
  bf16* Vs = Ks + TILE * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + TILE * LD);
  float* delta_s = lse_s + TILE;
  int* segq = reinterpret_cast<int*>(delta_s + TILE);
  int* segk = segq + TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * TILE;
  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh % p.h;
  const int kvh = hi / (p.h / p.h_kv);
  const int64_t qoff = (int64_t)bh * p.sq * D;
  const bf16* kb = k + ((int64_t)bi * p.h_kv + kvh) * p.sk * D;
  const bf16* vb = v + ((int64_t)bi * p.h_kv + kvh) * p.sk * D;
  const int* seg = p.seg ? p.seg + (int64_t)bi * p.sq : nullptr;

  const int hs = sc.heads == 1 ? 0 : hi;
  const int64_t row = ((int64_t)hs * sc.rows + q0 / sc.bq) * sc.width;
  const int* idx = sc.index + row;
  const int* knd = sc.kind + row;

  load_tile<TILE, D>(Qs, q + qoff, q0, p.sq);
  load_tile<TILE, D>(dOs, dout + qoff, q0, p.sq);
  if (tid < TILE) {
    lse_s[tid] = q0 + tid < p.sq ? lse[(int64_t)bh * p.sq + q0 + tid] : 0.f;
    if (seg) segq[tid] = q0 + tid < p.sq ? seg[q0 + tid] : 0;
  }
  __syncthreads();
  row_delta<D>(dOs, o + qoff, q0, p.sq, delta_s);
  __syncthreads();

  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;
  const int row0 = q0 + lr0, row1 = q0 + lr1;
  const int sr0 = seg ? segq[lr0] : 0, sr1 = seg ? segq[lr1] : 0;
  const float lse_r[2] = {lse_s[lr0], lse_s[lr1]};
  const float del_r[2] = {delta_s[lr0], delta_s[lr1]};
  const int q_last = min(q0 + TILE, p.sq) - 1;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int step = 0; step < sc.width; ++step) {
    const int kind = knd[step];
    if (kind == SKIP) continue;
    const int k_lo = idx[step] * sc.bk;
    const int k_hi = min(k_lo + sc.bk, p.sk);
    for (int k0 = k_lo; k0 < k_hi; k0 += TILE) {
      if (kind == PARTIAL && dstt::splash::tile_dropped(p, p.base + q0, p.base + q_last, k0,
                                                        min(k0 + TILE, k_hi) - 1)) {
        continue;  // a partial block's tile that keeps no pair
      }
      __syncthreads();  // the previous tile's readers of Ks, Vs and segk are done
      if (seg && tid < TILE) segk[tid] = k0 + tid < p.sk ? seg[k0 + tid] : 0;
      load_tile<TILE, D>(Ks, kb, k0, p.sk);
      load_tile<TILE, D>(Vs, vb, k0, p.sk);
      __syncthreads();

      dq_tile<D>(acc, Qs, dOs, Ks, Vs, p.scale, lse_r, del_r, [&](int c, bool upper) {
        const int r = upper ? row0 : row1;
        return r < p.sq && k0 + c < k_hi &&
               dstt::splash::kept(p, kind, p.base + r, k0 + c, upper ? sr0 : sr1,
                                  seg ? segk[c] : 0);
      }, warp, lane);
    }
  }
  store_rows<D, D>(dq + qoff, acc, p.scale, row0, row1, p.sq, 0, lane);
}

// ---------------------------------------------------------------------------
namespace fh = dstt::flash_hopper;
namespace hp = dstt::hopper;
using dstt::splash::FULL;

// The scheduled walk of a dk/dv CTA (flash_hopper_bwd.cuh's FlashWalk
// describes the interface). A stage's kind per 64-key half: SKIP (the half
// keeps no pair: every p is 0), PARTIAL or FULL.
struct SplashWalk {
  static constexpr bool SCHEDULED = true;
  const int* index;  // q_index [heads, nk, width]
  const int* kind;   // step_kind_t [heads, nk, width]
  int heads, nk, width, bq, bk;
  int sq;            // query rows (the keys are the problem's s)
  int causal, window;
  int seg, seg_all;  // segment ids present; they mask every step (else PARTIAL steps)

  // a PARTIAL tile of queries [q_lo, q_hi] x keys [k_lo, k_hi] that keeps
  // no pair (splash_common.cuh's tile_dropped at base 0)
  __device__ __forceinline__ bool dropped(int q_lo, int q_hi, int k_lo, int k_hi) const {
    return (causal && k_lo > q_hi) || (window && q_lo - k_hi >= window);
  }

  // is every pair of a stage of this kind, queries [q0, q_end) x keys
  // [k_lo, k_hi], kept? (a FULL step inside the sequence; a PARTIAL one
  // whose tile the causal bound and the band keep whole, as flash's rule)
  __device__ __forceinline__ bool whole(int knd, int q0, int q_end, int k_lo, int k_hi,
                                        int sk) const {
    if (knd == SKIP || (seg && (seg_all || knd == PARTIAL)) || q_end > sq || k_hi >= sk)
      return false;
    return knd == FULL || ((!causal || k_hi <= q0) && (!window || q_end - 1 - k_lo < window));
  }

  // is the pair (query q, key k) of a step of this kind kept?
  __device__ __forceinline__ bool keep(int knd, int q, int k, int q_id, int k_id, int sk) const {
    if (knd == SKIP || q >= sq || k >= sk) return false;
    if (knd == PARTIAL && ((causal && k > q) || (window && q - k >= window))) return false;
    return !(seg && (seg_all || knd == PARTIAL) && q_id != k_id);
  }

  // The producer warp's walk: lane c < rows keeps a cursor over row c of
  // the transposed schedule (the block of half c / nh, head c % nh); the
  // smallest query block any cursor points at is next, walked as 64-row
  // tiles, the group's heads inner; the cursors at it move on. Returns the
  // stages issued.
  template <int D>
  __device__ __forceinline__ int produce(const fh::DkvSmem<D, true>& sm,
                                         const CUtensorMap* const* maps, const Problem& p,
                                         const fh::KvTile& kt, int lane) const {
    using T = fh::BwdTiles<D>;
    constexpr int BQ = T::KV_BQ, S = T::KV_STAGES, IDS = BQ / 32, HALVES = T::KV_BK / 64;
    constexpr int NONE = 0x7fffffff;
    const int group = p.h / p.h_kv, head0 = kt.bi * p.h + kt.kvh * group;
    const int nh = heads == 1 ? 1 : group;
    int kb[HALVES];  // the kv block of each half's keys (-1: past the keys)
#pragma unroll
    for (int a = 0; a < HALVES; ++a) {
      const int key = kt.k0 + 64 * a;
      kb[a] = key < p.s ? (nk == 1 ? 0 : key / bk) : -1;
    }
    const int nkb = HALVES == 2 && kb[HALVES - 1] >= 0 && kb[HALVES - 1] != kb[0] ? 2 : 1;
    const int a = lane / nh, hs = lane - a * nh;
    const bool mine = lane < nkb * nh;
    const int64_t row =
        mine ? ((int64_t)(heads == 1 ? 0 : kt.kvh * group + hs) * nk + kb[a]) * width : 0;
    auto block_at = [&](int j) {
      return mine && j < width && kind[row + j] != SKIP ? index[row + j] : NONE;
    };
    int pos = 0, cur = block_at(0);
    const int kmin = sm.krange[0], kmax = sm.krange[1];
    int it = 0;
    for (;;) {
      const int qb = __reduce_min_sync(0xffffffffu, cur);
      if (qb == NONE) break;
      const int mk = cur == qb ? kind[row + pos] : SKIP;  // this row's kind at block qb
      const int q_lo = qb * bq, q_end = min(q_lo + bq, sq);
      for (int q0 = q_lo; q0 < q_end; q0 += BQ) {
        int ids[IDS];
        if (seg) {
          bool hit = false;
#pragma unroll
          for (int j = 0; j < IDS; ++j) {
            const int qpos = q0 + lane * IDS + j;
            ids[j] = qpos < sq ? kt.segq[qpos] : 0;
            hit |= qpos < sq && ids[j] >= kmin && ids[j] <= kmax;
          }
          if (seg_all && !__any_sync(0xffffffffu, hit)) continue;  // no id of the keys'
        }
        const int q_last = min(q0 + BQ, q_end) - 1;
        for (int gq = 0; gq < group; ++gq) {
          const int c = nh == 1 ? 0 : gq;
          int kd[HALVES];
#pragma unroll
          for (int h2 = 0; h2 < HALVES; ++h2) {
            const int k_lo = kt.k0 + 64 * h2;
            kd[h2] = __shfl_sync(0xffffffffu, mk, (h2 && nkb == 2 ? nh : 0) + c);
            if (kb[h2] < 0 ||
                (kd[h2] == PARTIAL && dropped(q0, q_last, k_lo, min(k_lo + 64, p.s) - 1)))
              kd[h2] = SKIP;
          }
          if (kd[0] == SKIP && kd[HALVES - 1] == SKIP) continue;
          const int st = it % S;
          hp::mbar_wait(&sm.empty[st], ((it / S) & 1) ^ 1);
          if (seg) {
#pragma unroll
            for (int j = 0; j < IDS; ++j) sm.ids[st * BQ + lane * IDS + j] = ids[j];
          }
          if (lane == 0) {
            sm.q0s[st] = q0;
            sm.heads[st] = head0 + gq;
            sm.kinds[2 * st] = kd[0];
            sm.kinds[2 * st + 1] = kd[HALVES - 1];
            hp::mbar_arrive(&sm.info[st]);
            hp::mbar_arrive_expect_tx(&sm.full[st], fh::DkvSmem<D, true>::STAGE);
#pragma unroll
            for (int cb = 0; cb < D / 64; ++cb) {
              hp::tma_load_3d(sm.q(st) + cb * BQ * 128, maps[2], &sm.full[st], 64 * cb, q0,
                              head0 + gq);
              hp::tma_load_3d(sm.dout(st) + cb * BQ * 128, maps[3], &sm.full[st], 64 * cb, q0,
                              head0 + gq);
              hp::tma_load_3d(sm.o(st) + cb * BQ * 128, maps[4], &sm.full[st], 64 * cb, q0,
                              head0 + gq);
            }
          } else {
            hp::mbar_arrive(&sm.full[st]);  // after this lane's ids
          }
          ++it;
        }
      }
      if (cur == qb) cur = block_at(++pos);
    }
    return it;
  }
};

// maps: k, v, q, dO, o (fh::encode_dkv_maps)
template <int D>
__global__ void __launch_bounds__(fh::THREADS, 1)
    splash_dkv_kernel(const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap domap,
                      const __grid_constant__ CUtensorMap omap, const float* __restrict__ lse,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, Problem p, SplashWalk walk) {
  extern __shared__ unsigned char smem_raw[];
  const CUtensorMap* maps[5] = {&kmap, &vmap, &qmap, &domap, &omap};
  const fh::KvTile kt = fh::make_kv_tile<D>(p, p.seg, p.seg);
  fh::dkv_cta<D>(
      smem_raw, maps, p, kt, lse,
      [&](auto& dka, auto& dva, int, int, int, int) {
        fh::acc_zero(dka);
        fh::acc_zero(dva);
      },
      [&](const auto& dka, const auto& dva, int key0, int key1, int c0, int tq) {
        constexpr int DC = 2 * (int)(sizeof(dka) / sizeof(float));
        const int64_t at = (int64_t)blockIdx.x * p.s * D;  // the CTA's (batch, kv head)
        fh::acc_store_bf16<DC>(dk + at, dka, p.scale, key0, key1, p.s, c0, D, tq);
        fh::acc_store_bf16<DC>(dv + at, dva, 1.f, key0, key1, p.s, c0, D, tq);
      },
      walk);
}

// ---------------------------------------------------------------------------
template <int D>
int launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
              const float* lse, bf16* dq, const SplashProblem& p, const Schedule& sc,
              cudaStream_t stream) {
  const size_t bytes = bwd_smem_bytes<D>();
  static size_t have = 0;
  if (int e = set_max_smem(splash_dq_kernel<D>, bytes, have)) return e;
  const dim3 grid((unsigned)(p.b * p.h), (unsigned)((p.sq + TILE - 1) / TILE));
  splash_dq_kernel<D><<<grid, NTHREADS, bytes, stream>>>(q, k, v, o, dout, lse, dq, p, sc);
  return (int)cudaGetLastError();
}

// Rows of the transposed schedule a dk/dv CTA's producer merges, a lane
// each: the kv blocks of its 64-key halves times the schedule's heads of a
// GQA group.
int walk_rows(int d, const SplashWalk& w, int group) {
  const int kv_bk = d == 256 ? 64 : 128;
  const int blocks = kv_bk == 128 && w.nk > 1 && w.bk % kv_bk ? 2 : 1;
  return blocks * (w.heads == 1 ? 1 : group);
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dk, void* dv, const Problem& p, const SplashWalk& w,
               cudaStream_t stream) {
  CUtensorMap maps[5];
  if (int e = fh::encode_dkv_maps<D>(maps, q, dout, o, k, v, p, w.sq)) return e;
  constexpr int bytes = fh::DkvSmem<D, true>::BYTES;
  static size_t have = 0;
  if (int e = set_max_smem(splash_dkv_kernel<D>, bytes, have)) return e;
  splash_dkv_kernel<D><<<fh::dkv_grid<D>(p), fh::THREADS, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], lse, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), p, w);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, do, dq: [b, h, sq, d] bf16; k, v: [b, h_kv, sk, d] bf16; lse: [b, h,
// sq] fp32 from dstt_splash_fwd; seg [b, s] int32 or null; kv_index,
// step_kind: [sched_heads, nq, width] int32; all contiguous, the bf16
// tensors 16-byte aligned; block_q a multiple of 64 or nq == 1. Returns
// cudaGetLastError().
extern "C" int dstt_splash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, const void* seg,
                                  const void* kv_index, const void* step_kind, void* dq, int b,
                                  int h, int h_kv, int sq, int sk, int d, float scale,
                                  int sched_heads, int nq, int width, int block_q, int block_kv,
                                  int causal, int window, int seg_all, void* stream) {
  if (!dstt::splash::blocks_ok(block_q, nq)) return (int)cudaErrorInvalidValue;
  SplashProblem p{b, h, h_kv, sq, sk, scale, causal, window,
                  static_cast<const int*>(seg), seg_all, 0};
  Schedule sc{static_cast<const int*>(kv_index), static_cast<const int*>(step_kind),
              sched_heads, nq, width, block_q, block_kv};
  auto Q = static_cast<const bf16*>(q), K = static_cast<const bf16*>(k),
       V = static_cast<const bf16*>(v), O = static_cast<const bf16*>(o),
       dO = static_cast<const bf16*>(dout);
  auto L = static_cast<const float*>(lse);
  auto dQ = static_cast<bf16*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dq<64>(Q, K, V, O, dO, L, dQ, p, sc, st);
    case 128: return launch_dq<128>(Q, K, V, O, dO, L, dQ, p, sc, st);
    case 256: return launch_dq<256>(Q, K, V, O, dO, L, dQ, p, sc, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dk, dv: [b, h_kv, sk, d] bf16, each the sum over the kv head's GQA group;
// q_index, step_kind_t: [sched_heads, nk, width_t] int32 (the transposed
// schedule); block_kv a multiple of 64 or nk == 1; at most 32 rows of the
// transposed schedule a CTA (walk_rows); q, k, v, o, do 16-byte aligned
// with rows of d elements (TMA); the rest as dstt_splash_bwd_dq.
extern "C" int dstt_splash_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, const void* seg,
                                   const void* q_index, const void* step_kind_t, void* dk,
                                   void* dv, int b, int h, int h_kv, int sq, int sk, int d,
                                   float scale, int sched_heads, int nk, int width_t,
                                   int block_q, int block_kv, int causal, int window,
                                   int seg_all, void* stream) {
  if (!dstt::splash::blocks_ok(block_kv, nk) || !(scale > 0.f))
    return (int)cudaErrorInvalidValue;
  Problem p;
  p.b = b;
  p.h = h;
  p.h_kv = h_kv;
  p.s = sk;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  p.seg = static_cast<const int*>(seg);
  const SplashWalk w{static_cast<const int*>(q_index), static_cast<const int*>(step_kind_t),
                     sched_heads, nk, width_t, block_q, block_kv, sq, causal, window,
                     seg != nullptr, seg_all};
  if (walk_rows(d, w, h / h_kv) > 32) return (int)cudaErrorInvalidValue;
  const float* L = static_cast<const float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dkv<64>(q, k, v, o, dout, L, dk, dv, p, w, st);
    case 128: return launch_dkv<128>(q, k, v, o, dout, L, dk, dv, p, w, st);
    case 256: return launch_dkv<256>(q, k, v, o, dout, L, dk, dv, p, w, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
