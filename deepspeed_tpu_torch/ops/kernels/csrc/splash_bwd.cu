// Splash (scheduled block-sparse) attention backward for Hopper (sm_90a):
// two kernels, dq and dk/dv, on wgmma fed by TMA.
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
// Design: the flash backward's two CTA bodies (flash_hopper_bwd.cuh, which
// flash_bwd.cu and the ring's flash_chunk.cu run with FlashWalk) on
// scheduled walks.
//  * dq (dq_cta on SplashDqWalk, splash_common.cuh's RowWalk): a CTA per
//    (128-query tile, b * h); the producer warp loads Q and dO once, then
//    the key tiles (BK 64; 32 at d 256) the CTA's two schedule rows list,
//    merged in ascending key order, into a three-stage ring, each stage's
//    word carrying a code per consumer warpgroup (one kind for the tile,
//    per-column kinds, or whole); two consumer warpgroups take delta in the
//    kernel, then S = Q K^T, dP = dO V^T, dS in registers, dQ += dS K on
//    wgmma, the kept-pair rule only where a tile is not whole (a
//    warpgroup whose columns are all SKIP adds exactly 0). A row that keeps
//    nothing gives dq = 0. Over a LocalMask schedule in 512-blocks the walk
//    is flash's: dq equals flash dq's with the same window.
//  * dk/dv: the flash dk/dv CTA body (dkv_cta: a producer warp's TMA loads
//    into a ring of query-tile stages, two warps taking delta per stage,
//    two consumer warpgroups on wgmma summing dV += P^T dO and dK += dS^T Q
//    over the GQA group in fp32, rounded once) on a scheduled walk
//    (SplashWalk below): one CTA per (KV_BK keys, b * h_kv) walks, query
//    tile outer and the group's heads inner as flash does, the query blocks
//    its rows of the transposed schedule (q_index, step_kind_t) list, each
//    as 64-row tiles in ascending order. The kv block of each 64-key half of
//    the CTA's keys has its own rows (blocks of 64 keys put two in a 128-key
//    CTA), a per-head schedule one row per head: the producer warp merges
//    them, any number, with a cursor a row in shared memory, each lane
//    owning every 32nd row, and hands over each (tile, head) some row lists
//    with the step kind of each half. Kind-0 steps, and PARTIAL tiles the
//    causal bound or the band leave empty, are dropped before any copy; a
//    head whose rows skip the tile skips it. The consumers apply the
//    kept-pair rule only on PARTIAL steps and for runtime segment ids; a
//    FULL step has no predicate. Over a schedule shared by the heads, the
//    walk visits a superset of flash's query tiles for the same window, in
//    flash's order, and a tile the mask leaves dead adds exactly 0: dk and
//    dv equal flash dk/dv's.
#include "flash_hopper_bwd.cuh"
#include "splash_common.cuh"

namespace {

namespace fh = dstt::flash_hopper;
namespace hp = dstt::hopper;
namespace sp = dstt::splash;
using dstt::flash::Problem;
using dstt::flash::set_max_smem;
using bf16 = __nv_bfloat16;
using sp::FULL;
using sp::PARTIAL;
using sp::SKIP;

// ---------------------------------------------------------------------------
struct SplashDqWalk : sp::RowWalk {
  // The producer's stages (flash_hopper_bwd.cuh's dq_produce calls this
  // after the Q and dO loads): each tile's word, ids and (per column)
  // kinds, then K and V by TMA on one barrier.
  template <int D>
  __device__ __forceinline__ int produce(const fh::DqSmem<D, true>& sm,
                                         const CUtensorMap* const* maps, const Problem& p,
                                         const fh::Tile& tile, int lane) const {
    using T = fh::BwdTiles<D>;
    constexpr int BK = T::BK, S = T::STAGES, IDS = BK / 32;
    return walk<BK>(
        tile.bh % p.h, tile.q0, tile.segk, sm.qrange[0], sm.qrange[1], lane,
        [&](int it, int word, const auto& kc, const auto& ids) {
          const int st = it % S, k0 = (word >> 6) * BK;
          hp::mbar_wait(&sm.empty[st], ((it / S) & 1) ^ 1);
          if (seg) {
#pragma unroll
            for (int j = 0; j < IDS; ++j) sm.ids[st * BK + lane * IDS + j] = ids[j];
          }
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            if (((word >> (3 * w)) & 7) == fh::SCHEDULED_COLUMNS)
              sp::store_kinds<IDS>(sm.kinds + (2 * st + w) * BK + lane * IDS, kc[w]);
          }
          if (lane == 0) {
            sm.k0s[st] = word;
            hp::mbar_arrive_expect_tx(&sm.full[st], fh::DqSmem<D>::STAGE);
#pragma unroll
            for (int c = 0; c < D / 64; ++c) {
              hp::tma_load_3d(sm.k(st) + c * BK * 128, maps[2], &sm.full[st], 64 * c, k0,
                              tile.bkv);
              hp::tma_load_3d(sm.v(st) + c * BK * 128, maps[3], &sm.full[st], 64 * c, k0,
                              tile.bkv);
            }
          } else {
            hp::mbar_arrive(&sm.full[st]);  // after this lane's ids and kinds
          }
        },
        [](int, int) {});
  }
};

// maps: q, dO, k, v (fh::encode_dq_maps over sq query and sk key rows)
template <int D>
__global__ void __launch_bounds__(fh::THREADS, 1)
    splash_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap domap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ o,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     bf16* __restrict__ dq, Problem p, SplashDqWalk walk) {
  extern __shared__ unsigned char smem_raw[];
  const CUtensorMap* maps[4] = {&qmap, &domap, &kmap, &vmap};
  const fh::Tile tile = sp::make_tile<fh::BwdTiles<D>::BQ>(p, walk.sk);
  const int64_t head = (int64_t)tile.bh * p.s;
  fh::dq_cta<D>(
      smem_raw, maps, p, tile, o + head * D, dout + head * D, lse + head,
      [&](auto& acc, int, int, int) { fh::acc_zero(acc); },
      [&](const auto& acc, int row0, int row1, int tq) {
        const int64_t at = (int64_t)blockIdx.x * p.s * D;  // the CTA's (batch, head)
        fh::acc_store_bf16<D>(dq + at, acc, p.scale, row0, row1, p.s, 0, D, tq);
      },
      walk);
}

// ---------------------------------------------------------------------------
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
  // no pair (every key after every query, or every pair too far back)
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

  // The producer warp's walk: a cursor over each row c of the transposed
  // schedule (the block of half c / nh, head c % nh), kept in shared memory
  // past the stages' kinds (cur: the query block it points at, at: its step
  // as an index into the schedule's arrays, mk: the row's kind at the block
  // being walked; walk_rows rows each), lane l owning rows l, l + 32, ...;
  // the smallest query block any cursor points at is next, walked as 64-row
  // tiles, the group's heads inner; the cursors at it move on. A row's steps
  // start at a multiple of width, so its end is where at reaches the next.
  // Returns the stages issued.
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
    const int rows = nkb * nh;
    int* cur = sm.cursors;
    int* at = cur + rows;
    int* mk = at + rows;
    for (int c = lane; c < rows; c += 32) {
      const int a = c / nh, hs = c - a * nh;
      const int r = ((heads == 1 ? 0 : kt.kvh * group + hs) * nk + (a ? kb[HALVES - 1] : kb[0])) *
                    width;
      at[c] = r;
      cur[c] = kind[r] != SKIP ? index[r] : NONE;
    }
    const int kmin = sm.krange[0], kmax = sm.krange[1];
    int it = 0;
    for (;;) {
      int least = NONE;
      for (int c = lane; c < rows; c += 32) least = min(least, cur[c]);
      const int qb = __reduce_min_sync(0xffffffffu, least);
      if (qb == NONE) break;
      for (int c = lane; c < rows; c += 32)
        mk[c] = cur[c] == qb ? kind[at[c]] : SKIP;  // row c's kind at block qb
      __syncwarp();  // every row's kind at block qb, for every lane
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
            kd[h2] = mk[(h2 && nkb == 2 ? nh : 0) + c];
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
      __syncwarp();  // every lane's reads of mk before the next block's writes
      for (int c = lane; c < rows; c += 32) {
        if (cur[c] == qb) {
          const int a = at[c] + 1;
          at[c] = a;
          cur[c] = a % width && kind[a] != SKIP ? index[a] : NONE;
        }
      }
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

// Rows of the transposed schedule a dk/dv CTA's producer merges: the kv
// blocks of its 64-key halves times the schedule's heads of a GQA group
// (splash.py's dkv_walk_rows); its cursors take 12 bytes of shared memory
// a row.
int walk_rows(int d, const SplashWalk& w, int group) {
  const int kv_bk = d == 256 ? 64 : 128;
  const int blocks = kv_bk == 128 && w.nk > 1 && w.bk % kv_bk ? 2 : 1;
  return blocks * (w.heads == 1 ? 1 : group);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, void* dq, const Problem& p, const SplashDqWalk& w,
              cudaStream_t stream) {
  CUtensorMap maps[4];
  if (int e = fh::encode_dq_maps<D>(maps, q, dout, k, v, p, w.sk)) return e;
  constexpr int bytes = fh::DqSmem<D, true>::BYTES;
  static size_t have = 0;
  if (int e = set_max_smem(splash_dq_kernel<D>, bytes, have)) return e;
  splash_dq_kernel<D><<<fh::dq_grid<D>(p), fh::THREADS, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dq), p, w);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dk, void* dv, const Problem& p, const SplashWalk& w,
               cudaStream_t stream) {
  CUtensorMap maps[5];
  if (int e = fh::encode_dkv_maps<D>(maps, q, dout, o, k, v, p, w.sq)) return e;
  const size_t bytes = fh::DkvSmem<D, true>::BYTES + 12 * (size_t)walk_rows(D, w, p.h / p.h_kv);
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
// tensors 16-byte aligned; h % h_kv == 0; scale > 0; block_q a multiple of
// 64 or nq == 1. Returns cudaGetLastError() (cudaErrorInvalidValue for what
// the kernel does not take).
extern "C" int dstt_splash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, const void* seg,
                                  const void* kv_index, const void* step_kind, void* dq, int b,
                                  int h, int h_kv, int sq, int sk, int d, float scale,
                                  int sched_heads, int nq, int width, int block_q, int block_kv,
                                  int causal, int window, int seg_all, void* stream) {
  if (!sp::blocks_ok(block_q, nq) || !(scale > 0.f) || h % h_kv)
    return (int)cudaErrorInvalidValue;
  Problem p;
  p.b = b;
  p.h = h;
  p.h_kv = h_kv;
  p.s = sq;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  p.seg = static_cast<const int*>(seg);
  SplashDqWalk w;
  w.index = static_cast<const int*>(kv_index);
  w.kind = static_cast<const int*>(step_kind);
  w.heads = sched_heads;
  w.nq = nq;
  w.width = width;
  w.bq = block_q;
  w.bk = block_kv;
  w.sq = sq;
  w.sk = sk;
  w.base = 0;
  w.causal = causal;
  w.window = window;
  w.seg = seg != nullptr;
  w.seg_all = seg_all;
  const float* L = static_cast<const float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dq<64>(q, k, v, o, dout, L, dq, p, w, st);
    case 128: return launch_dq<128>(q, k, v, o, dout, L, dq, p, w, st);
    case 256: return launch_dq<256>(q, k, v, o, dout, L, dq, p, w, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dk, dv: [b, h_kv, sk, d] bf16, each the sum over the kv head's GQA group;
// q_index, step_kind_t: [sched_heads, nk, width_t] int32 (the transposed
// schedule); block_kv a multiple of 64 or nk == 1; q, k, v, o, do 16-byte
// aligned with rows of d elements (TMA); the rest as dstt_splash_bwd_dq.
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
  const float* L = static_cast<const float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dkv<64>(q, k, v, o, dout, L, dk, dv, p, w, st);
    case 128: return launch_dkv<128>(q, k, v, o, dout, L, dk, dv, p, w, st);
    case 256: return launch_dkv<256>(q, k, v, o, dout, L, dk, dv, p, w, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
