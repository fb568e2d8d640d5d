// Shared pieces of the layout-predicate sparse kernels (sparse_fwd.cu,
// sparse_bwd.cu): the problem's checks and its flash description, and the
// walks that read the int32 layout itself (never a splash schedule):
// policies of flash_hopper.cuh's forward CTA body and flash_hopper_bwd.cuh's
// dq and dk/dv CTA bodies.
//
// The layout is int32 [h, nb, nb] with nb = s / block and block in {16, 32,
// 64, 128, 256} (log2 ``lg``): layout[h, i, j] != 0 keeps every pair of row
// block i and column block j. The forward and dq kernels read it with rows
// = query blocks; the dk/dv kernel reads its transpose (rows = key blocks).
// A pair is kept iff its blocks' entry is set and, when causal, the key is
// not after the query.
//
// Each walk hands its CTA body's consumer warpgroups, with every tile, a
// code per warpgroup: skip (no pair of the warpgroup's rows is kept), whole
// (every pair is: no predicate) or a predicate, whose bits say which of the
// warpgroup's layout blocks keep the tile's. A tile that keeps no pair for
// either warpgroup is dropped before any copy, and a bit is set only where
// its blocks keep at least one pair under the causal bound, so every tile
// handed over keeps a pair. The forward and dq walks share one scan of the
// layout's rows (LayoutRowWalk) and differ only in how a stage is issued
// and in the tile's width. ops/sparse_attention/sparse.py's
// ``layout_walk`` and ``layout_dkv_walk`` are the walks' plain models.
//
// Masked logits contribute exactly 0, so a row that keeps no key gives O =
// 0, lse = -1e30 (the Pallas bodies' NEG_INF) and zero gradients.
#pragma once

#include "flash_hopper_bwd.cuh"
#include "splash_common.cuh"

namespace dstt {
namespace sparse {

constexpr float NEG_INF = -1e30f;

// Does the kernel take this problem? (the wrapper checks first)
__host__ inline bool problem_ok(int s, int nb, int lg) {
  return lg >= 4 && lg <= 8 && nb > 0 && (nb << lg) == s;
}

// The flash bodies' problem: heads matched (the caller expands GQA), no
// band, no segment ids.
__host__ inline flash::Problem problem(int b, int h, int s, float scale, int causal) {
  flash::Problem p;
  p.b = b;
  p.h = h;
  p.h_kv = h;
  p.s = s;
  p.scale = scale;
  p.causal = causal;
  p.window = 0;
  p.seg = nullptr;
  return p;
}

// ---------------------------------------------------------------------------
// A code's or kind's bits are over the layout blocks of 64 rows (or keys):
// the x-th row of a 64-aligned group lies in its (x & 63) >> lg-th block,
// the 0-th for blocks of 64 and more.

// The forward's and dq's walk over a CTA's layout rows (128 query rows, two
// consumer warpgroups of 64, key tiles of BK: the forward's 128, 64 at d
// 256; dq's 64, 32 at d 256). Each stage's word is (k0 / BK) << 6 | code 0
// | code 1 << 3 with a code per warpgroup (flash_hopper.cuh): 0 skip, 1
// kept under the causal bound, SCHEDULED_WHOLE, or SCHEDULED_COLUMNS, where
// the stage's kinds bytes hold a bitmask per key column: bit i says whether
// the warpgroup's i-th row block keeps the column's block (and the block's
// last row sees the key, when causal). Blocks of at least 64 and of BK put
// a warpgroup's rows in one block and a key tile in one block: scalar
// codes, one tile a lane, 32 tiles at once. Smaller blocks (16 and 32: 4
// or 2 row blocks a warpgroup; 64 under the forward's 128-key tiles: two
// key blocks a tile) take the per-column form, a tile at a time.
struct LayoutRowWalk {
  static constexpr bool SCHEDULED = true;
  const int* layout;  // [h, nb, nb], rows = query blocks
  int nb, lg, s, causal;

  // is the pair (query q, key k) kept under this code or column bitmask?
  // (bitwise: no branch in the consumers' unrolled loop)
  __device__ __forceinline__ bool keep(int knd, int q, int k, int, int) const {
    const bool on = (knd >> ((q & 63) >> lg)) & 1;
    return on & (q < s) & (k < s) & (!causal | (k <= q));
  }

  // Walks the key tiles of the CTA of query rows [q0, q0 + 128) of head hi
  // (when causal, none past its last row) in ascending order and calls
  // issue(n, word, kinds) for the n-th tile handed over (kinds[w]: this
  // lane's BK / 32 column bitmasks of warpgroup w, a byte each, lowest
  // column first, where its code is SCHEDULED_COLUMNS); then(n, k0) follows
  // once the next tile is walked (or the walk ends), as splash's RowWalk
  // does for the forward's V. Returns the tiles handed over.
  template <int BK, class Issue, class Then>
  __device__ __forceinline__ int walk(int hi, int q0, int lane, Issue issue, Then then) const {
    constexpr int IDS = BK / 32;
    constexpr int COLUMNS = flash_hopper::SCHEDULED_COLUMNS, WHOLE = flash_hopper::SCHEDULED_WHOLE;
    const int* lay = layout + (int64_t)hi * nb * nb;
    const int nt = ((causal ? min(q0 + 128, s) : s) + BK - 1) / BK;
    int n = 0, last = 0;
    auto hand_over = [&](int word, const uint32_t(&kc)[2]) {
      if (n > 0) then(n - 1, last);
      issue(n, word, kc);
      last = (word >> 6) * BK;
      ++n;
    };
    if ((1 << lg) >= max(64, BK)) {
      // a warpgroup's rows lie in one block, all below s or all past it (s
      // is a multiple of the block), and a tile in one block; lane j takes
      // tile t0 + j
      int row[2];
#pragma unroll
      for (int w = 0; w < 2; ++w) row[w] = q0 + 64 * w < s ? ((q0 + 64 * w) >> lg) * nb : -1;
      const uint32_t none[2] = {0u, 0u};
      for (int t0 = 0; t0 < nt; t0 += 32) {
        const int t = t0 + lane, k0 = t * BK;
        int word = t << 6;
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const int r_lo = q0 + 64 * w;
          const bool on = t < nt && row[w] >= 0 && lay[row[w] + (k0 >> lg)] != 0 &&
                          (!causal || k0 <= r_lo + 63);
          const bool all = !causal || k0 + BK - 1 <= r_lo;
          word |= (on ? (all ? WHOLE : 1) : 0) << (3 * w);
        }
        for (uint32_t live = __ballot_sync(0xffffffffu, (word & 63) != 0); live;
             live &= live - 1)
          hand_over(__shfl_sync(0xffffffffu, word, __ffs(live) - 1), none);
      }
    } else {
      // per column: bit i of a column's byte is row block i of the
      // warpgroup's max(1, 64 >> lg) (kept where the block's last row sees
      // the key)
      const int R = lg < 6 ? 64 >> lg : 1;
      for (int t = 0; t < nt; ++t) {
        const int k0 = t * BK;
        uint32_t kc[2] = {0u, 0u};
        int word = t << 6;
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const int r_lo = q0 + 64 * w;
          bool all = r_lo + 64 <= s && k0 + BK <= s && (!causal || k0 + BK - 1 <= r_lo);
#pragma unroll
          for (int c = 0; c < IDS; ++c) {
            const int key = k0 + lane * IDS + c, kb = key >> lg;
            uint32_t m = 0;
            for (int i = 0; i < R && key < s; ++i) {
              const int rb = (r_lo >> lg) + i;
              if (rb < nb && lay[rb * nb + kb] != 0 && (!causal || kb <= rb)) m |= 1u << i;
            }
            kc[w] |= m << (8 * c);
            all = all && m == (1u << R) - 1;
          }
          const bool any = __any_sync(0xffffffffu, kc[w] != 0u);
          all = __all_sync(0xffffffffu, all);
          word |= (!any ? 0 : all ? WHOLE : COLUMNS) << (3 * w);
        }
        if (word & 63) hand_over(word, kc);
      }
    }
    if (n > 0) then(n - 1, last);
    return n;
  }
};

// dq (flash_hopper_bwd.cuh's dq CTA): K and V of each tile on one barrier.
struct LayoutDqWalk : LayoutRowWalk {
  // The producer warp's stages. Returns the stages issued.
  template <int D>
  __device__ __forceinline__ int produce(const flash_hopper::DqSmem<D, true>& sm,
                                         const CUtensorMap* const* maps,
                                         const flash::Problem& p, const flash_hopper::Tile& tile,
                                         int lane) const {
    namespace fh = flash_hopper;
    namespace hp = hopper;
    using T = fh::BwdTiles<D>;
    constexpr int BK = T::BK, S = T::STAGES, IDS = BK / 32;
    // tile `word`: its column bitmasks where its code is SCHEDULED_COLUMNS,
    // then K and V by TMA
    return walk<BK>(
        tile.bh % p.h, tile.q0, lane,
        [&](int it, int word, const uint32_t(&kc)[2]) {
          const int st = it % S, k0 = (word >> 6) * BK;
          hp::mbar_wait(&sm.empty[st], ((it / S) & 1) ^ 1);
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            if (((word >> (3 * w)) & 7) == fh::SCHEDULED_COLUMNS)
              splash::store_kinds<IDS>(sm.kinds + (2 * st + w) * BK + lane * IDS, kc[w]);
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
            hp::mbar_arrive(&sm.full[st]);  // after this lane's column bytes
          }
        },
        [](int, int) {});
  }
};

// dk/dv: a walk of flash_hopper_bwd.cuh's dk/dv CTA (KV_BK keys, 64 a half;
// query tiles of KV_BQ = 64 rows) over the CTA's rows of the transposed
// layout. Each stage's kind per half: a bitmask, bit (i << sub) + j (sub =
// log2 of the blocks per 64, 0 for blocks of 64 and more) saying whether
// the query tile's i-th block keeps the half's j-th key block, with WHOLE
// set where every pair is kept. Query tiles in ascending order (when
// causal, none before the CTA's first key), one tile a lane, 32 at once;
// the heads of a GQA group are one (the caller expands GQA).
struct LayoutDkvWalk {
  static constexpr bool SCHEDULED = true;
  static constexpr int WHOLE = 1 << 16;
  const int* layout_t;  // [h, nb, nb], rows = key blocks
  int nb, lg, sub, sq, causal;  // sq: the sequence (queries and keys)

  __device__ __forceinline__ bool whole(int kind, int, int, int, int, int) const {
    return (kind & WHOLE) != 0;
  }

  // is the pair (query q, key k) of a stage of this kind kept? (bitwise)
  __device__ __forceinline__ bool keep(int kind, int q, int k, int, int, int sk) const {
    const bool on = (kind >> ((((q & 63) >> lg) << sub) + ((k & 63) >> lg))) & 1;
    return on & (q < sq) & (k < sk) & (!causal | (k <= q));
  }

  // the kind of the 64 keys from k_lo against the query tile at q0 (0:
  // no pair kept)
  __device__ __forceinline__ int half_kind(const int* lay, int q0, int k_lo) const {
    if (k_lo >= sq) return 0;
    const bool all = (!causal || k_lo + 63 <= q0) && q0 + 64 <= sq && k_lo + 64 <= sq;
    if (lg >= 6) {
      const bool on = lay[(k_lo >> lg) * nb + (q0 >> lg)] != 0 && (!causal || k_lo <= q0 + 63);
      return on ? (all ? 1 | WHOLE : 1) : 0;
    }
    const int R = 1 << sub;
    int m = 0;
    for (int j = 0; j < R; ++j) {
      const int kb = (k_lo >> lg) + j;
      if (kb >= nb) break;
      const int* row = lay + kb * nb;
      for (int i = 0; i < R; ++i) {
        const int qb = (q0 >> lg) + i;
        if (qb < nb && row[qb] != 0 && (!causal || kb <= qb)) m |= 1 << ((i << sub) + j);
      }
    }
    return m != 0 && all && m == (1 << (R * R)) - 1 ? m | WHOLE : m;
  }

  // The producer warp's walk. Returns the stages issued.
  template <int D>
  __device__ __forceinline__ int produce(const flash_hopper::DkvSmem<D, true>& sm,
                                         const CUtensorMap* const* maps,
                                         const flash::Problem& p, const flash_hopper::KvTile& kt,
                                         int lane) const {
    namespace fh = flash_hopper;
    namespace hp = hopper;
    using T = fh::BwdTiles<D>;
    constexpr int BQ = T::KV_BQ, S = T::KV_STAGES, HALVES = T::KV_BK / 64;
    const int head = kt.bi * p.h + kt.kvh;  // h_kv == h
    const int* lay = layout_t + (int64_t)kt.kvh * nb * nb;
    const int nqt = (sq + BQ - 1) / BQ;
    int it = 0;
    for (int t0 = causal ? kt.k0 / BQ : 0; t0 < nqt; t0 += 32) {
      const int t = t0 + lane;
      int kd[HALVES];
#pragma unroll
      for (int a = 0; a < HALVES; ++a) kd[a] = t < nqt ? half_kind(lay, t * BQ, kt.k0 + 64 * a) : 0;
      for (uint32_t live = __ballot_sync(0xffffffffu, (kd[0] | kd[HALVES - 1]) != 0); live;
           live &= live - 1) {
        const int j = __ffs(live) - 1, q0 = (t0 + j) * BQ, st = it % S;
        int kj[HALVES];
#pragma unroll
        for (int a = 0; a < HALVES; ++a) kj[a] = __shfl_sync(0xffffffffu, kd[a], j);
        hp::mbar_wait(&sm.empty[st], ((it / S) & 1) ^ 1);
        if (lane == 0) {
          sm.q0s[st] = q0;
          sm.heads[st] = head;
          sm.kinds[2 * st] = kj[0];
          sm.kinds[2 * st + 1] = kj[HALVES - 1];
          hp::mbar_arrive(&sm.info[st]);
          hp::mbar_arrive_expect_tx(&sm.full[st], fh::DkvSmem<D, true>::STAGE);
#pragma unroll
          for (int cb = 0; cb < D / 64; ++cb) {
            hp::tma_load_3d(sm.q(st) + cb * BQ * 128, maps[2], &sm.full[st], 64 * cb, q0, head);
            hp::tma_load_3d(sm.dout(st) + cb * BQ * 128, maps[3], &sm.full[st], 64 * cb, q0,
                            head);
            hp::tma_load_3d(sm.o(st) + cb * BQ * 128, maps[4], &sm.full[st], 64 * cb, q0, head);
          }
        } else {
          hp::mbar_arrive(&sm.full[st]);
        }
        ++it;
      }
    }
    return it;
  }
};

}  // namespace sparse
}  // namespace dstt
