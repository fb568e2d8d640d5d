// Shared pieces of the splash kernels (splash_fwd.cu, splash_bwd.cu): the
// step kinds, the CTA placement of the forward and dq kernels, and their
// scheduled walk over the row schedule (RowWalk), which the flash bodies'
// producers (flash_hopper.cuh, flash_hopper_bwd.cuh) run in place of the
// flash key range.
//
// A schedule (deepspeed_tpu_torch/ops/sparse_attention/schedule.py) lists,
// per head row (1 shared or one per query head) and per query block, the kv
// blocks to visit, compacted left in ascending order, with a kind per step:
// 0 skip (padding, after the row's last real step: nothing is loaded), 1
// partial (the analytic predicate applies), 2 full (no predicate). The
// transposed form lists, per kv block, the query blocks that visit it.
// Query blocks are multiples of 64 rows, or the axis's single block (the
// prefill's chunk of t rows), so each 64-row half of a 128-row CTA lies in
// one block: one schedule row a consumer warpgroup. Key blocks are any
// size in the forward (the prefill passes the serving pool's block) and
// multiples of 64 (or single) in the backward; the walk gives each key
// column of a tile its own kind, so a tile may span several blocks.
//
// A row that keeps no key gives O = 0 and lse = -1e30 (the Pallas bodies'
// NEG_INF), and dq = 0.
#pragma once

#include "flash_hopper.cuh"

namespace dstt {
namespace splash {

using flash::bf16;

constexpr float NEG_INF = -1e30f;
constexpr int SKIP = 0;
constexpr int PARTIAL = 1;
constexpr int FULL = 2;

// Does the kernel take this schedule's blocks? (the wrapper checks first)
__host__ inline bool blocks_ok(int block, int n_blocks) {
  return block % 64 == 0 || n_blocks == 1;
}

// A forward or dq CTA (BQ query rows of one (batch, head)): its kv head,
// its query tile (the last first: under a causal schedule it lists the
// most blocks) and its batch row's id planes. p.s is the query length, sk
// the keys'.
template <int BQ>
__device__ __forceinline__ flash_hopper::Tile make_tile(const flash::Problem& p, int sk) {
  flash_hopper::Tile t;
  t.bh = blockIdx.x;
  const int bi = t.bh / p.h, hi = t.bh % p.h;
  t.bkv = bi * p.h_kv + hi / (p.h / p.h_kv);
  t.q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * BQ;
  t.segq = p.seg ? p.seg + (int64_t)bi * p.s : nullptr;
  t.segk = p.seg ? p.seg + (int64_t)bi * sk : nullptr;
  return t;
}

// The scheduled walk of a forward or dq CTA over the row schedule.
//
// The producer warp merges the two consumer warpgroups' schedule rows (one
// row when the CTA's 128 rows lie in one block) in ascending key order and
// hands over aligned key tiles of BK: the next tile starts at the least key
// any row still lists, rounded down to BK. With each tile it gives each
// warpgroup a code (flash_hopper.cuh's SCHEDULED_COLUMNS). Over a run of
// tiles that one block of each row holds (or none does: the common case,
// blocks of whole tiles) the codes are scalar tests, one tile a lane, 32
// tiles at once: the block's kind, SKIP where the row lists no block or
// its causal bound or band leaves every key dead for all of the
// warpgroup's rows, WHOLE where it keeps every pair (FULL, or PARTIAL
// inside the bound and the band, every row and key in range, no segment
// ids that mask it); the warp then hands the run's tiles over with a
// shuffle each. A tile that a block boundary cuts (blocks smaller than the
// tile or not aligned to it) gets a kind per key column in the stage's
// kinds bytes (the block's that holds it, SKIP where the row lists none or
// a PARTIAL step leaves it dead), with WHOLE where every column is kept. A
// tile both of whose codes are SKIP, or (runtime ids) none of whose ids
// falls in the query tile's range, is dropped before any copy. (The walk's
// instructions share a sub-partition with two consumer warps: a few per
// tile, as the flash walk's, cost them nothing, some dozens per tile cost
// the forward ~15% on an H100.) Over a schedule shared by the heads
// whose blocks are whole tiles (a LocalMask in 512-blocks), the tiles are
// exactly the flash walk's for the same window, in its order. The loop's
// values are the same in every lane (the same loads; votes; shuffles).
struct RowWalk {
  static constexpr bool SCHEDULED = true;
  const int* index;  // kv_index [heads, nq, width]
  const int* kind;   // step_kind [heads, nq, width]
  int heads, nq, width, bq, bk;
  int sq, sk, base;  // query and key lengths; the global position of query row 0
  int causal, window;
  int seg, seg_all;  // segment ids present; they mask every step (else PARTIAL steps)

  // is the pair (query row q, key k) of a step of this kind kept? (in
  // bitwise form: predicates, no branch, in the consumers' unrolled loops)
  __device__ __forceinline__ bool keep(int knd, int q, int k, int q_id, int k_id) const {
    const int qp = base + q;
    const bool part = knd == PARTIAL;
    const bool band = (!causal | (k <= qp)) & (!window | (qp - k < window));
    return (knd != SKIP) & (q < sq) & (k < sk) & (!part | band) &
           (!seg | !(seg_all | part) | (q_id == k_id));
  }

  // Walks the CTA of query rows [q0, q0 + 128) of head hi (its key ids
  // segk, its query ids' range [qmin, qmax]) and calls issue(n, word,
  // kinds, ids) for the n-th tile handed over: word = (k0 / BK) << 6 |
  // code 0 | code 1 << 3; kinds[w] holds this lane's BK / 32 columns' kinds
  // for warpgroup w where its code is SCHEDULED_COLUMNS, a byte each,
  // lowest column first; ids their ids (with segment ids). then(n, k0)
  // follows once the next tile is walked (or the walk ends): the forward's
  // V, whose stage frees last, so that the walk's own work runs before that
  // wait and the next K follows the V at once, as in the flash walk.
  // Returns the tiles handed over.
  template <int BK, class Issue, class Then>
  __device__ __forceinline__ int walk(int hi, int q0, const int* segk, int qmin, int qmax,
                                      int lane, Issue issue, Then then) const {
    constexpr int IDS = BK / 32;
    constexpr int NONE = 0x7fffffff;
    constexpr int COLUMNS = flash_hopper::SCHEDULED_COLUMNS, WHOLE = flash_hopper::SCHEDULED_WHOLE;
    int row[2];  // each warpgroup's schedule row (-1: its rows lie past sq)
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int first = q0 + 64 * w;
      row[w] = first < sq
                   ? ((heads == 1 ? 0 : hi) * nq + (nq == 1 ? 0 : first / bq)) * width
                   : -1;
    }
    // step j of warpgroup w's row: its block's keys [ks, ke) and its kind
    // (ks NONE past the row's last real step). The block at each cursor
    // stays in registers, so a tile inside it reads no schedule.
    auto fetch = [&](int w, int j, int& ks, int& ke, int& kd) {
      kd = row[w] >= 0 && j < width ? kind[row[w] + j] : SKIP;
      ks = kd != SKIP ? index[row[w] + j] * bk : NONE;
      ke = kd != SKIP ? min(ks + bk, sk) : NONE;
    };
    int pos[2] = {0, 0}, ks[2], ke[2], kd[2];
    fetch(0, 0, ks[0], ke[0], kd[0]);
    fetch(1, 0, ks[1], ke[1], kd[1]);
    int next = 0, n = 0, last = 0;  // keys below next are walked; last: tile n - 1
    // hands tile (k0, word) over unless both codes are SKIP or (runtime ids)
    // none of its ids falls in the queries' range
    auto hand_over = [&](int k0, int word, const uint32_t(&kc)[2]) {
      if ((word & 63) == 0) return;  // both warpgroups SKIP
      int ids[IDS];
      if (seg) {
        bool hit = false;
#pragma unroll
        for (int c = 0; c < IDS; ++c) {
          const int kpos = k0 + lane * IDS + c;
          ids[c] = kpos < sk ? segk[kpos] : 0;
          hit |= kpos < sk && ids[c] >= qmin && ids[c] <= qmax;
        }
        if (seg_all && !__any_sync(0xffffffffu, hit)) return;  // no id of the queries'
      }
      if (n > 0) then(n - 1, last);
      issue(n, word, kc, ids);
      last = k0;
      ++n;
    };
    for (;;) {
      const int t = min(ks[0] == NONE ? NONE : max(ks[0], next),
                        ks[1] == NONE ? NONE : max(ks[1], next));
      if (t == NONE) break;
      const int k0 = t / BK * BK;
      // A run of tiles from k0 each of which one block of each row holds
      // (or none does): where it ends, or no run if a block starts or ends
      // inside the tile at k0.
      int run_end = NONE;
      bool run = true;
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        if (ks[w] <= k0) {  // the cursor's block holds k0
          const int e = ke[w] == sk ? (sk + BK - 1) / BK * BK : ke[w] / BK * BK;
          if (e <= k0) run = false;
          else run_end = min(run_end, e);
        } else if (ks[w] < k0 + BK) {
          run = false;
        } else {  // no block of this row before ks[w] (NONE: none at all)
          run_end = min(run_end, ks[w] / BK * BK);
        }
      }
      if (run) {
        // lane j takes the stage word of the run's j-th tile: codes are
        // scalar tests of the tile's bounds against each row's block
        const int tiles = min(32, (run_end - k0) / BK), kj = k0 + lane * BK;
        int word = (kj / BK) << 6;
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          if (ks[w] > k0) continue;  // SKIP: this row lists no block in the run
          const int r_lo = base + q0 + 64 * w, r_hi = base + min(q0 + 64 * w + 63, sq - 1);
          const int k_last = min(kj + BK, ke[w]) - 1;
          const bool dead = kd[w] == PARTIAL && ((causal && kj > r_hi) ||
                                                 (window && r_lo - k_last >= window));
          const bool all =
              kd[w] == FULL || ((!causal || k_last <= r_lo) && (!window || r_hi - kj < window));
          const bool whole = q0 + 64 * w + 64 <= sq && kj + BK <= sk && all &&
                             !(seg && (seg_all || kd[w] == PARTIAL));
          word |= (dead ? SKIP : whole ? WHOLE : kd[w]) << (3 * w);
        }
        const uint32_t none[2] = {0u, 0u};
        for (int j = 0; j < tiles; ++j) {
          const int wj = __shfl_sync(0xffffffffu, word, j);
          hand_over(k0 + j * BK, wj, none);
        }
        next = k0 + tiles * BK;
      } else {
        // blocks smaller than the tile or not aligned to it: per column
        const int k_end = k0 + BK;
        int code[2];
        uint32_t kc[2] = {0u, 0u};
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const int r_lo = base + q0 + 64 * w, r_hi = base + min(q0 + 64 * w + 63, sq - 1);
          // this lane's columns of the block [s, e) of kind k
          auto mark = [&](int s, int e, int k) {
#pragma unroll
            for (int c = 0; c < IDS; ++c) {
              const int key = k0 + lane * IDS + c;
              const bool dead =
                  k == PARTIAL && ((causal && key > r_hi) || (window && r_lo - key >= window));
              if (key >= s && key < e && !dead) kc[w] |= (uint32_t)k << (8 * c);
            }
          };
          if (ks[w] < k_end) {  // not NONE
            mark(ks[w], ke[w], kd[w]);
            for (int j = pos[w] + 1; ke[w] < k_end; ++j) {  // the blocks past the cursor's
              int s, e, k;
              fetch(w, j, s, e, k);
              if (s >= k_end) break;
              mark(s, e, k);
            }
          }
          bool all = q0 + 64 * w + 64 <= sq && k_end <= sk, part = false;
#pragma unroll
          for (int c = 0; c < IDS; ++c) {
            const int k = (kc[w] >> (8 * c)) & 0xff, key = k0 + lane * IDS + c;
            all = all && (k == FULL || (k == PARTIAL && (!causal || key <= r_lo) &&
                                        (!window || r_hi - key < window)));
            part |= k == PARTIAL;
          }
          const bool any = __any_sync(0xffffffffu, kc[w] != 0u);
          all = __all_sync(0xffffffffu, all);
          part = __any_sync(0xffffffffu, part);
          code[w] = !any ? SKIP : all && !(seg && (seg_all || part)) ? WHOLE : COLUMNS;
        }
        hand_over(k0, (k0 / BK) << 6 | code[0] | code[1] << 3, kc);
        next = k_end;
      }
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        while (ke[w] <= next) {  // NONE stays
          ++pos[w];
          fetch(w, pos[w], ks[w], ke[w], kd[w]);
        }
      }
    }
    if (n > 0) then(n - 1, last);
    return n;
  }
};

// The forward's state at the start of a CTA's walk (O 0, m -inf, l 0).
template <int N>
__device__ __forceinline__ void init_empty(float (&o)[N], float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] = 0.f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
}

// flash_hopper.cuh's store_out, with a row that kept nothing (l = 0) at lse
// -1e30 (its O is 0 / 1e-30 = 0): the Pallas bodies' dead-row result.
template <int D>
__device__ __forceinline__ void store_out(bf16* ob, float* lseb, const float (&o)[D / 2],
                                          const float (&m)[2], const float (&l)[2], int row0,
                                          int row1, int s, int tq) {
  const float ls[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
  const int rows[2] = {row0, row1};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (rows[u] >= s) continue;
    bf16* orow = ob + (int64_t)rows[u] * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * u] / ls[u], o[4 * j + 2 * u + 1] / ls[u]);
    }
    if (tq == 0) lseb[rows[u]] = l[u] > 0.f ? m[u] + logf(ls[u]) : NEG_INF;
  }
}

// This lane's BK / 32 column kinds of one warpgroup into a stage's row of
// BK bytes (lane * IDS is a multiple of IDS bytes: one aligned store)
template <int IDS>
__device__ __forceinline__ void store_kinds(unsigned char* at, uint32_t kinds) {
  if constexpr (IDS == 4) *reinterpret_cast<uint32_t*>(at) = kinds;
  else if constexpr (IDS == 2) *reinterpret_cast<uint16_t*>(at) = (uint16_t)kinds;
  else *at = (unsigned char)kinds;
}

}  // namespace splash
}  // namespace dstt
