// Shared pieces of the splash kernels (splash_fwd.cu, splash_bwd.cu): the
// problem and schedule descriptions and the rule that keeps a (query, key)
// pair of a scheduled step.
//
// A schedule (deepspeed_tpu_torch/ops/sparse_attention/schedule.py) lists,
// per head row (1 shared or one per query head) and per query block, the kv
// blocks to visit, compacted left, with a kind per step: 0 skip (padding,
// nothing is loaded), 1 partial (the analytic predicate applies), 2 full (no
// predicate). The transposed form lists, per kv block, the query blocks that
// visit it. The kernels' 64-row tiles are not the schedule's blocks: a block
// of 64 * n rows is walked as n tiles; a block of any other size is taken
// only when it is the single block of its axis (the prefill's chunk of t
// query rows), and then the tile's rows past it are masked. A key block of
// fewer than 64 keys is walked as one tile whose keys past the block are
// masked (forward only).
//
// Masked logits are -1e30 (the Pallas bodies' NEG_INF) and exp() of a logit
// at or below -5e29 is taken as 0, so a row that keeps no key gives O = 0 and
// lse = -1e30 + log(1e-30), which rounds to -1e30 in fp32.
#pragma once

#include "flash_common.cuh"

namespace dstt {
namespace splash {

using flash::bf16;

constexpr float NEG_INF = -1e30f;
constexpr int SKIP = 0;
constexpr int PARTIAL = 1;
constexpr int FULL = 2;

struct Problem {
  int b, h, h_kv, sq, sk;
  float scale;
  int causal;
  int window;       // 0: no band; key k is kept for query q iff q - k < window
  const int* seg;   // [b, s] (square attention) or null
  int seg_all;      // 1: the ids mask every step (runtime ids); 0: partial steps only
  int base;         // global position of query row 0 (the prefill's chunk start)
};

struct Schedule {
  const int* index;  // [heads, rows, width] block indices
  const int* kind;   // [heads, rows, width] step kinds
  int heads;         // 1 (shared by every query head) or h
  int rows;          // nq (forward, dq) or nk (dk/dv)
  int width;
  int bq, bk;        // the schedule's query and key blocks
};

// Is the pair (query qpos, key kpos) of a step of this kind kept? qpos is
// global (base included); sq_id / sk_id are the pair's segment ids.
__device__ __forceinline__ bool kept(const Problem& p, int kind, int qpos, int kpos, int sq_id,
                                     int sk_id) {
  if (kind == PARTIAL) {
    if (p.causal && kpos > qpos) return false;
    if (p.window && qpos - kpos >= p.window) return false;
  }
  if (p.seg && (p.seg_all || kind == PARTIAL) && sq_id != sk_id) return false;
  return true;
}

// Inside a PARTIAL step, can a whole 64 x 64 tile of the pair grid be
// skipped? Queries [q_lo, q_hi] against keys [k_lo, k_hi] (global, both
// inclusive): every key after every query (causal), or every pair too far
// back (window). Segment ids are left to the per-pair rule. The same for
// every thread of the CTA.
__device__ __forceinline__ bool tile_dropped(const Problem& p, int q_lo, int q_hi, int k_lo,
                                             int k_hi) {
  if (p.causal && k_lo > q_hi) return true;
  if (p.window && q_lo - k_hi >= p.window) return true;
  return false;
}

// Does the kernel take this schedule's blocks? (the wrapper checks first)
__host__ inline bool blocks_ok(int block, int n_blocks) {
  return block % flash::TILE == 0 || n_blocks == 1;
}

}  // namespace splash
}  // namespace dstt
