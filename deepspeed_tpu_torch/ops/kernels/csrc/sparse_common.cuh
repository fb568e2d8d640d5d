// Shared pieces of the layout-predicate sparse kernels (sparse_fwd.cu,
// sparse_bwd.cu): the problem description, the per-CTA masks built from the
// int32 layout, and the rule that keeps a (row, column) pair of a tile.
//
// The layout is int32 [h, nb, nb] with nb = s / block and block in {16, 32,
// 64, 128, 256} (log2 ``lg``): layout[h, i, j] != 0 keeps every pair of row
// block i and column block j. The forward and dq kernels read it with rows
// = query blocks; the dk/dv kernel reads its transpose (rows = key blocks).
// A CTA owns one 64-row tile of one (batch, head) and walks the 64-column
// tiles of the other axis. At its start it folds the layout rows its tile
// overlaps into one 16-bit mask per column tile: with sub = max(1, 64 /
// block) layout blocks per tile side, bit (i * sub + j) is the layout entry
// of the tile's i-th row block and the column tile's j-th column block. A
// column tile whose mask is 0 is skipped before any load; inside a visited
// tile a pair is kept iff its bit is set (and, when causal, the key is not
// after the query). Blocks of 64 and more give one bit per tile.
//
// Masked logits are -1e30 (the Pallas bodies' NEG_INF) and exp() of a logit
// at or below -5e29 is taken as 0, so a row that keeps no key gives O = 0,
// lse = -1e30 + log(1e-30) (-1e30 in fp32), and zero gradients.
#pragma once

#include "flash_common.cuh"

namespace dstt {
namespace sparse {

constexpr float NEG_INF = -1e30f;

struct Problem {
  int b, h, s;
  float scale;
  int causal;
  int nb;  // layout blocks per axis (s / block)
  int lg;  // log2(block)
};

// layout blocks per side of a 64-row tile (1 for blocks of 64 and more)
__host__ __device__ inline int sub_blocks(int lg) { return lg < 6 ? (flash::TILE >> lg) : 1; }

__host__ __device__ inline int n_tiles(int s) { return (s + flash::TILE - 1) / flash::TILE; }

// masks[ct] for every column tile ct of the CTA whose tile starts at row r0;
// lay is this head's [nb, nb] plane (rows on the CTA's axis).
__device__ __forceinline__ void build_masks(uint16_t* masks, const int* __restrict__ lay,
                                            const Problem& p, int r0) {
  const int sub = sub_blocks(p.lg);
  const int rb0 = r0 >> p.lg;
  const int nt = n_tiles(p.s);
  for (int ct = threadIdx.x; ct < nt; ct += flash::NTHREADS) {
    const int cb0 = (ct * flash::TILE) >> p.lg;
    uint32_t m = 0;
    for (int i = 0; i < sub && rb0 + i < p.nb; ++i) {
      const int* row = lay + (int64_t)(rb0 + i) * p.nb;
      for (int j = 0; j < sub && cb0 + j < p.nb; ++j) {
        if (row[cb0 + j] != 0) m |= 1u << (i * sub + j);
      }
    }
    masks[ct] = (uint16_t)m;
  }
}

// The bits of one row (local row lr of the CTA's tile) within a column
// tile's mask: bit j is the row's j-th column block.
__device__ __forceinline__ uint32_t row_bits(uint32_t mask, const Problem& p, int lr) {
  const int sub = sub_blocks(p.lg);
  return (mask >> ((lr >> p.lg) * sub)) & ((1u << sub) - 1u);
}

// Is local column lc (of a visited tile) kept for a row with these bits?
__device__ __forceinline__ bool col_kept(uint32_t bits, const Problem& p, int lc) {
  return (bits >> (lc >> p.lg)) & 1u;
}

// Bytes of the masks, rounded up to 16.
__host__ inline size_t mask_bytes(int s) {
  return ((size_t)n_tiles(s) * sizeof(uint16_t) + 15) / 16 * 16;
}

// Does the kernel take this problem? (the wrapper checks first)
__host__ inline bool problem_ok(int s, int nb, int lg) {
  return lg >= 4 && lg <= 8 && nb > 0 && (nb << lg) == s;
}

}  // namespace sparse
}  // namespace dstt
