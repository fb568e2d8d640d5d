// The flash forward's CTA body on wgmma fed by TMA, shared by the single
// kernel (flash_fwd.cu) and the ring's carry-mode forward (flash_chunk.cu),
// so that a chunk streamed through one equals the whole sequence streamed
// through the other, bit for bit.
//
// One CTA owns BQ = 128 query rows of one (batch, head) and walks the key
// tiles of its kv head that the causal bound, the static band and the
// segment ids leave live. 384 threads in three warpgroups:
//
//  * warpgroup 2, lowered to 40 registers by setmaxnreg: its first warp is
//    the producer. It loads the Q tile once, then decides which key tiles
//    to load (the causal and band range of key_tiles; a tile none of whose
//    ids falls in the query tile's [min, max] is skipped, costing neither a
//    copy nor a wgmma) and issues TMA loads of K and of V into a ring of
//    STAGES stages, K and V each completing on its own `full` mbarrier and
//    freed by its own `empty` one (K goes back as soon as S is read, V
//    only after the P V that reads it). With a K tile it hands over its
//    first key position and its ids (shared memory, before the arrivals);
//    a stage whose position is -1 ends the walk, so the consumers need no
//    list of their own.
//  * warpgroups 0 and 1, raised to 232 registers: each owns 64 query rows.
//    Per key tile: S = Q K^T by wgmma with both operands in shared memory
//    (Q and K K-major in the 128-byte swizzle), the online softmax on the
//    accumulator fragments, O *= the correction, then O += P V by wgmma
//    with P rounded to bf16 from the S accumulators into A fragments
//    (registers) and V the MN-major B operand. A tile's P V is issued with
//    the next tile's S and runs under the next tile's softmax; O is
//    rescaled once it is done, so O = O corr + P V tile by tile, the same
//    operations in the same order as one pass per tile.
//  * The two consumers take turns at the tensor cores: each issues its
//    products only on its turn (named barriers 1 and 2) and hands the turn
//    over at once, so one's softmax also runs under the other's products.
//    No branch stands between a wgmma and its wait (the first tile is
//    peeled, the last P V follows the walk), the loop's exit is on a value
//    broadcast across the warp, and no accumulator is touched while a
//    wgmma that writes it may be in flight: otherwise ptxas serialises
//    every wgmma of the kernel.
//
// Tiles per head dim (FwdTiles; ops/attention/flash.py FWD_TILES mirrors
// them): BQ 128 at every d; BK 128 keys at d 64 and 128, 64 at d 256,
// where the O accumulator alone takes 128 registers a thread; two stages.
// Shared memory: Q 128 d bf16 + 2 stages of K and V BK d bf16 each: 80 KB
// at d 64, 160 KB at d 128, 192 KB at d 256.
//
// Arithmetic (the Pallas body's, flash_pallas.py:104-149): scores in fp32;
// a masked pair is -inf and contributes exactly 0; per row the tile's max
// m_t = max(raw S) * scale (scale > 0), m' = max(m, m_t), corr = 1 when the
// max does not move (else 2^((m - m') log2 e)), p = 2^(S scale log2 e -
// m' log2 e), l = l corr + the row's sum of p (unrounded, the tile's sum
// reduced over the row's 4 lanes each tile), O = O corr + bf16(p) V.
// So a fully masked tile leaves a row's bits alone, and a row's result
// depends only on the key tiles' boundaries and order: a carry stored in
// fp32 between two calls (m and l per row, O in the accumulator layout)
// continues exactly where one call would. The ring gets the single
// kernel's bits when its chunks are whole key tiles (sharded.py).
//
// Tails: the maps are 3-D (d, s, matrices), so rows of a box past s arrive
// as zeros, never as the next head's rows; such keys are masked, such
// queries never stored.
//
// The walk is a template policy. FlashWalk (SCHEDULED false) is the above:
// the producer's key tiles of key_tiles and the segment ids, and
// flash_common.cuh's `visible`. A scheduled walk (splash_fwd.cu) brings
// its own producer walk (produce: the stages it issued) and its rule for a
// kept pair (keep); each K stage's word then packs the tile's first key
// with a code per consumer warpgroup (SCHEDULED_COLUMNS below), read with
// the key, and p.s is the query length (the walk knows the keys').
// FlashWalk compiles to the same code as before the policy existed.
#pragma once

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace dstt {
namespace flash_hopper {

using bf16 = __nv_bfloat16;
using dstt::flash::Problem;
namespace hp = dstt::hopper;

template <int D>
struct FwdTiles;
template <>
struct FwdTiles<64> {
  static constexpr int BQ = 128, BK = 128, STAGES = 2;
};
template <>
struct FwdTiles<128> {
  static constexpr int BQ = 128, BK = 128, STAGES = 2;
};
template <>
struct FwdTiles<256> {
  static constexpr int BQ = 128, BK = 64, STAGES = 2;
};

constexpr int THREADS = 384;  // consumers: warpgroups 0-1; producer: warpgroup 2's first warp
constexpr int TURN = 1;       // named barriers TURN + w: warpgroup w's turn at the tensor cores
constexpr float LOG2E = 1.4426950408889634f;

// The flash kernels' walk (see the header); the dq and dk/dv bodies
// (flash_hopper_bwd.cuh) take the same tag.
struct FlashWalk {
  static constexpr bool SCHEDULED = false;
};

// A scheduled walk's stage word (forward and dq): (k0 / BK) << 6 | code of
// warpgroup 0 | code of warpgroup 1 << 3, where a code is one step kind
// for every key column of the tile (0 skip, 1 partial, 2 full),
// SCHEDULED_COLUMNS (each column's kind in the stage's kinds bytes) or
// SCHEDULED_WHOLE (every pair of the warpgroup's rows kept: no predicate).
constexpr int SCHEDULED_COLUMNS = 3, SCHEDULED_WHOLE = 4;

// Dynamic shared memory: Q [D/64 blocks][BQ rows][128 bytes]; each stage
// K then V, [D/64][BK][128] each; then the mbarriers (full and empty of K
// and of V per stage; Q), each stage's first key position, each stage's
// key ids, the query tile's id range; KINDS (a scheduled walk): each
// stage's step kind per (consumer warpgroup, key column), a byte each.
template <int D, bool KINDS = false>
struct Smem {
  using T = FwdTiles<D>;
  static constexpr int Q_BYTES = T::BQ * D * 2;
  static constexpr int KV_BYTES = T::BK * D * 2;
  static constexpr int TILES = Q_BYTES + T::STAGES * 2 * KV_BYTES;
  static constexpr int BYTES = 1024 + TILES + (4 * T::STAGES + 1) * 8 +
                               T::STAGES * 4 * (1 + T::BK) + 8 +
                               (KINDS ? T::STAGES * 2 * T::BK : 0);

  unsigned char* q;
  unsigned char* ring;
  uint64_t* full_k;
  uint64_t* full_v;
  uint64_t* empty_k;
  uint64_t* empty_v;
  uint64_t* qbar;
  int* k0s;
  int* ids;
  int* qrange;
  unsigned char* kinds;  // KINDS: [STAGES][2][BK]

  __device__ explicit Smem(unsigned char* raw) {
    q = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                         ~uintptr_t(1023));
    ring = q + Q_BYTES;
    full_k = reinterpret_cast<uint64_t*>(q + TILES);
    full_v = full_k + T::STAGES;
    empty_k = full_v + T::STAGES;
    empty_v = empty_k + T::STAGES;
    qbar = empty_v + T::STAGES;
    k0s = reinterpret_cast<int*>(qbar + 1);
    ids = k0s + T::STAGES;
    qrange = ids + T::STAGES * T::BK;
    kinds = reinterpret_cast<unsigned char*>(qrange + 2);
  }
  __device__ unsigned char* k(int st) const { return ring + st * 2 * KV_BYTES; }
  __device__ unsigned char* v(int st) const { return k(st) + KV_BYTES; }
};

// Where a CTA of BQ query rows sits: its (batch, head) and first query row,
// its kv head, and the id planes of its batch row (queries, keys; null
// without ids). Query tiles go heaviest first under a causal mask.
struct Tile {
  int bh, bkv, q0;
  const int* segq;
  const int* segk;
};

template <int BQ>
__device__ __forceinline__ Tile make_tile(const Problem& p, const int* seg_q, const int* seg_k) {
  Tile t;
  t.bh = blockIdx.x;
  const int bi = t.bh / p.h, hi = t.bh % p.h;
  t.bkv = bi * p.h_kv + hi / (p.h / p.h_kv);
  t.q0 = dstt::flash::heavy_first_query_tile(p, gridDim.y) * BQ;
  t.segq = seg_q ? seg_q + (int64_t)bi * p.s : nullptr;
  t.segk = seg_k ? seg_k + (int64_t)bi * p.s : nullptr;
  return t;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S[64 x BK] = Q K^T (k-th 16-deep step; K-major operands)
template <int BK>
__device__ __forceinline__ void mma_s(float (&s)[BK / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (BK == 128) hp::wgmma_m64n128k16<0, 0>(s, a, b, acc);
  else hp::wgmma_m64n64k16<0, 0>(s, a, b, acc);
}

// O[64 x D] += P V (P from registers, V MN-major)
template <int D>
__device__ __forceinline__ void mma_o(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 64) hp::wgmma_m64n64k16_rs<1>(o, a, b, 1);
  else if constexpr (D == 128) hp::wgmma_m64n128k16_rs<1>(o, a, b, 1);
  else hp::wgmma_m64n256k16_rs<1>(o, a, b, 1);
}

// ---------------------------------------------------------------------------
// Accumulator fragments (hopper_common.cuh): element i of a thread's m64nN
// accumulator sits at row lr + 8 ((i / 2) % 2) of its warpgroup's 64 (lr =
// 16 warp + lane / 4) and column 8 (i / 4) + 2 (lane % 4) + i % 2. The
// helpers below load, store and finish rows row0 = the warpgroup's first
// row + lr and row1 = row0 + 8 of a [s, D] matrix in that layout.

// O / max(l, 1e-30) rounded once to bf16 into ob, lse = m + log(max(l,
// 1e-30)) into lseb (rows below s).
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
    if (tq == 0) lseb[rows[u]] = m[u] + logf(ls[u]);
  }
}

// An m64nN accumulator (N / 2 registers) against rows row0 / row1 and
// columns c0 + 8 j + 2 tq (+1) of a [s, ld] matrix: fp32 in (zeros past s),
// fp32 out, or times mul rounded to bf16 out (rows below s).
template <int N>
__device__ __forceinline__ void acc_load(float (&a)[N / 2], const float* base, int row0, int row1,
                                         int s, int c0, int ld, int tq) {
  const int rows[2] = {row0, row1};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const bool in = rows[u] < s;
    const float* r = base + (int64_t)rows[u] * ld + c0 + 2 * tq;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float2 v = in ? *reinterpret_cast<const float2*>(r + 8 * j) : make_float2(0.f, 0.f);
      a[4 * j + 2 * u] = v.x;
      a[4 * j + 2 * u + 1] = v.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void acc_store(float* base, const float (&a)[N / 2], int row0,
                                          int row1, int s, int c0, int ld, int tq) {
  const int rows[2] = {row0, row1};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (rows[u] >= s) continue;
    float* r = base + (int64_t)rows[u] * ld + c0 + 2 * tq;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float2*>(r + 8 * j) = make_float2(a[4 * j + 2 * u], a[4 * j + 2 * u + 1]);
  }
}

template <int N>
__device__ __forceinline__ void acc_store_bf16(bf16* base, const float (&a)[N / 2], float mul,
                                               int row0, int row1, int s, int c0, int ld,
                                               int tq) {
  const int rows[2] = {row0, row1};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (rows[u] >= s) continue;
    bf16* r = base + (int64_t)rows[u] * ld + c0 + 2 * tq;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(r + 8 * j) =
          __floats2bfloat162_rn(a[4 * j + 2 * u] * mul, a[4 * j + 2 * u + 1] * mul);
  }
}

template <int N>
__device__ __forceinline__ void acc_zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// The raw fp32 state of rows row0 / row1 (m, l [s]; acc [s, D]) into the
// registers (m -inf, l 0, O 0 past s) and back (rows below s).
template <int D>
__device__ __forceinline__ void carry_load(float (&o)[D / 2], float (&m)[2], float (&l)[2],
                                           const float* mb, const float* lb, const float* accb,
                                           int row0, int row1, int s, int tq) {
  const int rows[2] = {row0, row1};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const bool in = rows[u] < s;
    m[u] = in ? mb[rows[u]] : -INFINITY;
    l[u] = in ? lb[rows[u]] : 0.f;
  }
  acc_load<D>(o, accb, row0, row1, s, 0, D, tq);
}

template <int D>
__device__ __forceinline__ void carry_store(float* mb, float* lb, float* accb,
                                            const float (&o)[D / 2], const float (&m)[2],
                                            const float (&l)[2], int row0, int row1, int s,
                                            int tq) {
  acc_store<D>(accb, o, row0, row1, s, 0, D, tq);
  if (tq == 0) {  // m and l are equal across the 4 lanes of a row
    if (row0 < s) {
      mb[row0] = m[0];
      lb[row0] = l[0];
    }
    if (row1 < s) {
      mb[row1] = m[1];
      lb[row1] = l[1];
    }
  }
}

// ---------------------------------------------------------------------------
// The producer warp: Q once, then the live key tiles into the ring (the
// walk's), then the end marker.
template <int D, class W>
__device__ __forceinline__ void produce(const Smem<D, W::SCHEDULED>& sm, const CUtensorMap* qmap,
                                        const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        const Problem& p, const Tile& tile, int lane,
                                        const W& walk) {
  using T = FwdTiles<D>;
  constexpr int BK = T::BK, S = T::STAGES, IDS = BK / 32;
  if (lane == 0) {
    hp::tma_prefetch_desc(qmap);
    hp::tma_prefetch_desc(kmap);
    hp::tma_prefetch_desc(vmap);
    hp::mbar_arrive_expect_tx(sm.qbar, Smem<D>::Q_BYTES);
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      hp::tma_load_3d(sm.q + c * T::BQ * 128, qmap, sm.qbar, 64 * c, tile.q0, tile.bh);
  }
  int it = 0;
  if constexpr (W::SCHEDULED) {
    it = walk.template produce<D>(sm, kmap, vmap, p, tile, lane);
  } else {
    const int qmin = sm.qrange[0], qmax = sm.qrange[1];
    int lo, hi;
    dstt::flash::key_tiles<T::BQ, BK>(p, tile.q0, lo, hi);
    for (int k0 = lo; k0 < hi; k0 += BK) {
      int ids[IDS];
      if (tile.segk) {
        bool mine = false;
#pragma unroll
        for (int j = 0; j < IDS; ++j) {
          const int kpos = k0 + lane * IDS + j;
          ids[j] = kpos < p.s ? tile.segk[kpos] : 0;
          mine |= kpos < p.s && ids[j] >= qmin && ids[j] <= qmax;
        }
        if (!__any_sync(0xffffffffu, mine)) continue;
      }
      const int st = it % S;
      const uint32_t free = ((it / S) & 1) ^ 1;
      hp::mbar_wait(&sm.empty_k[st], free);
      if (tile.segk) {
#pragma unroll
        for (int j = 0; j < IDS; ++j) sm.ids[st * BK + lane * IDS + j] = ids[j];
      }
      if (lane == 0) {
        sm.k0s[st] = k0;
        hp::mbar_arrive_expect_tx(&sm.full_k[st], Smem<D>::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          hp::tma_load_3d(sm.k(st) + c * BK * 128, kmap, &sm.full_k[st], 64 * c, k0, tile.bkv);
      } else {
        hp::mbar_arrive(&sm.full_k[st]);  // after this lane's ids
      }
      hp::mbar_wait(&sm.empty_v[st], free);
      if (lane == 0) {
        hp::mbar_arrive_expect_tx(&sm.full_v[st], Smem<D>::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          hp::tma_load_3d(sm.v(st) + c * BK * 128, vmap, &sm.full_v[st], 64 * c, k0, tile.bkv);
      }
      ++it;
    }
  }
  const int st = it % S;
  hp::mbar_wait(&sm.empty_k[st], ((it / S) & 1) ^ 1);
  if (lane == 0) sm.k0s[st] = -1;
  hp::mbar_arrive(&sm.full_k[st]);
}

// One consumer warpgroup (wg 0 or 1, thread t of 128): its 64 rows against
// every tile the producer hands over. init(o, m, l, row0, row1, tq) seeds
// the state, store(o, m, l, row0, row1, tq) finishes it.
template <int D, class W, typename Init, typename Store>
__device__ __forceinline__ void consume(const Smem<D, W::SCHEDULED>& sm, const Problem& p,
                                        const Tile& tile, int wg, int t, Init init, Store store,
                                        const W& walk) {
  using T = FwdTiles<D>;
  constexpr int BQ = T::BQ, BK = T::BK, S = T::STAGES;
  const int warp = t >> 5, lane = t & 31, tq = lane & 3;
  const int r_lo = tile.q0 + 64 * wg, r_hi = r_lo + 63;
  const int row0 = r_lo + 16 * warp + (lane >> 2), row1 = row0 + 8;
  const int rows[2] = {row0, row1};
  int sr[2] = {0, 0};
  if (tile.segq) {
    sr[0] = row0 < p.s ? tile.segq[row0] : 0;
    sr[1] = row1 < p.s ? tile.segq[row1] : 0;
  }
  const float sl2 = p.scale * LOG2E;

  float o[D / 2], m[2], l[2];
  init(o, m, l, row0, row1, tq);
  if (wg == 1) hp::named_arrive(TURN, 256);  // warpgroup 0 goes first
  hp::mbar_wait(sm.qbar, 0);

  float sacc[BK / 2];
  uint32_t pf[BK / 16][4];  // P of the tile whose P V is pending, as A fragments

  // S = Q K^T of the tile in stage st, one commit group
  auto issue_s = [&](int st) {
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int blk = kk / 4, col = (kk % 4) * 32;
      const uint64_t a = hp::desc_b128(sm.q + blk * BQ * 128 + wg * 64 * 128 + col, 16, 1024);
      const uint64_t b = hp::desc_b128(sm.k(st) + blk * BK * 128 + col, 16, 1024);
      mma_s<BK>(sacc, a, b, kk != 0);
    }
    hp::wgmma_commit();
    hp::fence_acc(sacc);
  };
  // O += P V of the tile whose V is in stage st, one commit group
  auto issue_pv = [&](int st) {
    hp::fence_acc(o);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_o<D>(o, pf[kk], hp::desc_b128(sm.v(st) + kk * 2048, BK * 128, 1024));
    hp::wgmma_commit();
    hp::fence_acc(o);
  };
  // the online softmax of S (tile at k0, its ids in stage st): p in place
  // in sacc, m and l updated, the correction of O into corr
  auto softmax = [&](int st, int k0, float (&corr)[2]) {
    hp::fence_acc(sacc);
    // every pair visible: no mask (a scheduled walk's producer decides:
    // k0 is its stage word, broadcast by next_tile)
    bool whole;
    int code = 0;
    if constexpr (W::SCHEDULED) {
      code = (k0 >> (3 * wg)) & 7;
      k0 = (k0 >> 6) * BK;
      whole = code == SCHEDULED_WHOLE;
    } else {
      whole = !tile.segk && (!p.causal || k0 + BK - 1 <= r_lo) &&
              (!p.window || r_hi - k0 < p.window) && k0 + BK <= p.s && r_hi < p.s;
    }
    if (!whole) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int u = (i >> 1) & 1, c = 8 * (i >> 2) + 2 * tq + (i & 1);
        bool ok;
        if constexpr (W::SCHEDULED) {
          // both loads unconditional (shared memory; an id is unused without
          // ids): a load under a condition costs a branch region a pair
          const int col = sm.kinds[(2 * st + wg) * BK + c], id = sm.ids[st * BK + c];
          ok = walk.keep(code == SCHEDULED_COLUMNS ? col : code, rows[u], k0 + c, sr[u], id);
        } else {
          ok = dstt::flash::visible(p, rows[u], k0 + c);
          if (tile.segk) ok = ok && sm.ids[st * BK + c] == sr[u];
        }
        if (!ok) sacc[i] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY}, nb[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float mn = fmaxf(m[u], dstt::flash::quad_max(mx[u]) * p.scale);
      corr[u] = m[u] == mn ? 1.f : ex2((m[u] - mn) * LOG2E);
      m[u] = mn;
      nb[u] = -mn * LOG2E;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int u = (i >> 1) & 1;
      float pe = ex2(fmaf(sacc[i], sl2, nb[u]));
      if (!whole) pe = sacc[i] > -INFINITY ? pe : 0.f;
      rs[u] += pe;
      sacc[i] = pe;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) l[u] = l[u] * corr[u] + dstt::flash::quad_sum(rs[u]);
  };
  // O *= corr, then P of this tile into A fragments
  auto rescale_pack = [&](const float (&corr)[2]) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2)
      pf[i / 8][(i / 2) % 4] = dstt::flash::pack_bf16(sacc[i], sacc[i + 1]);
  };
  // the key position of the tile in stage st, -1 at the end (broadcast, so
  // that the compiler sees the loop's exit as uniform: a wgmma on a path it
  // cannot prove uniform is serialised)
  auto next_tile = [&](int it) {
    hp::mbar_wait(&sm.full_k[it % S], (it / S) & 1);
    return __shfl_sync(0xffffffffu, sm.k0s[it % S], 0);
  };

  // Tile j's S runs with tile j - 1's P V in flight and its softmax under
  // that P V; O is rescaled once the P V is done: O = O corr_j + P_j V_j,
  // tile by tile, as in one pass per tile. The first tile is peeled, the
  // last P V follows the walk; every tile takes one turn.
  int k0 = next_tile(0);
  if (k0 >= 0) {
    float corr[2];
    hp::named_sync(TURN + wg, 256);
    issue_s(0);
    hp::named_arrive(TURN + (wg ^ 1), 256);
    hp::wgmma_wait<0>();
    softmax(0, k0, corr);
    hp::mbar_arrive(&sm.empty_k[0]);
    rescale_pack(corr);
    int it = 1;
    for (;; ++it) {
      k0 = next_tile(it);
      if (k0 < 0) break;
      const int st = it % S, prev = (it - 1) % S;
      hp::named_sync(TURN + wg, 256);
      issue_s(st);
      hp::mbar_wait(&sm.full_v[prev], ((it - 1) / S) & 1);
      issue_pv(prev);
      hp::named_arrive(TURN + (wg ^ 1), 256);
      hp::wgmma_wait<1>();  // S done; the P V runs on under the softmax
      softmax(st, k0, corr);
      hp::mbar_arrive(&sm.empty_k[st]);  // K and the tile's ids read
      hp::wgmma_wait<0>();
      hp::fence_acc(o);
      hp::mbar_arrive(&sm.empty_v[prev]);
      rescale_pack(corr);
    }
    const int last = (it - 1) % S;
    hp::mbar_wait(&sm.full_v[last], ((it - 1) / S) & 1);
    issue_pv(last);
    hp::wgmma_wait<0>();
    hp::fence_acc(o);
  }
  if (wg == 0) hp::named_sync(TURN, 256);  // the turn warpgroup 1 handed over last
  store(o, m, l, row0, row1, tq);
}

// The CTA: barriers and the query tile's id range, then the roles over
// `walk`'s stages. The caller's kernel must end with this call (the roles
// never reconverge).
template <int D, typename Init, typename Store, class W = FlashWalk>
__device__ __forceinline__ void fwd_cta(unsigned char* smem_raw, const CUtensorMap* qmap,
                                        const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        const Problem& p, const Tile& tile, Init init,
                                        Store store, const W& walk = W()) {
  using T = FwdTiles<D>;
  const Smem<D, W::SCHEDULED> sm(smem_raw);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < T::STAGES; ++st) {
      hp::mbar_init(&sm.full_k[st], 32);    // the producer warp's lanes
      hp::mbar_init(&sm.full_v[st], 1);
      hp::mbar_init(&sm.empty_k[st], 256);  // every consumer thread
      hp::mbar_init(&sm.empty_v[st], 256);
    }
    hp::mbar_init(sm.qbar, 1);
    hp::mbar_init_fence();
    sm.qrange[0] = 0x7fffffff;
    sm.qrange[1] = -0x7fffffff - 1;
  }
  __syncthreads();
  if (tile.segq && tid < T::BQ && tile.q0 + tid < p.s) {
    const int sv = tile.segq[tile.q0 + tid];
    atomicMin(&sm.qrange[0], sv);
    atomicMax(&sm.qrange[1], sv);
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // uniform to the compiler
  if (wg == 2) {
    hp::setmaxnreg_dec<40>();
    if (tid < 256 + 32) produce<D>(sm, qmap, kmap, vmap, p, tile, tid & 31, walk);
  } else {
    hp::setmaxnreg_inc<232>();
    consume<D>(sm, p, tile, wg, tid & 127, init, store, walk);
  }
}

// The three maps of a launch: q [b h, s, D], k and v [b h_kv, s, D] (sk:
// the keys' length where it differs from the queries' p.s).
template <int D>
__host__ inline int encode_maps(CUtensorMap* maps, const void* q, const void* k, const void* v,
                                const Problem& p, int sk = -1) {
  const int ks = sk < 0 ? p.s : sk;
  int e = dstt::encode_tma_3d(&maps[0], q, D, p.s, (uint64_t)p.b * p.h, FwdTiles<D>::BQ);
  if (!e) e = dstt::encode_tma_3d(&maps[1], k, D, ks, (uint64_t)p.b * p.h_kv, FwdTiles<D>::BK);
  if (!e) e = dstt::encode_tma_3d(&maps[2], v, D, ks, (uint64_t)p.b * p.h_kv, FwdTiles<D>::BK);
  return e;
}

}  // namespace flash_hopper
}  // namespace dstt
