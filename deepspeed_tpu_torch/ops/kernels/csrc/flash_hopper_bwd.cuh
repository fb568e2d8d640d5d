// The flash backward's two CTA bodies on wgmma fed by TMA, dq and dk/dv,
// each shared by the single kernel (flash_bwd.cu) and the ring's carry-mode
// twin (flash_chunk.cu), so that a ring of chunks of whole tiles equals the
// single kernel bit for bit (out and lse come from flash_hopper.cuh).
//
// Arithmetic (the Pallas bodies', flash_pallas.py:152-290): per visible
// (query, key) pair p = 2^(S scale log2 e - lse log2 e) (exactly 0 for a
// masked pair), dS = p (dP - delta) with dP = dO V^T and delta = sum(dO O)
// over the query's row in fp32; p and dS rounded to bf16 before their
// products; dq = scale sum dS K, dk = scale sum dS^T Q, dv = sum P^T dO,
// each summed in fp32 and rounded once. dk and dv are summed over the kv
// head's GQA group in the kernel (the Pallas path writes per-query-head
// partials and sums them afterwards).
//
// dq (dq_cta): one CTA per (BQ = 128 query rows, b * h), the forward's
// shape (flash_hopper.cuh): 384 threads in three warpgroups.
//  * warpgroup 2, lowered to 40 registers: its first warp is the producer.
//    It loads the Q and dO tiles once (3-D maps: rows past s arrive as
//    zeros), then walks the key tiles the causal bound, the band and the
//    segment ids leave live (pruned before any copy, as the forward) and
//    loads K and V of each into a ring of STAGES stages (one `full`
//    mbarrier a stage, K and V together; one `empty`). A stage carries its
//    first key position and its key ids; -1 ends the walk.
//  * warpgroups 0 and 1, raised to 232 registers, 64 query rows each. Each
//    first takes its rows' lse and delta (dO and O from device memory, a
//    quarter row a lane). Per key tile: S = Q K^T and dP = dO V^T (both
//    operands in shared memory, K-major), p and dS on the accumulator
//    fragments, then dQ += dS K with dS from registers (A fragments) and
//    the same K tile as the MN-major B operand. A tile's dS K is issued
//    with the next tile's S and dP and runs under the next tile's
//    elementwise work, so the stage goes back once that product is done;
//    the order of the sums stays the order of the tiles. (At d 256, where
//    dQ alone is 128 registers a thread, dS K takes a turn of its own.)
//    The two consumers take turns at the tensor cores (named barriers), as
//    in the forward.
// dk/dv (dkv_cta): one CTA per (KV_BK key rows, b * h_kv), 384 threads.
//  * The producer warp loads the CTA's K and V once, then walks the query
//    tiles of KV_BQ rows that see the key tile (query_tiles, the band, the
//    segment ids), query tile outer and the GQA group's heads inner, and
//    loads Q, dO and O of each (tile, head) into a ring of KV_STAGES. The
//    stage carries the query tile's position and ids; -1 ends the walk. The
//    same order in the single kernel and the ring (whose hops hand over
//    query chunks in ascending order) makes one order of the fp32 sums, so
//    the ring's GQA dk/dv are the single kernel's bits.
//  * Warps 1 and 2 of warpgroup 2 (a query row a thread) take each
//    stage's delta = sum(dO O) from its dO and O tiles, and lse log2 e,
//    into the stage's slots (an `aux` mbarrier): the JAX body's in-kernel
//    delta, off the consumers' path and a stage ahead of them. (Read from
//    device memory a row a thread, with a few loads in flight, it could not
//    keep pace with the consumers.)
//  * Warpgroups 0 and 1 (232 registers; warpgroup 2 lowered to 40): per
//    (tile, head) S^T = K Q^T and dP^T = V dO^T (m64nKV_BQ, shared memory),
//    p^T and dS^T in registers, then dV += P^T dO and dK += dS^T Q with P^T,
//    dS^T from registers and dO, Q as MN-major B operands. At d 64 and 128 the CTA holds 128 keys, 64 a warpgroup; at d
//    256 (dK and dV alone would take 256 registers a thread) it holds 64
//    keys and each warpgroup sums 128 of the columns, both computing S^T
//    and dP^T.
// Every wgmma is waited for in the same tile and off any branch; the loop
// exits on values broadcast across the warp (flash_hopper.cuh's pitfalls:
// otherwise ptxas serialises every wgmma of the kernel).
//
// Both bodies take the walk as a template policy, as the forward does:
// FlashWalk (the flash kernels; flash_hopper.cuh) or a scheduled walk (the
// splash kernels' over a schedule, splash_bwd.cu; the sparse kernels' over
// the int32 layout, sparse_common.cuh), which brings its producer walk and
// its rule for a kept pair. dq's scheduled walk packs each K/V stage's
// first key with a code per consumer warpgroup (flash_hopper.cuh's
// SCHEDULED_COLUMNS); p.s is then the query length. dk/dv's hands over a
// step kind per 64-key half of the CTA's keys; p.s is then the key length.
//
// ALiBi (AlibiWalk, flash_hopper.cuh): dq's producer hands each stage's
// terms over with the tile, as the forward's; dk/dv's CTA holds its keys'
// positions and the producer hands over each stage's slope, since under GQA
// the stage's query head, and with it the slope, changes stage by stage.
// Both then take p = 2^(fmaf(S, scale, term) log2 e - lse log2 e), the
// forward's logits.
//
// Tiles per head dim (BwdTiles; ops/attention/flash.py BWD_TILES mirrors
// them): dq BQ 128 query rows a CTA and BK key rows a stage (64; 32 at d
// 256, where Q, dO and stages of 64-key K and V would not fit in shared
// memory), three stages (a stage goes back only after the next tile's
// elementwise work: with two the producer got it back just as it was
// needed, and four ran no faster); dk/dv KV_BK key rows a CTA (128; 64 at d
// 256) and KV_BQ = 64 query rows a stage, three stages (one at d 256, where
// a stage of Q, dO and O is 96 KB; three stages of 32 rows ran slower).
// Shared memory: dq 80 / 160 / 224 KB and dk/dv 104 / 208 / 160 KB at d 64
// / 128 / 256. The bits depend on the key tiles of dq
// (BK) and the query tiles of dk/dv (KV_BQ) only: a CTA's rows are summed
// independently, and a tile that masks a row adds exactly 0 to it.
#pragma once

#include "flash_hopper.cuh"

namespace dstt {
namespace flash_hopper {

template <int D>
struct BwdTiles;
template <>
struct BwdTiles<64> {
  static constexpr int BQ = 128, BK = 64, KV_BK = 128, KV_BQ = 64, STAGES = 3, KV_STAGES = 3;
};
template <>
struct BwdTiles<128> {
  static constexpr int BQ = 128, BK = 64, KV_BK = 128, KV_BQ = 64, STAGES = 3, KV_STAGES = 3;
};
template <>
struct BwdTiles<256> {
  static constexpr int BQ = 128, BK = 32, KV_BK = 64, KV_BQ = 64, STAGES = 3, KV_STAGES = 1;
};


// setmaxnreg's split of the CTA's registers (168 a thread at launch): the
// two consumer warpgroups and warpgroup 2 (the producer warp, and in dk/dv
// the delta threads). 240 / 24 spilled warpgroup 2 and ran dk/dv slower.
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;

// S[64 x N] = A B^T (k-th 16-deep step; both operands K-major in shared
// memory)
template <int N>
__device__ __forceinline__ void mma_ss(float (&s)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 128) hp::wgmma_m64n128k16<0, 0>(s, a, b, acc);
  else if constexpr (N == 64) hp::wgmma_m64n64k16<0, 0>(s, a, b, acc);
  else hp::wgmma_m64n32k16<0, 0>(s, a, b, acc);
}

// sum of a[i] b[i] over N bf16 pairs in fp32, 16-byte loads, in order
template <int N, int UNROLL>
__device__ __forceinline__ float dot_row(const bf16* a, const bf16* b) {
  float acc = 0.f;
#pragma unroll UNROLL
  for (int c = 0; c < N; c += 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(a + c);
    const uint4 y = *reinterpret_cast<const uint4*>(b + c);
    const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fx = __bfloat1622float2(xp[j]), fy = __bfloat1622float2(yp[j]);
      acc = fmaf(fx.x, fy.x, acc);
      acc = fmaf(fx.y, fy.y, acc);
    }
  }
  return acc;
}

// ===========================================================================
// dq
// ===========================================================================
// Dynamic shared memory: Q and dO [D/64 blocks][BQ rows][128 bytes] each;
// each stage K then V, [D/64][BK][128] each; then the mbarriers (full and
// empty per stage; Q), each stage's first key position, each stage's key
// ids, the query tile's id range; KINDS (a scheduled walk): each stage's
// step kind per (consumer warpgroup, key column), a byte each; ALIBI: each
// stage's ALiBi term per key column, fp32.
template <int D, bool KINDS = false, bool ALIBI = false>
struct DqSmem {
  using T = BwdTiles<D>;
  static constexpr int Q_BYTES = T::BQ * D * 2;
  static constexpr int KV_BYTES = T::BK * D * 2;
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int TILES = 2 * Q_BYTES + T::STAGES * STAGE;
  static constexpr int BYTES = 1024 + TILES + (2 * T::STAGES + 1) * 8 +
                               T::STAGES * 4 * (1 + T::BK) + 8 +
                               (KINDS ? T::STAGES * 2 * T::BK : 0) +
                               (ALIBI ? 16 + T::STAGES * 4 * T::BK : 0);

  unsigned char* q;
  unsigned char* dout;
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* qbar;
  int* k0s;
  int* ids;
  int* qrange;
  unsigned char* kinds;  // KINDS: [STAGES][2][BK]
  float* bias;           // ALIBI: [STAGES][BK]

  __device__ explicit DqSmem(unsigned char* raw) {
    q = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                         ~uintptr_t(1023));
    dout = q + Q_BYTES;
    ring = dout + Q_BYTES;
    full = reinterpret_cast<uint64_t*>(q + TILES);
    empty = full + T::STAGES;
    qbar = empty + T::STAGES;
    k0s = reinterpret_cast<int*>(qbar + 1);
    ids = k0s + T::STAGES;
    qrange = ids + T::STAGES * T::BK;
    kinds = reinterpret_cast<unsigned char*>(qrange + 2);
    // 16-byte aligned: the consumers read the terms in pairs
    bias = reinterpret_cast<float*>(
        (reinterpret_cast<uintptr_t>(kinds + (KINDS ? T::STAGES * 2 * T::BK : 0)) + 15) &
        ~uintptr_t(15));
  }
  __device__ unsigned char* k(int st) const { return ring + st * STAGE; }
  __device__ unsigned char* v(int st) const { return k(st) + KV_BYTES; }
};

// maps: q, dO [b h, s, D] in boxes of BQ rows; k, v [b h_kv, s, D] in
// boxes of BK rows
template <int D, class W>
__device__ __forceinline__ void dq_produce(const DqSmem<D, W::SCHEDULED, IsAlibi<W>::value>& sm,
                                           const CUtensorMap* const* maps, const Problem& p,
                                           const Tile& tile, int lane, const W& walk) {
  using T = BwdTiles<D>;
  constexpr int BK = T::BK, S = T::STAGES, IDS = BK / 32;
  if (lane == 0) {
    for (int m = 0; m < 4; ++m) hp::tma_prefetch_desc(maps[m]);
    hp::mbar_arrive_expect_tx(sm.qbar, 2 * DqSmem<D>::Q_BYTES);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      hp::tma_load_3d(sm.q + c * T::BQ * 128, maps[0], sm.qbar, 64 * c, tile.q0, tile.bh);
      hp::tma_load_3d(sm.dout + c * T::BQ * 128, maps[1], sm.qbar, 64 * c, tile.q0, tile.bh);
    }
  }
  int it = 0;
  if constexpr (W::SCHEDULED) {
    it = walk.template produce<D>(sm, maps, p, tile, lane);
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
      float terms[IDS];
      if constexpr (IsAlibi<W>::value) alibi_terms<BK>(terms, walk, p, tile, k0, lane);
      const int st = it % S;
      hp::mbar_wait(&sm.empty[st], ((it / S) & 1) ^ 1);
      if (tile.segk) {
#pragma unroll
        for (int j = 0; j < IDS; ++j) sm.ids[st * BK + lane * IDS + j] = ids[j];
      }
      if constexpr (IsAlibi<W>::value) store_terms<BK>(sm.bias + st * BK, terms, lane);
      if (lane == 0) {
        sm.k0s[st] = k0;
        hp::mbar_arrive_expect_tx(&sm.full[st], DqSmem<D>::STAGE);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          hp::tma_load_3d(sm.k(st) + c * BK * 128, maps[2], &sm.full[st], 64 * c, k0, tile.bkv);
          hp::tma_load_3d(sm.v(st) + c * BK * 128, maps[3], &sm.full[st], 64 * c, k0, tile.bkv);
        }
      } else {
        hp::mbar_arrive(&sm.full[st]);  // after this lane's ids
      }
      ++it;
    }
  }
  const int st = it % S;
  hp::mbar_wait(&sm.empty[st], ((it / S) & 1) ^ 1);
  if (lane == 0) sm.k0s[st] = -1;
  hp::mbar_arrive(&sm.full[st]);
}

// One dq consumer warpgroup (wg 0 or 1, thread t of 128): its 64 rows
// against every key tile the producer hands over. ob, dob, lseb: the
// head's o, do [s, D] and lse [s]. init(acc, row0, row1, tq) seeds dQ,
// store(acc, row0, row1, tq) finishes it (both derive their row offsets
// from blockIdx: a value held across the walk costs a register the
// consumers do not have).
template <int D, class W, typename Init, typename Store>
__device__ __forceinline__ void dq_consume(const DqSmem<D, W::SCHEDULED, IsAlibi<W>::value>& sm,
                                           const Problem& p,
                                           const Tile& tile, const bf16* ob, const bf16* dob,
                                           const float* lseb, int wg, int t, Init init,
                                           Store store, const W& walk) {
  using T = BwdTiles<D>;
  constexpr int BQ = T::BQ, BK = T::BK, S = T::STAGES;
  const int warp = t >> 5, lane = t & 31, tq = lane & 3;
  const int r_lo = tile.q0 + 64 * wg, r_hi = r_lo + 63;
  const int row0 = r_lo + 16 * warp + (lane >> 2), row1 = row0 + 8;
  const int rows[2] = {row0, row1};
  int sr[2] = {0, 0};
  float lse2[2], delta[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const bool in = rows[u] < p.s;
    if (tile.segq && in) sr[u] = tile.segq[rows[u]];
    lse2[u] = in ? lseb[rows[u]] * LOG2E : 0.f;
    const int64_t at = (int64_t)rows[u] * D + tq * (D / 4);
    delta[u] = dstt::flash::quad_sum(in ? dot_row<D / 4, D / 32>(dob + at, ob + at) : 0.f);
  }
  // ALiBi keeps the scores scaled (the term is added to them), as the
  // forward does
  const float sl2 = IsAlibi<W>::value ? LOG2E : p.scale * LOG2E;

  float dq[D / 2];
  init(dq, row0, row1, tq);
  if (wg == 1) hp::named_arrive(TURN, 256);  // warpgroup 0 goes first
  hp::mbar_wait(sm.qbar, 0);

  float sacc[BK / 2], pacc[BK / 2];
  uint32_t df[BK / 16][4];  // dS of the tile whose dS K is pending, as A fragments

  // S = Q K^T and dP = dO V^T of the tile in stage st, one commit group
  auto issue_sdp = [&](int st) {
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * BQ * 128 + wg * 64 * 128 + (kk % 4) * 32;
      const int koff = (kk / 4) * BK * 128 + (kk % 4) * 32;
      mma_ss<BK>(sacc, hp::desc_b128(sm.q + off, 16, 1024),
                 hp::desc_b128(sm.k(st) + koff, 16, 1024), kk != 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * BQ * 128 + wg * 64 * 128 + (kk % 4) * 32;
      const int koff = (kk / 4) * BK * 128 + (kk % 4) * 32;
      mma_ss<BK>(pacc, hp::desc_b128(sm.dout + off, 16, 1024),
                 hp::desc_b128(sm.v(st) + koff, 16, 1024), kk != 0);
    }
    hp::wgmma_commit();
    hp::fence_acc(sacc);
    hp::fence_acc(pacc);
  };
  // dQ += dS K of the tile whose K is in stage st, one commit group
  auto issue_dq = [&](int st) {
    hp::fence_acc(dq);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      mma_o<D>(dq, df[kk], hp::desc_b128(sm.k(st) + kk * 2048, BK * 128, 1024));
    hp::wgmma_commit();
    hp::fence_acc(dq);
  };
  // p and dS = p (dP - delta) of the tile at k0 (its ids in stage st), in
  // place in pacc
  auto grad = [&](int st, int k0) {
    hp::fence_acc(sacc);
    hp::fence_acc(pacc);
    bool whole;  // a scheduled walk's producer decides (k0: its stage word)
    int code = 0;
    if constexpr (W::SCHEDULED) {
      code = (k0 >> (3 * wg)) & 7;
      k0 = (k0 >> 6) * BK;
      whole = code == SCHEDULED_WHOLE;
    } else {
      whole = !tile.segk && (!p.causal || k0 + BK - 1 <= r_lo) &&
              (!p.window || r_hi - k0 < p.window) && k0 + BK <= p.s && r_hi < p.s;
    }
    if constexpr (IsAlibi<W>::value) {  // logits = S scale + the term, the forward's
      const float* bs = sm.bias + st * BK;
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const float2 b = *reinterpret_cast<const float2*>(bs + 8 * (i >> 2) + 2 * tq);
        sacc[i] = fmaf(sacc[i], p.scale, b.x);
        sacc[i + 1] = fmaf(sacc[i + 1], p.scale, b.y);
      }
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int u = (i >> 1) & 1;
      float pe = ex2(fmaf(sacc[i], sl2, -lse2[u]));
      if (!whole) {
        const int c = 8 * (i >> 2) + 2 * tq + (i & 1);
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
        pe = ok ? pe : 0.f;
      }
      pacc[i] = pe * (pacc[i] - delta[u]);
    }
  };
  auto pack = [&]() {
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2)
      df[i / 8][(i / 2) % 4] = dstt::flash::pack_bf16(pacc[i], pacc[i + 1]);
  };
  // the key position of the tile in stage it % S, -1 at the end (broadcast:
  // a loop exit the compiler sees as uniform)
  auto next_tile = [&](int it) {
    hp::mbar_wait(&sm.full[it % S], (it / S) & 1);
    return __shfl_sync(0xffffffffu, sm.k0s[it % S], 0);
  };

  // Tile j's S and dP run with tile j - 1's dS K in flight and tile j's
  // elementwise work under that product; dQ gets the tiles' products in
  // tile order. The first tile is peeled, the last dS K follows the walk.
  // At d 256 (dQ alone 128 registers a thread) dQ, S, dP and the pending dS
  // do not fit together: each tile's dS K is issued on its own turn and
  // waited for, as dk/dv does.
  if constexpr (D == 256) {
    for (int it = 0;; ++it) {
      const int k0 = next_tile(it);
      if (k0 < 0) break;
      const int st = it % S;
      hp::named_sync(TURN + wg, 256);
      issue_sdp(st);
      hp::named_arrive(TURN + (wg ^ 1), 256);
      hp::wgmma_wait<0>();
      grad(st, k0);
      pack();
      hp::named_sync(TURN + wg, 256);
      issue_dq(st);
      hp::named_arrive(TURN + (wg ^ 1), 256);
      hp::wgmma_wait<0>();
      hp::fence_acc(dq);
      hp::mbar_arrive(&sm.empty[st]);  // K, V and the ids read
    }
  } else if (int k0 = next_tile(0); k0 >= 0) {
    hp::named_sync(TURN + wg, 256);
    issue_sdp(0);
    hp::named_arrive(TURN + (wg ^ 1), 256);
    hp::wgmma_wait<0>();
    grad(0, k0);
    pack();
    int it = 1;
    for (;; ++it) {
      k0 = next_tile(it);
      if (k0 < 0) break;
      const int st = it % S, prev = (it - 1) % S;
      hp::named_sync(TURN + wg, 256);
      issue_sdp(st);
      issue_dq(prev);
      hp::named_arrive(TURN + (wg ^ 1), 256);
      hp::wgmma_wait<1>();  // S and dP done; the previous dS K runs on
      grad(st, k0);
      hp::wgmma_wait<0>();
      hp::fence_acc(dq);
      hp::mbar_arrive(&sm.empty[prev]);  // K, V and the ids of tile it - 1 read
      pack();
    }
    const int last = (it - 1) % S;
    hp::named_sync(TURN + wg, 256);
    issue_dq(last);
    hp::named_arrive(TURN + (wg ^ 1), 256);
    hp::wgmma_wait<0>();
    hp::fence_acc(dq);
    hp::mbar_arrive(&sm.empty[last]);
  }
  if (wg == 0) hp::named_sync(TURN, 256);  // the turn warpgroup 1 handed over last
  store(dq, row0, row1, tq);
}

// The dq CTA: barriers and the query tile's id range, then the roles over
// `walk`'s stages. The caller's kernel must end with this call (the roles
// never reconverge).
template <int D, typename Init, typename Store, class W = FlashWalk>
__device__ __forceinline__ void dq_cta(unsigned char* smem_raw, const CUtensorMap* const* maps,
                                       const Problem& p, const Tile& tile, const bf16* ob,
                                       const bf16* dob, const float* lseb, Init init,
                                       Store store, const W& walk = W()) {
  using T = BwdTiles<D>;
  const DqSmem<D, W::SCHEDULED, IsAlibi<W>::value> sm(smem_raw);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < T::STAGES; ++st) {
      hp::mbar_init(&sm.full[st], 32);    // the producer warp's lanes
      hp::mbar_init(&sm.empty[st], 256);  // every consumer thread
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
    hp::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid < 256 + 32) dq_produce<D>(sm, maps, p, tile, tid & 31, walk);
  } else {
    hp::setmaxnreg_inc<CONSUMER_REGS>();
    dq_consume<D>(sm, p, tile, ob, dob, lseb, wg, tid & 127, init, store, walk);
  }
}

// ===========================================================================
// dk/dv
// ===========================================================================
// Dynamic shared memory: K and V [D/64 blocks][KV_BK rows][128 bytes]
// each; each stage Q, dO, then O, [D/64][KV_BQ][128] each; then the
// mbarriers (K/V; full, info, aux and empty per stage), each stage's query
// position and (batch, head) row, its query ids, delta and lse log2 e, the
// key tile's id range; ALIBI: each stage's slope.
template <int D, bool KINDS = false, bool ALIBI = false>
struct DkvSmem {
  using T = BwdTiles<D>;
  static constexpr int S = T::KV_STAGES;
  static constexpr int KV_BYTES = T::KV_BK * D * 2;
  static constexpr int Q_BYTES = T::KV_BQ * D * 2;
  static constexpr int STAGE = 3 * Q_BYTES;
  static constexpr int TILES = 2 * KV_BYTES + S * STAGE;
  static constexpr int BYTES = 1024 + TILES + (4 * S + 1) * 8 + S * 4 * (2 + 3 * T::KV_BQ) + 8 +
                               (KINDS ? S * 2 * 4 : 0) + (ALIBI ? S * 4 : 0);

  unsigned char* k;
  unsigned char* v;
  unsigned char* ring;
  uint64_t* full;
  uint64_t* info;
  uint64_t* aux;
  uint64_t* empty;
  uint64_t* kvbar;
  int* q0s;
  int* heads;
  int* ids;
  float* delta;
  float* lse2;
  int* krange;
  int* kinds;    // KINDS: each stage's step kind per 64-key half of the CTA's keys
  int* cursors;  // KINDS: the scheduled walk's cursors (their bytes added at launch)
  float* slope;  // ALIBI: [S]

  __device__ explicit DkvSmem(unsigned char* raw) {
    k = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                         ~uintptr_t(1023));
    v = k + KV_BYTES;
    ring = v + KV_BYTES;
    full = reinterpret_cast<uint64_t*>(k + TILES);
    info = full + S;
    aux = info + S;
    empty = aux + S;
    kvbar = empty + S;
    q0s = reinterpret_cast<int*>(kvbar + 1);
    heads = q0s + S;
    ids = heads + S;
    delta = reinterpret_cast<float*>(ids + S * T::KV_BQ);
    lse2 = delta + S * T::KV_BQ;
    krange = reinterpret_cast<int*>(lse2 + S * T::KV_BQ);
    kinds = krange + 2;
    cursors = kinds + 2 * S;
    slope = reinterpret_cast<float*>(kinds + (KINDS ? 2 * S : 0));
  }
  __device__ unsigned char* q(int st) const { return ring + st * STAGE; }
  __device__ unsigned char* dout(int st) const { return q(st) + Q_BYTES; }
  __device__ unsigned char* o(int st) const { return dout(st) + Q_BYTES; }
};

// The walk of a dk/dv CTA: which (query tile, head) stages its producer
// hands over, and the rule for a kept pair. FlashWalk (SCHEDULED false):
// the query tiles of query_tiles, the band and the segment ids, and
// flash_common.cuh's `visible`. A scheduled walk (splash_bwd.cu,
// sparse_common.cuh) brings its own producer walk (produce: the stages it
// issued), the step kind of each stage per 64-key half of the CTA's keys,
// the rule for a kept pair of a step of that kind (keep, and whole: a
// stage that needs no predicate), and its query length sq (queries and
// keys may differ). Splash's producer keeps its cursors in shared memory
// past the kinds (`cursors`: its launch adds their bytes to BYTES).

// Where a dk/dv CTA sits: its (batch, kv head) row, batch and kv head, its
// first key row, and the id planes of its batch row (queries, keys).
struct KvTile {
  int bkv, bi, kvh, k0;
  const int* segq;
  const int* segk;
};

// The first key tiles carry the most work under a causal mask and go
// first (CUDA hands blocks out x fastest).
template <int D>
__device__ __forceinline__ KvTile make_kv_tile(const Problem& p, const int* seg_q,
                                               const int* seg_k) {
  KvTile t;
  t.bkv = blockIdx.x;
  t.bi = t.bkv / p.h_kv;
  t.kvh = t.bkv % p.h_kv;
  t.k0 = blockIdx.y * BwdTiles<D>::KV_BK;
  t.segq = seg_q ? seg_q + (int64_t)t.bi * p.s : nullptr;
  t.segk = seg_k ? seg_k + (int64_t)t.bi * p.s : nullptr;
  return t;
}

// maps: k, v [b h_kv, s, D] in boxes of KV_BK rows; q, dO, O [b h, s, D]
// in boxes of KV_BQ rows
template <int D, class W>
__device__ __forceinline__ void dkv_produce(const DkvSmem<D, W::SCHEDULED, IsAlibi<W>::value>& sm,
                                            const CUtensorMap* const* maps, const Problem& p,
                                            const KvTile& kt, int lane, const W& walk) {
  using T = BwdTiles<D>;
  constexpr int BQ = T::KV_BQ, S = T::KV_STAGES, IDS = BQ / 32;
  if (lane == 0) {
    for (int m = 0; m < 5; ++m) hp::tma_prefetch_desc(maps[m]);
    hp::mbar_arrive_expect_tx(sm.kvbar, 2 * DkvSmem<D>::KV_BYTES);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      hp::tma_load_3d(sm.k + c * T::KV_BK * 128, maps[0], sm.kvbar, 64 * c, kt.k0, kt.bkv);
      hp::tma_load_3d(sm.v + c * T::KV_BK * 128, maps[1], sm.kvbar, 64 * c, kt.k0, kt.bkv);
    }
  }
  int it = 0;
  if constexpr (W::SCHEDULED) {
    it = walk.template produce<D>(sm, maps, p, kt, lane);
  } else {
    const int kmin = sm.krange[0], kmax = sm.krange[1];
    const int group = p.h / p.h_kv;
    const int head0 = kt.bi * p.h + kt.kvh * group;
    int lo, hi;
    dstt::flash::query_tiles<BQ, T::KV_BK>(p, kt.k0, lo, hi);
    for (int q0 = lo; q0 < hi; q0 += BQ) {
      int ids[IDS];
      if (kt.segq) {
        bool mine = false;
#pragma unroll
        for (int j = 0; j < IDS; ++j) {
          const int qpos = q0 + lane * IDS + j;
          ids[j] = qpos < p.s ? kt.segq[qpos] : 0;
          mine |= qpos < p.s && ids[j] >= kmin && ids[j] <= kmax;
        }
        if (!__any_sync(0xffffffffu, mine)) continue;
      }
      for (int gq = 0; gq < group; ++gq) {
        const int st = it % S;
        hp::mbar_wait(&sm.empty[st], ((it / S) & 1) ^ 1);
        if (kt.segq) {
#pragma unroll
          for (int j = 0; j < IDS; ++j) sm.ids[st * BQ + lane * IDS + j] = ids[j];
        }
        if (lane == 0) {
          sm.q0s[st] = q0;
          sm.heads[st] = head0 + gq;
          if constexpr (IsAlibi<W>::value) sm.slope[st] = walk.slopes[kt.kvh * group + gq];
          hp::mbar_arrive(&sm.info[st]);
          hp::mbar_arrive_expect_tx(&sm.full[st], DkvSmem<D>::STAGE);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            hp::tma_load_3d(sm.q(st) + c * BQ * 128, maps[2], &sm.full[st], 64 * c, q0,
                            head0 + gq);
            hp::tma_load_3d(sm.dout(st) + c * BQ * 128, maps[3], &sm.full[st], 64 * c, q0,
                            head0 + gq);
            hp::tma_load_3d(sm.o(st) + c * BQ * 128, maps[4], &sm.full[st], 64 * c, q0,
                            head0 + gq);
          }
        } else {
          hp::mbar_arrive(&sm.full[st]);  // after this lane's ids
        }
        ++it;
      }
    }
  }
  const int st = it % S;
  hp::mbar_wait(&sm.empty[st], ((it / S) & 1) ^ 1);
  if (lane == 0) {
    sm.q0s[st] = -1;
    hp::mbar_arrive(&sm.info[st]);
  }
  hp::mbar_arrive(&sm.full[st]);
}

// The delta threads (r: the query row within a tile, 0 .. KV_BQ - 1):
// per stage, delta = sum(dO O) over the row from the stage's dO and O
// tiles (row r's 16-byte chunk j of a 64-column block sits at chunk j ^ (r
// % 8): the 128-byte swizzle; eight rows a quarter warp, no bank
// conflict), and lse log2 e from device memory (lse [b h, s]), read as
// soon as the producer names the stage's (batch, head) row and query tile,
// before its copies land; 0 past s.
template <int D, class W>
__device__ __forceinline__ void dkv_delta(const DkvSmem<D, W::SCHEDULED, IsAlibi<W>::value>& sm,
                                          const Problem& p,
                                          const float* lse, int r, const W& walk) {
  using T = BwdTiles<D>;
  constexpr int BQ = T::KV_BQ, S = T::KV_STAGES;
  int sq;  // query rows
  if constexpr (W::SCHEDULED) {
    sq = walk.sq;
  } else {
    sq = p.s;
  }
  for (int it = 0;; ++it) {
    const int st = it % S;
    const uint32_t ph = (it / S) & 1;
    hp::mbar_wait(&sm.info[st], ph);
    const int q0 = sm.q0s[st];
    if (q0 < 0) break;
    const bool in = q0 + r < sq;
    const float l2 = in ? lse[(int64_t)sm.heads[st] * sq + q0 + r] * LOG2E : 0.f;
    hp::mbar_wait(&sm.full[st], ph);
    const unsigned char* a = sm.dout(st) + r * 128;
    const unsigned char* b = sm.o(st) + r * 128;
    float dl = 0.f;
#pragma unroll 4
    for (int j = 0; j < D / 8; ++j) {
      const int off = (j / 8) * BQ * 128 + (((j % 8) ^ (r & 7)) << 4);
      const uint4 x = *reinterpret_cast<const uint4*>(a + off);
      const uint4 y = *reinterpret_cast<const uint4*>(b + off);
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fx = __bfloat1622float2(xp[e]), fy = __bfloat1622float2(yp[e]);
        dl = fmaf(fx.x, fy.x, dl);
        dl = fmaf(fx.y, fy.y, dl);
      }
    }
    sm.delta[st * BQ + r] = dl;
    sm.lse2[st * BQ + r] = l2;
    hp::mbar_arrive(&sm.aux[st]);
  }
}

// One dk/dv consumer warpgroup (wg 0 or 1, thread t of 128): its 64 keys
// (its DC columns of dK and dV) against every (query tile, head) the
// producer hands over. init(dk, dv, key0, key1, c0, tq) seeds the sums,
// store(dk, dv, key0, key1, c0, tq) finishes them.
template <int D, class W, typename Init, typename Store>
__device__ __forceinline__ void dkv_consume(const DkvSmem<D, W::SCHEDULED, IsAlibi<W>::value>& sm,
                                            const Problem& p,
                                            const KvTile& kt, int wg, int t, Init init,
                                            Store store, const W& walk) {
  using T = BwdTiles<D>;
  constexpr int BQ = T::KV_BQ, KV_BK = T::KV_BK, S = T::KV_STAGES;
  // SPLIT: both warpgroups on the CTA's 64 keys, half the columns each
  constexpr bool SPLIT = KV_BK == 64;
  constexpr int DC = SPLIT ? D / 2 : D;
  const int kr = SPLIT ? 0 : 64 * wg;  // the warpgroup's first key row in the CTA's tile
  const int c0 = SPLIT ? DC * wg : 0;  // its first column of dK and dV
  const int warp = t >> 5, lane = t & 31, tq = lane & 3;
  const int k_lo = kt.k0 + kr, k_hi = k_lo + 63;
  const int key0 = k_lo + 16 * warp + (lane >> 2), key1 = key0 + 8;
  const int keys[2] = {key0, key1};
  int sk[2] = {0, 0};
  if (kt.segk) {
    sk[0] = key0 < p.s ? kt.segk[key0] : 0;
    sk[1] = key1 < p.s ? kt.segk[key1] : 0;
  }
  const bool seg = kt.segq != nullptr;
  const float sl2 = p.scale * LOG2E;
  float kf[2] = {0.f, 0.f};  // ALiBi: the keys' positions
  if constexpr (IsAlibi<W>::value) {
    const int* kpos = walk.kpos + (int64_t)kt.bi * p.s;
    kf[0] = key0 < p.s ? (float)kpos[key0] : 0.f;
    kf[1] = key1 < p.s ? (float)kpos[key1] : 0.f;
  }

  float dk[DC / 2], dv[DC / 2];
  init(dk, dv, key0, key1, c0, tq);
  if (wg == 1) hp::named_arrive(TURN, 256);  // warpgroup 0 goes first
  hp::mbar_wait(sm.kvbar, 0);

  float sacc[BQ / 2], pacc[BQ / 2];
  uint32_t pf[BQ / 16][4], df[BQ / 16][4];

  for (int it = 0;; ++it) {
    const int st = it % S;
    const uint32_t ph = (it / S) & 1;
    hp::mbar_wait(&sm.full[st], ph);
    const int q0 = __shfl_sync(0xffffffffu, sm.q0s[st], 0);  // uniform: the loop's exit
    if (q0 < 0) break;
    hp::mbar_wait(&sm.aux[st], ph);

    // S^T = K Q^T and dP^T = V dO^T, one commit group
    hp::named_sync(TURN + wg, 256);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int aoff = (kk / 4) * KV_BK * 128 + kr * 128 + (kk % 4) * 32;
      const int boff = (kk / 4) * BQ * 128 + (kk % 4) * 32;
      mma_ss<BQ>(sacc, hp::desc_b128(sm.k + aoff, 16, 1024),
                 hp::desc_b128(sm.q(st) + boff, 16, 1024), kk != 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int aoff = (kk / 4) * KV_BK * 128 + kr * 128 + (kk % 4) * 32;
      const int boff = (kk / 4) * BQ * 128 + (kk % 4) * 32;
      mma_ss<BQ>(pacc, hp::desc_b128(sm.v + aoff, 16, 1024),
                 hp::desc_b128(sm.dout(st) + boff, 16, 1024), kk != 0);
    }
    hp::wgmma_commit();
    hp::named_arrive(TURN + (wg ^ 1), 256);
    hp::wgmma_wait<0>();
    hp::fence_acc(sacc);
    hp::fence_acc(pacc);

    // p^T and dS^T (rows: keys; columns: the tile's queries)
    bool whole;
    int kind = 0;  // scheduled: the stage's step kind for this warpgroup's keys
    if constexpr (W::SCHEDULED) {
      kind = sm.kinds[2 * st + (SPLIT ? 0 : wg)];
      whole = walk.whole(kind, q0, q0 + BQ, k_lo, k_hi, p.s);
    } else {
      whole = !seg && (!p.causal || k_hi <= q0) &&
              (!p.window || q0 + BQ - 1 - k_lo < p.window) && q0 + BQ <= p.s && k_hi < p.s;
    }
    // p^T first (the tile's lse), then dS^T (its delta): the barrier keeps
    // the compiler from holding all 32 of those values beside the 192
    // accumulator registers at once
    const float* dl = sm.delta + st * BQ;
    const float* l2 = sm.lse2 + st * BQ;
    float bias[2];  // ALiBi: the stage's slope times the keys' positions
    if constexpr (IsAlibi<W>::value) {
      const float sl = sm.slope[st];
      bias[0] = sl * kf[0];
      bias[1] = sl * kf[1];
    }
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int u = (i >> 1) & 1, c = 8 * (i >> 2) + 2 * tq + (i & 1);
      float pe;
      if constexpr (IsAlibi<W>::value) {
        pe = ex2(fmaf(fmaf(sacc[i], p.scale, bias[u]), LOG2E, -l2[c]));
      } else {
        pe = ex2(fmaf(sacc[i], sl2, -l2[c]));
      }
      if (!whole) {
        bool ok;
        if constexpr (W::SCHEDULED) {
          ok = walk.keep(kind, q0 + c, keys[u], seg ? sm.ids[st * BQ + c] : 0, sk[u], p.s);
        } else {
          ok = dstt::flash::visible(p, q0 + c, keys[u]);
          if (seg) ok = ok && sm.ids[st * BQ + c] == sk[u];
        }
        pe = ok ? pe : 0.f;
      }
      sacc[i] = pe;
    }
    asm volatile("" ::: "memory");
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int c = 8 * (i >> 2) + 2 * tq + (i & 1);
      pacc[i] = sacc[i] * (pacc[i] - dl[c]);
    }
#pragma unroll
    for (int i = 0; i < BQ / 2; i += 2) {
      pf[i / 8][(i / 2) % 4] = dstt::flash::pack_bf16(sacc[i], sacc[i + 1]);
      df[i / 8][(i / 2) % 4] = dstt::flash::pack_bf16(pacc[i], pacc[i + 1]);
    }

    // dV += P^T dO and dK += dS^T Q over the warpgroup's columns, one
    // commit group
    const int cb = (c0 / 64) * BQ * 128;
    hp::named_sync(TURN + wg, 256);
    hp::fence_acc(dk);
    hp::fence_acc(dv);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      mma_o<DC>(dv, pf[kk], hp::desc_b128(sm.dout(st) + cb + kk * 2048, BQ * 128, 1024));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      mma_o<DC>(dk, df[kk], hp::desc_b128(sm.q(st) + cb + kk * 2048, BQ * 128, 1024));
    hp::wgmma_commit();
    hp::named_arrive(TURN + (wg ^ 1), 256);
    hp::wgmma_wait<0>();
    hp::fence_acc(dk);
    hp::fence_acc(dv);
    hp::mbar_arrive(&sm.empty[st]);  // Q, dO, O (by the delta threads), ids, delta, lse read
  }
  if (wg == 0) hp::named_sync(TURN, 256);  // the turn warpgroup 1 handed over last
  store(dk, dv, key0, key1, c0, tq);
}

// The dk/dv CTA: barriers and the key tile's id range, then the roles (lse
// [b h, s] for the delta threads) over `walk`'s stages. The caller's kernel
// must end with this call.
template <int D, typename Init, typename Store, class W = FlashWalk>
__device__ __forceinline__ void dkv_cta(unsigned char* smem_raw, const CUtensorMap* const* maps,
                                        const Problem& p, const KvTile& kt, const float* lse,
                                        Init init, Store store, const W& walk = W()) {
  using T = BwdTiles<D>;
  const DkvSmem<D, W::SCHEDULED, IsAlibi<W>::value> sm(smem_raw);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < T::KV_STAGES; ++st) {
      hp::mbar_init(&sm.full[st], 32);        // the producer warp's lanes
      hp::mbar_init(&sm.info[st], 1);         // the producer's lane 0
      hp::mbar_init(&sm.aux[st], T::KV_BQ);   // the delta threads, a row each
      hp::mbar_init(&sm.empty[st], 256);      // every consumer thread
    }
    hp::mbar_init(sm.kvbar, 1);
    hp::mbar_init_fence();
    sm.krange[0] = 0x7fffffff;
    sm.krange[1] = -0x7fffffff - 1;
  }
  __syncthreads();
  if (kt.segk && tid < T::KV_BK && kt.k0 + tid < p.s) {
    const int sv = kt.segk[kt.k0 + tid];
    atomicMin(&sm.krange[0], sv);
    atomicMax(&sm.krange[1], sv);
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // uniform to the compiler
  if (wg == 2) {
    hp::setmaxnreg_dec<PRODUCER_REGS>();
    const int w = (tid >> 5) & 3;
    if (w == 0) dkv_produce<D>(sm, maps, p, kt, tid & 31, walk);
    else if (w <= T::KV_BQ / 32) dkv_delta<D>(sm, p, lse, tid - 256 - 32, walk);
  } else {
    hp::setmaxnreg_inc<CONSUMER_REGS>();
    dkv_consume<D>(sm, p, kt, wg, tid & 127, init, store, walk);
  }
}

// The four maps of a dq launch (q, dO in boxes of BQ rows; k, v of BK;
// sk: the keys' length where it differs from the queries' p.s) or the five
// of a dk/dv launch (k, v in boxes of KV_BK rows; q, dO, o of KV_BQ).
template <int D>
__host__ inline int encode_dq_maps(CUtensorMap* maps, const void* q, const void* dout,
                                   const void* k, const void* v, const Problem& p,
                                   int sk = -1) {
  using T = BwdTiles<D>;
  const uint64_t bh = (uint64_t)p.b * p.h, bkv = (uint64_t)p.b * p.h_kv;
  const int ks = sk < 0 ? p.s : sk;
  int e = dstt::encode_tma_3d(&maps[0], q, D, p.s, bh, T::BQ);
  if (!e) e = dstt::encode_tma_3d(&maps[1], dout, D, p.s, bh, T::BQ);
  if (!e) e = dstt::encode_tma_3d(&maps[2], k, D, ks, bkv, T::BK);
  if (!e) e = dstt::encode_tma_3d(&maps[3], v, D, ks, bkv, T::BK);
  return e;
}

// (sq: the query length where it differs from the keys' p.s)
template <int D>
__host__ inline int encode_dkv_maps(CUtensorMap* maps, const void* q, const void* dout,
                                    const void* o, const void* k, const void* v,
                                    const Problem& p, int sq = -1) {
  using T = BwdTiles<D>;
  const uint64_t bh = (uint64_t)p.b * p.h, bkv = (uint64_t)p.b * p.h_kv;
  const int qs = sq < 0 ? p.s : sq;
  int e = dstt::encode_tma_3d(&maps[0], k, D, p.s, bkv, T::KV_BK);
  if (!e) e = dstt::encode_tma_3d(&maps[1], v, D, p.s, bkv, T::KV_BK);
  if (!e) e = dstt::encode_tma_3d(&maps[2], q, D, qs, bh, T::KV_BQ);
  if (!e) e = dstt::encode_tma_3d(&maps[3], dout, D, qs, bh, T::KV_BQ);
  if (!e) e = dstt::encode_tma_3d(&maps[4], o, D, qs, bh, T::KV_BQ);
  return e;
}

// A dq or dk/dv launch's grid: (b h, query tiles of BQ) or (b h_kv, key
// tiles of KV_BK).
template <int D>
__host__ inline dim3 dq_grid(const Problem& p) {
  constexpr int BQ = BwdTiles<D>::BQ;
  return dim3((unsigned)(p.b * p.h), (unsigned)((p.s + BQ - 1) / BQ));
}

template <int D>
__host__ inline dim3 dkv_grid(const Problem& p) {
  constexpr int BK = BwdTiles<D>::KV_BK;
  return dim3((unsigned)(p.b * p.h_kv), (unsigned)((p.s + BK - 1) / BK));
}

}  // namespace flash_hopper
}  // namespace dstt
