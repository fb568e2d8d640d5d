// Splash (scheduled block-sparse) attention forward for Hopper (sm_90a):
// wgmma fed by TMA.
//
// Replaces: deepspeed_tpu/ops/sparse_attention/splash_pallas.py::
// _splash_fwd_kernel (the pallas_call in _splash_fwd_call), for both of its
// callers: splash_attention (training; the schedule of a mask or a
// SparsityConfig layout) and splash_prefill_attention (serving; one schedule
// row built from the chunk start, query rows at global positions base + i).
// Online-softmax attention over the kv blocks the schedule lists, GQA
// through the kv head index, the analytic predicate (causal, window, static
// segment ids) on partial steps only, runtime segment ids on every step.
// Writes bf16 O and the fp32 log-sum-exp [b, h, sq].
//
// Bound: operations. 4 * d FLOPs per kept (query, key) pair against one read
// of q, k, v and one write of o: at Mistral's widths (d 128) the arithmetic
// intensity is far above the card's ~295 FLOP/byte ridge whenever a query
// keeps more than a few hundred keys.
//
// Design: the flash forward's CTA body (flash_hopper.cuh's fwd_cta, which
// flash_fwd.cu and the ring's flash_chunk.cu run with FlashWalk) on a
// scheduled walk, SplashFwdWalk (splash_common.cuh's RowWalk): a CTA per
// (128-query tile, b * h), a producer warp issuing TMA loads of the key
// tiles the CTA's two schedule rows list (merged in ascending key order)
// into a two-stage mbarrier ring, each K stage's word carrying a code per
// consumer warpgroup (one kind for the tile, per-column kinds, or whole);
// two consumer warpgroups of 64 query rows each, S = Q K^T and O += P V on
// wgmma, the online softmax on the accumulators, the kept-pair rule only
// where a tile is not whole. A warpgroup whose columns are all SKIP
// for a tile masks every score and adds exactly 0, taking its turn as
// usual. The query map covers sq rows and the key maps sk rows (3-D maps:
// a 128-row box over a chunk of t < 128 rows reads zeros past them; rows
// past sq are never stored). A row that keeps nothing (l = 0) is stored as
// O = 0 and lse = -1e30. Over a LocalMask schedule in 512-blocks the walk
// visits flash's key tiles in flash's order with the same arithmetic: out
// and lse equal the flash forward's with the same window.
#include "splash_common.cuh"

namespace {

namespace fh = dstt::flash_hopper;
namespace hp = dstt::hopper;
namespace sp = dstt::splash;
using dstt::flash::Problem;
using bf16 = __nv_bfloat16;

struct SplashFwdWalk : sp::RowWalk {
  // The producer's stages (flash_hopper.cuh's produce calls this after the
  // Q load): each tile's word, ids and (per column) kinds, and K by TMA;
  // its V once the next tile is walked.
  template <int D>
  __device__ __forceinline__ int produce(const fh::Smem<D, true>& sm, const CUtensorMap* kmap,
                                         const CUtensorMap* vmap, const Problem& p,
                                         const fh::Tile& tile, int lane) const {
    using T = fh::FwdTiles<D>;
    constexpr int BK = T::BK, S = T::STAGES, IDS = BK / 32;
    return walk<BK>(
        tile.bh % p.h, tile.q0, tile.segk, sm.qrange[0], sm.qrange[1], lane,
        [&](int it, int word, const auto& kc, const auto& ids) {
          const int st = it % S;
          hp::mbar_wait(&sm.empty_k[st], ((it / S) & 1) ^ 1);
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
            hp::mbar_arrive_expect_tx(&sm.full_k[st], fh::Smem<D>::KV_BYTES);
#pragma unroll
            for (int c = 0; c < D / 64; ++c)
              hp::tma_load_3d(sm.k(st) + c * BK * 128, kmap, &sm.full_k[st], 64 * c,
                              (word >> 6) * BK, tile.bkv);
          } else {
            hp::mbar_arrive(&sm.full_k[st]);  // after this lane's ids and kinds
          }
        },
        [&](int it, int k0) {
          const int st = it % S;
          hp::mbar_wait(&sm.empty_v[st], ((it / S) & 1) ^ 1);
          if (lane == 0) {
            hp::mbar_arrive_expect_tx(&sm.full_v[st], fh::Smem<D>::KV_BYTES);
#pragma unroll
            for (int c = 0; c < D / 64; ++c)
              hp::tma_load_3d(sm.v(st) + c * BK * 128, vmap, &sm.full_v[st], 64 * c, k0,
                              tile.bkv);
          }
        });
  }
};

template <int D>
__global__ void __launch_bounds__(fh::THREADS, 1)
    splash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out,
                      float* __restrict__ lse, Problem p, SplashFwdWalk walk) {
  extern __shared__ unsigned char smem_raw[];
  const fh::Tile tile = sp::make_tile<fh::FwdTiles<D>::BQ>(p, walk.sk);
  bf16* ob = out + (int64_t)tile.bh * p.s * D;
  float* lseb = lse + (int64_t)tile.bh * p.s;
  fh::fwd_cta<D>(
      smem_raw, &qmap, &kmap, &vmap, p, tile,
      [](auto& o, auto& m, auto& l, int, int, int) { sp::init_empty(o, m, l); },
      [&](const auto& o, const auto& m, const auto& l, int row0, int row1, int tq) {
        sp::store_out<D>(ob, lseb, o, m, l, row0, row1, p.s, tq);
      },
      walk);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, const Problem& p,
           const SplashFwdWalk& w, cudaStream_t stream) {
  CUtensorMap maps[3];
  if (int e = fh::encode_maps<D>(maps, q, k, v, p, w.sk)) return e;
  constexpr int bytes = fh::Smem<D, true>::BYTES;
  static size_t have = 0;
  if (int e = dstt::flash::set_max_smem(splash_fwd_kernel<D>, bytes, have)) return e;
  constexpr int BQ = fh::FwdTiles<D>::BQ;
  const dim3 grid((unsigned)(p.b * p.h), (unsigned)((p.s + BQ - 1) / BQ));
  splash_fwd_kernel<D><<<grid, fh::THREADS, bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(out), lse, p, w);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [b, h, sq, d] bf16; k, v: [b, h_kv, sk, d] bf16; lse: [b, h, sq]
// fp32; seg: [b, s] int32 (square attention) or null; kv_index, step_kind:
// [sched_heads, nq, width] int32 with sched_heads 1 or h; all contiguous,
// the bf16 tensors 16-byte aligned. d in {64, 128, 256}; h % h_kv == 0;
// scale > 0; block_q a multiple of 64 or nq == 1; block_kv any size.
// Returns cudaGetLastError() (cudaErrorInvalidValue for what the kernel
// does not take).
extern "C" int dstt_splash_fwd(const void* q, const void* k, const void* v, const void* seg,
                               const void* kv_index, const void* step_kind, void* out, void* lse,
                               int b, int h, int h_kv, int sq, int sk, int d, float scale,
                               int sched_heads, int nq, int width, int block_q, int block_kv,
                               int causal, int window, int seg_all, int base, void* stream) {
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
  SplashFwdWalk w;
  w.index = static_cast<const int*>(kv_index);
  w.kind = static_cast<const int*>(step_kind);
  w.heads = sched_heads;
  w.nq = nq;
  w.width = width;
  w.bq = block_q;
  w.bk = block_kv;
  w.sq = sq;
  w.sk = sk;
  w.base = base;
  w.causal = causal;
  w.window = window;
  w.seg = seg != nullptr;
  w.seg_all = seg_all;
  float* L = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64>(q, k, v, out, L, p, w, st);
    case 128: return launch<128>(q, k, v, out, L, p, w, st);
    case 256: return launch<256>(q, k, v, out, L, p, w, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
