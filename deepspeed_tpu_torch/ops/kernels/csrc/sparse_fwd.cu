// Layout-predicate block-sparse attention forward for Hopper (sm_90a):
// wgmma fed by TMA.
//
// Replaces: deepspeed_tpu/ops/sparse_attention/sparse_pallas.py::
// _sparse_fwd_kernel (the pallas_call in _sparse_fwd): online-softmax
// attention over the key blocks a static per-head int32 layout keeps, q
// scaled before its products, ``causal`` masking q >= k inside the kept
// blocks. Head counts match (the caller expands GQA). Writes bf16 O and the
// fp32 log-sum-exp [b, h, s]; a row that keeps nothing writes 0 and -1e30.
//
// Bound: operations. 4 * d FLOPs per kept (query, key) pair against one read
// of q, k, v and one write of o: at d 128 and a layout that keeps more than a
// few hundred keys per query the arithmetic intensity is far above the
// card's ~295 FLOP/byte ridge.
//
// Design: the flash forward's CTA body (flash_hopper.cuh's fwd_cta, which
// the flash, ring and splash forwards run) on a walk that reads the int32
// layout, LayoutFwdWalk (sparse_common.cuh's LayoutRowWalk, the scan dq's
// walk runs too): a CTA per (128-query tile, b * h), later query tiles
// first (under a causal layout they keep the most tiles); a producer warp
// issuing TMA loads of the key tiles (BK 128; 64 at d 256) its layout rows
// keep (when causal, none past its last row), in ascending order, into a
// two-stage mbarrier ring, K with the stage word (a code per consumer
// warpgroup: skip, whole, the layout's bit, or a bitmask per key column
// where blocks are smaller than the tile) and V a tile later, each on its
// own barriers; two consumer warpgroups of 64 query rows, S = Q K^T and O +=
// P V on wgmma, the online softmax on the accumulators, the kept-pair rule
// only where a tile is not whole. A tile that keeps no pair is never
// loaded. A row that keeps nothing (l = 0) is stored as O = 0 and lse =
// -1e30, the JAX body's dead-row result. Over the dense layout, or a causal
// one that keeps every block on and below the diagonal, in blocks of at
// least the tile, the walk visits flash's key tiles in flash's order with
// the same arithmetic: out and lse equal the flash forward's.
#include "sparse_common.cuh"

namespace {

namespace fh = dstt::flash_hopper;
namespace hp = dstt::hopper;
namespace sp = dstt::sparse;
using dstt::flash::Problem;
using bf16 = __nv_bfloat16;

struct LayoutFwdWalk : sp::LayoutRowWalk {
  // The producer's stages (flash_hopper.cuh's produce calls this after the
  // Q load): each tile's word and (per column) bitmasks, and K by TMA; its
  // V once the next tile is walked.
  template <int D>
  __device__ __forceinline__ int produce(const fh::Smem<D, true>& sm, const CUtensorMap* kmap,
                                         const CUtensorMap* vmap, const Problem& p,
                                         const fh::Tile& tile, int lane) const {
    using T = fh::FwdTiles<D>;
    constexpr int BK = T::BK, S = T::STAGES, IDS = BK / 32;
    return walk<BK>(
        tile.bh % p.h, tile.q0, lane,
        [&](int it, int word, const uint32_t(&kc)[2]) {
          const int st = it % S;
          hp::mbar_wait(&sm.empty_k[st], ((it / S) & 1) ^ 1);
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            if (((word >> (3 * w)) & 7) == fh::SCHEDULED_COLUMNS)
              dstt::splash::store_kinds<IDS>(sm.kinds + (2 * st + w) * BK + lane * IDS, kc[w]);
          }
          if (lane == 0) {
            sm.k0s[st] = word;
            hp::mbar_arrive_expect_tx(&sm.full_k[st], fh::Smem<D>::KV_BYTES);
#pragma unroll
            for (int c = 0; c < D / 64; ++c)
              hp::tma_load_3d(sm.k(st) + c * BK * 128, kmap, &sm.full_k[st], 64 * c,
                              (word >> 6) * BK, tile.bkv);
          } else {
            hp::mbar_arrive(&sm.full_k[st]);  // after this lane's column bytes
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
    sparse_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out,
                      float* __restrict__ lse, Problem p, LayoutFwdWalk walk) {
  extern __shared__ unsigned char smem_raw[];
  const fh::Tile tile = dstt::splash::make_tile<fh::FwdTiles<D>::BQ>(p, p.s);
  bf16* ob = out + (int64_t)tile.bh * p.s * D;
  float* lseb = lse + (int64_t)tile.bh * p.s;
  fh::fwd_cta<D>(
      smem_raw, &qmap, &kmap, &vmap, p, tile,
      [](auto& o, auto& m, auto& l, int, int, int) { dstt::splash::init_empty(o, m, l); },
      [&](const auto& o, const auto& m, const auto& l, int row0, int row1, int tq) {
        dstt::splash::store_out<D>(ob, lseb, o, m, l, row0, row1, p.s, tq);
      },
      walk);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, const Problem& p,
           const LayoutFwdWalk& w, cudaStream_t stream) {
  CUtensorMap maps[3];
  if (int e = fh::encode_maps<D>(maps, q, k, v, p)) return e;
  constexpr int bytes = fh::Smem<D, true>::BYTES;
  static size_t have = 0;
  if (int e = dstt::flash::set_max_smem(sparse_fwd_kernel<D>, bytes, have)) return e;
  constexpr int BQ = fh::FwdTiles<D>::BQ;
  const dim3 grid((unsigned)(p.b * p.h), (unsigned)((p.s + BQ - 1) / BQ));
  sparse_fwd_kernel<D><<<grid, fh::THREADS, bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(out), lse, p, w);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: [b, h, s, d] bf16; layout: [h, nb, nb] int32 with nb * block
// == s, block = 2^lg in 16..256; lse: [b, h, s] fp32; all contiguous, the
// bf16 tensors 16-byte aligned. d in {64, 128, 256}; scale > 0. Returns
// cudaGetLastError() (cudaErrorInvalidValue for what the kernel does not
// take).
extern "C" int dstt_sparse_fwd(const void* q, const void* k, const void* v, const void* layout,
                               void* out, void* lse, int b, int h, int s, int d, float scale,
                               int nb, int lg, int causal, void* stream) {
  if (!sp::problem_ok(s, nb, lg) || !(scale > 0.f)) return (int)cudaErrorInvalidValue;
  const Problem p = sp::problem(b, h, s, scale, causal);
  LayoutFwdWalk w;
  w.layout = static_cast<const int*>(layout);
  w.nb = nb;
  w.lg = lg;
  w.s = s;
  w.causal = causal;
  float* L = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64>(q, k, v, out, L, p, w, st);
    case 128: return launch<128>(q, k, v, out, L, p, w, st);
    case 256: return launch<256>(q, k, v, out, L, p, w, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
