// Flash attention forward for Hopper (sm_90a): wgmma fed by TMA.
//
// Replaces: deepspeed_tpu/ops/attention/flash_pallas.py::_fwd_kernel (the
// pallas_call in _flash_call): online-softmax attention over [b, h, s, d]
// with GQA (kv head = h / (h / h_kv)), causal masking, packed-sequence
// segment ids, a static sliding window and a per-layer window flag. Writes
// bf16 O and the fp32 log-sum-exp [b, h, s] the backward recomputes from.
//
// Bound: operations. 4 * d FLOPs per visible (query, key) pair against
// 2 * d * 2 bytes per row of q, k, v and o: at s = 4096, d = 128 the
// arithmetic intensity is in the thousands, far above the card's ~295
// FLOP/byte ridge, so the least time is the tensor-core time.
//
// Design: flash_hopper.cuh's CTA body, which the ring's carry-mode forward
// (flash_chunk.cu) runs too: a CTA per (128-query tile, b * h), a producer
// warp issuing TMA loads of K and V (3-D maps, so a tail tile reads zeros)
// into a two-stage mbarrier ring and pruning key tiles by the causal bound,
// the static band and the segment ids before any copy; two consumer
// warpgroups of 64 query rows each, taking turns at the tensor cores: S =
// Q K^T and O += P V on wgmma, P from registers, a tile's P V running
// under the next tile's softmax. Tiles per d in FwdTiles. Query tiles are
// handed out heaviest first under a causal mask (flash_common.cuh's
// heavy_first_query_tile); a persistent grid was not tried.
//
// ALiBi (the Pallas body with its alibi operand, _alibi_term): the entry
// dstt_flash_fwd_alibi, the same body on flash_hopper.cuh's AlibiWalk, a
// kernel of its own, so the entry above keeps its code.
#include "flash_hopper.cuh"

namespace {

namespace fh = dstt::flash_hopper;
using dstt::flash::make_problem;
using dstt::flash::Problem;
using bf16 = __nv_bfloat16;

template <int D>
__global__ void __launch_bounds__(fh::THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out,
                     float* __restrict__ lse, Problem p) {
  extern __shared__ unsigned char smem_raw[];
  const fh::Tile tile = fh::make_tile<fh::FwdTiles<D>::BQ>(p, p.seg, p.seg);
  bf16* ob = out + (int64_t)tile.bh * p.s * D;
  float* lseb = lse + (int64_t)tile.bh * p.s;
  fh::fwd_cta<D>(
      smem_raw, &qmap, &kmap, &vmap, p, tile,
      [&](auto& o, auto& m, auto& l, int, int, int) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
        m[0] = m[1] = -INFINITY;
        l[0] = l[1] = 0.f;
      },
      [&](const auto& o, const auto& m, const auto& l, int row0, int row1, int tq) {
        fh::store_out<D>(ob, lseb, o, m, l, row0, row1, p.s, tq);
      });
}

template <int D>
__global__ void __launch_bounds__(fh::THREADS, 1)
    flash_fwd_alibi_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out,
                           float* __restrict__ lse, Problem p, fh::AlibiWalk walk) {
  extern __shared__ unsigned char smem_raw[];
  const fh::Tile tile = fh::make_tile<fh::FwdTiles<D>::BQ>(p, p.seg, p.seg);
  bf16* ob = out + (int64_t)tile.bh * p.s * D;
  float* lseb = lse + (int64_t)tile.bh * p.s;
  fh::fwd_cta<D>(
      smem_raw, &qmap, &kmap, &vmap, p, tile,
      [&](auto& o, auto& m, auto& l, int, int, int) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
        m[0] = m[1] = -INFINITY;
        l[0] = l[1] = 0.f;
      },
      [&](const auto& o, const auto& m, const auto& l, int row0, int row1, int tq) {
        fh::store_out<D>(ob, lseb, o, m, l, row0, row1, p.s, tq);
      },
      walk);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           const Problem& p, cudaStream_t stream) {
  CUtensorMap maps[3];
  if (int e = fh::encode_maps<D>(maps, q, k, v, p)) return e;
  constexpr int bytes = fh::Smem<D>::BYTES;
  static size_t have = 0;
  if (int e = dstt::flash::set_max_smem(flash_fwd_kernel<D>, bytes, have)) return e;
  constexpr int BQ = fh::FwdTiles<D>::BQ;
  const dim3 grid((unsigned)(p.b * p.h), (unsigned)((p.s + BQ - 1) / BQ));
  flash_fwd_kernel<D><<<grid, fh::THREADS, bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(out), lse, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_alibi(const void* q, const void* k, const void* v, void* out, float* lse,
                 const Problem& p, const fh::AlibiWalk& walk, cudaStream_t stream) {
  CUtensorMap maps[3];
  if (int e = fh::encode_maps<D>(maps, q, k, v, p)) return e;
  constexpr int bytes = fh::Smem<D, false, true>::BYTES;
  static size_t have = 0;
  if (int e = dstt::flash::set_max_smem(flash_fwd_alibi_kernel<D>, bytes, have)) return e;
  constexpr int BQ = fh::FwdTiles<D>::BQ;
  const dim3 grid((unsigned)(p.b * p.h), (unsigned)((p.s + BQ - 1) / BQ));
  flash_fwd_alibi_kernel<D><<<grid, fh::THREADS, bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(out), lse, p, walk);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [b, h, s, d] bf16; k, v: [b, h_kv, s, d] bf16; lse: [b, h, s]
// fp32; seg: [b, s] int32 or null; all contiguous and 16-byte aligned.
// d in {64, 128, 256}; h % h_kv == 0; scale > 0; window > 0 requires
// causal; window_flag < 0 means no per-layer flag. Returns
// cudaGetLastError() (cudaErrorInvalidValue for what the kernel does not
// take).
extern "C" int dstt_flash_fwd(const void* q, const void* k, const void* v, const void* seg,
                              void* out, void* lse, int b, int h, int h_kv, int s, int d,
                              float scale, int causal, int window, int window_flag,
                              void* stream) {
  if (!(scale > 0.f)) return (int)cudaErrorInvalidValue;
  const Problem p = make_problem(b, h, h_kv, s, scale, causal, window, window_flag, seg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (d) {
    case 64: return launch<64>(q, k, v, out, l, p, st);
    case 128: return launch<128>(q, k, v, out, l, p, st);
    case 256: return launch<256>(q, k, v, out, l, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dstt_flash_fwd with ALiBi: slope_h * float(kpos[b, key]) added to every
// scaled score before the masks. slopes: [h] fp32; kpos: [b, s] int32;
// both contiguous.
extern "C" int dstt_flash_fwd_alibi(const void* q, const void* k, const void* v, const void* seg,
                                    const void* slopes, const void* kpos, void* out, void* lse,
                                    int b, int h, int h_kv, int s, int d, float scale,
                                    int causal, int window, int window_flag, void* stream) {
  if (!(scale > 0.f) || !slopes || !kpos) return (int)cudaErrorInvalidValue;
  const Problem p = make_problem(b, h, h_kv, s, scale, causal, window, window_flag, seg);
  const fh::AlibiWalk walk{static_cast<const float*>(slopes), static_cast<const int*>(kpos)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (d) {
    case 64: return launch_alibi<64>(q, k, v, out, l, p, walk, st);
    case 128: return launch_alibi<128>(q, k, v, out, l, p, walk, st);
    case 256: return launch_alibi<256>(q, k, v, out, l, p, walk, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
