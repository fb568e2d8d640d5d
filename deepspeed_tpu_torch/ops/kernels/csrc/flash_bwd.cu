// Flash attention backward for Hopper (sm_90a): two kernels, dq and dk/dv,
// on wgmma fed by TMA.
//
// Replaces: deepspeed_tpu/ops/attention/flash_pallas.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (the two pallas_calls in _flash_bwd). Both recompute
// p = exp(q k^T * scale - lse) from the forward's fp32 log-sum-exp and take
// delta = sum(do * o) in the kernel; ds = p * (do v^T - delta) is rounded to
// bf16 before its products, as in the Pallas bodies.
//
// Bound: operations. dq does 3 products of 2 * d FLOPs per visible (query,
// key) pair (q k^T, do v^T, ds k), dk/dv 4 (q k^T, do v^T, p^T do, ds^T q);
// the bytes are a few rows of [s, d] each, far below the card's ~295
// FLOP/byte ridge.
//
// Design: flash_hopper_bwd.cuh's two CTA bodies, which the ring's carry-mode
// dq and dk/dv (flash_chunk.cu) run too. dq: a CTA per (128-query tile,
// b * h), a producer warp loading Q and dO once and the live K/V tiles into
// a three-stage mbarrier ring by TMA, two consumer warpgroups of 64 rows
// taking turns at the tensor cores: S = Q K^T, dP = dO V^T, dS in
// registers, dQ += dS K, a tile's dS K under the next tile's elementwise
// work. dk/dv: a CTA per (key tile, b * h_kv) with K and V resident, the
// producer streaming Q and dO over (query tile, group head) pairs, query
// tile outer, two warps taking delta and lse per stage, two consumer
// warpgroups summing dV += P^T dO and dK += dS^T Q over the group in fp32,
// rounded once. Tiles per d in BwdTiles. Query tiles of dq are handed out
// heaviest first under a causal mask, key tiles of dk/dv too (the first);
// a persistent grid was not tried.
//
// ALiBi (the Pallas bodies with their alibi operand): the entries
// dstt_flash_bwd_dq_alibi and dstt_flash_bwd_dkv_alibi, the same bodies on
// flash_hopper.cuh's AlibiWalk, kernels of their own, so the entries above
// keep their code.
#include "flash_hopper_bwd.cuh"

namespace {

namespace fh = dstt::flash_hopper;
using dstt::flash::make_problem;
using dstt::flash::Problem;
using bf16 = __nv_bfloat16;

// maps: q, dO, k, v (fh::encode_dq_maps)
template <int D>
__global__ void __launch_bounds__(fh::THREADS, 1)
    flash_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap domap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, const float* __restrict__ lse,
                    bf16* __restrict__ dq, Problem p) {
  extern __shared__ unsigned char smem_raw[];
  const CUtensorMap* maps[4] = {&qmap, &domap, &kmap, &vmap};
  const fh::Tile tile = fh::make_tile<fh::BwdTiles<D>::BQ>(p, p.seg, p.seg);
  const int64_t head = (int64_t)tile.bh * p.s;
  fh::dq_cta<D>(
      smem_raw, maps, p, tile, o + head * D, dout + head * D, lse + head,
      [&](auto& acc, int, int, int) { fh::acc_zero(acc); },
      [&](const auto& acc, int row0, int row1, int tq) {
        const int64_t at = (int64_t)blockIdx.x * p.s * D;  // the CTA's (batch, head)
        fh::acc_store_bf16<D>(dq + at, acc, p.scale, row0, row1, p.s, 0, D, tq);
      });
}

// maps: k, v, q, dO, o (fh::encode_dkv_maps)
template <int D>
__global__ void __launch_bounds__(fh::THREADS, 1)
    flash_dkv_kernel(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap domap,
                     const __grid_constant__ CUtensorMap omap, const float* __restrict__ lse,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, Problem p) {
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
      });
}

// the ALiBi forms of the two kernels above
template <int D>
__global__ void __launch_bounds__(fh::THREADS, 1)
    flash_dq_alibi_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap domap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ o,
                          const bf16* __restrict__ dout, const float* __restrict__ lse,
                          bf16* __restrict__ dq, Problem p, fh::AlibiWalk walk) {
  extern __shared__ unsigned char smem_raw[];
  const CUtensorMap* maps[4] = {&qmap, &domap, &kmap, &vmap};
  const fh::Tile tile = fh::make_tile<fh::BwdTiles<D>::BQ>(p, p.seg, p.seg);
  const int64_t head = (int64_t)tile.bh * p.s;
  fh::dq_cta<D>(
      smem_raw, maps, p, tile, o + head * D, dout + head * D, lse + head,
      [&](auto& acc, int, int, int) { fh::acc_zero(acc); },
      [&](const auto& acc, int row0, int row1, int tq) {
        const int64_t at = (int64_t)blockIdx.x * p.s * D;
        fh::acc_store_bf16<D>(dq + at, acc, p.scale, row0, row1, p.s, 0, D, tq);
      },
      walk);
}

template <int D>
__global__ void __launch_bounds__(fh::THREADS, 1)
    flash_dkv_alibi_kernel(const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap domap,
                           const __grid_constant__ CUtensorMap omap, const float* __restrict__ lse,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, Problem p,
                           fh::AlibiWalk walk) {
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
        const int64_t at = (int64_t)blockIdx.x * p.s * D;
        fh::acc_store_bf16<DC>(dk + at, dka, p.scale, key0, key1, p.s, c0, D, tq);
        fh::acc_store_bf16<DC>(dv + at, dva, 1.f, key0, key1, p.s, c0, D, tq);
      },
      walk);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, void* dq, const Problem& p, cudaStream_t stream) {
  CUtensorMap maps[4];
  if (int e = fh::encode_dq_maps<D>(maps, q, dout, k, v, p)) return e;
  constexpr int bytes = fh::DqSmem<D>::BYTES;
  static size_t have = 0;
  if (int e = dstt::flash::set_max_smem(flash_dq_kernel<D>, bytes, have)) return e;
  flash_dq_kernel<D><<<fh::dq_grid<D>(p), fh::THREADS, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dq), p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dk, void* dv, const Problem& p, cudaStream_t stream) {
  CUtensorMap maps[5];
  if (int e = fh::encode_dkv_maps<D>(maps, q, dout, o, k, v, p)) return e;
  constexpr int bytes = fh::DkvSmem<D>::BYTES;
  static size_t have = 0;
  if (int e = dstt::flash::set_max_smem(flash_dkv_kernel<D>, bytes, have)) return e;
  flash_dkv_kernel<D><<<fh::dkv_grid<D>(p), fh::THREADS, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], lse, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_alibi(const void* q, const void* k, const void* v, const void* o, const void* dout,
                    const float* lse, void* dq, const Problem& p, const fh::AlibiWalk& walk,
                    cudaStream_t stream) {
  CUtensorMap maps[4];
  if (int e = fh::encode_dq_maps<D>(maps, q, dout, k, v, p)) return e;
  constexpr int bytes = fh::DqSmem<D, false, true>::BYTES;
  static size_t have = 0;
  if (int e = dstt::flash::set_max_smem(flash_dq_alibi_kernel<D>, bytes, have)) return e;
  flash_dq_alibi_kernel<D><<<fh::dq_grid<D>(p), fh::THREADS, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dq), p, walk);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_alibi(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, void* dk, void* dv, const Problem& p,
                     const fh::AlibiWalk& walk, cudaStream_t stream) {
  CUtensorMap maps[5];
  if (int e = fh::encode_dkv_maps<D>(maps, q, dout, o, k, v, p)) return e;
  constexpr int bytes = fh::DkvSmem<D, false, true>::BYTES;
  static size_t have = 0;
  if (int e = dstt::flash::set_max_smem(flash_dkv_alibi_kernel<D>, bytes, have)) return e;
  flash_dkv_alibi_kernel<D><<<fh::dkv_grid<D>(p), fh::THREADS, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], lse, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), p, walk);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, do, dq: [b, h, s, d] bf16; k, v: [b, h_kv, s, d] bf16; lse: [b, h,
// s] fp32 from dstt_flash_fwd; seg [b, s] int32 or null; all contiguous and
// 16-byte aligned; arguments as dstt_flash_fwd. Returns cudaGetLastError()
// (cudaErrorInvalidValue for what the kernel does not take).
extern "C" int dstt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const void* lse, const void* seg, void* dq,
                                 int b, int h, int h_kv, int s, int d, float scale, int causal,
                                 int window, int window_flag, void* stream) {
  if (!(scale > 0.f)) return (int)cudaErrorInvalidValue;
  const Problem p = make_problem(b, h, h_kv, s, scale, causal, window, window_flag, seg);
  const float* l = static_cast<const float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dq<64>(q, k, v, o, dout, l, dq, p, st);
    case 128: return launch_dq<128>(q, k, v, o, dout, l, dq, p, st);
    case 256: return launch_dq<256>(q, k, v, o, dout, l, dq, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dk, dv: [b, h_kv, s, d] bf16, each the sum over the kv head's GQA group.
extern "C" int dstt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, const void* seg, void* dk,
                                  void* dv, int b, int h, int h_kv, int s, int d, float scale,
                                  int causal, int window, int window_flag, void* stream) {
  if (!(scale > 0.f)) return (int)cudaErrorInvalidValue;
  const Problem p = make_problem(b, h, h_kv, s, scale, causal, window, window_flag, seg);
  const float* l = static_cast<const float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dkv<64>(q, k, v, o, dout, l, dk, dv, p, st);
    case 128: return launch_dkv<128>(q, k, v, o, dout, l, dk, dv, p, st);
    case 256: return launch_dkv<256>(q, k, v, o, dout, l, dk, dv, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The two entries above with ALiBi (dstt_flash_fwd_alibi's slopes [h] fp32
// and kpos [b, s] int32), recomputing the forward's logits.
extern "C" int dstt_flash_bwd_dq_alibi(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       const void* seg, const void* slopes, const void* kpos,
                                       void* dq, int b, int h, int h_kv, int s, int d,
                                       float scale, int causal, int window, int window_flag,
                                       void* stream) {
  if (!(scale > 0.f) || !slopes || !kpos) return (int)cudaErrorInvalidValue;
  const Problem p = make_problem(b, h, h_kv, s, scale, causal, window, window_flag, seg);
  const fh::AlibiWalk walk{static_cast<const float*>(slopes), static_cast<const int*>(kpos)};
  const float* l = static_cast<const float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dq_alibi<64>(q, k, v, o, dout, l, dq, p, walk, st);
    case 128: return launch_dq_alibi<128>(q, k, v, o, dout, l, dq, p, walk, st);
    case 256: return launch_dq_alibi<256>(q, k, v, o, dout, l, dq, p, walk, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int dstt_flash_bwd_dkv_alibi(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        const void* seg, const void* slopes, const void* kpos,
                                        void* dk, void* dv, int b, int h, int h_kv, int s, int d,
                                        float scale, int causal, int window, int window_flag,
                                        void* stream) {
  if (!(scale > 0.f) || !slopes || !kpos) return (int)cudaErrorInvalidValue;
  const Problem p = make_problem(b, h, h_kv, s, scale, causal, window, window_flag, seg);
  const fh::AlibiWalk walk{static_cast<const float*>(slopes), static_cast<const int*>(kpos)};
  const float* l = static_cast<const float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dkv_alibi<64>(q, k, v, o, dout, l, dk, dv, p, walk, st);
    case 128: return launch_dkv_alibi<128>(q, k, v, o, dout, l, dk, dv, p, walk, st);
    case 256: return launch_dkv_alibi<256>(q, k, v, o, dout, l, dk, dv, p, walk, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
