// Layout-predicate block-sparse attention backward for Hopper (sm_90a): two
// kernels, dq and dk/dv, on wgmma fed by TMA.
//
// Replaces: deepspeed_tpu/ops/sparse_attention/sparse_pallas.py::
// _sparse_bwd_dq_kernel and ::_sparse_bwd_dkv_kernel (the two pallas_calls
// in _sparse_bwd). Both recompute p = exp(q k^T * scale - lse) from the
// forward's fp32 log-sum-exp over the pairs the layout keeps (and, when
// causal, q >= k), and take delta = sum(do * o) in the kernel; ds = p * (do
// v^T - delta) is rounded to bf16 before its products; dq and dk are scaled
// once. A row that kept nothing (lse -1e30) has no kept pair, so its p, dq
// and its share of dk, dv are exactly 0.
//
// Bound: operations. dq does 3 products of 2 * d FLOPs per kept (query, key)
// pair (q k^T, do v^T, ds k), dk/dv 4 (q k^T, do v^T, p^T do, ds^T q); the
// bytes are a few reads of q, k, v, o, do.
//
// Design: the flash backward's two CTA bodies (flash_hopper_bwd.cuh, which
// the flash and splash kernels run too) on walks that read the int32 layout
// (sparse_common.cuh), with h_kv = h (the caller expands GQA, so a GQA group
// is one head):
//  * dq (dq_cta on LayoutDqWalk): a CTA per (128-query tile, b * h), later
//    query tiles first; the producer warp loads Q and dO once, then the key
//    tiles (BK 64; 32 at d 256) its layout rows keep (when causal, none past
//    its last row), in ascending order, into a three-stage ring, each
//    stage's word carrying a code per consumer warpgroup (skip, whole, or
//    the layout's bits); two consumer warpgroups take delta, then S = Q K^T,
//    dP = dO V^T, dS in registers, dQ += dS K.
//  * dk/dv (dkv_cta on LayoutDkvWalk): a CTA per (KV_BK keys: 128; 64 at d
//    256, b * h) in the natural order, whose first key tiles carry the most
//    work under a causal layout (a global key block is seen by every later
//    query block); the producer warp loads K and V once, then the query
//    tiles of 64 rows its rows of the transposed layout keep (when causal,
//    none before its first key), in ascending order, Q, dO and O of each
//    into the ring with a kind per 64-key half; two warps take each stage's
//    delta; two consumer warpgroups sum dV += P^T dO and dK += dS^T Q in
//    fp32, rounded once. At d 256 both warpgroups take the CTA's 64 keys
//    (half the columns each) and both recompute S^T and dP^T.
// A tile the layout leaves whole for a warpgroup needs no predicate; a
// tile that keeps no pair is never loaded.
//
// ``cta_clock`` (dk/dv; null in use): where set, each CTA writes its start
// and end (%globaltimer, ns) and its SM, for the measurement of the grid's
// tail (tools/torch_sparse_ab.py).
#include "sparse_common.cuh"

namespace {

namespace fh = dstt::flash_hopper;
namespace sp = dstt::sparse;
using dstt::flash::Problem;
using dstt::flash::set_max_smem;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int sm_id() {
  int id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

// maps: q, dO, k, v (fh::encode_dq_maps)
template <int D>
__global__ void __launch_bounds__(fh::THREADS, 1)
    sparse_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap domap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ o,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     bf16* __restrict__ dq, Problem p, sp::LayoutDqWalk walk) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int BQ = fh::BwdTiles<D>::BQ;
  const CUtensorMap* maps[4] = {&qmap, &domap, &kmap, &vmap};
  fh::Tile tile = fh::make_tile<BQ>(p, nullptr, nullptr);
  tile.q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * BQ;  // later query tiles first
  const int64_t head = (int64_t)tile.bh * p.s;
  fh::dq_cta<D>(
      smem_raw, maps, p, tile, o + head * D, dout + head * D, lse + head,
      [&](auto& acc, int, int, int) { fh::acc_zero(acc); },
      [&](const auto& acc, int row0, int row1, int tq) {
        const int64_t at = (int64_t)blockIdx.x * p.s * D;  // the CTA's (batch, head)
        fh::acc_store_bf16<D>(dq + at, acc, p.scale, row0, row1, p.s, 0, D, tq);
      },
      walk);
}

// maps: k, v, q, dO, o (fh::encode_dkv_maps)
template <int D>
__global__ void __launch_bounds__(fh::THREADS, 1)
    sparse_dkv_kernel(const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap domap,
                      const __grid_constant__ CUtensorMap omap, const float* __restrict__ lse,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, long long* __restrict__ clock,
                      Problem p, sp::LayoutDkvWalk walk) {
  extern __shared__ unsigned char smem_raw[];
  const CUtensorMap* maps[5] = {&kmap, &vmap, &qmap, &domap, &omap};
  // the CTA's record, in launch order (recomputed where used: a value held
  // across the walk costs the consumers a register)
  auto record = [&]() { return clock + 3 * ((int64_t)blockIdx.y * gridDim.x + blockIdx.x); };
  if (clock != nullptr && threadIdx.x == 0) record()[0] = global_ns();
  const fh::KvTile kt = fh::make_kv_tile<D>(p, nullptr, nullptr);
  fh::dkv_cta<D>(
      smem_raw, maps, p, kt, lse,
      [&](auto& dka, auto& dva, int, int, int, int) {
        fh::acc_zero(dka);
        fh::acc_zero(dva);
      },
      [&](const auto& dka, const auto& dva, int key0, int key1, int c0, int tq) {
        constexpr int DC = 2 * (int)(sizeof(dka) / sizeof(float));
        const int64_t at = (int64_t)blockIdx.x * p.s * D;  // the CTA's (batch, head)
        fh::acc_store_bf16<DC>(dk + at, dka, p.scale, key0, key1, p.s, c0, D, tq);
        fh::acc_store_bf16<DC>(dv + at, dva, 1.f, key0, key1, p.s, c0, D, tq);
        if (clock != nullptr && threadIdx.x == 0) {  // warpgroup 0, which finishes last
          record()[1] = global_ns();
          record()[2] = sm_id();
        }
      },
      walk);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, void* dq, const Problem& p, const sp::LayoutDqWalk& w,
              cudaStream_t stream) {
  CUtensorMap maps[4];
  if (int e = fh::encode_dq_maps<D>(maps, q, dout, k, v, p)) return e;
  constexpr int bytes = fh::DqSmem<D, true>::BYTES;
  static size_t have = 0;
  if (int e = set_max_smem(sparse_dq_kernel<D>, bytes, have)) return e;
  sparse_dq_kernel<D><<<fh::dq_grid<D>(p), fh::THREADS, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dq), p, w);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dk, void* dv, long long* clock, const Problem& p,
               const sp::LayoutDkvWalk& w, cudaStream_t stream) {
  CUtensorMap maps[5];
  if (int e = fh::encode_dkv_maps<D>(maps, q, dout, o, k, v, p)) return e;
  constexpr int bytes = fh::DkvSmem<D, true>::BYTES;
  static size_t have = 0;
  if (int e = set_max_smem(sparse_dkv_kernel<D>, bytes, have)) return e;
  sparse_dkv_kernel<D><<<fh::dkv_grid<D>(p), fh::THREADS, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], lse, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), clock, p, w);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o, do, dq: [b, h, s, d] bf16; lse: [b, h, s] fp32 from
// dstt_sparse_fwd; layout: [h, nb, nb] int32 with nb * block == s, block =
// 2^lg in 16..256; all contiguous, the bf16 tensors 16-byte aligned. d in
// {64, 128, 256}. Returns cudaGetLastError() (cudaErrorInvalidValue for what
// the kernel does not take).
extern "C" int dstt_sparse_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, const void* layout,
                                  void* dq, int b, int h, int s, int d, float scale, int nb,
                                  int lg, int causal, void* stream) {
  if (!sp::problem_ok(s, nb, lg)) return (int)cudaErrorInvalidValue;
  const Problem p = sp::problem(b, h, s, scale, causal);
  sp::LayoutDqWalk w;
  w.layout = static_cast<const int*>(layout);
  w.nb = nb;
  w.lg = lg;
  w.s = s;
  w.causal = causal;
  const float* L = static_cast<const float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dq<64>(q, k, v, o, dout, L, dq, p, w, st);
    case 128: return launch_dq<128>(q, k, v, o, dout, L, dq, p, w, st);
    case 256: return launch_dq<256>(q, k, v, o, dout, L, dq, p, w, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dk, dv: [b, h, s, d] bf16; layout_t: the layout transposed, [h, nb, nb]
// int32 with rows = key blocks (contiguous); cta_clock: null, or int64 [b h
// * key tiles of KV_BK, 3] (start ns, end ns, SM per CTA, in launch order);
// the rest as dstt_sparse_bwd_dq.
extern "C" int dstt_sparse_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, const void* layout_t,
                                   void* dk, void* dv, int b, int h, int s, int d, float scale,
                                   int nb, int lg, int causal, void* cta_clock, void* stream) {
  if (!sp::problem_ok(s, nb, lg)) return (int)cudaErrorInvalidValue;
  const Problem p = sp::problem(b, h, s, scale, causal);
  const sp::LayoutDkvWalk w{static_cast<const int*>(layout_t), nb, lg, lg < 6 ? 6 - lg : 0, s,
                            causal};
  const float* L = static_cast<const float*>(lse);
  long long* clock = static_cast<long long*>(cta_clock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dkv<64>(q, k, v, o, dout, L, dk, dv, clock, p, w, st);
    case 128: return launch_dkv<128>(q, k, v, o, dout, L, dk, dv, clock, p, w, st);
    case 256: return launch_dkv<256>(q, k, v, o, dout, L, dk, dv, clock, p, w, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
