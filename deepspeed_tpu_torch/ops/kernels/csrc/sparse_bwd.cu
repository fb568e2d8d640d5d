// Layout-predicate block-sparse attention backward for Hopper (sm_90a): two
// kernels, dq and dk/dv.
//
// Replaces: deepspeed_tpu/ops/sparse_attention/sparse_pallas.py::
// _sparse_bwd_dq_kernel and ::_sparse_bwd_dkv_kernel (the two pallas_calls
// in _sparse_bwd). Both recompute p = exp(q k^T * scale - lse) from the
// forward's fp32 log-sum-exp over the pairs the layout keeps (and, when
// causal, q >= k), and take delta = sum(do * o) in the kernel; ds = p * (do
// v^T - delta) is rounded to bf16 before its products. A row that kept
// nothing (lse -1e30) has no kept pair, so its p, dq and its share of dk, dv
// are exactly 0.
//
// Bound: operations. dq does 3 products of 2 * d FLOPs per kept (query, key)
// pair (q k^T, do v^T, ds k), dk/dv 4 (q k^T, do v^T, p^T do, ds^T q); the
// bytes are a few reads of q, k, v, o, do.
//
// Design (flash_common.cuh's mma.sync grids and per-tile bodies, dq_tile
// and dkv_tile, with the layout's rule for a kept pair from
// sparse_common.cuh; CTAs of 4 warps, each warp owning 16 rows,
// every accumulator in registers, P and dS turned into A fragments without
// leaving registers):
//  * dq: one CTA per (64-query tile, b * h); folds its layout rows into a
//    mask per key tile and walks the key tiles the layout keeps (when
//    causal, none past its last query); dQ += dS K; scaled once at the end.
//  * dk/dv: one CTA per (64-key tile, b * h); reads the transposed layout
//    (the Pallas path's ``layout_t``), so its masks are per query tile, and
//    walks the query tiles that keep any of its keys (when causal, none
//    before its first key), on the transposed products (S^T = K Q^T, dP^T =
//    V dO^T): dV += P^T dO, dK += dS^T Q in fp32, rounded once. At d = 256
//    the accumulators are taken in two 128-column halves, each its own pass.
#include "sparse_common.cuh"

namespace {

using namespace dstt::flash;
using SparseProblem = dstt::sparse::Problem;
namespace sp = dstt::sparse;

template <int D>
constexpr size_t bwd_tile_bytes() {
  return sizeof(bf16) * 4 * TILE * (D + PAD_H) + sizeof(float) * 2 * TILE;
}

// ---------------------------------------------------------------------------
// At d <= 128 the register cap of 3 CTAs per SM (168 a thread).
template <int D>
__global__ void __launch_bounds__(NTHREADS, D <= 128 ? 3 : 1) sparse_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const int* __restrict__ layout, bf16* __restrict__ dq, SparseProblem p) {
  constexpr int LD = D + PAD_H;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + TILE * LD;
  bf16* Ks = dOs + TILE * LD;
  bf16* Vs = Ks + TILE * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + TILE * LD);
  float* delta_s = lse_s + TILE;
  uint16_t* masks = reinterpret_cast<uint16_t*>(delta_s + TILE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * TILE;
  const int bh = blockIdx.x;
  const int hi = bh % p.h;
  const int64_t off = (int64_t)bh * p.s * D;

  sp::build_masks(masks, layout + (int64_t)hi * p.nb * p.nb, p, q0);
  load_tile<TILE, D>(Qs, q + off, q0, p.s);
  load_tile<TILE, D>(dOs, dout + off, q0, p.s);
  if (tid < TILE) lse_s[tid] = q0 + tid < p.s ? lse[(int64_t)bh * p.s + q0 + tid] : 0.f;
  __syncthreads();
  row_delta<D>(dOs, o + off, q0, p.s, delta_s);
  __syncthreads();

  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;
  const int row0 = q0 + lr0, row1 = q0 + lr1;
  const float lse_r[2] = {lse_s[lr0], lse_s[lr1]};
  const float del_r[2] = {delta_s[lr0], delta_s[lr1]};
  const int q_last = min(q0 + TILE, p.s) - 1;
  const int kt_end = p.causal ? q_last / TILE + 1 : sp::n_tiles(p.s);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < kt_end; ++kt) {
    const uint32_t mask = masks[kt];
    if (mask == 0) continue;
    const int k0 = kt * TILE;
    __syncthreads();  // the previous tile's readers of Ks and Vs are done
    load_tile<TILE, D>(Ks, k + off, k0, p.s);
    load_tile<TILE, D>(Vs, v + off, k0, p.s);
    __syncthreads();

    const uint32_t bits0 = sp::row_bits(mask, p, lr0), bits1 = sp::row_bits(mask, p, lr1);
    dq_tile<D>(acc, Qs, dOs, Ks, Vs, p.scale, lse_r, del_r, [&](int c, bool upper) {
      const int r = upper ? row0 : row1;
      const int kp = k0 + c;
      return r < p.s && kp < p.s && sp::col_kept(upper ? bits0 : bits1, p, c) &&
             (!p.causal || kp <= r);
    }, warp, lane);
  }
  store_rows<D, D>(dq + off, acc, p.scale, row0, row1, p.s, 0, lane);
}

// ---------------------------------------------------------------------------
template <int D, int DC>
__global__ void __launch_bounds__(NTHREADS) sparse_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const int* __restrict__ layout_t, bf16* __restrict__ dk, bf16* __restrict__ dv,
    SparseProblem p) {
  constexpr int LD = D + PAD_H;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + TILE * LD;
  bf16* Ks = dOs + TILE * LD;
  bf16* Vs = Ks + TILE * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + TILE * LD);
  float* delta_s = lse_s + TILE;
  uint16_t* masks = reinterpret_cast<uint16_t*>(delta_s + TILE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const int k0 = blockIdx.y * TILE;
  const int bh = blockIdx.x;
  const int hi = bh % p.h;
  const int64_t off = (int64_t)bh * p.s * D;
  const float* lseb = lse + (int64_t)bh * p.s;

  // masks per query tile, from this key tile's rows of the transposed layout
  sp::build_masks(masks, layout_t + (int64_t)hi * p.nb * p.nb, p, k0);
  load_tile<TILE, D>(Ks, k + off, k0, p.s);
  load_tile<TILE, D>(Vs, v + off, k0, p.s);
  __syncthreads();

  // this lane's two keys (fragment rows g and g + 8 of the warp's 16)
  const int lk0 = warp * 16 + g, lk1 = lk0 + 8;
  const int key0 = k0 + lk0, key1 = k0 + lk1;
  const int qt_begin = p.causal ? k0 / TILE : 0;
  const int nt = sp::n_tiles(p.s);

  for (int c0 = 0; c0 < D; c0 += DC) {
    float dka[DC / 8][4], dva[DC / 8][4];
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
      dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
    }
    for (int qt = qt_begin; qt < nt; ++qt) {
      const uint32_t mask = masks[qt];
      if (mask == 0) continue;
      const int q0 = qt * TILE;
      __syncthreads();  // the previous tile's readers are done
      if (tid < TILE) lse_s[tid] = q0 + tid < p.s ? lseb[q0 + tid] : 0.f;
      load_tile<TILE, D>(Qs, q + off, q0, p.s);
      load_tile<TILE, D>(dOs, dout + off, q0, p.s);
      __syncthreads();
      row_delta<D>(dOs, o + off, q0, p.s, delta_s);
      __syncthreads();

      const uint32_t bits0 = sp::row_bits(mask, p, lk0), bits1 = sp::row_bits(mask, p, lk1);
      dkv_tile<D, DC>(dka, dva, Ks, Vs, Qs, dOs, lse_s, delta_s, p.scale,
                      [&](int c, bool upper) {
                        const int key = upper ? key0 : key1;
                        const int qp = q0 + c;
                        return qp < p.s && key < p.s &&
                               sp::col_kept(upper ? bits0 : bits1, p, c) &&
                               (!p.causal || key <= qp);
                      }, c0, warp, lane);
    }
    store_rows<D, DC>(dk + off, dka, p.scale, key0, key1, p.s, c0, lane);
    store_rows<D, DC>(dv + off, dva, 1.f, key0, key1, p.s, c0, lane);
  }
}

// ---------------------------------------------------------------------------
template <int D>
int launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
              const float* lse, const int* layout, bf16* dq, const SparseProblem& p,
              cudaStream_t stream) {
  const size_t bytes = bwd_tile_bytes<D>() + sp::mask_bytes(p.s);
  static size_t have = 0;
  if (int e = set_max_smem(sparse_dq_kernel<D>, bytes, have)) return e;
  const dim3 grid((unsigned)(p.b * p.h), (unsigned)sp::n_tiles(p.s));
  sparse_dq_kernel<D><<<grid, NTHREADS, bytes, stream>>>(q, k, v, o, dout, lse, layout, dq, p);
  return (int)cudaGetLastError();
}

template <int D, int DC>
int launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
               const float* lse, const int* layout_t, bf16* dk, bf16* dv,
               const SparseProblem& p, cudaStream_t stream) {
  const size_t bytes = bwd_tile_bytes<D>() + sp::mask_bytes(p.s);
  static size_t have = 0;
  if (int e = set_max_smem(sparse_dkv_kernel<D, DC>, bytes, have)) return e;
  const dim3 grid((unsigned)(p.b * p.h), (unsigned)sp::n_tiles(p.s));
  sparse_dkv_kernel<D, DC><<<grid, NTHREADS, bytes, stream>>>(q, k, v, o, dout, lse, layout_t,
                                                              dk, dv, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o, do, dq: [b, h, s, d] bf16; lse: [b, h, s] fp32 from
// dstt_sparse_fwd; layout: [h, nb, nb] int32 with nb * block == s, block =
// 2^lg in 16..256; all contiguous, the bf16 tensors 16-byte aligned. d in
// {64, 128, 256}. Returns cudaGetLastError().
extern "C" int dstt_sparse_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, const void* layout,
                                  void* dq, int b, int h, int s, int d, float scale, int nb,
                                  int lg, int causal, void* stream) {
  if (!sp::problem_ok(s, nb, lg)) return (int)cudaErrorInvalidValue;
  SparseProblem p{b, h, s, scale, causal, nb, lg};
  auto Q = static_cast<const bf16*>(q), K = static_cast<const bf16*>(k),
       V = static_cast<const bf16*>(v), O = static_cast<const bf16*>(o),
       dO = static_cast<const bf16*>(dout);
  auto L = static_cast<const float*>(lse);
  auto Lay = static_cast<const int*>(layout);
  auto dQ = static_cast<bf16*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dq<64>(Q, K, V, O, dO, L, Lay, dQ, p, st);
    case 128: return launch_dq<128>(Q, K, V, O, dO, L, Lay, dQ, p, st);
    case 256: return launch_dq<256>(Q, K, V, O, dO, L, Lay, dQ, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dk, dv: [b, h, s, d] bf16; layout_t: the layout transposed, [h, nb, nb]
// int32 with rows = key blocks (contiguous); the rest as dstt_sparse_bwd_dq.
extern "C" int dstt_sparse_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, const void* layout_t,
                                   void* dk, void* dv, int b, int h, int s, int d, float scale,
                                   int nb, int lg, int causal, void* stream) {
  if (!sp::problem_ok(s, nb, lg)) return (int)cudaErrorInvalidValue;
  SparseProblem p{b, h, s, scale, causal, nb, lg};
  auto Q = static_cast<const bf16*>(q), K = static_cast<const bf16*>(k),
       V = static_cast<const bf16*>(v), O = static_cast<const bf16*>(o),
       dO = static_cast<const bf16*>(dout);
  auto L = static_cast<const float*>(lse);
  auto LayT = static_cast<const int*>(layout_t);
  auto dK = static_cast<bf16*>(dk), dV = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dkv<64, 64>(Q, K, V, O, dO, L, LayT, dK, dV, p, st);
    case 128: return launch_dkv<128, 128>(Q, K, V, O, dO, L, LayT, dK, dV, p, st);
    case 256: return launch_dkv<256, 128>(Q, K, V, O, dO, L, LayT, dK, dV, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
