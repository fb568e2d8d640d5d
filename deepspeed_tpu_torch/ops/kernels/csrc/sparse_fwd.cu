// Layout-predicate block-sparse attention forward for Hopper (sm_90a).
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
// Design: flash_common.cuh's mma.sync grid and per-tile body (fwd_tile:
// one CTA of 4 warps per (64-query tile, b * h), each warp owning 16 query
// rows; S = Q K^T with mma.m16n8k16 into registers, the running max and sum
// in fp32, P rounded to bf16 straight from the S accumulators, O += P V in
// fp32 registers) with the layout's rule for a kept pair
// (sparse_common.cuh). The Pallas body walks every key block
// under a cond (and keeps K and V whole in VMEM); here the CTA first folds
// its layout rows into one mask per 64-key tile, then walks the key tiles
// and skips, before any load, those the layout drops and, when causal, those
// past its last query. Blocks of 16 and 32 give a tile several layout
// blocks each way, and the mask a bit per pair of them. The tile's loads are
// synchronous; several CTAs per SM hide them.
#include "sparse_common.cuh"

namespace {

using namespace dstt::flash;
using SparseProblem = dstt::sparse::Problem;
namespace sp = dstt::sparse;

template <int D>
constexpr size_t fwd_tile_bytes() {
  return sizeof(bf16) * 3 * TILE * (D + PAD_H);
}

// At d <= 128 the register cap of 3 CTAs per SM (168 a thread).
template <int D>
__global__ void __launch_bounds__(NTHREADS, D <= 128 ? 3 : 1) sparse_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ layout, bf16* __restrict__ out, float* __restrict__ lse,
    SparseProblem p) {
  constexpr int LD = D + PAD_H;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + TILE * LD;
  bf16* Vs = Ks + TILE * LD;
  uint16_t* masks = reinterpret_cast<uint16_t*>(Vs + TILE * LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  // later query tiles first: under a causal layout they keep the most tiles
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * TILE;
  const int bh = blockIdx.x;
  const int hi = bh % p.h;
  const int64_t off = (int64_t)bh * p.s * D;

  sp::build_masks(masks, layout + (int64_t)hi * p.nb * p.nb, p, q0);
  load_tile<TILE, D>(Qs, q + off, q0, p.s);
  __syncthreads();

  // this lane's two rows (fragment rows g and g + 8 of the warp's 16)
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;
  const int row0 = q0 + lr0, row1 = q0 + lr1;

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {sp::NEG_INF, sp::NEG_INF}, l[2] = {0.f, 0.f};
  const int q_last = min(q0 + TILE, p.s) - 1;
  const int kt_end = p.causal ? q_last / TILE + 1 : sp::n_tiles(p.s);

  for (int kt = 0; kt < kt_end; ++kt) {
    const uint32_t mask = masks[kt];
    if (mask == 0) continue;  // the same for every thread of the CTA
    const int k0 = kt * TILE;
    __syncthreads();  // the previous tile's readers of Ks and Vs are done
    load_tile<TILE, D>(Ks, k + off, k0, p.s);
    load_tile<TILE, D>(Vs, v + off, k0, p.s);
    __syncthreads();

    const uint32_t bits0 = sp::row_bits(mask, p, lr0), bits1 = sp::row_bits(mask, p, lr1);
    fwd_tile<D>(o, m, l, Qs, Ks, Vs, p.scale, sp::NEG_INF, [&](int c, bool upper) {
      const int r = upper ? row0 : row1;
      const int kp = k0 + c;
      return r < p.s && kp < p.s && sp::col_kept(upper ? bits0 : bits1, p, c) &&
             (!p.causal || kp <= r);
    }, warp, lane);
  }
  fwd_store<D>(out + off, lse + (int64_t)bh * p.s, o, m, l, row0, row1, p.s, lane);
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const int* layout, bf16* out, float* lse,
           const SparseProblem& p, cudaStream_t stream) {
  const size_t bytes = fwd_tile_bytes<D>() + sp::mask_bytes(p.s);
  static size_t have = 0;
  if (int e = set_max_smem(sparse_fwd_kernel<D>, bytes, have)) return e;
  const dim3 grid((unsigned)(p.b * p.h), (unsigned)sp::n_tiles(p.s));
  sparse_fwd_kernel<D><<<grid, NTHREADS, bytes, stream>>>(q, k, v, layout, out, lse, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out: [b, h, s, d] bf16; layout: [h, nb, nb] int32 with nb * block
// == s, block = 2^lg in 16..256; lse: [b, h, s] fp32; all contiguous, the
// bf16 tensors 16-byte aligned. d in {64, 128, 256}. Returns
// cudaGetLastError().
extern "C" int dstt_sparse_fwd(const void* q, const void* k, const void* v, const void* layout,
                               void* out, void* lse, int b, int h, int s, int d, float scale,
                               int nb, int lg, int causal, void* stream) {
  if (!sp::problem_ok(s, nb, lg)) return (int)cudaErrorInvalidValue;
  SparseProblem p{b, h, s, scale, causal, nb, lg};
  auto Q = static_cast<const bf16*>(q), K = static_cast<const bf16*>(k),
       V = static_cast<const bf16*>(v);
  auto Lay = static_cast<const int*>(layout);
  auto O = static_cast<bf16*>(out);
  auto L = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64>(Q, K, V, Lay, O, L, p, st);
    case 128: return launch<128>(Q, K, V, Lay, O, L, p, st);
    case 256: return launch<256>(Q, K, V, Lay, O, L, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
