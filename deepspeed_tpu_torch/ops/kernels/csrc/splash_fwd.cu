// Splash (scheduled block-sparse) attention forward for Hopper (sm_90a).
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
// Design: flash_common.cuh's grid and per-tile body (fwd_tile, which the
// sparse forward runs too: one CTA of 4 warps per (64-query tile, b * h), each warp owning
// 16 query rows; S = Q K^T with mma.m16n8k16 into registers, the running max
// and sum in fp32, P rounded to bf16 straight from the S accumulators into A
// fragments, O += P V in fp32 registers) with splash's rule for a kept pair,
// and the key range taken from the schedule instead of the causal bound: the CTA
// reads its schedule row (q0 / bq, head row 0 or h), skips kind-0 steps
// without loading anything, and walks each listed block as 64-key tiles. The
// tile's loads are synchronous; several CTAs per SM hide them.
#include "splash_common.cuh"

namespace {

using namespace dstt::flash;
using dstt::splash::NEG_INF;
using SplashProblem = dstt::splash::Problem;
using dstt::splash::Schedule;
using dstt::splash::PARTIAL;
using dstt::splash::SKIP;

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(bf16) * 3 * TILE * (D + PAD_H) + sizeof(int) * 2 * TILE;
}

// At d <= 128 the register cap of 3 CTAs per SM (168 a thread) keeps three
// tiles' loads in flight on each SM, as flash_fwd.cu's 166 do by themselves.
template <int D>
__global__ void __launch_bounds__(NTHREADS, D <= 128 ? 3 : 1) splash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, float* __restrict__ lse, SplashProblem p, Schedule sc) {
  constexpr int LD = D + PAD_H;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + TILE * LD;
  bf16* Vs = Ks + TILE * LD;
  int* segq = reinterpret_cast<int*>(Vs + TILE * LD);
  int* segk = segq + TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  // later query tiles first: under a causal schedule they list the most blocks
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * TILE;
  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh % p.h;
  const int kvh = hi / (p.h / p.h_kv);
  const bf16* qb = q + (int64_t)bh * p.sq * D;
  const bf16* kb = k + ((int64_t)bi * p.h_kv + kvh) * p.sk * D;
  const bf16* vb = v + ((int64_t)bi * p.h_kv + kvh) * p.sk * D;
  const int* seg = p.seg ? p.seg + (int64_t)bi * p.sq : nullptr;

  // this CTA's schedule row
  const int hs = sc.heads == 1 ? 0 : hi;
  const int64_t row = ((int64_t)hs * sc.rows + q0 / sc.bq) * sc.width;
  const int* idx = sc.index + row;
  const int* knd = sc.kind + row;

  load_tile<TILE, D>(Qs, qb, q0, p.sq);
  if (seg && tid < TILE) segq[tid] = q0 + tid < p.sq ? seg[q0 + tid] : 0;
  __syncthreads();

  // this lane's two rows (fragment rows g and g + 8 of the warp's 16)
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;
  const int row0 = q0 + lr0, row1 = q0 + lr1;
  const int sr0 = seg ? segq[lr0] : 0, sr1 = seg ? segq[lr1] : 0;

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int q_last = min(q0 + TILE, p.sq) - 1;

  for (int step = 0; step < sc.width; ++step) {
    const int kind = knd[step];
    if (kind == SKIP) continue;  // the same for every thread of the CTA
    const int k_lo = idx[step] * sc.bk;
    const int k_hi = min(k_lo + sc.bk, p.sk);
    for (int k0 = k_lo; k0 < k_hi; k0 += TILE) {
      if (kind == PARTIAL && dstt::splash::tile_dropped(p, p.base + q0, p.base + q_last, k0,
                                                        min(k0 + TILE, k_hi) - 1)) {
        continue;  // a partial block's tile that keeps no pair
      }
      __syncthreads();  // the previous tile's readers of Ks, Vs and segk are done
      if (seg && tid < TILE) segk[tid] = k0 + tid < p.sk ? seg[k0 + tid] : 0;
      load_tile<TILE, D>(Ks, kb, k0, p.sk);
      load_tile<TILE, D>(Vs, vb, k0, p.sk);
      __syncthreads();

      fwd_tile<D>(o, m, l, Qs, Ks, Vs, p.scale, NEG_INF, [&](int c, bool upper) {
        const int r = upper ? row0 : row1;
        return r < p.sq && k0 + c < k_hi &&
               dstt::splash::kept(p, kind, p.base + r, k0 + c, upper ? sr0 : sr1,
                                  seg ? segk[c] : 0);
      }, warp, lane);
    }
  }
  // a row that kept nothing: O = 0, lse = -1e30 + log(1e-30)
  fwd_store<D>(out + (int64_t)bh * p.sq * D, lse + (int64_t)bh * p.sq, o, m, l, row0, row1, p.sq,
               lane);
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* lse,
           const SplashProblem& p, const Schedule& sc, cudaStream_t stream) {
  const size_t bytes = fwd_smem_bytes<D>();
  static size_t have = 0;
  if (int e = set_max_smem(splash_fwd_kernel<D>, bytes, have)) return e;
  const dim3 grid((unsigned)(p.b * p.h), (unsigned)((p.sq + TILE - 1) / TILE));
  splash_fwd_kernel<D><<<grid, NTHREADS, bytes, stream>>>(q, k, v, out, lse, p, sc);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [b, h, sq, d] bf16; k, v: [b, h_kv, sk, d] bf16; lse: [b, h, sq]
// fp32; seg: [b, s] int32 (square attention) or null; kv_index, step_kind:
// [sched_heads, nq, width] int32 with sched_heads 1 or h; all contiguous,
// the bf16 tensors 16-byte aligned. d in {64, 128, 256}; h % h_kv == 0;
// block_q a multiple of 64 or nq == 1. Returns cudaGetLastError().
extern "C" int dstt_splash_fwd(const void* q, const void* k, const void* v, const void* seg,
                               const void* kv_index, const void* step_kind, void* out, void* lse,
                               int b, int h, int h_kv, int sq, int sk, int d, float scale,
                               int sched_heads, int nq, int width, int block_q, int block_kv,
                               int causal, int window, int seg_all, int base, void* stream) {
  if (!dstt::splash::blocks_ok(block_q, nq)) return (int)cudaErrorInvalidValue;
  SplashProblem p{b, h, h_kv, sq, sk, scale, causal, window,
                  static_cast<const int*>(seg), seg_all, base};
  Schedule sc{static_cast<const int*>(kv_index), static_cast<const int*>(step_kind),
              sched_heads, nq, width, block_q, block_kv};
  auto Q = static_cast<const bf16*>(q), K = static_cast<const bf16*>(k),
       V = static_cast<const bf16*>(v);
  auto O = static_cast<bf16*>(out);
  auto L = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64>(Q, K, V, O, L, p, sc, st);
    case 128: return launch<128>(Q, K, V, O, L, p, sc, st);
    case 256: return launch<256>(Q, K, V, O, L, p, sc, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
