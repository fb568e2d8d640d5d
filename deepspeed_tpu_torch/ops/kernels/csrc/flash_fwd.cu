// Flash attention forward for Hopper (sm_90a).
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
// Design (mma.sync, no TMA or wgmma yet): one CTA of 4 warps per (64-query
// tile, b * h); each warp owns 16 query rows. The Q tile sits in shared
// memory; the CTA walks the key tiles of its kv head that the causal bound
// and the static band leave live, and skips a tile whose segment ids
// cannot meet the query tile's. Per 64-key tile (flash_common.cuh's
// fwd_tile, which splash_fwd.cu runs too): S = Q K^T with
// mma.m16n8k16 (bf16 in, fp32 accumulate) into registers; the running max
// and sum in fp32 per row (a row's values sit in 4 lanes); P rounded to
// bf16 (as the Pallas body rounds p before p @ v) straight from the S
// accumulators into A fragments; O += P V into fp32 register accumulators.
// A masked key contributes exactly 0 and never enters a rescale: until a
// row has seen a visible key its max stays -inf and nothing accumulates.
// Small shared memory (Q, K, V tiles) keeps several CTAs on each SM to hide
// the synchronous tile loads.
#include "flash_common.cuh"

namespace {

using namespace dstt::flash;

constexpr int BQ = 64;
constexpr int BK = 64;

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(bf16) * (BQ + 2 * BK) * (D + PAD_H) + sizeof(int) * (BQ + BK + 2);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, float* __restrict__ lse, Problem p) {
  constexpr int LD = D + PAD_H;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;
  bf16* Vs = Ks + BK * LD;
  int* segq = reinterpret_cast<int*>(Vs + BK * LD);
  int* segk = segq + BQ;
  int* qrange = segk + BK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const int q0 = heavy_first_query_tile(p, gridDim.y) * BQ;
  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh % p.h;
  const int kvh = hi / (p.h / p.h_kv);
  const bf16* qb = q + ((int64_t)bh * p.s) * D;
  const bf16* kb = k + ((int64_t)bi * p.h_kv + kvh) * p.s * D;
  const bf16* vb = v + ((int64_t)bi * p.h_kv + kvh) * p.s * D;
  const int* seg = p.seg ? p.seg + (int64_t)bi * p.s : nullptr;

  load_tile<BQ, D>(Qs, qb, q0, p.s);
  if (tid == 0) {
    qrange[0] = 0x7fffffff;
    qrange[1] = -0x7fffffff - 1;
  }
  __syncthreads();
  if (seg && tid < BQ && q0 + tid < p.s) {
    const int sv = seg[q0 + tid];
    segq[tid] = sv;
    atomicMin(&qrange[0], sv);
    atomicMax(&qrange[1], sv);
  }
  __syncthreads();
  const int qmin = qrange[0], qmax = qrange[1];

  // this lane's two rows (fragment rows g and g + 8 of the warp's 16)
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;
  const int row0 = q0 + lr0, row1 = q0 + lr1;
  const int sr0 = (seg && row0 < p.s) ? segq[lr0] : 0;
  const int sr1 = (seg && row1 < p.s) ? segq[lr1] : 0;

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  int lo, hi_k;
  key_tiles<BQ, BK>(p, q0, lo, hi_k);
  for (int k0 = lo; k0 < hi_k; k0 += BK) {
    // segment pruning: a key tile whose ids all fall outside the query
    // tile's [min, max] meets no query. The barrier also fences the
    // previous tile's readers of Ks/Vs and segk, so the ids are stored
    // after it.
    int mine = 1, sv = 0;
    if (seg) {
      mine = 0;
      if (tid < BK && k0 + tid < p.s) {
        sv = seg[k0 + tid];
        mine = sv >= qmin && sv <= qmax;
      }
    }
    if (!__syncthreads_or(mine)) continue;
    if (seg && tid < BK) segk[tid] = sv;
    load_tile<BK, D>(Ks, kb, k0, p.s);
    load_tile<BK, D>(Vs, vb, k0, p.s);
    __syncthreads();

    fwd_tile<D>(o, m, l, Qs, Ks, Vs, p.scale, -INFINITY, [&](int c, bool upper) {
      const bool ok = visible(p, upper ? row0 : row1, k0 + c);
      return seg ? ok && segk[c] == (upper ? sr0 : sr1) : ok;
    }, warp, lane);
  }
  fwd_store<D>(out + (int64_t)bh * p.s * D, lse + (int64_t)bh * p.s, o, m, l, row0, row1, p.s,
               lane);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           const Problem& p, cudaStream_t stream) {
  const size_t bytes = fwd_smem_bytes<D>();
  static size_t have = 0;
  if (int e = set_max_smem(flash_fwd_kernel<D>, bytes, have)) return e;
  const dim3 grid((unsigned)(p.b * p.h), (unsigned)((p.s + BQ - 1) / BQ));
  flash_fwd_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, p);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: [b, h, s, d] bf16; k, v: [b, h_kv, s, d] bf16; lse: [b, h, s]
// fp32; seg: [b, s] int32 or null; all contiguous and 16-byte aligned.
// d in {64, 128, 256}; h % h_kv == 0; window > 0 requires causal;
// window_flag < 0 means no per-layer flag. Returns cudaGetLastError().
extern "C" int dstt_flash_fwd(const void* q, const void* k, const void* v, const void* seg,
                              void* out, void* lse, int b, int h, int h_kv, int s, int d,
                              float scale, int causal, int window, int window_flag,
                              void* stream) {
  Problem p;
  p.b = b;
  p.h = h;
  p.h_kv = h_kv;
  p.s = s;
  p.scale = scale;
  p.causal = causal;
  p.window = effective_window(window, window_flag);
  p.seg = static_cast<const int*>(seg);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (d) {
    case 64: return launch<64>(q, k, v, out, l, p, st);
    case 128: return launch<128>(q, k, v, out, l, p, st);
    case 256: return launch<256>(q, k, v, out, l, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
