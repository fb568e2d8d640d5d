// Flash attention backward for Hopper (sm_90a): two kernels, dq and dk/dv.
//
// Replaces: deepspeed_tpu/ops/attention/flash_pallas.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel (the two pallas_calls in _flash_bwd). Both recompute
// p = exp(q k^T * scale - lse) from the forward's fp32 log-sum-exp and take
// delta = sum(do * o) in the kernel; ds = p * (do v^T - delta) is rounded to
// bf16 before its products, as in the Pallas bodies.
//
// Bound: operations. dq does 3 products of 2 * d FLOPs per visible (query,
// key) pair (q k^T, do v^T, ds k), dk/dv 4 (q k^T, do v^T, p^T do, ds^T q);
// the bytes are a few rows of [s, d] each, far below the card's ridge.
//
// Design (mma.sync as flash_fwd.cu; CTAs of 4 warps, each warp owning 16
// rows, every product's accumulator in registers, P and dS turned into A
// fragments without leaving registers; the per-tile bodies are
// flash_common.cuh's dq_tile and dkv_tile, which splash_bwd.cu runs too):
//  * dq: one CTA per (64-query tile, b * h); walks the live key tiles of
//    its kv head like the forward: S = Q K^T and dP = dO V^T per tile, dS in
//    registers, dQ += dS K; scales once at the end.
//  * dk/dv: one CTA per (64-key tile, b * h_kv); walks every query head of
//    its GQA group and the query tiles that see the key tile, working on
//    the transposed products (S^T = K Q^T, dP^T = V dO^T, so a warp's rows
//    are its keys): dV += P^T dO, dK += dS^T Q, summed over the group in
//    fp32 before rounding once. (The Pallas path writes per-query-head bf16
//    partials and sums them afterwards.) At d = 256 the dk/dv accumulators
//    are taken in two 128-column halves, each its own pass, to stay in
//    registers.
#include "flash_common.cuh"

namespace {

using namespace dstt::flash;

constexpr int BQ = TILE;
constexpr int BK = TILE;

template <int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(bf16) * (2 * BQ + 2 * BK) * (D + PAD_H) +
         sizeof(float) * 2 * BQ + sizeof(int) * (BQ + BK + 2);
}

// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    bf16* __restrict__ dq, Problem p) {
  constexpr int LD = D + PAD_H;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BQ * LD;
  bf16* Ks = dOs + BQ * LD;
  bf16* Vs = Ks + BK * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + BK * LD);
  float* delta_s = lse_s + BQ;
  int* segq = reinterpret_cast<int*>(delta_s + BQ);
  int* segk = segq + BQ;
  int* qrange = segk + BK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const int q0 = heavy_first_query_tile(p, gridDim.y) * BQ;
  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh % p.h;
  const int kvh = hi / (p.h / p.h_kv);
  const int64_t qoff = (int64_t)bh * p.s * D;
  const bf16* kb = k + ((int64_t)bi * p.h_kv + kvh) * p.s * D;
  const bf16* vb = v + ((int64_t)bi * p.h_kv + kvh) * p.s * D;
  const int* seg = p.seg ? p.seg + (int64_t)bi * p.s : nullptr;

  load_tile<BQ, D>(Qs, q + qoff, q0, p.s);
  load_tile<BQ, D>(dOs, dout + qoff, q0, p.s);
  if (tid == 0) {
    qrange[0] = 0x7fffffff;
    qrange[1] = -0x7fffffff - 1;
  }
  if (tid < BQ) lse_s[tid] = q0 + tid < p.s ? lse[(int64_t)bh * p.s + q0 + tid] : 0.f;
  __syncthreads();
  if (seg && tid < BQ && q0 + tid < p.s) {
    const int sv = seg[q0 + tid];
    segq[tid] = sv;
    atomicMin(&qrange[0], sv);
    atomicMax(&qrange[1], sv);
  }
  row_delta<D>(dOs, o + qoff, q0, p.s, delta_s);
  __syncthreads();
  const int qmin = qrange[0], qmax = qrange[1];

  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;
  const int row0 = q0 + lr0, row1 = q0 + lr1;
  const int sr0 = (seg && row0 < p.s) ? segq[lr0] : 0;
  const int sr1 = (seg && row1 < p.s) ? segq[lr1] : 0;
  const float lse_r[2] = {lse_s[lr0], lse_s[lr1]};
  const float del_r[2] = {delta_s[lr0], delta_s[lr1]};

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  int lo, hi_k;
  key_tiles<BQ, BK>(p, q0, lo, hi_k);
  for (int k0 = lo; k0 < hi_k; k0 += BK) {
    // segment pruning as in the forward; the ids are stored after the
    // barrier, which fences the previous tile's readers
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

    dq_tile<D>(acc, Qs, dOs, Ks, Vs, p.scale, lse_r, del_r, [&](int c, bool upper) {
      const bool ok = visible(p, upper ? row0 : row1, k0 + c);
      return seg ? ok && segk[c] == (upper ? sr0 : sr1) : ok;
    }, warp, lane);
  }
  store_rows<D, D>(dq + qoff, acc, p.scale, row0, row1, p.s, 0, lane);
}

// ---------------------------------------------------------------------------
template <int D, int DC>
__global__ void __launch_bounds__(NTHREADS) flash_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    bf16* __restrict__ dk, bf16* __restrict__ dv, Problem p) {
  constexpr int LD = D + PAD_H;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BQ * LD;
  bf16* Ks = dOs + BQ * LD;
  bf16* Vs = Ks + BK * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + BK * LD);
  float* delta_s = lse_s + BQ;
  int* segq = reinterpret_cast<int*>(delta_s + BQ);
  int* segk = segq + BQ;
  int* krange = segk + BK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const int k0 = blockIdx.y * BK;  // the first key tiles carry the most work
  const int bkv = blockIdx.x;
  const int bi = bkv / p.h_kv, kvh = bkv % p.h_kv;
  const int group = p.h / p.h_kv;
  const int64_t kvoff = (int64_t)bkv * p.s * D;
  const int* seg = p.seg ? p.seg + (int64_t)bi * p.s : nullptr;

  load_tile<BK, D>(Ks, k + kvoff, k0, p.s);
  load_tile<BK, D>(Vs, v + kvoff, k0, p.s);
  if (tid == 0) {
    krange[0] = 0x7fffffff;
    krange[1] = -0x7fffffff - 1;
  }
  __syncthreads();
  if (seg && tid < BK && k0 + tid < p.s) {
    const int sv = seg[k0 + tid];
    segk[tid] = sv;
    atomicMin(&krange[0], sv);
    atomicMax(&krange[1], sv);
  }
  __syncthreads();
  const int kmin = krange[0], kmax = krange[1];

  // this lane's two keys (fragment rows g and g + 8 of the warp's 16)
  const int lk0 = warp * 16 + g, lk1 = lk0 + 8;
  const int key0 = k0 + lk0, key1 = k0 + lk1;
  const int sk0 = (seg && key0 < p.s) ? segk[lk0] : 0;
  const int sk1 = (seg && key1 < p.s) ? segk[lk1] : 0;

  int lo, hi_q;
  query_tiles<BQ, BK>(p, k0, lo, hi_q);
  for (int c0 = 0; c0 < D; c0 += DC) {
    float dka[DC / 8][4], dva[DC / 8][4];
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
      dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
    }
    for (int gq = 0; gq < group; ++gq) {
      const int64_t qoff = ((int64_t)bi * p.h + kvh * group + gq) * p.s * D;
      const float* lseb = lse + ((int64_t)bi * p.h + kvh * group + gq) * p.s;
      for (int q0 = lo; q0 < hi_q; q0 += BQ) {
        // segment pruning as in the forward; the ids are stored after the
        // barrier, which fences the previous tile's readers
        int mine = 1, sv = 0;
        if (seg) {
          mine = 0;
          if (tid < BQ && q0 + tid < p.s) {
            sv = seg[q0 + tid];
            mine = sv >= kmin && sv <= kmax;
          }
        }
        if (!__syncthreads_or(mine)) continue;
        if (seg && tid < BQ) segq[tid] = sv;
        load_tile<BQ, D>(Qs, q + qoff, q0, p.s);
        load_tile<BQ, D>(dOs, dout + qoff, q0, p.s);
        if (tid < BQ) lse_s[tid] = q0 + tid < p.s ? lseb[q0 + tid] : 0.f;
        __syncthreads();
        row_delta<D>(dOs, o + qoff, q0, p.s, delta_s);
        __syncthreads();

        dkv_tile<D, DC>(dka, dva, Ks, Vs, Qs, dOs, lse_s, delta_s, p.scale,
                        [&](int c, bool upper) {
                          const bool ok = visible(p, q0 + c, upper ? key0 : key1);
                          return seg ? ok && segq[c] == (upper ? sk0 : sk1) : ok;
                        }, c0, warp, lane);
      }
    }
    store_rows<D, DC>(dk + kvoff, dka, p.scale, key0, key1, p.s, c0, lane);
    store_rows<D, DC>(dv + kvoff, dva, 1.f, key0, key1, p.s, c0, lane);
  }
}

// ---------------------------------------------------------------------------
template <int D>
int launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
              const float* lse, bf16* dq, const Problem& p, cudaStream_t stream) {
  const size_t bytes = bwd_smem_bytes<D>();
  static size_t have = 0;
  if (int e = set_max_smem(flash_dq_kernel<D>, bytes, have)) return e;
  const dim3 grid((unsigned)(p.b * p.h), (unsigned)((p.s + BQ - 1) / BQ));
  flash_dq_kernel<D><<<grid, NTHREADS, bytes, stream>>>(q, k, v, o, dout, lse, dq, p);
  return (int)cudaGetLastError();
}

template <int D, int DC>
int launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
               const float* lse, bf16* dk, bf16* dv, const Problem& p, cudaStream_t stream) {
  const size_t bytes = bwd_smem_bytes<D>();
  static size_t have = 0;
  if (int e = set_max_smem(flash_dkv_kernel<D, DC>, bytes, have)) return e;
  const dim3 grid((unsigned)(p.b * p.h_kv), (unsigned)((p.s + BK - 1) / BK));
  flash_dkv_kernel<D, DC><<<grid, NTHREADS, bytes, stream>>>(q, k, v, o, dout, lse, dk, dv, p);
  return (int)cudaGetLastError();
}

Problem make_problem(int b, int h, int h_kv, int s, float scale, int causal, int window,
                     int window_flag, const void* seg) {
  Problem p;
  p.b = b;
  p.h = h;
  p.h_kv = h_kv;
  p.s = s;
  p.scale = scale;
  p.causal = causal;
  p.window = effective_window(window, window_flag);
  p.seg = static_cast<const int*>(seg);
  return p;
}

}  // namespace

// q, o, do, dq: [b, h, s, d] bf16; k, v: [b, h_kv, s, d] bf16; lse: [b, h,
// s] fp32 from dstt_flash_fwd; seg [b, s] int32 or null; all contiguous and
// 16-byte aligned; arguments as dstt_flash_fwd. Returns cudaGetLastError().
extern "C" int dstt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const void* lse, const void* seg, void* dq,
                                 int b, int h, int h_kv, int s, int d, float scale, int causal,
                                 int window, int window_flag, void* stream) {
  const Problem p = make_problem(b, h, h_kv, s, scale, causal, window, window_flag, seg);
  auto Q = static_cast<const bf16*>(q), K = static_cast<const bf16*>(k),
       V = static_cast<const bf16*>(v), O = static_cast<const bf16*>(o),
       dO = static_cast<const bf16*>(dout);
  auto lse_ = static_cast<const float*>(lse);
  auto dQ = static_cast<bf16*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dq<64>(Q, K, V, O, dO, lse_, dQ, p, st);
    case 128: return launch_dq<128>(Q, K, V, O, dO, lse_, dQ, p, st);
    case 256: return launch_dq<256>(Q, K, V, O, dO, lse_, dQ, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dk, dv: [b, h_kv, s, d] bf16, each the sum over the kv head's GQA group.
extern "C" int dstt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, const void* seg, void* dk,
                                  void* dv, int b, int h, int h_kv, int s, int d, float scale,
                                  int causal, int window, int window_flag, void* stream) {
  const Problem p = make_problem(b, h, h_kv, s, scale, causal, window, window_flag, seg);
  auto Q = static_cast<const bf16*>(q), K = static_cast<const bf16*>(k),
       V = static_cast<const bf16*>(v), O = static_cast<const bf16*>(o),
       dO = static_cast<const bf16*>(dout);
  auto lse_ = static_cast<const float*>(lse);
  auto dK = static_cast<bf16*>(dk), dV = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dkv<64, 64>(Q, K, V, O, dO, lse_, dK, dV, p, st);
    case 128: return launch_dkv<128, 128>(Q, K, V, O, dO, lse_, dK, dV, p, st);
    case 256: return launch_dkv<256, 128>(Q, K, V, O, dO, lse_, dK, dV, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
