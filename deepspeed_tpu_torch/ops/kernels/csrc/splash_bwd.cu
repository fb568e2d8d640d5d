// Splash (scheduled block-sparse) attention backward for Hopper (sm_90a):
// two kernels, dq and dk/dv.
//
// Replaces: deepspeed_tpu/ops/sparse_attention/splash_pallas.py::
// _splash_bwd_dq_kernel and ::_splash_bwd_dkv_kernel (the two pallas_calls
// in _splash_vjp_bwd). Both recompute p = exp(q k^T * scale - lse) from the
// forward's fp32 log-sum-exp over the scheduled steps only, with the
// forward's rule for a kept pair, and take delta = sum(do * o) in the
// kernel; ds = p * (do v^T - delta) is rounded to bf16 before its products.
//
// Bound: operations. dq does 3 products of 2 * d FLOPs per kept (query, key)
// pair (q k^T, do v^T, ds k), dk/dv 4 (q k^T, do v^T, p^T do, ds^T q); the
// bytes are a few reads of q, k, v, o, do.
//
// Design (flash_common.cuh's per-tile bodies dq_tile and dkv_tile, with
// splash's rule for a kept pair; CTAs of 4 warps, each warp owning 16 rows,
// every accumulator in registers, P and dS turned into A fragments without
// leaving registers):
//  * dq: one CTA per (64-query tile, b * h); walks the kv blocks of its
//    schedule row (kind-0 steps skipped, each block as 64-key tiles);
//    dQ += dS K; scaled once at the end.
//  * dk/dv: one CTA per (64-key tile, b * h_kv); walks every query head of
//    its GQA group, each through its own row of the transposed schedule
//    (q_index, step_kind_t at the tile's kv block), and each listed query
//    block as 64-query tiles, on the transposed products (S^T = K Q^T, dP^T =
//    V dO^T): dV += P^T dO, dK += dS^T Q, summed over the group in fp32 and
//    rounded once. (The Pallas path writes per-query-head [b, h, sk, d]
//    planes and sums them afterwards.) At d = 256 the accumulators are taken
//    in two 128-column halves, each its own pass.
#include "splash_common.cuh"

namespace {

using namespace dstt::flash;
using SplashProblem = dstt::splash::Problem;
using dstt::splash::Schedule;
using dstt::splash::PARTIAL;
using dstt::splash::SKIP;

template <int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(bf16) * 4 * TILE * (D + PAD_H) + sizeof(float) * 2 * TILE +
         sizeof(int) * 2 * TILE;
}

// ---------------------------------------------------------------------------
// At d <= 128 the register cap of 3 CTAs per SM (168 a thread, what
// flash_dq_kernel takes uncapped) keeps a third tile's loads in flight; left
// to itself ptxas gives this kernel ~244 registers and 2 CTAs per SM.
template <int D>
__global__ void __launch_bounds__(NTHREADS, D <= 128 ? 3 : 1) splash_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    bf16* __restrict__ dq, SplashProblem p, Schedule sc) {
  constexpr int LD = D + PAD_H;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + TILE * LD;
  bf16* Ks = dOs + TILE * LD;
  bf16* Vs = Ks + TILE * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + TILE * LD);
  float* delta_s = lse_s + TILE;
  int* segq = reinterpret_cast<int*>(delta_s + TILE);
  int* segk = segq + TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * TILE;
  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh % p.h;
  const int kvh = hi / (p.h / p.h_kv);
  const int64_t qoff = (int64_t)bh * p.sq * D;
  const bf16* kb = k + ((int64_t)bi * p.h_kv + kvh) * p.sk * D;
  const bf16* vb = v + ((int64_t)bi * p.h_kv + kvh) * p.sk * D;
  const int* seg = p.seg ? p.seg + (int64_t)bi * p.sq : nullptr;

  const int hs = sc.heads == 1 ? 0 : hi;
  const int64_t row = ((int64_t)hs * sc.rows + q0 / sc.bq) * sc.width;
  const int* idx = sc.index + row;
  const int* knd = sc.kind + row;

  load_tile<TILE, D>(Qs, q + qoff, q0, p.sq);
  load_tile<TILE, D>(dOs, dout + qoff, q0, p.sq);
  if (tid < TILE) {
    lse_s[tid] = q0 + tid < p.sq ? lse[(int64_t)bh * p.sq + q0 + tid] : 0.f;
    if (seg) segq[tid] = q0 + tid < p.sq ? seg[q0 + tid] : 0;
  }
  __syncthreads();
  row_delta<D>(dOs, o + qoff, q0, p.sq, delta_s);
  __syncthreads();

  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;
  const int row0 = q0 + lr0, row1 = q0 + lr1;
  const int sr0 = seg ? segq[lr0] : 0, sr1 = seg ? segq[lr1] : 0;
  const float lse_r[2] = {lse_s[lr0], lse_s[lr1]};
  const float del_r[2] = {delta_s[lr0], delta_s[lr1]};
  const int q_last = min(q0 + TILE, p.sq) - 1;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int step = 0; step < sc.width; ++step) {
    const int kind = knd[step];
    if (kind == SKIP) continue;
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

      dq_tile<D>(acc, Qs, dOs, Ks, Vs, p.scale, lse_r, del_r, [&](int c, bool upper) {
        const int r = upper ? row0 : row1;
        return r < p.sq && k0 + c < k_hi &&
               dstt::splash::kept(p, kind, p.base + r, k0 + c, upper ? sr0 : sr1,
                                  seg ? segk[c] : 0);
      }, warp, lane);
    }
  }
  store_rows<D, D>(dq + qoff, acc, p.scale, row0, row1, p.sq, 0, lane);
}

// ---------------------------------------------------------------------------
template <int D, int DC>
__global__ void __launch_bounds__(NTHREADS) splash_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    bf16* __restrict__ dk, bf16* __restrict__ dv, SplashProblem p, Schedule st) {
  constexpr int LD = D + PAD_H;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + TILE * LD;
  bf16* Ks = dOs + TILE * LD;
  bf16* Vs = Ks + TILE * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + TILE * LD);
  float* delta_s = lse_s + TILE;
  int* segq = reinterpret_cast<int*>(delta_s + TILE);
  int* segk = segq + TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const int k0 = blockIdx.y * TILE;
  const int bkv = blockIdx.x;
  const int bi = bkv / p.h_kv, kvh = bkv % p.h_kv;
  const int group = p.h / p.h_kv;
  const int64_t kvoff = (int64_t)bkv * p.sk * D;
  const int* seg = p.seg ? p.seg + (int64_t)bi * p.sq : nullptr;
  const int kblock = k0 / st.bk;  // this tile's row of the transposed schedule

  load_tile<TILE, D>(Ks, k + kvoff, k0, p.sk);
  load_tile<TILE, D>(Vs, v + kvoff, k0, p.sk);
  if (seg && tid < TILE) segk[tid] = k0 + tid < p.sk ? seg[k0 + tid] : 0;
  __syncthreads();

  // this lane's two keys (fragment rows g and g + 8 of the warp's 16)
  const int lk0 = warp * 16 + g, lk1 = lk0 + 8;
  const int key0 = k0 + lk0, key1 = k0 + lk1;
  const int sk0 = seg ? segk[lk0] : 0, sk1 = seg ? segk[lk1] : 0;
  const int k_last = min(k0 + TILE, p.sk) - 1;

  for (int c0 = 0; c0 < D; c0 += DC) {
    float dka[DC / 8][4], dva[DC / 8][4];
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
      dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
    }
    for (int gq = 0; gq < group; ++gq) {
      const int hq = kvh * group + gq;
      const int hs = st.heads == 1 ? 0 : hq;
      const int64_t row = ((int64_t)hs * st.rows + kblock) * st.width;
      const int* idx = st.index + row;
      const int* knd = st.kind + row;
      const int64_t qoff = ((int64_t)bi * p.h + hq) * p.sq * D;
      const float* lseb = lse + ((int64_t)bi * p.h + hq) * p.sq;
      for (int step = 0; step < st.width; ++step) {
        const int kind = knd[step];
        if (kind == SKIP) continue;
        const int q_lo = idx[step] * st.bq;
        const int q_hi = min(q_lo + st.bq, p.sq);
        for (int q0 = q_lo; q0 < q_hi; q0 += TILE) {
          if (kind == PARTIAL && dstt::splash::tile_dropped(p, p.base + q0,
                                                            p.base + min(q0 + TILE, q_hi) - 1,
                                                            k0, k_last)) {
            continue;  // a partial block's tile that keeps no pair
          }
          __syncthreads();  // the previous tile's readers are done
          if (tid < TILE) {
            lse_s[tid] = q0 + tid < p.sq ? lseb[q0 + tid] : 0.f;
            if (seg) segq[tid] = q0 + tid < p.sq ? seg[q0 + tid] : 0;
          }
          load_tile<TILE, D>(Qs, q + qoff, q0, p.sq);
          load_tile<TILE, D>(dOs, dout + qoff, q0, p.sq);
          __syncthreads();
          row_delta<D>(dOs, o + qoff, q0, p.sq, delta_s);
          __syncthreads();

          dkv_tile<D, DC>(dka, dva, Ks, Vs, Qs, dOs, lse_s, delta_s, p.scale,
                          [&](int c, bool upper) {
                            const int key = upper ? key0 : key1;
                            return q0 + c < q_hi && key < p.sk &&
                                   dstt::splash::kept(p, kind, p.base + q0 + c, key, segq[c],
                                                      upper ? sk0 : sk1);
                          }, c0, warp, lane);
        }
      }
    }
    store_rows<D, DC>(dk + kvoff, dka, p.scale, key0, key1, p.sk, c0, lane);
    store_rows<D, DC>(dv + kvoff, dva, 1.f, key0, key1, p.sk, c0, lane);
  }
}

// ---------------------------------------------------------------------------
template <int D>
int launch_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
              const float* lse, bf16* dq, const SplashProblem& p, const Schedule& sc,
              cudaStream_t stream) {
  const size_t bytes = bwd_smem_bytes<D>();
  static size_t have = 0;
  if (int e = set_max_smem(splash_dq_kernel<D>, bytes, have)) return e;
  const dim3 grid((unsigned)(p.b * p.h), (unsigned)((p.sq + TILE - 1) / TILE));
  splash_dq_kernel<D><<<grid, NTHREADS, bytes, stream>>>(q, k, v, o, dout, lse, dq, p, sc);
  return (int)cudaGetLastError();
}

template <int D, int DC>
int launch_dkv(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
               const float* lse, bf16* dk, bf16* dv, const SplashProblem& p, const Schedule& st,
               cudaStream_t stream) {
  const size_t bytes = bwd_smem_bytes<D>();
  static size_t have = 0;
  if (int e = set_max_smem(splash_dkv_kernel<D, DC>, bytes, have)) return e;
  const dim3 grid((unsigned)(p.b * p.h_kv), (unsigned)((p.sk + TILE - 1) / TILE));
  splash_dkv_kernel<D, DC><<<grid, NTHREADS, bytes, stream>>>(q, k, v, o, dout, lse, dk, dv, p,
                                                              st);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, do, dq: [b, h, sq, d] bf16; k, v: [b, h_kv, sk, d] bf16; lse: [b, h,
// sq] fp32 from dstt_splash_fwd; seg [b, s] int32 or null; kv_index,
// step_kind: [sched_heads, nq, width] int32; all contiguous, the bf16
// tensors 16-byte aligned; block_q a multiple of 64 or nq == 1. Returns
// cudaGetLastError().
extern "C" int dstt_splash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, const void* lse, const void* seg,
                                  const void* kv_index, const void* step_kind, void* dq, int b,
                                  int h, int h_kv, int sq, int sk, int d, float scale,
                                  int sched_heads, int nq, int width, int block_q, int block_kv,
                                  int causal, int window, int seg_all, void* stream) {
  if (!dstt::splash::blocks_ok(block_q, nq)) return (int)cudaErrorInvalidValue;
  SplashProblem p{b, h, h_kv, sq, sk, scale, causal, window,
                  static_cast<const int*>(seg), seg_all, 0};
  Schedule sc{static_cast<const int*>(kv_index), static_cast<const int*>(step_kind),
              sched_heads, nq, width, block_q, block_kv};
  auto Q = static_cast<const bf16*>(q), K = static_cast<const bf16*>(k),
       V = static_cast<const bf16*>(v), O = static_cast<const bf16*>(o),
       dO = static_cast<const bf16*>(dout);
  auto L = static_cast<const float*>(lse);
  auto dQ = static_cast<bf16*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dq<64>(Q, K, V, O, dO, L, dQ, p, sc, st);
    case 128: return launch_dq<128>(Q, K, V, O, dO, L, dQ, p, sc, st);
    case 256: return launch_dq<256>(Q, K, V, O, dO, L, dQ, p, sc, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dk, dv: [b, h_kv, sk, d] bf16, each the sum over the kv head's GQA group;
// q_index, step_kind_t: [sched_heads, nk, width_t] int32 (the transposed
// schedule); block_kv a multiple of 64 or nk == 1; the rest as
// dstt_splash_bwd_dq.
extern "C" int dstt_splash_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, const void* seg,
                                   const void* q_index, const void* step_kind_t, void* dk,
                                   void* dv, int b, int h, int h_kv, int sq, int sk, int d,
                                   float scale, int sched_heads, int nk, int width_t,
                                   int block_q, int block_kv, int causal, int window,
                                   int seg_all, void* stream) {
  if (!dstt::splash::blocks_ok(block_kv, nk)) return (int)cudaErrorInvalidValue;
  SplashProblem p{b, h, h_kv, sq, sk, scale, causal, window,
                  static_cast<const int*>(seg), seg_all, 0};
  Schedule sc{static_cast<const int*>(q_index), static_cast<const int*>(step_kind_t),
              sched_heads, nk, width_t, block_q, block_kv};
  auto Q = static_cast<const bf16*>(q), K = static_cast<const bf16*>(k),
       V = static_cast<const bf16*>(v), O = static_cast<const bf16*>(o),
       dO = static_cast<const bf16*>(dout);
  auto L = static_cast<const float*>(lse);
  auto dK = static_cast<bf16*>(dk), dV = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dkv<64, 64>(Q, K, V, O, dO, L, dK, dV, p, sc, st);
    case 128: return launch_dkv<128, 128>(Q, K, V, O, dO, L, dK, dV, p, sc, st);
    case 256: return launch_dkv<256, 128>(Q, K, V, O, dO, L, dK, dV, p, sc, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
