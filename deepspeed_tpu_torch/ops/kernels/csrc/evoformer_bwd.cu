// Evoformer attention backward for Hopper (sm_90a): two kernels, dq (with
// the bias gradient dS) and dk/dv.
//
// Replaces: deepspeed_tpu/ops/deepspeed4science/evoformer_attn.py::
// _bwd_dq_kernel and ::_bwd_dkv_kernel (the two pallas_calls in _evo_bwd).
// Both recompute p = exp(q k^T * scale + b1 + b2 - lse) from the forward's
// fp32 log-sum-exp and take delta = sum(do * o) in the kernel; dS = p * (do
// v^T - delta) in fp32 is the gradient of the summed bias. A dead pair (see
// evoformer_common.cuh) has p = 0, so a row with no live logit gets zero dq
// and dS, and adds exactly 0 to dk and dv.
//
// Bound: dq writes the fp32 dS plane [B, h, s, s] when a bias needs a
// gradient: at the Evoformer's widths (s 384, d 32) those 4 s^2 bytes per
// (row, head) outweigh q, k, v, o, do and dq, so dq is bytes-bound; without
// dS, and for dk/dv, bf16 is bytes-bound too (6d / 8d FLOPs per pair at d 32)
// and fp32 operation-bound.
//
// Design (evoformer_common.cuh's products; CTAs of 4 warps, each warp owning
// 16 rows, every accumulator in registers):
//  * dq: one CTA per (64-query tile, head, batch row) walks the key tiles
//    (the summed bias of each staged in shared memory, as in the forward):
//    S = Q K^T, dP = dO V^T, then per pair the logit, p, dS (written to the
//    plane when asked, by the lane's fragment pairs: float2 when s is even),
//    dQ += dS K; scaled once at the end. The reduction of dS to each bias's
//    shape is left to the caller (torch), as the JAX package leaves it to
//    XLA.
//  * dk/dv: one CTA per (64-key tile, head, batch row) walks the query
//    tiles on the transposed products (S^T = K Q^T, dP^T = V dO^T), reading
//    the staged bias tile transposed; dV += P^T dO, dK += dS^T Q
//    in fp32, rounded once. The fp32 path at d 128 takes the accumulators
//    in two 64-column halves, each its own pass.
// bf16 rounds P and dS to bf16 before their products (the tensor cores'
// operands), as the flash kernels do; the Pallas bodies keep them in fp32,
// as the fp32 path does.
#include "evoformer_common.cuh"

namespace {

using namespace dstt::evo;

template <typename T, int D>
constexpr size_t bwd_bytes() {
  return sizeof(T) * 4 * TILE * ld<T, D>() + sizeof(float) * 2 * TILE + BIAS_TILE_BYTES +
         stage_bytes<T>();
}

// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, (min_ctas<T, D>())) evo_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
    T* __restrict__ dq, float* __restrict__ dS, Problem p) {
  constexpr int LD = ld<T, D>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + TILE * LD;
  T* Ks = dOs + TILE * LD;
  T* Vs = Ks + TILE * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + TILE * LD);
  float* delta_s = lse_s + TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* Bs = delta_s + TILE;
  float* stage = Bs + TILE * STAGE_LD + warp * 16 * STAGE_LD;
  // one (batch row, head)'s tiles run next to each other: its K and V
  // (and the pair bias) are read from L2 after the first
  const int nt = n_tiles(p.s);
  const int bh = blockIdx.x / nt;
  const int bi = bh / p.h, hi = bh % p.h;
  const int q0 = (int)(blockIdx.x % nt) * TILE;
  const int64_t stride = (int64_t)p.h * D;
  const int64_t off = head_offset(bi, hi, p, D);

  load_tile<T, D>(Qs, q + off, q0, p.s, stride);
  load_tile<T, D>(dOs, dout + off, q0, p.s, stride);
  if (tid < TILE) lse_s[tid] = q0 + tid < p.s ? lse[(int64_t)bh * p.s + q0 + tid] : 0.f;
  __syncthreads();
  row_delta<T, D>(dOs, o + off, q0, p.s, stride, delta_s);
  __syncthreads();

  const int lr[2] = {warp * 16 + g, warp * 16 + g + 8};
  const int row[2] = {q0 + lr[0], q0 + lr[1]};
  const float lse_r[2] = {lse_s[lr[0]], lse_s[lr[1]]};
  const float del_r[2] = {delta_s[lr[0]], delta_s[lr[1]]};
  const float* p1 = bias_plane(p.b1, bi, hi);
  const float* p2 = bias_plane(p.b2, bi, hi);
  const bool biased = p1 || p2;
  float* dSb = dS ? dS + (int64_t)bh * p.s * p.s : nullptr;
  const bool pairs = (p.s & 1) == 0;  // float2 stores of dS stay aligned

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < p.s; k0 += TILE) {
    __syncthreads();  // the previous tile's readers of Ks and Vs are done
    load_tile<T, D>(Ks, k + off, k0, p.s, stride);
    load_tile<T, D>(Vs, v + off, k0, p.s, stride);
    if (biased) load_bias_tile(Bs, p1, p.b1.sq, p2, p.b2.sq, q0, k0, p.s, p.vec);
    __syncthreads();

    float sc[TILE / 8][4], ds[TILE / 8][4];
    abt<T, D>(sc, Qs, Ks, warp * 16, lane);
    abt<T, D>(ds, dOs, Vs, warp * 16, lane);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = e >> 1, c = j * 8 + 2 * t + (e & 1);
        float pe = 0.f;
        if (row[u] < p.s && k0 + c < p.s) {
          const float x = logit(sc[j][e], p.scale, biased ? Bs[lr[u] * STAGE_LD + c] : 0.f);
          if (x > NEG_INF) pe = __expf(x - lse_r[u]);
        }
        ds[j][e] = pe * (ds[j][e] - del_r[u]);
      }
    }
    if (dSb) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (row[u] >= p.s) continue;
        float* drow = dSb + (int64_t)row[u] * p.s;
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          const int kp = k0 + j * 8 + 2 * t;
          if (pairs) {
            if (kp < p.s)
              *reinterpret_cast<float2*>(drow + kp) = make_float2(ds[j][2 * u], ds[j][2 * u + 1]);
          } else {
            if (kp < p.s) drow[kp] = ds[j][2 * u];
            if (kp + 1 < p.s) drow[kp + 1] = ds[j][2 * u + 1];
          }
        }
      }
    }
    accum<T, D, D>(acc, ds, Ks, 0, stage, lane);  // K stored [key][d]: k-major here
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (row[u] >= p.s) continue;
    T* drow = dq + off + (int64_t)row[u] * stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + 2 * t;
      const float a = acc[j][2 * u] * p.scale, b = acc[j][2 * u + 1] * p.scale;
      if constexpr (is_bf16<T>()) {
        *reinterpret_cast<__nv_bfloat162*>(drow + c) = __floats2bfloat162_rn(a, b);
      } else {
        *reinterpret_cast<float2*>(drow + c) = make_float2(a, b);
      }
    }
  }
}

// ---------------------------------------------------------------------------
template <typename T, int D, int DC>
__global__ void __launch_bounds__(NTHREADS, (min_ctas<T, D>())) evo_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
    T* __restrict__ dk, T* __restrict__ dv, Problem p) {
  constexpr int LD = ld<T, D>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + TILE * LD;
  T* Ks = dOs + TILE * LD;
  T* Vs = Ks + TILE * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + TILE * LD);
  float* delta_s = lse_s + TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* Bs = delta_s + TILE;
  float* stage = Bs + TILE * STAGE_LD + warp * 16 * STAGE_LD;
  const int nt = n_tiles(p.s);
  const int bh = blockIdx.x / nt;
  const int bi = bh / p.h, hi = bh % p.h;
  const int k0 = (int)(blockIdx.x % nt) * TILE;
  const int64_t stride = (int64_t)p.h * D;
  const int64_t off = head_offset(bi, hi, p, D);
  const float* lseb = lse + (int64_t)bh * p.s;

  load_tile<T, D>(Ks, k + off, k0, p.s, stride);
  load_tile<T, D>(Vs, v + off, k0, p.s, stride);

  // this lane's two keys (fragment rows g and g + 8 of the warp's 16)
  const int lk[2] = {warp * 16 + g, warp * 16 + g + 8};
  const int key[2] = {k0 + lk[0], k0 + lk[1]};
  const float* p1 = bias_plane(p.b1, bi, hi);
  const float* p2 = bias_plane(p.b2, bi, hi);
  const bool biased = p1 || p2;

  for (int c0 = 0; c0 < D; c0 += DC) {
    float dka[DC / 8][4], dva[DC / 8][4];
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
      dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
    }
    for (int q0 = 0; q0 < p.s; q0 += TILE) {
      __syncthreads();  // the previous tile's readers are done
      if (tid < TILE) lse_s[tid] = q0 + tid < p.s ? lseb[q0 + tid] : 0.f;
      load_tile<T, D>(Qs, q + off, q0, p.s, stride);
      load_tile<T, D>(dOs, dout + off, q0, p.s, stride);
      if (biased) load_bias_tile(Bs, p1, p.b1.sq, p2, p.b2.sq, q0, k0, p.s, p.vec);
      __syncthreads();
      row_delta<T, D>(dOs, o + off, q0, p.s, stride, delta_s);
      __syncthreads();

      float pt[TILE / 8][4], dst[TILE / 8][4];
      abt<T, D>(pt, Ks, Qs, warp * 16, lane);
      abt<T, D>(dst, Vs, dOs, warp * 16, lane);
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = e >> 1, c = j * 8 + 2 * t + (e & 1);  // query within the tile
          const int qp = q0 + c;
          float pe = 0.f;
          if (qp < p.s && key[u] < p.s) {
            // the bias tile is [query][key]: read transposed
            const float x = logit(pt[j][e], p.scale, biased ? Bs[c * STAGE_LD + lk[u]] : 0.f);
            if (x > NEG_INF) pe = __expf(x - lse_s[c]);
          }
          pt[j][e] = pe;
          dst[j][e] = pe * (dst[j][e] - delta_s[c]);
        }
      }
      accum<T, D, DC>(dva, pt, dOs, c0, stage, lane);
      accum<T, D, DC>(dka, dst, Qs, c0, stage, lane);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (key[u] >= p.s) continue;
      T* krow = dk + off + (int64_t)key[u] * stride;
      T* vrow = dv + off + (int64_t)key[u] * stride;
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
        const int c = c0 + j * 8 + 2 * t;
        const float ka = dka[j][2 * u] * p.scale, kb = dka[j][2 * u + 1] * p.scale;
        const float va = dva[j][2 * u], vb = dva[j][2 * u + 1];
        if constexpr (is_bf16<T>()) {
          *reinterpret_cast<__nv_bfloat162*>(krow + c) = __floats2bfloat162_rn(ka, kb);
          *reinterpret_cast<__nv_bfloat162*>(vrow + c) = __floats2bfloat162_rn(va, vb);
        } else {
          *reinterpret_cast<float2*>(krow + c) = make_float2(ka, kb);
          *reinterpret_cast<float2*>(vrow + c) = make_float2(va, vb);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *a, *b;  // dq and dS, or dk and dv
};

template <typename T, int D>
int launch_dq(const Args& x, const Problem& p, cudaStream_t stream) {
  const size_t bytes = bwd_bytes<T, D>();
  static size_t have = 48 * 1024;
  if (int e = set_max_smem(evo_dq_kernel<T, D>, bytes, have)) return e;
  const dim3 grid((unsigned)((int64_t)p.B * p.h * n_tiles(p.s)));
  evo_dq_kernel<T, D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(x.q), static_cast<const T*>(x.k), static_cast<const T*>(x.v),
      static_cast<const T*>(x.o), static_cast<const T*>(x.dout),
      static_cast<const float*>(x.lse), static_cast<T*>(x.a), static_cast<float*>(x.b), p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& x, const Problem& p, cudaStream_t stream) {
  // fp32 at d 128: two 64-column passes keep the accumulators in registers
  constexpr int DC = (!is_bf16<T>() && D > 64) ? 64 : D;
  const size_t bytes = bwd_bytes<T, D>();
  static size_t have = 48 * 1024;
  if (int e = set_max_smem(evo_dkv_kernel<T, D, DC>, bytes, have)) return e;
  const dim3 grid((unsigned)((int64_t)p.B * p.h * n_tiles(p.s)));
  evo_dkv_kernel<T, D, DC><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(x.q), static_cast<const T*>(x.k), static_cast<const T*>(x.v),
      static_cast<const T*>(x.o), static_cast<const T*>(x.dout),
      static_cast<const float*>(x.lse), static_cast<T*>(x.a), static_cast<T*>(x.b), p);
  return (int)cudaGetLastError();
}

template <bool DQ, typename T>
int dispatch(int d, const Args& x, const Problem& p, cudaStream_t st) {
  switch (d) {
    case 16: return DQ ? launch_dq<T, 16>(x, p, st) : launch_dkv<T, 16>(x, p, st);
    case 32: return DQ ? launch_dq<T, 32>(x, p, st) : launch_dkv<T, 32>(x, p, st);
    case 64: return DQ ? launch_dq<T, 64>(x, p, st) : launch_dkv<T, 64>(x, p, st);
    case 128: return DQ ? launch_dq<T, 128>(x, p, st) : launch_dkv<T, 128>(x, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool DQ>
int entry(const Args& x, const void* b1, const void* b2, long long b1_sb, long long b1_sh,
          long long b1_sq, long long b2_sb, long long b2_sh, long long b2_sq, int B, int h,
          int s, int d, float scale, int fp32, int vec, void* stream) {
  if (B <= 0 || h <= 0 || s <= 0) return (int)cudaErrorInvalidValue;
  Problem p{B, h, s, scale, {static_cast<const float*>(b1), b1_sb, b1_sh, b1_sq},
            {static_cast<const float*>(b2), b2_sb, b2_sh, b2_sq}, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fp32 ? dispatch<DQ, float>(d, x, p, st) : dispatch<DQ, bf16>(d, x, p, st);
}

}  // namespace

// q, k, v, o, do, dq: [B, s, h, d] bf16 (fp32 = 0) or fp32 (fp32 = 1),
// contiguous, 16-byte aligned; lse: [B, h, s] fp32 from dstt_evoformer_fwd;
// b1, b2: the forward's bias operands (fp32 or null, element (bi, hi, qp,
// kp) at bi * sb + hi * sh + qp * sq + kp); ds: the fp32 [B, h, s, s] bias
// gradient, or null to skip it. d in {16, 32, 64, 128}. vec: as in
// dstt_evoformer_fwd. Returns cudaGetLastError().
extern "C" int dstt_evoformer_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, const void* b1,
                                     const void* b2, void* dq, void* ds, long long b1_sb,
                                     long long b1_sh, long long b1_sq, long long b2_sb,
                                     long long b2_sh, long long b2_sq, int B, int h, int s, int d,
                                     float scale, int fp32, int vec, void* stream) {
  return entry<true>({q, k, v, o, dout, lse, dq, ds}, b1, b2, b1_sb, b1_sh, b1_sq, b2_sb, b2_sh,
                     b2_sq, B, h, s, d, scale, fp32, vec, stream);
}

// dk, dv: [B, s, h, d] in q's dtype; the rest as dstt_evoformer_bwd_dq.
extern "C" int dstt_evoformer_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse,
                                      const void* b1, const void* b2, void* dk, void* dv,
                                      long long b1_sb, long long b1_sh, long long b1_sq,
                                      long long b2_sb, long long b2_sh, long long b2_sq, int B,
                                      int h, int s, int d, float scale, int fp32, int vec,
                                      void* stream) {
  return entry<false>({q, k, v, o, dout, lse, dk, dv}, b1, b2, b1_sb, b1_sh, b1_sq, b2_sb,
                      b2_sh, b2_sq, B, h, s, d, scale, fp32, vec, stream);
}
