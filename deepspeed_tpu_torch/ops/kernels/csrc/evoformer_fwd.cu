// Evoformer attention forward for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/deepspeed4science/evoformer_attn.py::
// _fwd_kernel (the pallas_call in _evo_call): softmax(q k^T * scale + b1 +
// b2) v with an online softmax over key tiles, no causal mask, no GQA, every
// sum in fp32. Writes out in q's dtype and the fp32 log-sum-exp [B, h, s]; a
// row with no live logit writes 0 and -1e30.
//
// Bound: in bf16, bytes at the Evoformer's widths (d 32, s 384: 4d FLOPs
// per pair is ~190 FLOP per byte of q, k, v and out, under the card's ~295
// ridge); in fp32, operations (FFMA at 67 TFLOP/s).
//
// Design: one CTA of 4 warps per (64-query tile, head, flattened batch row),
// each warp owning 16 query rows, walking the 64-key tiles (any s: rows and
// keys past s load as zeros and are dropped from the softmax). S = Q K^T in
// C fragments (bf16: mma.m16n8k16; fp32: FFMA, evoformer_common.cuh), then
// per pair the scale, the summed bias (the tile of both operands, read
// through their strides with coalesced loads beside the K and V tiles and
// staged in shared memory: a broadcast dim has stride 0, so the [*, 1, 1, s]
// mask and the [1, h, s, s] pair bias are never materialized over the
// batch), the running max and sum, O *= the correction, O += P V. The Pallas
// body keeps P in fp32; the bf16 path rounds it to bf16 for the tensor
// cores, as the flash kernels do. Loads are synchronous; several CTAs per SM
// hide them (4 in bf16 at d <= 32, under min_ctas's register cap).
#include "evoformer_common.cuh"

namespace {

using namespace dstt::evo;
namespace fl = dstt::flash;

template <typename T, int D>
constexpr size_t fwd_bytes() {
  return sizeof(T) * 3 * TILE * ld<T, D>() + BIAS_TILE_BYTES + stage_bytes<T>();
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, (min_ctas<T, D>())) evo_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, Problem p) {
  constexpr int LD = ld<T, D>();
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + TILE * LD;
  T* Vs = Ks + TILE * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* Bs = reinterpret_cast<float*>(Vs + TILE * LD);
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

  const int lr[2] = {warp * 16 + g, warp * 16 + g + 8};
  const int row[2] = {q0 + lr[0], q0 + lr[1]};
  const float* p1 = bias_plane(p.b1, bi, hi);
  const float* p2 = bias_plane(p.b2, bi, hi);
  const bool biased = p1 || p2;

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < p.s; k0 += TILE) {
    __syncthreads();  // the previous tile's readers of Ks and Vs are done
    load_tile<T, D>(Ks, k + off, k0, p.s, stride);
    load_tile<T, D>(Vs, v + off, k0, p.s, stride);
    if (biased) load_bias_tile(Bs, p1, p.b1.sq, p2, p.b2.sq, q0, k0, p.s, p.vec);
    __syncthreads();

    float sc[TILE / 8][4];
    abt<T, D>(sc, Qs, Ks, warp * 16, lane);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = e >> 1, c = j * 8 + 2 * t + (e & 1);
        float x = NEG_INF;
        if (row[u] < p.s && k0 + c < p.s)
          x = logit(sc[j][e], p.scale, biased ? Bs[lr[u] * STAGE_LD + c] : 0.f);
        sc[j][e] = x;
        mx[u] = fmaxf(mx[u], x);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float mn = fmaxf(m[u], fl::quad_max(mx[u]));
      corr[u] = m[u] == mn ? 1.f : __expf(m[u] - mn);
      m[u] = mn;
    }
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = e >> 1;
        const float pe = sc[j][e] > NEG_INF ? __expf(sc[j][e] - m[u]) : 0.f;
        sc[j][e] = pe;
        rs[u] += pe;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) l[u] = l[u] * corr[u] + fl::quad_sum(rs[u]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
    accum<T, D, D>(o, sc, Vs, 0, stage, lane);
  }

  // out = O / max(l, 1e-30) rounded once; lse = m + log(max(l, 1e-30))
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (row[u] >= p.s) continue;
    const float ls = fmaxf(l[u], 1e-30f);
    T* orow = out + off + (int64_t)row[u] * stride;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + 2 * t;
      const float a = o[j][2 * u] / ls, b = o[j][2 * u + 1] / ls;
      if constexpr (is_bf16<T>()) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(a, b);
      } else {
        *reinterpret_cast<float2*>(orow + c) = make_float2(a, b);
      }
    }
    if (t == 0) lse[(int64_t)bh * p.s + row[u]] = m[u] + logf(ls);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, const Problem& p,
           cudaStream_t stream) {
  const size_t bytes = fwd_bytes<T, D>();
  static size_t have = 48 * 1024;
  if (int e = set_max_smem(evo_fwd_kernel<T, D>, bytes, have)) return e;
  const dim3 grid((unsigned)((int64_t)p.B * p.h * n_tiles(p.s)));
  evo_fwd_kernel<T, D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* out, void* lse,
             const Problem& p, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, lse, p, st);
    case 32: return launch<T, 32>(q, k, v, out, lse, p, st);
    case 64: return launch<T, 64>(q, k, v, out, lse, p, st);
    case 128: return launch<T, 128>(q, k, v, out, lse, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: [B, s, h, d] bf16 (fp32 = 0) or fp32 (fp32 = 1), contiguous,
// 16-byte aligned; lse: [B, h, s] fp32; b1, b2: fp32 bias operands or null,
// element (bi, hi, qp, kp) at bi * sb + hi * sh + qp * sq + kp. d in {16, 32,
// 64, 128}. vec: both operands' pointers 16-byte aligned and every stride a
// multiple of 4 (float4 loads of the bias tile). Returns cudaGetLastError().
extern "C" int dstt_evoformer_fwd(const void* q, const void* k, const void* v, const void* b1,
                                  const void* b2, void* out, void* lse, long long b1_sb,
                                  long long b1_sh, long long b1_sq, long long b2_sb,
                                  long long b2_sh, long long b2_sq, int B, int h, int s, int d,
                                  float scale, int fp32, int vec, void* stream) {
  if (B <= 0 || h <= 0 || s <= 0) return (int)cudaErrorInvalidValue;
  Problem p{B, h, s, scale, {static_cast<const float*>(b1), b1_sb, b1_sh, b1_sq},
            {static_cast<const float*>(b2), b2_sb, b2_sh, b2_sq}, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fp32 ? dispatch<float>(d, q, k, v, out, lse, p, st)
              : dispatch<bf16>(d, q, k, v, out, lse, p, st);
}
