// Fused Adam / AdamW step for Hopper (sm_90a): one pass over a flat leaf.
//
// Replaces: deepspeed_tpu/ops/adam/fused_adam.py::_fused_kernel (the
// pallas_call in fused_adam_step), with _adam_math's order of operations:
//
//   g' = g + wd * p                         (L2 mode only)
//   m  = b1 * m + (1 - b1) * g'
//   v  = b2 * v + (1 - b2) * g' * g'
//   u  = (m / c1) / (sqrt(v / c2) + eps)    (c1 = c2 = 1 without bias correction)
//   u  = u + wd * p                         (AdamW mode only)
//   p  = p - lr * u
//
// p is the fp32 master; lr, c1 = 1 - b1^t and c2 = 1 - b2^t arrive as
// scalars computed on the host in fp32. Optionally the new p is also
// written, rounded once, to the model's bf16 or fp16 parameter, so the
// optimizer needs no second pass to refresh it.
//
// Bound: bytes. No reuse: 16 B read and 12 B written per element (p, g, m,
// v in; p, m, v out) plus 2 B for the half-precision copy, a few dozen
// FLOPs. Design: each thread handles 4 consecutive elements with 128-bit
// loads and stores, the grid covers the leaf, and the tail (n % 4
// elements) is handled in place by scalar threads of the last block: no
// padded copy of the leaf is made. Every operation is rounded on its own
// (no fused multiply-add), so the result does not depend on how the
// compiler contracts the expression.
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

struct Hyper {
  float lr, b1, b2, omb1, omb2, eps, wd, c1, c2;
  int adamw, bias_correction;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v, const Hyper& hp) {
  if (!hp.adamw && hp.wd != 0.f) g = __fadd_rn(g, __fmul_rn(hp.wd, p));
  m = __fadd_rn(__fmul_rn(hp.b1, m), __fmul_rn(hp.omb1, g));
  v = __fadd_rn(__fmul_rn(hp.b2, v), __fmul_rn(hp.omb2, __fmul_rn(g, g)));
  float u;
  if (hp.bias_correction) {
    u = __fdiv_rn(__fdiv_rn(m, hp.c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, hp.c2)), hp.eps));
  } else {
    u = __fdiv_rn(m, __fadd_rn(__fsqrt_rn(v), hp.eps));
  }
  if (hp.adamw && hp.wd != 0.f) u = __fadd_rn(u, __fmul_rn(hp.wd, p));
  p = __fsub_rn(p, __fmul_rn(hp.lr, u));
}

template <typename T>
__device__ __forceinline__ T half_from(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 half_from<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half half_from<__half>(float v) {
  return __float2half_rn(v);
}

// T: the type of the half-precision copy (unused when lowp is null).
template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_adam_kernel(float* __restrict__ p, const float* __restrict__ g, float* __restrict__ m,
                  float* __restrict__ v, T* __restrict__ lowp, int64_t n, Hyper hp) {
  const int64_t quads = n / 4;
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i < quads) {
    float4 p4 = reinterpret_cast<float4*>(p)[i];
    const float4 g4 = reinterpret_cast<const float4*>(g)[i];
    float4 m4 = reinterpret_cast<float4*>(m)[i];
    float4 v4 = reinterpret_cast<float4*>(v)[i];
    adam_one(p4.x, g4.x, m4.x, v4.x, hp);
    adam_one(p4.y, g4.y, m4.y, v4.y, hp);
    adam_one(p4.z, g4.z, m4.z, v4.z, hp);
    adam_one(p4.w, g4.w, m4.w, v4.w, hp);
    reinterpret_cast<float4*>(p)[i] = p4;
    reinterpret_cast<float4*>(m)[i] = m4;
    reinterpret_cast<float4*>(v)[i] = v4;
    if (lowp != nullptr) {
      __align__(8) T h4[4] = {half_from<T>(p4.x), half_from<T>(p4.y), half_from<T>(p4.z),
                              half_from<T>(p4.w)};
      reinterpret_cast<uint2*>(lowp)[i] = *reinterpret_cast<const uint2*>(h4);
    }
  } else if (i - quads < n - quads * 4) {  // the tail: at most 3 scalar threads
    const int64_t j = quads * 4 + (i - quads);
    float pj = p[j], mj = m[j], vj = v[j];
    adam_one(pj, g[j], mj, vj, hp);
    p[j] = pj;
    m[j] = mj;
    v[j] = vj;
    if (lowp != nullptr) lowp[j] = half_from<T>(pj);
  }
}

}  // namespace

// p, g, m, v: fp32 [n], 16-byte aligned, updated in place (g is read).
// lowp: null, or the bf16 (lowp_kind 1) / fp16 (lowp_kind 2) parameter [n],
// 8-byte aligned. omb1 = 1 - b1 and omb2 = 1 - b2 as the host rounds them.
extern "C" int dstt_fused_adam(void* p, const void* g, void* m, void* v, void* lowp,
                               long long n, float lr, float b1, float b2, float omb1, float omb2,
                               float eps, float wd, float c1, float c2, int adamw,
                               int bias_correction, int lowp_kind, void* stream) {
  if (n <= 0) return 0;
  Hyper hp{lr, b1, b2, omb1, omb2, eps, wd, c1, c2, adamw, bias_correction};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long work = n / 4 + n % 4;  // one thread per quad, one per tail element
  const unsigned blocks = (unsigned)((work + THREADS - 1) / THREADS);
  float* pp = static_cast<float*>(p);
  const float* gg = static_cast<const float*>(g);
  float* mm = static_cast<float*>(m);
  float* vv = static_cast<float*>(v);
  if (lowp_kind == 2) {
    fused_adam_kernel<__half><<<blocks, THREADS, 0, st>>>(pp, gg, mm, vv,
                                                          static_cast<__half*>(lowp), n, hp);
  } else if (lowp_kind == 0 || lowp_kind == 1) {
    fused_adam_kernel<__nv_bfloat16><<<blocks, THREADS, 0, st>>>(
        pp, gg, mm, vv, lowp_kind ? static_cast<__nv_bfloat16*>(lowp) : nullptr, n, hp);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
