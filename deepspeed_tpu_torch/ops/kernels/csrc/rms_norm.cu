// RMSNorm forward for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/normalization/fused_norm.py::_rms_fwd_kernel
// (pallas_call in _rms_fwd): y = x * rsqrt(mean(x^2) + eps) * w with fp32
// statistics, output rounded once to x's dtype.
//
// Bound: memory. Each row is read twice (once for the sum of squares, once
// for the output; the second read hits L1/L2 for rows up to tens of KB) and
// written once; the arithmetic is a handful of FLOPs per byte, far below
// the card's ~295 FLOP/byte ridge. The least time is bytes(x + w + y) over
// HBM bandwidth.
//
// Design: one block per row, so any row count works (the TPU's rows-per-
// block choice and its VMEM cap have no meaning here). Loads and stores are
// 16-byte vectors of 8 elements when h % 8 == 0 and every pointer is
// 16-byte aligned; otherwise the whole row goes scalar. The sum of squares
// is fp32: per-thread partials, warp shuffles, then one shared-memory pass
// across warps. The output is (x * inv) * w in fp32, the order of
// fused_norm.py, rounded once. The weight may be bf16 or fp32 (gemma's
// rmsnorm_1p passes 1 + w in fp32).
#include "common.cuh"

namespace {

using dstt::to_f;

template <typename T, typename W, bool VEC>
__global__ void __launch_bounds__(256) rms_norm_fwd_kernel(
    const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
    int h, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * h;
  T* orow = out + row * h;
  float ss = 0.f;
  if constexpr (VEC) {
    const int nv = h / 8;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      float f[8];
      dstt::load_vec<8>(xr + 8 * i, f);
#pragma unroll
      for (int j = 0; j < 8; ++j) ss += f[j] * f[j];
    }
  } else {
    for (int i = threadIdx.x; i < h; i += blockDim.x) {
      const float f = to_f(xr[i]);
      ss += f * f;
    }
  }
  __shared__ float red[32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  ss = dstt::warp_sum(ss);
  if (lane == 0) red[wid] = ss;
  __syncthreads();
  if (wid == 0) {
    float v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    v = dstt::warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(red[0] / (float)h + eps);
  if constexpr (VEC) {
    const int nv = h / 8;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      float f[8], g[8];
      dstt::load_vec<8>(xr + 8 * i, f);
      dstt::load_vec<8>(w + 8 * i, g);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = (f[j] * inv) * g[j];
      dstt::store8(orow + 8 * i, f);
    }
  } else {
    for (int i = threadIdx.x; i < h; i += blockDim.x) {
      orow[i] = dstt::from_f<T>((to_f(xr[i]) * inv) * to_f(w[i]));
    }
  }
}

template <typename T, typename W>
void launch(const void* x, const void* w, void* out, long long rows, int h,
            float eps, int vec, cudaStream_t stream) {
  const int units = vec ? h / 8 : h;
  int threads = ((units + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const dim3 grid((unsigned)rows);
  if (vec) {
    rms_norm_fwd_kernel<T, W, true><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out), h, eps);
  } else {
    rms_norm_fwd_kernel<T, W, false><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out), h, eps);
  }
}

}  // namespace

// x, out: [rows, h] contiguous, bf16 (x_bf16=1) or fp32; w: [h], bf16
// (w_bf16=1) or fp32. vec=1 requires h % 8 == 0 and 16-byte aligned
// pointers (the wrapper checks). Returns cudaGetLastError() after launch.
extern "C" int dstt_rms_norm_fwd(const void* x, const void* w, void* out,
                                 long long rows, int h, float eps, int x_bf16,
                                 int w_bf16, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, h, eps, vec, s);
  } else if (x_bf16) {
    launch<__nv_bfloat16, float>(x, w, out, rows, h, eps, vec, s);
  } else if (w_bf16) {
    launch<float, __nv_bfloat16>(x, w, out, rows, h, eps, vec, s);
  } else {
    launch<float, float>(x, w, out, rows, h, eps, vec, s);
  }
  return (int)cudaGetLastError();
}
