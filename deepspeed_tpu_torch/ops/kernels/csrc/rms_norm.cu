// RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/normalization/fused_norm.py::_rms_fwd_kernel
// (pallas_call in _rms_fwd): y = x * rsqrt(mean(x^2) + eps) * w with fp32
// statistics, output rounded once to x's dtype; and ::_rms_bwd_kernel
// (pallas_call in _rms_bwd): dx = inv * (g*w - xhat * mean(g*w * xhat)),
// xhat = x * inv, statistics recomputed in fp32. The weight gradient stays
// a plain torch row reduction outside the kernel, as in the JAX package.
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

// Sum of one float per thread over the block (blockDim.x a multiple of 32,
// at most 1024); ``red`` is 32 floats of shared scratch. Every thread gets
// the sum; the scratch may be reused after the call returns.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = dstt::warp_sum(v);
  if (lane == 0) red[wid] = v;
  __syncthreads();
  if (wid == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    t = dstt::warp_sum(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  const float total = red[0];
  __syncthreads();
  return total;
}

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
  const float inv = rsqrtf(block_sum(ss, red) / (float)h + eps);
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

// Backward, one block per row, three passes over the row (the later two
// hit L1/L2): sum of squares -> inv; dot = mean((g*w) * (x*inv)); then
// dx = inv * (g*w - (x*inv) * dot), all fp32, rounded once to x's dtype.
// Bound: memory (x, g read and dx written once from device memory).
template <typename T, typename W, bool VEC>
__global__ void __launch_bounds__(256) rms_norm_bwd_kernel(
    const T* __restrict__ x, const W* __restrict__ w, const T* __restrict__ g,
    T* __restrict__ dx, int h, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * h;
  const T* gr = g + row * h;
  T* dr = dx + row * h;
  __shared__ float red[32];
  float ss = 0.f;
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < h / 8; i += blockDim.x) {
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
  const float inv = rsqrtf(block_sum(ss, red) / (float)h + eps);
  float dot = 0.f;
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < h / 8; i += blockDim.x) {
      float f[8], gg[8], ww[8];
      dstt::load_vec<8>(xr + 8 * i, f);
      dstt::load_vec<8>(gr + 8 * i, gg);
      dstt::load_vec<8>(w + 8 * i, ww);
#pragma unroll
      for (int j = 0; j < 8; ++j) dot += (gg[j] * ww[j]) * (f[j] * inv);
    }
  } else {
    for (int i = threadIdx.x; i < h; i += blockDim.x) {
      dot += (to_f(gr[i]) * to_f(w[i])) * (to_f(xr[i]) * inv);
    }
  }
  dot = block_sum(dot, red) / (float)h;
  if constexpr (VEC) {
    for (int i = threadIdx.x; i < h / 8; i += blockDim.x) {
      float f[8], gg[8], ww[8];
      dstt::load_vec<8>(xr + 8 * i, f);
      dstt::load_vec<8>(gr + 8 * i, gg);
      dstt::load_vec<8>(w + 8 * i, ww);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = inv * (gg[j] * ww[j] - (f[j] * inv) * dot);
      dstt::store8(dr + 8 * i, f);
    }
  } else {
    for (int i = threadIdx.x; i < h; i += blockDim.x) {
      const float xh = to_f(xr[i]) * inv;
      dr[i] = dstt::from_f<T>(inv * (to_f(gr[i]) * to_f(w[i]) - xh * dot));
    }
  }
}

int block_threads(int h, int vec) {
  const int units = vec ? h / 8 : h;
  int threads = ((units + 31) / 32) * 32;
  return threads < 32 ? 32 : (threads > 256 ? 256 : threads);
}

template <typename T, typename W>
void launch_bwd(const void* x, const void* w, const void* g, void* dx, long long rows, int h,
                float eps, int vec, cudaStream_t stream) {
  const int threads = block_threads(h, vec);
  const dim3 grid((unsigned)rows);
  if (vec) {
    rms_norm_bwd_kernel<T, W, true><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), static_cast<const T*>(g),
        static_cast<T*>(dx), h, eps);
  } else {
    rms_norm_bwd_kernel<T, W, false><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w), static_cast<const T*>(g),
        static_cast<T*>(dx), h, eps);
  }
}

template <typename T, typename W>
void launch(const void* x, const void* w, void* out, long long rows, int h,
            float eps, int vec, cudaStream_t stream) {
  const int threads = block_threads(h, vec);
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

// x, g, dx: [rows, h] contiguous, bf16 (x_bf16=1) or fp32 (g and dx in x's
// dtype); w: [h], bf16 (w_bf16=1) or fp32. vec=1 as for the forward.
// Returns cudaGetLastError() after launch.
extern "C" int dstt_rms_norm_bwd(const void* x, const void* w, const void* g, void* dx,
                                 long long rows, int h, float eps, int x_bf16, int w_bf16,
                                 int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16) {
    launch_bwd<__nv_bfloat16, __nv_bfloat16>(x, w, g, dx, rows, h, eps, vec, s);
  } else if (x_bf16) {
    launch_bwd<__nv_bfloat16, float>(x, w, g, dx, rows, h, eps, vec, s);
  } else if (w_bf16) {
    launch_bwd<float, __nv_bfloat16>(x, w, g, dx, rows, h, eps, vec, s);
  } else {
    launch_bwd<float, float>(x, w, g, dx, rows, h, eps, vec, s);
  }
  return (int)cudaGetLastError();
}
