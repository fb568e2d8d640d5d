// Shared device helpers for the port's hand-written Hopper kernels:
// bf16/fp32/int8 -> fp32 and fp32 -> bf16/fp32 conversion, vector loads of
// N consecutive elements into fp32 registers, and warp reductions. Header-only; each kernel
// source includes it and builds into its own shared library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dstt {

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t v) { return (float)v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Load N consecutive elements starting at p (aligned to N * sizeof(T)
// bytes) into f[0..N). One 4-, 8- or 16-byte load for bf16; one or two
// 8/16-byte loads for fp32.
template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  static_assert(N == 2 || N == 4 || N == 8, "bf16 vector of 2, 4 or 8");
  if constexpr (N == 2) {
    float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    f[0] = t.x;
    f[1] = t.y;
  } else if constexpr (N == 4) {
    uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  } else {
    uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  static_assert(N == 2 || N == 4 || N == 8, "fp32 vector of 2, 4 or 8");
  if constexpr (N == 2) {
    float2 t = *reinterpret_cast<const float2*>(p);
    f[0] = t.x;
    f[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      float4 t = reinterpret_cast<const float4*>(p)[i];
      f[4 * i] = t.x;
      f[4 * i + 1] = t.y;
      f[4 * i + 2] = t.z;
      f[4 * i + 3] = t.w;
    }
  }
}

// 8 int8 codes (8-byte aligned) as fp32, exactly.
template <int N>
__device__ __forceinline__ void load_vec(const int8_t* p, float* f) {
  static_assert(N == 8, "int8 vector of 8");
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = (float)b[i];
}

// Store 8 fp32 values as 8 consecutive elements (16-byte aligned for bf16,
// 32-byte run of two float4 for fp32), each rounded once.
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace dstt

// Message for a code returned by an entry point (each kernel library
// includes this header once, so each exports its own copy).
extern "C" const char* dstt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
