// Blockwise symmetric absmax int8 quantization for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/quantizer/block_quant.py::_quant_kernel
// (pallas_call in quantize_blockwise_pallas). Rows [n, block] of bf16 or
// fp32 -> int8 codes [n, block] and one fp32 scale per row:
//   scale = absmax * fl(1 / qmax)
//   inv   = scale > 0 ? 1 / max(scale, 1e-30) : 0
//   q     = clip(rint(x * inv [+ u - 0.5]), -qmax, qmax)
// qmax is 127 (int8) or 7 (before the int4 pack, a torch post-pass). The
// engine's quantize-on-write (quantize_kv) is this kernel at block = d.
//
// Bit for bit with the plain version (block_quant_reference) and with the
// JAX package's quantize_kv / _quant_kernel in the deterministic mode, as
// XLA compiles them: XLA turns absmax / qmax into a product with the fp32
// reciprocal of the constant, so the kernel does the same. The divisions
// are __fdiv_rn, the products and the noise add __fmul_rn / __fadd_rn
// (never contracted into an FMA), rintf rounds half to even like
// torch.round and jnp.round. Stochastic mode: u is the top 24 bits of the
// counter-based hash fold(fold(mix32(seed), i >> 32), i) of the element's
// index i over 2^24 (utils/counter_hash.py computes the same words), not
// the TPU PRNG's bits.
//
// Bound: memory. Per element the kernel reads 2 or 4 bytes, writes 1, and
// does a handful of operations; the least time is those bytes (plus 4 per
// row) over HBM bandwidth.
//
// Design (simple first): one warp per row, 8 rows per 256-thread block.
// Each lane takes 8 consecutive elements at a time with one 16-byte load
// (bf16) or two (fp32), so a warp reads 512 or 1024 contiguous bytes per
// pass; the absmax is a warp reduction; a second pass over the row (from
// L1/L2) writes the codes 8 at a time with one 8-byte store. block must be
// a multiple of 8.
#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int ROWS = NT / 32;  // rows per block, one per warp

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t fold(uint32_t key, uint32_t word) {
  return mix32(key ^ (word * 0x9E3779B1u));
}

template <typename T>
__global__ void __launch_bounds__(NT) block_quant_kernel(const T* __restrict__ x,
                                                         int8_t* __restrict__ q,
                                                         float* __restrict__ scales,
                                                         int64_t rows, int block, float qmax,
                                                         int stochastic, uint32_t seed) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * block;
  const int nv = block / 8;

  float amax = 0.f;
  for (int c = lane; c < nv; c += 32) {
    float f[8];
    dstt::load_vec<8>(xr + c * 8, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(f[j]));
  }
  amax = dstt::warp_max(amax);
  const float scale = __fmul_rn(amax, __fdiv_rn(1.f, qmax));
  const float inv = scale > 0.f ? __fdiv_rn(1.f, fmaxf(scale, 1e-30f)) : 0.f;
  const uint32_t key = mix32(seed);

  int8_t* qr = q + row * block;
  for (int c = lane; c < nv; c += 32) {
    float f[8];
    dstt::load_vec<8>(xr + c * 8, f);
    uint2 packed;
    int8_t* out = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s = __fmul_rn(f[j], inv);
      if (stochastic) {
        const uint64_t i = (uint64_t)row * (uint64_t)block + (uint64_t)(c * 8 + j);
        const uint32_t bits = fold(fold(key, (uint32_t)(i >> 32)), (uint32_t)i);
        const float u = (float)(bits >> 8) * (1.f / 16777216.f);
        s = __fadd_rn(s, u - 0.5f);
      }
      s = fminf(fmaxf(rintf(s), -qmax), qmax);
      out[j] = (int8_t)s;
    }
    *reinterpret_cast<uint2*>(qr + c * 8) = packed;
  }
  if (lane == 0) scales[row] = scale;
}

}  // namespace

// x: [rows, block] bf16 (x_bf16 = 1) or fp32, contiguous, 16-byte aligned;
// q: [rows, block] int8; scales: [rows] fp32. block a positive multiple of
// 8. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a block the kernel does not take).
extern "C" int dstt_block_quant(const void* x, void* q, void* scales, long long rows, int block,
                                float qmax, int stochastic, unsigned int seed, int x_bf16,
                                void* stream) {
  if (block <= 0 || block % 8 != 0 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((rows + ROWS - 1) / ROWS);
  if (x_bf16) {
    block_quant_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scales), (int64_t)rows, block, qmax, stochastic, seed);
  } else {
    block_quant_kernel<float><<<grid, NT, 0, s>>>(static_cast<const float*>(x),
                                                  static_cast<int8_t*>(q),
                                                  static_cast<float*>(scales), (int64_t)rows,
                                                  block, qmax, stochastic, seed);
  }
  return (int)cudaGetLastError();
}
