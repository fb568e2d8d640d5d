// Blockwise symmetric absmax int8 quantization for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/quantizer/block_quant.py::_quant_kernel
// (pallas_call in quantize_blockwise_pallas). Rows [n, block] of bf16 or
// fp32 -> int8 codes [n, block] and one fp32 scale per row:
//   scale = absmax * fl(1 / qmax)
//   inv   = scale > 0 ? 1 / max(scale, 1e-30) : 0
//   q     = clip(rint(x * inv [+ u - 0.5]), -qmax, qmax)
// qmax is 127 (int8) or 7 (before the int4 pack, a torch post-pass). The
// engine's quantize-on-write (quantize_kv_pair) is this kernel at block =
// d over the K and the V of one write: an optional second plane of the
// same shape, quantized in the same launch as if by a call of its own.
//
// Bit for bit with the plain version (block_quant_reference) and with the
// JAX package's quantize_kv / _quant_kernel in the deterministic mode, as
// XLA compiles them: XLA turns absmax / qmax into a product with the fp32
// reciprocal of the constant, so the kernel does the same. The divisions
// are __fdiv_rn, the products and the noise add __fmul_rn / __fadd_rn
// (never contracted into an FMA), rintf rounds half to even like
// torch.round and jnp.round. Stochastic mode: u is the top 24 bits of the
// counter-based hash fold(fold(mix32(seed), i >> 32), i) of the element's
// index i in its plane over 2^24 (utils/counter_hash.py computes the same
// words), not the TPU PRNG's bits.
//
// Bound: memory. Per element the kernel reads 2 or 4 bytes, writes 1, and
// does a handful of operations; the least time is those bytes (plus 4 per
// row) over HBM bandwidth.
//
// Design. Head vectors (block 64, 128, 256: the engine's writes, a few
// MB a step): a row on block / 8 lanes (8, 16 or 32), each lane holding 8
// consecutive elements in registers from one 16-byte load (bf16) or two
// (fp32), so a warp takes 4, 2 or 1 rows; the absmax is a shuffle
// reduction over the row's lanes and the codes come from the registers
// (one read of x), 8 at a time with one 8-byte store. 256 threads a CTA;
// the grid covers the first plane's CTAs, then the second's: the pair of a
// split step's write ([8448, 128] bf16 twice) is one wave of 1056 CTAs,
// every load in flight at once. Other blocks (multiples of 8: the
// blockwise quantizer's 2048): one warp per row, 8 rows a CTA, the absmax
// over 8-element vectors, then a second pass over the row (from L1/L2)
// for the codes.
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
struct Plane {
  const T* x;
  int8_t* q;
  float* scales;
};

// The CTA's plane and its index among that plane's CTAs (the grid holds
// `ctas` CTAs a plane, the first plane's first).
template <typename T>
__device__ __forceinline__ Plane<T> cta_plane(const Plane<T>& a, const Plane<T>& b, int ctas,
                                              int& cta) {
  cta = (int)blockIdx.x;
  if (cta < ctas) return a;
  cta -= ctas;
  return b;
}

// 8 codes of x (elements e0 .. e0 + 7 of the plane) and their 8-byte word
__device__ __forceinline__ uint2 codes8(const float (&f)[8], float inv, float qmax,
                                        int stochastic, uint32_t key, uint64_t e0) {
  uint2 packed;
  int8_t* out = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float s = __fmul_rn(f[j], inv);
    if (stochastic) {
      const uint64_t i = e0 + (uint64_t)j;
      const uint32_t bits = fold(fold(key, (uint32_t)(i >> 32)), (uint32_t)i);
      const float u = (float)(bits >> 8) * (1.f / 16777216.f);
      s = __fadd_rn(s, u - 0.5f);
    }
    s = fminf(fmaxf(rintf(s), -qmax), qmax);
    out[j] = (int8_t)s;
  }
  return packed;
}

__device__ __forceinline__ void scale_of(float amax, float qmax, float& scale, float& inv) {
  scale = __fmul_rn(amax, __fdiv_rn(1.f, qmax));
  inv = scale > 0.f ? __fdiv_rn(1.f, fmaxf(scale, 1e-30f)) : 0.f;
}

// Head vectors: a row of 8 * LPR elements on LPR lanes, NT / LPR rows a CTA.
// Every lane takes part in the shuffles (a row past the plane loads zeros
// and stores nothing).
template <typename T, int LPR>
__global__ void __launch_bounds__(NT) block_quant_vec_kernel(Plane<T> a, Plane<T> b, int ctas,
                                                             int64_t rows, float qmax,
                                                             int stochastic, uint32_t seed) {
  constexpr int BLOCK = 8 * LPR;
  int cta;
  const Plane<T> pl = cta_plane(a, b, ctas, cta);
  const int c = threadIdx.x % LPR;
  const int64_t row = (int64_t)cta * (NT / LPR) + threadIdx.x / LPR;
  const bool in = row < rows;
  float f[8];
  if (in) {
    dstt::load_vec<8>(pl.x + row * BLOCK + c * 8, f);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = 0.f;
  }
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(f[j]));
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  float scale, inv;
  scale_of(amax, qmax, scale, inv);
  if (!in) return;
  *reinterpret_cast<uint2*>(pl.q + row * BLOCK + c * 8) =
      codes8(f, inv, qmax, stochastic, mix32(seed), (uint64_t)row * BLOCK + (uint64_t)(c * 8));
  if (c == 0) pl.scales[row] = scale;
}

// Any block (a multiple of 8): one warp per row, ROWS rows a CTA.
template <typename T>
__global__ void __launch_bounds__(NT) block_quant_kernel(Plane<T> a, Plane<T> b, int ctas,
                                                         int64_t rows, int block, float qmax,
                                                         int stochastic, uint32_t seed) {
  int cta;
  const Plane<T> pl = cta_plane(a, b, ctas, cta);
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)cta * ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = pl.x + row * block;
  const int nv = block / 8;

  float amax = 0.f;
  for (int c = lane; c < nv; c += 32) {
    float f[8];
    dstt::load_vec<8>(xr + c * 8, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(f[j]));
  }
  amax = dstt::warp_max(amax);
  float scale, inv;
  scale_of(amax, qmax, scale, inv);
  const uint32_t key = mix32(seed);

  int8_t* qr = pl.q + row * block;
  for (int c = lane; c < nv; c += 32) {
    float f[8];
    dstt::load_vec<8>(xr + c * 8, f);
    *reinterpret_cast<uint2*>(qr + c * 8) =
        codes8(f, inv, qmax, stochastic, key, (uint64_t)row * block + (uint64_t)(c * 8));
  }
  if (lane == 0) pl.scales[row] = scale;
}

template <typename T, int LPR>
void launch_vec(const Plane<T>& a, const Plane<T>& b, int planes, int64_t rows, float qmax,
                int stochastic, uint32_t seed, cudaStream_t s) {
  const int ctas = (int)((rows + NT / LPR - 1) / (NT / LPR));
  block_quant_vec_kernel<T, LPR><<<ctas * planes, NT, 0, s>>>(a, b, ctas, rows, qmax,
                                                              stochastic, seed);
}

template <typename T>
int launch(const void* x, void* q, void* scales, const void* x2, void* q2, void* scales2,
           int64_t rows, int block, float qmax, int stochastic, uint32_t seed,
           cudaStream_t s) {
  const Plane<T> a{static_cast<const T*>(x), static_cast<int8_t*>(q),
                   static_cast<float*>(scales)};
  const Plane<T> b{static_cast<const T*>(x2), static_cast<int8_t*>(q2),
                   static_cast<float*>(scales2)};
  const int planes = x2 != nullptr ? 2 : 1;
  switch (block) {
    case 64: launch_vec<T, 8>(a, b, planes, rows, qmax, stochastic, seed, s); break;
    case 128: launch_vec<T, 16>(a, b, planes, rows, qmax, stochastic, seed, s); break;
    case 256: launch_vec<T, 32>(a, b, planes, rows, qmax, stochastic, seed, s); break;
    default: {
      const int ctas = (int)((rows + ROWS - 1) / ROWS);
      block_quant_kernel<T><<<ctas * planes, NT, 0, s>>>(a, b, ctas, rows, block, qmax,
                                                          stochastic, seed);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: [rows, block] bf16 (x_bf16 = 1) or fp32, contiguous, 16-byte aligned;
// q: [rows, block] int8; scales: [rows] fp32. x2, q2, scales2: a second
// plane of the same shape and dtype, quantized in the same launch, or all
// null. block a positive multiple of 8. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for what the kernel does not take).
extern "C" int dstt_block_quant(const void* x, void* q, void* scales, const void* x2, void* q2,
                                void* scales2, long long rows, int block, float qmax,
                                int stochastic, unsigned int seed, int x_bf16, void* stream) {
  const bool pair = x2 != nullptr;
  if (block <= 0 || block % 8 != 0 || rows < 0 || (pair != (q2 != nullptr)) ||
      (pair != (scales2 != nullptr)) || (rows + ROWS - 1) / ROWS > 0x3fffffff)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch<__nv_bfloat16>(x, q, scales, x2, q2, scales2, rows, block, qmax, stochastic,
                                 seed, s);
  return launch<float>(x, q, scales, x2, q2, scales2, rows, block, qmax, stochastic, seed, s);
}
