// Shared pieces of the evoformer attention kernels (evoformer_fwd.cu,
// evoformer_bwd.cu): the problem and its two bias operands, the cp.async
// loaders of the [B, s, h, d] tiles and of the bias regions, the shared
// layouts wgmma reads, the bf16 products on wgmma and the fp32 products on
// FFMA, and the logit of one (query, key) pair.
//
// Both element types share one fragment layout: a warpgroup owns a 64-row
// tile, a warp 16 of its rows, and a thread holds a 16 x 64 product of its
// warp as 8 C tiles (lane = 4 * g + t: x[j][0..1] = row g, cols 8j + 2t,
// +1; x[j][2..3] = row g + 8, same cols), which is also the wgmma m64nN
// accumulator layout (element 4j + e of the flat accumulator is x[j][e]).
// bf16 tiles are products on the tensor cores (wgmma); fp32 tiles are the
// same fragments computed with FFMA on the CUDA cores (TF32 would lose the
// fp32 contract's digits), the A operand of their second product staged
// through a per-warp shared buffer. So the logit, mask, softmax and dS code
// is one for both.
//
// Layout as in the JAX package's call: q, k, v, out, do, dq, dk, dv are
// [B, s, h, d] (the flattened leading dims, then the sequence, heads and
// head dim), contiguous, 16-byte aligned; lse [B, h, s] fp32; dS [B, h, s,
// s] fp32. A bias operand is fp32 with unit key stride and any strides
// (possibly 0) over (batch row, head, query row). Offsets are 64-bit.
//
// Shared tiles. A [64, D] operand tile in bf16 is laid out as wgmma reads
// it (hopper_common.cuh): up to d 32 rows of 64 bytes in the 64-byte swizzle
// (d 16 zero-padded to 32 columns), at d 64 and 128 64-column blocks of
// [64 rows][128 bytes] in the 128-byte swizzle; in fp32 rows of D + 4 floats.
// cp.async writes them (16 bytes a thread, zeros past s), one loader for
// both element types, every head dim, any s and any bias strides.
#pragma once

#include <type_traits>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace dstt {
namespace evo {

using flash::bf16;
using flash::NTHREADS;
using flash::NWARPS;
using flash::TILE;
namespace hp = dstt::hopper;

// A logit at or below this (the Pallas bodies' NEG_INF), -inf or NaN is
// dead: its pair contributes exactly 0, and a row with no live logit writes
// out 0, lse -1e30 and zero gradients.
constexpr float NEG_INF = -1e30f;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a CTA may have

struct Bias {
  const float* p;            // null: absent
  long long sb, sh, sq;      // strides of (batch row, head, query row)
};

struct Problem {
  int B, h, s;
  float scale;
  Bias b1, b2;
  int vec;  // the bias operands allow 16-byte copies (load_bias_async)
};

template <typename T>
__host__ __device__ constexpr bool is_bf16() {
  return std::is_same<T, bf16>::value;
}

// Row stride of an fp32 tile, in floats: 16 bytes of padding per row keep
// rows 16-byte aligned and shift consecutive rows across banks.
template <int D>
__host__ __device__ constexpr int fld() {
  return D + 4;
}

// fp32 only: each warp's staging buffer for the A operand of its second
// product, 16 rows of 64 (+4 padding) floats.
constexpr int STAGE_LD = TILE + 4;

__host__ __device__ inline int n_tiles(int s) { return (s + TILE - 1) / TILE; }

__device__ __forceinline__ int64_t head_offset(int bi, int hi, const Problem& p, int D) {
  return ((int64_t)bi * p.s * p.h + hi) * D;  // element (bi, 0, hi, 0)
}

// A bias operand's plane for one (batch row, head): null when absent.
__device__ __forceinline__ const float* bias_plane(const Bias& b, int bi, int hi) {
  return b.p ? b.p + bi * b.sb + hi * b.sh : nullptr;
}

// a bias operand: 0 absent, 1 one row of keys (query stride 0), 2 a tile
__host__ __device__ inline int bias_kind(const Bias& b) {
  return b.p == nullptr ? 0 : (b.sq == 0 ? 1 : 2);
}

// The logit of a pair: the scaled product plus the summed bias, in fp32;
// dead (see NEG_INF) becomes exactly NEG_INF.
__device__ __forceinline__ float logit(float prod, float scale, float bias) {
  const float x = prod * scale + bias;
  return x > NEG_INF ? x : NEG_INF;
}

// Raise a kernel's dynamic shared memory limit when it needs more than 48 KB.
using flash::set_max_smem;

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------
// 16 bytes to dst: the first `bytes` from src, the rest zeros
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hp::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
// 4 bytes, or zeros
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hp::smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_wait_all() { cp_wait<0>(); }

// ---------------------------------------------------------------------------
// shared tiles
// ---------------------------------------------------------------------------
template <typename T, int D>
__host__ __device__ constexpr int tile_bytes() {
  return is_bf16<T>() ? (D <= 32 ? 4096 : 8192 * (D / 64)) : TILE * fld<D>() * 4;
}

// byte offset of the 16-byte chunk ch of row r of a tile
template <typename T, int D>
__device__ __forceinline__ int tile_off(int r, int ch) {
  if constexpr (!is_bf16<T>()) {
    return r * fld<D>() * 4 + ch * 16;
  } else if constexpr (D <= 32) {
    return r * 64 + (((ch ^ (r >> 1)) & 3) << 4);
  } else {
    return (ch >> 3) * 8192 + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
  }
}

// columns of a bf16 product of width d (O, dQ, dK, dV): d, at least 32
template <int D>
__host__ __device__ constexpr int nq() {
  return D <= 32 ? 32 : D;
}

// wgmma descriptors of a tile: the kk-th 16-wide K step of it as a K-major
// operand (its rows the M or N dimension), and the kk-th 16-row K step of
// it as an MN-major B operand (its rows the K dimension, its D columns N)
template <int D>
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int kk) {
  if constexpr (D <= 32) {
    return hp::desc_b64(tile + kk * 32, 16, 512);
  } else {
    return hp::desc_b128(tile + (kk >> 2) * 8192 + (kk & 3) * 32, 16, 1024);
  }
}
template <int D>
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile, int kk) {
  if constexpr (D <= 32) {
    return hp::desc_b64(tile + kk * 1024, 4096, 512);
  } else {
    return hp::desc_b128(tile + kk * 2048, 8192, 1024);
  }
}

__device__ __forceinline__ unsigned char* aligned_base(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~uintptr_t(1023));
}

// rows [row0, row0 + 64) of one head (src: its row 0, rows `stride`
// elements apart) into a tile by the 128 threads of a warpgroup (tid its
// thread); rows at or past s arrive as zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile_async(unsigned char* dst, const T* src, int row0, int s,
                                                int64_t stride, int tid) {
  constexpr int CH = D * (int)sizeof(T) / 16, EPC = 16 / (int)sizeof(T);
  for (int i = tid; i < TILE * CH; i += NTHREADS) {
    const int r = i / CH, ch = i % CH;
    const bool ok = row0 + r < s;
    cp16(dst + tile_off<T, D>(r, ch), src + (ok ? (int64_t)(row0 + r) * stride + ch * EPC : 0),
         ok ? 16 : 0);
  }
}

// The bias operand's region for queries [q0, q0 + 64) x keys [k0, k0 + 64)
// of one (batch row, head) (`plane`, null when absent) by a warpgroup: a
// tile of row stride ld, or (ld 0) the one row of an operand with query
// stride 0; zeros past s. vec: 16-byte copies (the wrapper checked the
// alignment).
__device__ __forceinline__ void load_bias_async(float* dst, int ld, const float* plane,
                                                long long sq, int q0, int k0, int s, bool vec,
                                                int tid) {
  if (plane == nullptr) return;
  const int rows = ld ? TILE : 1;
  if (vec) {
    for (int i = tid; i < rows * 16; i += NTHREADS) {
      const int r = i >> 4, c = (i & 15) * 4, qp = q0 + r, kp = k0 + c;
      const int n = qp < s ? max(0, min(4, s - kp)) : 0;
      cp16(dst + r * ld + c, plane + (n ? qp * sq + kp : 0), n * 4);
    }
  } else {
    for (int i = tid; i < rows * TILE; i += NTHREADS) {
      const int r = i >> 6, c = i & 63, qp = q0 + r, kp = k0 + c;
      const bool ok = qp < s && kp < s;
      cp4(dst + r * ld + c, plane + (ok ? qp * sq + kp : 0), ok);
    }
  }
}

// ---------------------------------------------------------------------------
// products
// ---------------------------------------------------------------------------
template <int R>
__device__ __forceinline__ float (&flat(float (&x)[R / 4][4]))[R] {
  return reinterpret_cast<float(&)[R]>(x);
}

// bf16: acc = A B^T over D (two [64, D] tiles, K-major), queued on the
// open commit group
template <int D>
__device__ __forceinline__ void ss_product(float (&acc)[32], const unsigned char* a,
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hp::wgmma_m64n64k16<0, 0>(acc, desc_k<D>(a, kk), desc_k<D>(b, kk), kk != 0);
}

// bf16: acc[64, nq] += X T with X the 64 x 64 fragments of the warpgroup
// (rounded to bf16 A fragments) and T a [64, D] tile as the MN-major B
// operand
template <int D>
__device__ __forceinline__ void rs_product(float (&acc)[nq<D>() / 2],
                                           const uint32_t (&a)[TILE / 16][4],
                                           const unsigned char* tile) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    const uint64_t b = desc_mn<D>(tile, kk);
    if constexpr (nq<D>() == 32) {
      hp::wgmma_m64n32k16_rs<1>(acc, a[kk], b, 1);
    } else if constexpr (nq<D>() == 64) {
      hp::wgmma_m64n64k16_rs<1>(acc, a[kk], b, 1);
    } else {
      hp::wgmma_m64n128k16_rs<1>(acc, a[kk], b, 1);
    }
  }
}

__device__ __forceinline__ void to_a(uint32_t (&a)[TILE / 16][4], const float (&x)[TILE / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) dstt::flash::c_to_a(a[kk], x[2 * kk], x[2 * kk + 1]);
}

// fp32: x = A[r0 .. r0 + 16) B^T over the 64 rows of B (both shared tiles,
// rows of fld<D>() floats), in C-tile fragments, on FFMA.
template <typename T, int D>
__device__ __forceinline__ void abt(float (&x)[TILE / 8][4], const T* A, const T* B, int r0,
                                    int lane) {
  static_assert(!is_bf16<T>(), "bf16 products run on wgmma");
  constexpr int LD = fld<D>();
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
  const int g = lane >> 2, t = lane & 3;
  const float* au = A + (r0 + g) * LD;
  const float* al = au + 8 * LD;
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 4) {
    const float4 u = *reinterpret_cast<const float4*>(au + kk);
    const float4 w = *reinterpret_cast<const float4*>(al + kk);
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 b = *reinterpret_cast<const float4*>(B + (j * 8 + 2 * t + e) * LD + kk);
        float xu = x[j][e], xl = x[j][2 + e];
        xu = fmaf(u.x, b.x, xu);
        xl = fmaf(w.x, b.x, xl);
        xu = fmaf(u.y, b.y, xu);
        xl = fmaf(w.y, b.y, xl);
        xu = fmaf(u.z, b.z, xu);
        xl = fmaf(w.z, b.z, xl);
        xu = fmaf(u.w, b.w, xu);
        xl = fmaf(w.w, b.w, xl);
        x[j][e] = xu;
        x[j][2 + e] = xl;
      }
    }
  }
}

// fp32: acc[:, c0 .. c0 + DC) += X Tt, X the warp's 16 x 64 fragments and
// Tt a 64-row shared tile (rows of fld<D>() floats, k-major): X staged in
// the warp's buffer, then FFMA over the 64 rows of Tt.
template <typename T, int D, int DC>
__device__ __forceinline__ void accum(float (&acc)[DC / 8][4], const float (&x)[TILE / 8][4],
                                      const T* Tt, int c0, float* stage, int lane) {
  static_assert(!is_bf16<T>(), "bf16 products run on wgmma");
  constexpr int LD = fld<D>();
  const int g = lane >> 2, t = lane & 3;
  __syncwarp();  // the previous product's readers of the buffer are done
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) {
    *reinterpret_cast<float2*>(stage + g * STAGE_LD + j * 8 + 2 * t) =
        make_float2(x[j][0], x[j][1]);
    *reinterpret_cast<float2*>(stage + (g + 8) * STAGE_LD + j * 8 + 2 * t) =
        make_float2(x[j][2], x[j][3]);
  }
  __syncwarp();
#pragma unroll 1
  for (int kc = 0; kc < TILE; kc += 4) {
    const float4 xu4 = *reinterpret_cast<const float4*>(stage + g * STAGE_LD + kc);
    const float4 xl4 = *reinterpret_cast<const float4*>(stage + (g + 8) * STAGE_LD + kc);
    const float xu[4] = {xu4.x, xu4.y, xu4.z, xu4.w};
    const float xl[4] = {xl4.x, xl4.y, xl4.z, xl4.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float* trow = Tt + (kc + r) * LD + c0 + 2 * t;
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
        const float2 tv = *reinterpret_cast<const float2*>(trow + j * 8);
        acc[j][0] = fmaf(xu[r], tv.x, acc[j][0]);
        acc[j][1] = fmaf(xu[r], tv.y, acc[j][1]);
        acc[j][2] = fmaf(xl[r], tv.x, acc[j][2]);
        acc[j][3] = fmaf(xl[r], tv.y, acc[j][3]);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b) {
  if constexpr (is_bf16<T>()) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
}

}  // namespace evo
}  // namespace dstt
