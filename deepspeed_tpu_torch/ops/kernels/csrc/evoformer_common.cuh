// Shared pieces of the evoformer attention kernels (evoformer_fwd.cu,
// evoformer_bwd.cu): the problem and its two bias operands, tile loads from
// the [B, s, h, d] layout, the two products every pass is made of, the
// per-row delta of the backward, the summed bias tile staged in shared
// memory, the logit of one (query, key) pair, and the register cap.
//
// The tile bodies are written here from flash_common.cuh's primitives
// (ldmatrix, mma.m16n8k16, the C-to-A fragment reuse), not through its
// per-tile bodies: those take a keep rule and scale inside, with no place
// for a per-pair addend, and the flash, splash and sparse kernels keep their
// code and bits untouched.
//
// Both element types share one fragment layout: a warp owns 16 rows of a
// 64-row tile and holds a 16 x 64 product as 8 C tiles of mma.m16n8k16
// (lane = 4 * g + t: x[j][0..1] = row g, cols 8j + 2t, +1; x[j][2..3] = row
// g + 8, same cols). bf16 tiles are products on the tensor cores; fp32
// tiles are the same fragments computed with FFMA on the CUDA cores (TF32
// would lose the fp32 contract's digits), the A operand of their second
// product staged through a per-warp shared buffer. So the logit, mask,
// softmax and dS code is one for both.
//
// Layout as in the JAX package's call: q, k, v, out, do, dq, dk, dv are
// [B, s, h, d] (the flattened leading dims, then the sequence, heads and
// head dim), contiguous, 16-byte aligned; lse [B, h, s] fp32; dS [B, h, s,
// s] fp32. A bias operand is fp32 with unit key stride and any strides
// (possibly 0) over (batch row, head, query row). Offsets are 64-bit.
#pragma once

#include <type_traits>

#include "flash_common.cuh"

namespace dstt {
namespace evo {

using flash::bf16;
using flash::NTHREADS;
using flash::NWARPS;
using flash::TILE;

// A logit at or below this (the Pallas bodies' NEG_INF), -inf or NaN is
// dead: its pair contributes exactly 0, and a row with no live logit writes
// out 0, lse -1e30 and zero gradients.
constexpr float NEG_INF = -1e30f;

struct Bias {
  const float* p;            // null: absent
  long long sb, sh, sq;      // strides of (batch row, head, query row)
};

struct Problem {
  int B, h, s;
  float scale;
  Bias b1, b2;
  int vec;  // the bias operands allow float4 loads (load_bias_tile)
};

template <typename T>
__host__ __device__ constexpr bool is_bf16() {
  return std::is_same<T, bf16>::value;
}

// Row stride of a shared tile, in elements: 16 bytes of padding per row
// keeps rows 16-byte aligned and shifts consecutive rows across banks.
template <typename T, int D>
__host__ __device__ constexpr int ld() {
  return D + (is_bf16<T>() ? flash::PAD_H : 4);
}

// The register cap's CTAs per SM: at the Evoformer's d 32 in bf16 the
// per-pair scalar work, not the tensor cores, sets the pace, so 4 CTAs (at
// most 128 registers a thread) hide more latency than fewer with more
// registers.
template <typename T, int D>
__host__ __device__ constexpr int min_ctas() {
  return (is_bf16<T>() && D <= 32) ? 4 : 1;
}

// fp32 only: each warp's staging buffer for the A operand of its second
// product, 16 rows of 64 (+4 padding) floats.
constexpr int STAGE_LD = TILE + 4;

template <typename T>
constexpr size_t stage_bytes() {
  return is_bf16<T>() ? 0 : sizeof(float) * NWARPS * 16 * STAGE_LD;
}

__host__ __device__ inline int n_tiles(int s) { return (s + TILE - 1) / TILE; }

__device__ __forceinline__ int64_t head_offset(int bi, int hi, const Problem& p, int D) {
  return ((int64_t)bi * p.s * p.h + hi) * D;  // element (bi, 0, hi, 0)
}

// Rows [row0, row0 + 64) of one head (``src`` points at its row 0, rows
// ``stride`` elements apart) into a padded shared tile; rows at or past s
// become zeros. 16-byte vectors.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int s,
                                          int64_t stride) {
  constexpr int EPV = 16 / sizeof(T);
  constexpr int VPR = D / EPV;
  constexpr int LD = ld<T, D>();
  for (int i = threadIdx.x; i < TILE * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * EPV;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < s) val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// x = A[r0 .. r0 + 16) B^T over the 64 rows of B (both shared tiles, rows
// of D elements), in C-tile fragments, fp32.
template <typename T, int D>
__device__ __forceinline__ void abt(float (&x)[TILE / 8][4], const T* A, const T* B, int r0,
                                    int lane) {
  constexpr int LD = ld<T, D>();
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
  if constexpr (is_bf16<T>()) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      flash::ldsm_x4(a, flash::a_addr<LD>(A, r0, kk * 16, lane));
#pragma unroll
      for (int jj = 0; jj < TILE / 16; ++jj) {
        uint32_t b[4];
        flash::ldsm_x4(b, flash::b_addr<LD>(B, jj * 16, kk * 16, lane));
        flash::mma16816(x[2 * jj], a, b[0], b[1]);
        flash::mma16816(x[2 * jj + 1], a, b[2], b[3]);
      }
    }
  } else {
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
}

// acc[:, c0 .. c0 + DC) += X Tt, X the warp's 16 x 64 fragments and Tt a
// 64-row shared tile (rows of D elements, k-major). bf16: X rounded to bf16
// A fragments (flash_common's accumulate). fp32: X staged in the warp's
// buffer, then FFMA over the 64 rows of Tt.
template <typename T, int D, int DC>
__device__ __forceinline__ void accum(float (&acc)[DC / 8][4], const float (&x)[TILE / 8][4],
                                      const T* Tt, int c0, float* stage, int lane) {
  if constexpr (is_bf16<T>()) {
    flash::accumulate<D, DC>(acc, x, Tt, c0, lane);
  } else {
    constexpr int LD = ld<T, D>();
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
}

// delta[r] = sum_c do[r, c] * o[r, c] in fp32 for the 64 rows of a tile,
// two threads per row (dOs the shared dO tile, ob row 0 of this head's o,
// rows ``stride`` apart).
template <typename T, int D>
__device__ __forceinline__ void row_delta(const T* dOs, const T* ob, int q0, int s,
                                          int64_t stride, float* delta_s) {
  static_assert(NTHREADS == 2 * TILE, "two threads per row");
  constexpr int LD = ld<T, D>();
  constexpr int EPV = 16 / sizeof(T);
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  float acc = 0.f;
  if (q0 + r < s) {
    const T* orow = ob + (int64_t)(q0 + r) * stride + half * (D / 2);
    const T* drow = dOs + r * LD + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; c += EPV) {
      float fo[EPV], fd[EPV];
      dstt::load_vec<EPV>(orow + c, fo);
      dstt::load_vec<EPV>(drow + c, fd);
#pragma unroll
      for (int j = 0; j < EPV; ++j) acc = fmaf(fd[j], fo[j], acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (!half) delta_s[r] = acc;
}

// A bias operand's plane for one (batch row, head): null when absent.
__device__ __forceinline__ const float* bias_plane(const Bias& b, int bi, int hi) {
  return b.p ? b.p + bi * b.sb + hi * b.sh : nullptr;
}

// The summed bias of query rows [r0, r0 + 64) x keys [c0, c0 + 64) of one
// (batch row, head), staged in shared memory (row stride STAGE_LD, zeros
// past s): a warp reads 32 consecutive keys of a row, so the loads are
// coalesced whatever the operands' strides, and they are issued beside the
// tile's other loads. Then each pair reads one value from shared memory.
constexpr size_t BIAS_TILE_BYTES = sizeof(float) * TILE * STAGE_LD;

// ``vec``: every operand's plane and query stride keep 16-byte alignment
// (the wrapper checks), so full runs of 4 keys load as one float4.
__device__ __forceinline__ void load_bias_tile(float* Bs, const float* p1, long long sq1,
                                               const float* p2, long long sq2, int r0, int c0,
                                               int s, bool vec) {
  // thread: keys c .. c + 3 of rows r, r + 8, ... (16 threads per row)
  const int c = (threadIdx.x % 16) * 4, r_first = threadIdx.x / 16;
  const int kp = c0 + c;
  for (int r = r_first; r < TILE; r += NTHREADS / 16) {
    const int qp = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qp < s) {
      if (vec && kp + 3 < s) {
        if (p1) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(p1 + qp * sq1 + kp));
          v.x += a.x, v.y += a.y, v.z += a.z, v.w += a.w;
        }
        if (p2) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(p2 + qp * sq2 + kp));
          v.x += a.x, v.y += a.y, v.z += a.z, v.w += a.w;
        }
      } else {
        float e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (kp + i >= s) continue;
          if (p1) e[i] += __ldg(p1 + qp * sq1 + kp + i);
          if (p2) e[i] += __ldg(p2 + qp * sq2 + kp + i);
        }
        v = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
    *reinterpret_cast<float4*>(Bs + r * STAGE_LD + c) = v;
  }
}

// The logit of a pair: the scaled product plus the summed bias, in fp32;
// dead (see NEG_INF) becomes exactly NEG_INF.
__device__ __forceinline__ float logit(float prod, float scale, float bias) {
  const float x = prod * scale + bias;
  return x > NEG_INF ? x : NEG_INF;
}

// Raise a kernel's dynamic shared memory limit when it needs more than 48 KB.
using flash::set_max_smem;

}  // namespace evo
}  // namespace dstt
