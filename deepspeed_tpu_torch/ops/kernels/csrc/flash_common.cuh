// Shared pieces of the flash-attention kernels and the kernels built on
// them (splash, sparse): the problem description, the visibility rule of a
// (query, key) pair, the range of key tiles a query tile needs (and of
// query tiles a key tile needs) and the causal order of query tiles, which
// the wgmma flash kernels (flash_hopper.cuh and flash_hopper_bwd.cuh:
// flash_fwd.cu, flash_bwd.cu and the ring's flash_chunk.cu) share too; and
// the mma.sync primitives that paged_decode.cu and the evoformer take
// (ldmatrix loads of 16x16 bf16 fragments from shared memory, mma.sync
// m16n8k16 with bf16 in and fp32 accumulate, the bf16 packing of C tiles
// into A fragments, the quad reductions).
//
// Fragment layouts of mma.m16n8k16 (PTX ISA), lane = 4 * g + t:
//   A 16x16: a[0] = (row g,   cols 2t, 2t+1)   a[1] = (row g+8, cols 2t, 2t+1)
//            a[2] = (row g,   cols 2t+8, +9)   a[3] = (row g+8, cols 2t+8, +9)
//   B 16x8:  b[0] = (rows 2t, 2t+1, col g)      b[1] = (rows 2t+8, +9, col g)
//   C 16x8:  c[0], c[1] = (row g, cols 2t, 2t+1); c[2], c[3] = (row g+8, same)
// so the accumulators of two adjacent 8-column C tiles, rounded to bf16 and
// packed in pairs, are exactly the A fragment of the next product: P never
// leaves registers.
//
// Layout as in the JAX package: q/out [b, h, s, d], k/v [b, h_kv, s, d],
// contiguous bf16; lse [b, h, s] fp32; segment ids [b, s] int32 or null.
// Offsets are 64-bit throughout.
#pragma once

#include "common.cuh"

namespace dstt {
namespace flash {

using bf16 = __nv_bfloat16;

// query and key tiles of the mma.sync kernels: 64 rows, 16 per warp
constexpr int TILE = 64;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;

struct Problem {
  int b, h, h_kv, s;
  float scale;
  int causal;
  int window;  // effective band (0: none): key k visible to query q iff q - k < window
  const int* seg;  // [b, s] or null
};

__host__ __device__ inline int effective_window(int window, int window_flag) {
  // window_flag < 0: no per-layer flag (every layer banded); 0: this layer
  // is global; > 0: this layer is banded
  return (window > 0 && window_flag != 0) ? window : 0;
}

// Is key kpos visible to query qpos? (segment equality is checked by the
// caller from its shared copies)
__device__ __forceinline__ bool visible(const Problem& p, int qpos, int kpos) {
  if (qpos >= p.s || kpos >= p.s) return false;
  if (p.causal && kpos > qpos) return false;
  if (p.window && qpos - kpos >= p.window) return false;
  return true;
}

// Key-tile range [lo, hi) a query tile [q0, q0 + BQ) needs: the causal
// bound and the static band prune whole tiles.
template <int BQ, int BK>
__device__ __forceinline__ void key_tiles(const Problem& p, int q0, int& lo, int& hi) {
  hi = p.s;
  if (p.causal) hi = min(p.s, q0 + BQ);
  lo = 0;
  if (p.window) lo = max(0, q0 - p.window + 1) / BK * BK;
}

// Blocks are launched as (b * heads, tiles) so that CUDA hands them out
// heads-fastest; under a causal mask the last query tile (and the first key
// tile) carries the most work, so it goes first and the short ones fill
// the tail.
__device__ __forceinline__ int heavy_first_query_tile(const Problem& p, int n_tiles) {
  return p.causal ? n_tiles - 1 - (int)blockIdx.y : (int)blockIdx.y;
}

// Query-tile range [lo, hi) a key tile [k0, k0 + BK) is seen by.
template <int BQ, int BK>
__device__ __forceinline__ void query_tiles(const Problem& p, int k0, int& lo, int& hi) {
  lo = p.causal ? k0 / BQ * BQ : 0;
  hi = p.s;
  if (p.window) hi = min(p.s, min(k0 + BK, p.s) - 1 + p.window);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. ``trans`` transposes each matrix.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a * b for one 16x8 tile.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of two adjacent C tiles (columns 16 * i .. 16 * i + 15 of
// a row block), rounded to bf16.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// ldmatrix row addresses in a row-major shared tile with row stride LD:
//  * a_addr: the A fragment of rows r0..r0+15, cols c0..c0+15 (ldsm_x4),
//    or, with ldsm_x4_t, the B fragments of the two n-tiles c0, c0+8 of a
//    [k = rows r0..r0+15][n] matrix stored k-major (r[0], r[1] for c0;
//    r[2], r[3] for c0 + 8);
//  * b_addr: with ldsm_x4, the B fragments of the two n-tiles n0, n0+8 of
//    a matrix stored n-major (rows n, cols k = c0..c0+15).
template <int LD>
__device__ __forceinline__ const bf16* a_addr(const bf16* base, int r0, int c0, int lane) {
  return base + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 + (lane >> 4) * 8;
}

template <int LD>
__device__ __forceinline__ const bf16* b_addr(const bf16* base, int n0, int c0, int lane) {
  return base + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + c0 + ((lane >> 3) & 1) * 8;
}

// Max and sum over the 4 lanes that share a fragment row (lanes 4g..4g+3).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Raise a kernel's dynamic shared memory limit to ``bytes`` when the limit
// set so far (``have``, the launcher's static record) is lower: once for a
// fixed size, again whenever a launch needs more. Returns a cudaError_t.
template <typename K>
__host__ inline int set_max_smem(K kernel, size_t bytes, size_t& have) {
  if (bytes <= have) return 0;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  have = bytes;
  return 0;
}

}  // namespace flash
}  // namespace dstt
