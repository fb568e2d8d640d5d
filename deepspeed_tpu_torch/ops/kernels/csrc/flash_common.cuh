// Shared pieces of the flash-attention kernels and the kernels built on
// them (splash, sparse): the problem description, the
// visibility rule of a (query, key) pair, the range of key tiles a query
// tile needs (and of query tiles a key tile needs) and the causal order of
// query tiles, which the wgmma flash kernels (flash_hopper.cuh and
// flash_hopper_bwd.cuh: flash_fwd.cu, flash_bwd.cu and the ring's
// flash_chunk.cu) share too; and for the mma.sync kernels (the
// layout-predicate sparse_fwd.cu; paged_decode.cu and the evoformer take
// some primitives): tile loads into padded shared memory, the tensor-core
// primitives (ldmatrix loads of 16x16 bf16 fragments from shared memory and
// mma.sync m16n8k16, bf16 in, fp32 accumulate), a C-tile product
// accumulated against a shared tile, and the forward's per-tile body and
// epilogue, taking the family's rule for a kept pair.
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
// row padding of shared bf16 tiles, in elements: keeps rows 16-byte aligned
// and shifts consecutive rows across banks
constexpr int PAD_H = 8;

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

// Copy rows [row0, row0 + ROWS) of a [s, D] bf16 matrix into a shared tile
// with row stride D + PAD_H; rows at or past s become zeros. 16-byte
// vectors (D % 8 == 0 and the wrapper checks 16-byte alignment). The padded
// stride puts the 8 rows one ldmatrix reads in 8 different bank groups.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int s) {
  constexpr int VPR = D / 8;  // uint4 per row
  for (int i = threadIdx.x; i < ROWS * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < s) val = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + PAD_H) + c) = val;
  }
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

// acc[:, c0 .. c0 + DC) += X * T where X is 16 x 64 in C tiles (rounded to
// bf16 into A fragments) and T a 64-row shared tile stored k-major.
template <int D, int DC>
__device__ __forceinline__ void accumulate(float (&acc)[DC / 8][4], const float (&x)[TILE / 8][4],
                                           const bf16* T, int c0, int lane) {
  constexpr int LD = D + PAD_H;
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    uint32_t a[4];
    c_to_a(a, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
    for (int dd = 0; dd < DC / 16; ++dd) {
      uint32_t b[4];
      ldsm_x4_t(b, a_addr<LD>(T, kk * 16, c0 + dd * 16, lane));
      mma16816(acc[2 * dd], a, b[0], b[1]);
      mma16816(acc[2 * dd + 1], a, b[2], b[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// The forward's per-tile body (sparse_fwd.cu). A kernel picks the 64-row
// tiles it visits and which (query, key) pairs of a tile it keeps: keep(c, upper)
// says whether tile column c is kept for the lane's upper (fragment row g)
// or lower (g + 8) row. A dropped logit is `neg` (the sparse forward's: the
// Pallas body's -1e30) and, like any logit at or below neg / 2,
// contributes exactly 0, also to a row that has seen nothing else.

// Forward: S = Q K^T for the warp's 16 query rows against a key tile, keep
// and scale, the online softmax of the lane's rows (m, l: upper, lower), O *=
// the correction, then O += P V with P rounded to bf16 straight from the S
// accumulators.
template <int D, typename Keep>
__device__ __forceinline__ void fwd_tile(float (&o)[D / 8][4], float (&m)[2], float (&l)[2],
                                         const bf16* Qs, const bf16* Ks, const bf16* Vs,
                                         float scale, float neg, Keep keep, int warp, int lane) {
  constexpr int LD = D + PAD_H;
  const int t = lane & 3;
  float s[TILE / 8][4];
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_addr<LD>(Qs, warp * 16, kk * 16, lane));
#pragma unroll
    for (int jj = 0; jj < TILE / 16; ++jj) {
      uint32_t b[4];
      ldsm_x4(b, b_addr<LD>(Ks, jj * 16, kk * 16, lane));
      mma16816(s[2 * jj], a, b[0], b[1]);
      mma16816(s[2 * jj + 1], a, b[2], b[3]);
    }
  }

  float mx[2] = {neg, neg};
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int u = e >> 1;
      s[j][e] = keep(j * 8 + 2 * t + (e & 1), u == 0) ? s[j][e] * scale : neg;
      mx[u] = fmaxf(mx[u], s[j][e]);
    }
  }
  float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float mn = fmaxf(m[u], quad_max(mx[u]));
    corr[u] = m[u] == mn ? 1.f : expf(m[u] - mn);
    m[u] = mn;
  }
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int u = e >> 1;
      const float pe = s[j][e] > 0.5f * neg ? expf(s[j][e] - m[u]) : 0.f;
      s[j][e] = pe;
      rs[u] += pe;
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) l[u] = l[u] * corr[u] + quad_sum(rs[u]);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[j][0] *= corr[0];
    o[j][1] *= corr[0];
    o[j][2] *= corr[1];
    o[j][3] *= corr[1];
  }
  accumulate<D, D>(o, s, Vs, 0, lane);
}

// The forward's epilogue: the lane's rows row0 / row1 (those below s) of O /
// max(l, 1e-30) rounded once to bf16 into ob, lse = m + log(max(l, 1e-30))
// into lseb.
template <int D>
__device__ __forceinline__ void fwd_store(bf16* ob, float* lseb, const float (&o)[D / 8][4],
                                          const float (&m)[2], const float (&l)[2], int row0,
                                          int row1, int s, int lane) {
  const int t = lane & 3;
  const float ls0 = fmaxf(l[0], 1e-30f), ls1 = fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (row0 < s) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row0 * D + c) =
          __floats2bfloat162_rn(o[j][0] / ls0, o[j][1] / ls0);
    }
    if (row1 < s) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row1 * D + c) =
          __floats2bfloat162_rn(o[j][2] / ls1, o[j][3] / ls1);
    }
  }
  if (t == 0) {
    if (row0 < s) lseb[row0] = m[0] + logf(ls0);
    if (row1 < s) lseb[row1] = m[1] + logf(ls1);
  }
}

// Raise a kernel's dynamic shared memory limit to ``bytes`` when the limit
// set so far (``have``, the launcher's static record) is lower: once for a
// fixed size, again whenever a launch needs more (the sparse kernels' masks
// grow with s). Returns a cudaError_t.
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
