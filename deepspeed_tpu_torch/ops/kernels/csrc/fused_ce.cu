// Fused LM head + cross-entropy forward for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/fused_ce.py::_fwd_kernel (the pallas_call of
// _ce_call). For x [n, h], w [h, V] (both bf16, row-major) and labels [n]:
//
//   logits = x w (fp32 sums), lse_i = logsumexp_v logits_iv,
//   loss_i = lse_i - logits_i[label_i]
//
// The [n, V] logits never reach device memory. (The backward kernels, dx
// and dW, are fused_ce_bwd.cu's.)
//
// Bound: operations. 2 n h V FLOPs against x, w and the per-row outputs
// read or written once: hundreds of FLOPs per byte at n = h = 4096, V =
// 32000, above the card's ridge.
//
// Design (mma.sync m16n8k16, cp.async; no TMA or wgmma yet). The TPU grid
// walks (rows, vocabulary) in order and keeps its running state resident. A
// CTA here does not, and CTAs run in no order, so:
//
//  * One mainloop, logits_tile(): a 128 x 128 tile of x w, contraction
//    over h streamed through a 3-stage cp.async ring of [128 x 32] x tiles
//    and [32 x 128] w tiles; 8 warps, each a 64 x 32 piece in registers
//    (a fourth stage changed nothing: the loads are already covered).
//  * One CTA per (row tile, vocabulary tile). It reduces its tile to a
//    per-row (max, sum-exp) pair, written to a [tiles, n] partial plane,
//    and the CTA whose tile holds a row's label writes that logit. A second
//    small kernel merges the partials per row: lse = M + log(max(L,
//    1e-30)), loss = lse - target. A masked column (past V) is -inf before
//    the max and adds exactly 0; no exp(-inf + inf) is formed.
//
// Tails: rows past n and columns past V are zero-filled on load and masked;
// h need not divide 32 or 128. When h or V is not a multiple of 8 (16-byte
// rows) a tile is loaded element by element instead of cp.async.
#include "flash_common.cuh"

namespace {

using namespace dstt::flash;  // bf16, ldsm_x4(_t), mma16816, a_addr, quad_max, quad_sum

constexpr int BM = 128;  // rows of a logits tile
constexpr int BN = 128;  // vocabulary columns of a logits tile
constexpr int BK = 32;   // contraction step
// warps of a CTA: WARPS_M x WARPS_N pieces of (BM / WARPS_M) x (BN / WARPS_N).
// 2 x 4 (64 x 32 pieces, 128 registers, 16 warps on an SM) measured faster
// than 2 x 2 (64 x 64 pieces: half the shared-memory reads per product, but
// 249 registers and 8 warps on an SM): the loop is bound by latency, not by
// shared-memory bandwidth.
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;  // rows of a warp's piece
constexpr int WN = BN / WARPS_N;  // cols of a warp's piece
constexpr int MT = WM / 16;       // its 16-row fragment tiles
constexpr int NT = WN / 8;        // its 8-col fragment tiles
using Acc = float[MT][NT][4];
constexpr int STAGES = 3;
constexpr int LDK = BK + 8;   // row stride of a [128][32] tile (rows m or n, cols k)
constexpr int LDN = BN + 8;   // row stride of a [32][128] tile (rows k, cols n or m)
constexpr int STAGE_ELEMS = BM * LDK + BK * LDN;

constexpr size_t stage_bytes() { return sizeof(bf16) * STAGES * STAGE_ELEMS; }

struct Head {
  const bf16* x;      // [n, h]
  const bf16* w;      // [h, V]
  const int* labels;  // [n]
  int n, h, V;
  int x_vec, w_vec;  // rows of x / w are 16-byte aligned: cp.async path
};

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool pred) {
  const int bytes = pred ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { 
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) x cols [c0, c0 + COLS) of a row-major [R, C] bf16
// matrix into a shared tile of row stride LD; outside the matrix: zeros.
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int r0, int c0, int R,
                                                int C, int vec) {
  constexpr int CPR = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int gr = r0 + r, gc = c0 + c;
    bf16* d = dst + r * LD + c;
    if (vec) {
      const bool ok = gr < R && gc < C;  // C % 8 == 0: a chunk is all in or all out
      cp_async16(d, ok ? src + (int64_t)gr * C + gc : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        d[e] = (gr < R && gc + e < C) ? src[(int64_t)gr * C + gc + e] : __float2bfloat16_rn(0.f);
      }
    }
  }
}

// A ring of STAGES tiles: load(step, stage) issues a step's copies,
// compute(step, stage) consumes them. One barrier per step: it publishes
// step i's tile and retires step i - 1's readers before their stage is
// overwritten. Ends with every copy landed and every reader done.
template <typename Load, typename Compute>
__device__ __forceinline__ void pipeline(int nsteps, Load load, Compute compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < nsteps; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nx = i + STAGES - 1;
    if (nx < nsteps) load(nx, nx % STAGES);
    cp_async_commit();
    compute(i, i % STAGES);
  }
  cp_async_wait<0>();
  __syncthreads();
}

struct Lane {
  int warp, lane, g, t, wm, wn;
  __device__ Lane() {
    warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    wm = warp / WARPS_N;  // rows wm * WM
    wn = warp % WARPS_N;  // cols wn * WN
  }
};

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

// acc = x[m0 : m0 + 128, :] w[:, n0 : n0 + 128]; this warp's WM x WN piece:
// acc[mt][nt] is the C tile of rows wm*WM + mt*16, cols wn*WN + nt*8.
__device__ __forceinline__ void logits_tile(Acc& acc, bf16* stages, const Head& p,
                                            int m0, int n0, const Lane& L) {
  zero_acc(acc);
  const int nk = (p.h + BK - 1) / BK;
  pipeline(
      nk,
      [&](int ks, int st) {
        bf16* xs = stages + st * STAGE_ELEMS;
        bf16* ws = xs + BM * LDK;
        load_tile_async<BM, BK, LDK>(xs, p.x, m0, ks * BK, p.n, p.h, p.x_vec);
        load_tile_async<BK, BN, LDN>(ws, p.w, ks * BK, n0, p.h, p.V, p.w_vec);
      },
      [&](int, int st) {
        const bf16* xs = stages + st * STAGE_ELEMS;
        const bf16* ws = xs + BM * LDK;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldsm_x4(a[mt], a_addr<LDK>(xs, L.wm * WM + mt * 16, kk, L.lane));
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t b[4];  // w is k-major: transposed load, n-tiles 2np, 2np + 1
            ldsm_x4_t(b, a_addr<LDN>(ws, kk, L.wn * WN + np * 16, L.lane));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma16816(acc[mt][2 * np], a[mt], b[0], b[1]);
              mma16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
            }
          }
        }
      });
}

// Element e of acc[mt][nt] sits at local column:
__device__ __forceinline__ int frag_col(const Lane& L, int nt, int e) {
  return L.wn * WN + nt * 8 + 2 * L.t + (e & 1);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, 2)
ce_fwd_tile_kernel(Head p, float* __restrict__ pm, float* __restrict__ pl,
                   float* __restrict__ tgt) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  __shared__ float red_m[WARPS_N][BM];
  __shared__ float red_l[WARPS_N][BM];
  const Lane L;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  Acc acc;
  logits_tile(acc, stages, p, m0, n0, L);

  // per row of this warp's piece: max and sum-exp over its WN columns
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = L.wm * WM + mt * 16 + L.g + half * 8;
      const int row = m0 + lr;
      const int lbl = row < p.n ? p.labels[row] : -1;
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int e = half * 2 + e2;
          const int col = n0 + frag_col(L, nt, e);
          if (col >= p.V) acc[mt][nt][e] = -INFINITY;
          else if (col == lbl) tgt[row] = acc[mt][nt][e];
          mx = fmaxf(mx, acc[mt][nt][e]);
        }
      }
      mx = quad_max(mx);
      float sum = 0.f;
      if (mx != -INFINITY) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          sum += expf(acc[mt][nt][half * 2] - mx) + expf(acc[mt][nt][half * 2 + 1] - mx);
        }
      }
      sum = quad_sum(sum);
      if (L.t == 0) {
        red_m[L.wn][lr] = mx;
        red_l[L.wn][lr] = sum;
      }
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < BM && m0 + r < p.n; r += THREADS) {
    float M = red_m[0][r];
#pragma unroll
    for (int k = 1; k < WARPS_N; ++k) M = fmaxf(M, red_m[k][r]);
    float S = 0.f;  // n0 < V: at least one column is live, M is finite
#pragma unroll
    for (int k = 0; k < WARPS_N; ++k) {
      if (red_m[k][r] != -INFINITY) S += red_l[k][r] * expf(red_m[k][r] - M);
    }
    pm[(int64_t)blockIdx.y * p.n + m0 + r] = M;
    pl[(int64_t)blockIdx.y * p.n + m0 + r] = S;
  }
}

__global__ void ce_fwd_merge_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
                                    const float* __restrict__ tgt, float* __restrict__ loss,
                                    float* __restrict__ lse, int n, int tiles) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float M = -INFINITY;
  for (int j = 0; j < tiles; ++j) M = fmaxf(M, pm[(int64_t)j * n + row]);
  float S = 0.f;
  for (int j = 0; j < tiles; ++j) S += pl[(int64_t)j * n + row] * expf(pm[(int64_t)j * n + row] - M);
  const float v = M + logf(fmaxf(S, 1e-30f));
  lse[row] = v;
  loss[row] = v - tgt[row];
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Head make_problem(const void* x, const void* w, const void* labels, int n, int h, int V) {
  Head p;
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.labels = static_cast<const int*>(labels);
  p.n = n;
  p.h = h;
  p.V = V;
  p.x_vec = (h % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  p.w_vec = (V % 8 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  return p;
}

}  // namespace

// x [n, h], w [h, V] bf16 contiguous; labels [n] int32; pm, pl
// [ceil(V / 128), n] fp32 scratch; tgt [n] fp32 zeroed by the caller (a label
// outside [0, V) leaves 0); loss, lse [n] fp32 out.
extern "C" int dstt_fused_ce_fwd(const void* x, const void* w, const void* labels, void* pm,
                                 void* pl, void* tgt, void* loss, void* lse, int n, int h, int V,
                                 void* stream) {
  const Head p = make_problem(x, w, labels, n, h, V);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e = allow_smem(ce_fwd_tile_kernel, stage_bytes());
  if (e) return e;
  const int tiles = (V + BN - 1) / BN;
  const dim3 grid((unsigned)((n + BM - 1) / BM), (unsigned)tiles);
  ce_fwd_tile_kernel<<<grid, THREADS, stage_bytes(), st>>>(
      p, static_cast<float*>(pm), static_cast<float*>(pl), static_cast<float*>(tgt));
  e = (int)cudaGetLastError();
  if (e) return e;
  ce_fwd_merge_kernel<<<(n + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pl),
      static_cast<const float*>(tgt), static_cast<float*>(loss), static_cast<float*>(lse), n,
      tiles);
  return (int)cudaGetLastError();
}
