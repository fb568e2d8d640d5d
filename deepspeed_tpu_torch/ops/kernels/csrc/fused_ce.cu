// Fused LM head + cross-entropy for Hopper (sm_90a): forward, dx and dW.
//
// Replaces: deepspeed_tpu/ops/fused_ce.py::_fwd_kernel, _bwd_dx_kernel and
// _bwd_dw_kernel (the three pallas_calls of _ce_call and _ce_bwd). For
// x [n, h], w [h, V] (both bf16, row-major) and labels [n]:
//
//   fwd:  logits = x w (fp32 sums), lse_i = logsumexp_v logits_iv,
//         loss_i = lse_i - logits_i[label_i]
//   dx:   d_iv = (exp(logits_iv - lse_i) - [v == label_i]) g_i, rounded to
//         bf16; dx = d w^T summed in fp32 over the vocabulary
//   dW:   the same d; dW = x^T d summed in fp32 over the rows
//
// The [n, V] logits never reach device memory: every kernel recomputes the
// 128 x 128 tile it needs from x and w.
//
// Bound: operations. 2 n h V FLOPs forward, 4 n h V for dx and for dW
// (the logits product again plus the gradient product), against x, w and
// one output read or written once: hundreds of FLOPs per byte at n = h =
// 4096, V = 32000, above the card's ridge.
//
// Design (mma.sync m16n8k16, cp.async; no TMA or wgmma yet). The TPU grid
// walks (rows, vocabulary) in order and keeps its running state, and the
// whole [rows, h] or [h, vocab-tile] fp32 accumulator, resident. A CTA
// here holds neither, and CTAs run in no order, so the work is cut by the
// tile of d, which is computed exactly once:
//
//  * One mainloop, logits_tile(): a 128 x 128 tile of x w, contraction
//    over h streamed through a 3-stage cp.async ring of [128 x 32] x tiles
//    and [32 x 128] w tiles; 8 warps, each a 64 x 32 piece in registers
//    (a fourth stage changed nothing: the loads are already covered).
//  * fwd: one CTA per (row tile, vocabulary tile). It reduces its tile to
//    a per-row (max, sum-exp) pair, written to a [tiles, n] partial plane,
//    and the CTA whose tile holds a row's label writes that logit. A second
//    small kernel merges the partials per row: lse = M + log(max(L,
//    1e-30)), loss = lse - target. A masked column (past V) is -inf before
//    the max and adds exactly 0; no exp(-inf + inf) is formed.
//  * dx: one CTA per (row tile, VT vocabulary tiles). It forms d for its
//    tiles once, rounds it to bf16 into shared memory, then walks the
//    128-column chunks of h: each chunk's [128 x 128] product d w^T over
//    the CTA's vocabulary columns is added into an fp32 [n, h] plane with
//    vector atomics. No product is repeated (factor 1); the price is
//    n h V / (128 VT) atomic adds.
//  * dW: one CTA per (RT row tiles, vocabulary tile); the same with the
//    roles turned: x^T d over the CTA's rows, added into an fp32 [h, V]
//    plane. h V n / (128 RT) atomic adds.
//  The wrapper zeroes the fp32 planes and rounds them once to bf16.
//
// Tails: rows past n and columns past V are zero-filled on load and masked
// in d; h need not divide 32 or 128. When h or V is not a multiple of 8
// (16-byte rows) a tile is loaded element by element instead of cp.async.
#include "flash_common.cuh"

namespace {

using namespace dstt::flash;  // bf16, ldsm_x4(_t), mma16816, a_addr, b_addr, pack_bf16

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
// logits tiles a backward CTA turns into d before its second product: more
// tiles, fewer atomic adds, more shared memory. Measured at 1, 2 and 4 the
// times lay within a few percent of each other: the atomics do not set them.
constexpr int VT = 4;  // vocabulary tiles of a dx CTA
constexpr int RT = 1;  // row tiles of a dW CTA
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

// Element e of acc[mt][nt] sits at local (row, col):
__device__ __forceinline__ int frag_row(const Lane& L, int mt, int e) {
  return L.wm * WM + mt * 16 + L.g + (e >> 1) * 8;
}
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

// ---------------------------------------------------------------------------
// backward: d for one logits tile, rounded to bf16 into shared memory
// ---------------------------------------------------------------------------
// ds points at the tile's first element inside a resident plane of row
// stride LDD; rows past n and columns past V give 0.
template <int LDD>
__device__ __forceinline__ void store_d(bf16* ds, const Acc& acc, const Head& p,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ g, int m0, int n0,
                                        const Lane& L) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = L.wm * WM + mt * 16 + L.g + half * 8;
      const int row = m0 + lr;
      const bool live = row < p.n;
      const float ls = live ? lse[row] : 0.f;
      const float gr = live ? g[row] : 0.f;
      const int lbl = live ? p.labels[row] : -1;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float d[2];
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int col = n0 + frag_col(L, nt, e2);
          const float pr = expf(acc[mt][nt][half * 2 + e2] - ls) - (col == lbl ? 1.f : 0.f);
          d[e2] = (live && col < p.V) ? pr * gr : 0.f;
        }
        *reinterpret_cast<uint32_t*>(ds + lr * LDD + frag_col(L, nt, 0)) = pack_bf16(d[0], d[1]);
      }
    }
  }
}

// out[(r0 + row) * ld + c0 + col] += acc, for this warp's piece of a
// [128 x 128] tile, rows below R and cols below C only.
__device__ __forceinline__ void atomic_tile(float* out, const Acc& acc, int r0, int c0,
                                            int R, int C, const Lane& L) {
  const bool pair = (C & 1) == 0;  // even row length: 8-byte aligned pairs
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + frag_row(L, mt, half * 2);
      if (row >= R) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = c0 + frag_col(L, nt, 0);
        float* dst = out + (int64_t)row * C + col;
        const float v0 = acc[mt][nt][half * 2], v1 = acc[mt][nt][half * 2 + 1];
#if defined(__CUDACC_VER_MAJOR__) && (__CUDACC_VER_MAJOR__ * 100 + __CUDACC_VER_MINOR__ >= 1201)
        if (pair && col + 1 < C) {
          atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v0, v1));
          continue;
        }
#endif
        if (col < C) atomicAdd(dst, v0);
        if (col + 1 < C) atomicAdd(dst + 1, v1);
      }
    }
  }
}

// dx: CTA (row tile, VT vocabulary tiles). d [128][VT * 128] resident.
__global__ void __launch_bounds__(THREADS)
ce_dx_kernel(Head p, const float* __restrict__ lse, const float* __restrict__ g,
             float* __restrict__ dx32) {
  constexpr int LDD = VT * BN + 8;
  constexpr int KS = VT * BN / BK;  // contraction steps per chunk of h
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  bf16* ds = stages + STAGES * STAGE_ELEMS;
  const Lane L;
  const int m0 = blockIdx.x * BM, v0 = blockIdx.y * VT * BN;

  Acc acc;
  for (int vt = 0; vt < VT; ++vt) {
    const int n0 = v0 + vt * BN;
    if (n0 < p.V) logits_tile(acc, stages, p, m0, n0, L);
    else zero_acc(acc);  // past the vocabulary: the column mask gives d = 0
    store_d<LDD>(ds + vt * BN, acc, p, lse, g, m0, n0, L);
  }
  __syncthreads();

  // dx[rows, chunk] += d[rows, v] w[chunk, v]^T: A = d (resident, row-major),
  // B = w rows (n-major [128 h-rows][32 v]) streamed
  const int chunks = (p.h + BN - 1) / BN;
  zero_acc(acc);
  pipeline(
      chunks * KS,
      [&](int step, int st) {
        const int c = step / KS, kq = step % KS;
        load_tile_async<BN, BK, LDK>(stages + st * STAGE_ELEMS, p.w, c * BN, v0 + kq * BK, p.h,
                                     p.V, p.w_vec);
      },
      [&](int step, int st) {
        const int c = step / KS, kq = step % KS;
        const bf16* ws = stages + st * STAGE_ELEMS;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldsm_x4(a[mt], a_addr<LDD>(ds, L.wm * WM + mt * 16, kq * BK + kk, L.lane));
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t b[4];
            ldsm_x4(b, b_addr<LDK>(ws, L.wn * WN + np * 16, kk, L.lane));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma16816(acc[mt][2 * np], a[mt], b[0], b[1]);
              mma16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
            }
          }
        }
        if (kq == KS - 1) {
          atomic_tile(dx32, acc, m0, c * BN, p.n, p.h, L);
          zero_acc(acc);
        }
      });
}

// dW: CTA (RT row tiles, vocabulary tile). d [RT * 128][128] resident.
__global__ void __launch_bounds__(THREADS)
ce_dw_kernel(Head p, const float* __restrict__ lse, const float* __restrict__ g,
             float* __restrict__ dw32) {
  constexpr int LDD = BN + 8;
  constexpr int KS = RT * BM / BK;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  bf16* ds = stages + STAGES * STAGE_ELEMS;
  const Lane L;
  const int r0 = blockIdx.x * RT * BM, n0 = blockIdx.y * BN;

  Acc acc;
  for (int rt = 0; rt < RT; ++rt) {
    const int m0 = r0 + rt * BM;
    if (m0 < p.n) logits_tile(acc, stages, p, m0, n0, L);
    else zero_acc(acc);  // past the rows: the row mask gives d = 0
    store_d<LDD>(ds + rt * BM * LDD, acc, p, lse, g, m0, n0, L);
  }
  __syncthreads();

  // dW[chunk, cols] += x[rows, chunk]^T d[rows, cols]: A = x^T (k-major
  // [32 rows][128 h-cols], streamed), B = d (resident, k-major)
  const int chunks = (p.h + BM - 1) / BM;
  zero_acc(acc);
  pipeline(
      chunks * KS,
      [&](int step, int st) {
        const int c = step / KS, kq = step % KS;
        load_tile_async<BK, BM, LDN>(stages + st * STAGE_ELEMS, p.x, r0 + kq * BK, c * BM, p.n,
                                     p.h, p.x_vec);
      },
      [&](int step, int st) {
        const int c = step / KS, kq = step % KS;
        const bf16* xs = stages + st * STAGE_ELEMS;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          uint32_t a[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldsm_x4_t(a[mt], b_addr<LDN>(xs, kk, L.wm * WM + mt * 16, L.lane));
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t b[4];
            ldsm_x4_t(b, a_addr<LDD>(ds, kq * BK + kk, L.wn * WN + np * 16, L.lane));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma16816(acc[mt][2 * np], a[mt], b[0], b[1]);
              mma16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
            }
          }
        }
        if (kq == KS - 1) {
          atomic_tile(dw32, acc, c * BM, n0, p.h, p.V, L);
          zero_acc(acc);
        }
      });
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

int launch_dx(const Head& p, const float* lse, const float* g, float* dx32, cudaStream_t st) {
  const size_t bytes = stage_bytes() + sizeof(bf16) * BM * (VT * BN + 8);
  int e = allow_smem(ce_dx_kernel, bytes);
  if (e) return e;
  const dim3 grid((unsigned)((p.n + BM - 1) / BM), (unsigned)((p.V + VT * BN - 1) / (VT * BN)));
  ce_dx_kernel<<<grid, THREADS, bytes, st>>>(p, lse, g, dx32);
  return (int)cudaGetLastError();
}

int launch_dw(const Head& p, const float* lse, const float* g, float* dw32, cudaStream_t st) {
  const size_t bytes = stage_bytes() + sizeof(bf16) * RT * BM * (BN + 8);
  int e = allow_smem(ce_dw_kernel, bytes);
  if (e) return e;
  const dim3 grid((unsigned)((p.n + RT * BM - 1) / (RT * BM)), (unsigned)((p.V + BN - 1) / BN));
  ce_dw_kernel<<<grid, THREADS, bytes, st>>>(p, lse, g, dw32);
  return (int)cudaGetLastError();
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

// lse, g [n] fp32; dx32 [n, h] fp32, zeroed by the caller, summed into.
extern "C" int dstt_fused_ce_dx(const void* x, const void* w, const void* labels, const void* lse,
                                const void* g, void* dx32, int n, int h, int V,
                                void* stream) {
  const Head p = make_problem(x, w, labels, n, h, V);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_dx(p, static_cast<const float*>(lse), static_cast<const float*>(g),
                   static_cast<float*>(dx32), st);
}

// dw32 [h, V] fp32, zeroed by the caller, summed into.
extern "C" int dstt_fused_ce_dw(const void* x, const void* w, const void* labels, const void* lse,
                                const void* g, void* dw32, int n, int h, int V,
                                void* stream) {
  const Head p = make_problem(x, w, labels, n, h, V);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_dw(p, static_cast<const float*>(lse), static_cast<const float*>(g),
                   static_cast<float*>(dw32), st);
}
