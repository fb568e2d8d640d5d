// Fused LM head + cross-entropy backward for Hopper (sm_90a): dx and dW on
// wgmma fed by TMA.
//
// Replaces: deepspeed_tpu/ops/fused_ce.py::_bwd_dx_kernel and _bwd_dw_kernel
// (the two pallas_calls of _ce_bwd). For x [n, h], w [h, V] (bf16,
// row-major), labels [n], the forward's fp32 lse [n] and the cotangent g [n]:
//
//   d_iv = (exp(x_i w_v - lse_i) - [v == label_i]) g_i, rounded to bf16
//          (0 past n and past V)
//   dx   = d w^T,  dW = x^T d,  sums in fp32, each rounded once by the wrapper
//
// The [n, V] logits never reach device memory: each kernel recomputes the
// logits its d tile needs (the JAX design: fused_ce.py:107-110, :139-142).
//
// Bound: operations. 4 n h V FLOPs per kernel (the logits again, then the
// gradient product) against x, w and one output each read or written once:
// ~500 FLOPs per byte at n = h = 4096, V = 32000, above the card's ridge.
//
// Design. A CTA owns a 128-wide tile of the output's rows (dx: rows of x;
// dW: vocabulary columns) and a 512-wide span of the gradient product's
// contraction (dx: vocabulary; dW: rows). It computes d for tile x span once,
// keeps it in shared memory as a wgmma operand, and adds its share of the
// output into a zeroed fp32 plane:
//
//  * Warp specialisation: warpgroups 0 and 1 consume (wgmma, fp32
//    accumulators in registers, raised to 232 a thread by setmaxnreg), one
//    thread of warpgroup 2 produces (TMA loads into a three-stage ring with
//    full/empty mbarriers; lowered to 40 registers).
//  * Logits, two passes of 256 span columns, contraction over h in 64-deep
//    steps (fused_ce_hopper.cuh, the forward's logits pass too): each
//    consumer one m64n256k16 per 16 of h, dx as x (K-major) . w (MN-major),
//    dW transposed as w^T (MN-major) . x^T (K-major), so both kernels hold
//    [128 tile x 256 span] accumulators. The consumers turn
//    them into d and store it as bf16 in the 128-byte-swizzled layout that
//    TMA would give, [8 blocks][128 tile][64 span]: a K-major operand.
//  * Gradient product, chunks of 128 of h: dx[128 rows x 128 h] += d (A) .
//    w^T (B, K-major boxes of 128 h x 64 vocabulary), dW[128 h x 128 v] +=
//    x^T (A, MN-major) . d^T (B); m64n128k16, two 64-deep span steps a
//    stage. Two accumulator sets take turns: while one chunk's products run,
//    the previous chunk's sums go out a quarter per stage. Each chunk ends
//    with a wait for all its products, so the compiler can prove that the
//    reductions never read registers of an in-flight wgmma (otherwise it
//    serialises every wgmma of the kernel).
//  * Cross-CTA reduction: red.global.add.v2.f32 straight from the
//    accumulators. tools/torch_fused_ce_ab.py --reduce measured vector
//    reductions, the TMA unit's bulk reduce-add and float2 atomics at one
//    rate on the H100 (~2.8-3.0 TB/s into an L2-resident plane, ~1.2-1.35
//    into a 512 MB one), so the reduction takes no shared memory: d (128 KB)
//    and the ring (96 KB) hold all 227 KB. n h V / 512 adds for each kernel
//    (1.05e9 at n = h = 4096, V = 32000; the first kernels' dW added 4.19e9).
//  * The ring: three stages, where 96 KB hold two logits stages of 48 KB.
//    The third logits stage lies in the d of the pass it feeds (free until
//    that pass ends); the gradient phase re-slots the 96 KB as three 32 KB
//    stages. With two stages the loads were exposed: both kernels ran about
//    a fifth slower.
//  * Grid: one CTA per SM, (tile, span) pairs walked in groups of 8 tiles,
//    tiles fastest, so the CTAs in flight share their tiles' slabs of the
//    fp32 plane in L2.
//
// Not taken: a 2-CTA cluster multicasting the span operand halves its L2
// reads but ties the two CTAs' rings together stage by stage; at this ring
// depth it ran far slower.
//
// Tails: the wrapper pads x and w with zeros to row lengths that are
// multiples of 8 (TMA's 16-byte strides), which changes no sum; rows past
// n, columns past the padded h and V, and ragged boxes come from TMA's
// zero fill; a box that would lie wholly outside is not loaded (its logits
// columns, its d rows or its output rows are masked); d masks the columns
// past the true V and the rows past n.
#include "common.cuh"
#include "fused_ce_hopper.cuh"
#include "hopper_common.cuh"

namespace {

using namespace dstt::hopper;
using namespace dstt::fused_ce;  // BK, BOX64, TILE, PASS, the ring, the logits pass

constexpr int SPAN = 512;         // the CTA's K2: dx vocabulary columns, dW rows
constexpr int BLOCK = TILE * 128; // bytes of a [128 x 64] block of the resident d
constexpr int D_BYTES = SPAN / BK * BLOCK;  // 128 KB
constexpr int PASS_BYTES = PASS / BK * BLOCK;  // a pass's share of d: 64 KB
constexpr int CHUNK = 128;        // h per chunk of the gradient product (N of m64n128k16)
constexpr int S = 3;              // stages of the ring
constexpr int GRAD_STAGE = 32 * 1024;    // two 64-deep K2 steps of a chunk
constexpr int RING_BYTES = 2 * LOGITS_STAGE;  // = S * GRAD_STAGE
constexpr int SMEM = 1024 + D_BYTES + RING_BYTES + 256;  // 1024: alignment slack
static_assert(RING_BYTES == S * GRAD_STAGE && PASS_BYTES >= LOGITS_STAGE && SMEM <= 232448,
              "shared memory");

// The ring: load `it` goes to stage it % S. In the logits phase two stages
// are 48 KB slots of the ring region and the third is the resident d's
// share of the pass the load belongs to (free until that pass's d is
// written, after its last product); in the gradient phase the three are
// 32 KB slots of the ring region (the producer enters that phase only once
// every logits stage is released).
struct Ring : Barriers<S> {
  unsigned char* dsm;
  unsigned char* base;

  __device__ explicit Ring(unsigned char* d)
      : Barriers<S>(d + D_BYTES + RING_BYTES), dsm(d), base(d + D_BYTES) {}
  __device__ unsigned char* logits_slot(int it, int pass) const {
    const int s = it % S;
    return s < 2 ? base + s * LOGITS_STAGE : dsm + pass * PASS_BYTES;
  }
  __device__ unsigned char* grad_slot(int it) const { return base + (it % S) * GRAD_STAGE; }
};

struct RowIn {
  const int* labels;
  const float* lse;
  const float* g;
  int n, V;
};

// a row's share of d: d(logit, v) = (exp(logit - lse) - [v == label]) g,
// 0 past n and past V
struct RowD {
  float lse, g;
  int label;
  bool live;
  __device__ RowD(const RowIn& in, int row) {
    live = row < in.n;
    lse = live ? __ldg(in.lse + row) : 0.f;
    g = live ? __ldg(in.g + row) : 0.f;
    label = live ? __ldg(in.labels + row) : -1;
  }
  __device__ __forceinline__ float d(float logit, int v, int V) const {
    const float p = expf(logit - lse) - (v == label ? 1.f : 0.f);
    return (live && v < V) ? p * g : 0.f;
  }
};

// ---------------------------------------------------------------------------
// The two kernels, one body. A CTA owns a TILE of M (dx: 128 rows; dW: 128
// vocabulary columns) and a SPAN of the gradient product's contraction K2
// (dx: vocabulary; dW: rows). Its d is resident as [SPAN / 64 blocks][128
// M][64 K2], 128-byte swizzled: a K-major wgmma operand (dx: A = d; dW: B =
// d^T).
//
//  logits, per pass of 256 K2 (contraction h, 64 per stage):
//    dx: acc[128 rows x 256 v]  = x (A, K-major) . w (B, MN-major)
//    dW: acc[128 v x 256 rows]  = w^T (A, MN-major) . x^T (B, K-major)
//  gradient product, per chunk of 128 h (two 64-deep K2 steps per stage):
//    dx: dx[128 rows x 128 h]  += d (A, K-major) . w^T (B, K-major)
//    dW: dW[128 h x 128 v]     += x^T (A, MN-major) . d^T (B, K-major)
//  with two accumulators in turn: while one chunk's products run, the
//  previous chunk's sums go out to the plane, a quarter per stage.
// ---------------------------------------------------------------------------
template <bool DW, int J0, int J1>
__device__ __forceinline__ void red_part(float* out, const float (&acc)[64], int m0, int c, int wg,
                                         const RowIn& in, int h8, int t) {
  if constexpr (DW) {
    const int V8 = (in.V + 7) & ~7;
    red_fragment<64, J0, J1>(out, acc, c * CHUNK + 64 * wg, m0, h8, V8, V8, t);
  } else {
    red_fragment<64, J0, J1>(out, acc, m0 + 64 * wg, c * CHUNK, in.n, h8, h8, t);
  }
}

// the quarter `part` of a finished chunk's sums (parts at or past `from`
// when part < 0: the rest)
template <bool DW>
__device__ __forceinline__ void red_quarter(float* out, const float (&acc)[64], int part, int from,
                                            int m0, int c, int wg, const RowIn& in, int h8,
                                            int t) {
#define DSTT_CE_PART(P)                                                              \
  if (part == (P) || (part < 0 && (P) >= from))                                      \
    red_part<DW, 4 * (P), 4 * (P) + 4>(out, acc, m0, c, wg, in, h8, t);
  DSTT_CE_PART(0) DSTT_CE_PART(1) DSTT_CE_PART(2) DSTT_CE_PART(3)
#undef DSTT_CE_PART
}

// The products of one stage of a gradient chunk: STEPS 64-deep K2 steps.
template <bool DW, int STEPS>
__device__ __forceinline__ void grad_stage(float (&acc)[64], const unsigned char* st,
                                           const unsigned char* dsm, int s, int wg) {
  wgmma_fence();
#pragma unroll
  for (int e = 0; e < STEPS; ++e) {
    const unsigned char* dk = dsm + (2 * s + e) * BLOCK;
    const unsigned char* gk = st + e * 2 * BOX64;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (DW) {
        const uint64_t a = desc_b128(gk + wg * BOX64 + kk * 2048, BOX64, 1024);
        const uint64_t b = desc_b128(dk + kk * 32, 16, 1024);
        wgmma_m64n128k16<1, 0>(acc, a, b, (s | e | kk) != 0);
      } else {
        const uint64_t a = desc_b128(dk + wg * BOX64 + kk * 32, 16, 1024);
        const uint64_t b = desc_b128(gk + kk * 32, 16, 1024);
        wgmma_m64n128k16<0, 0>(acc, a, b, (s | e | kk) != 0);
      }
    }
  }
}

// One chunk of the gradient product into `acc`: stages of two K2 steps
// (one for an odd last step, kept out of the loop so that no wgmma sits
// under a branch inside a commit group). The previous chunk's sums
// (`prev`, chunk c - 1, retired by its drain) go out a quarter per stage
// while this chunk's products run.
template <bool DW>
__device__ __forceinline__ void grad_chunk(float (&acc)[64], float (&prev)[64], int c,
                                           Ring& ring, Consumer<Ring>& cons, int& it,
                                           const unsigned char* dsm, int kv, float* out, int m0,
                                           int wg, const RowIn& in, int h8, int t) {
  const int pairs = kv / 2;
  int s = 0;
  for (; s < pairs; ++s, ++it) {
    ring.ready(it);
    grad_stage<DW, 2>(acc, ring.grad_slot(it), dsm, s, wg);
    cons.step_done(it);
    if (c > 0) red_quarter<DW>(out, prev, s, 0, m0, c - 1, wg, in, h8, t);
  }
  if (kv & 1) {
    ring.ready(it);
    grad_stage<DW, 1>(acc, ring.grad_slot(it), dsm, s, wg);
    cons.step_done(it);
    ++it;
  }
  if (c > 0) red_quarter<DW>(out, prev, -1, pairs, m0, c - 1, wg, in, h8, t);
  // retire the chunk's products before the next chunk reads `acc` as its
  // `prev`: a wait for all groups is what lets the compiler prove that no
  // in-flight wgmma owns the registers the reductions read (one bubble per
  // chunk; with only wait<1> it serialises every wgmma of the kernel)
  cons.drain();
  fence_acc(acc);
}

template <bool DW>
__global__ void __launch_bounds__(THREADS, 1)
ce_bwd_kernel(const __grid_constant__ CUtensorMap a1_map,  // dx: x {64, 128}; dW: w {64, 64}
              const __grid_constant__ CUtensorMap b1_map,  // dx: w {64, 64};  dW: x {64, 256}
              const __grid_constant__ CUtensorMap g2_map,  // dx: w {64, 128}; dW: x {64, 64}
              RowIn in, float* __restrict__ out, int h8, int tiles, int spans) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* dsm = aligned_smem(smem_raw);
  Ring ring(dsm);

  // (tile, span): the CTAs in flight share their tiles' slabs of the fp32
  // plane in L2
  const TileSpan ts(tiles, spans, SPAN);
  const int m0 = ts.m0, k0 = ts.k0;
  const int V = in.V, V8 = (V + 7) & ~7;
  const int kspan = min(SPAN, (DW ? in.n : V) - k0);
  const int passes = cdiv(kspan, PASS);
  const int ksteps = cdiv(h8, BK);
  const int kv = cdiv(kspan, BK);  // 64-deep K2 steps of the gradient product
  const int chunks = cdiv(h8, CHUNK);

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      tma_prefetch_desc(&a1_map);
      tma_prefetch_desc(&b1_map);
      tma_prefetch_desc(&g2_map);
      int it = 0;
      for (int p = 0; p < passes; ++p) {
        load_logits_pass<DW>(ring, [&](int i) { return ring.logits_slot(i, p); }, &a1_map,
                             &b1_map, m0, k0 + p * PASS, V8, ksteps, it);
      }
      ring.wait_released(it);  // the gradient slots overlap the logits slots
      for (int c = 0; c < chunks; ++c) {
        const int hboxes = min(2, cdiv(h8 - c * CHUNK, BK));
        for (int s = 0; s < cdiv(kv, 2); ++s, ++it) {
          const int steps = min(2, kv - 2 * s);
          ring.acquire(it, steps * (DW ? hboxes * BOX64 : CHUNK * 128));
          unsigned char* st = ring.grad_slot(it);
          uint64_t* bar = &ring.full[it % S];
          for (int e = 0; e < steps; ++e) {
            const int kk = k0 + (2 * s + e) * BK;
            if constexpr (DW) {
              for (int j = 0; j < hboxes; ++j)
                tma_load_2d(st + e * 2 * BOX64 + j * BOX64, &g2_map, bar, c * CHUNK + j * BK, kk);
            } else {
              tma_load_2d(st + e * 2 * BOX64, &g2_map, bar, kk, c * CHUNK);
            }
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();  // 128 x 40 + 256 x 232 <= 65536
    const int t = threadIdx.x % 128;
    const int lr = 16 * (t >> 5) + ((t & 31) >> 2);  // this thread's accumulator rows lr, lr + 8
    Consumer<Ring> cons(ring);
    int it = 0;
    {
      float acc[128];
      for (int p = 0; p < passes; ++p) {
        logits_pass<DW>(acc, cons, [&](int i) { return ring.logits_slot(i, p); }, ksteps, it,
                        wg);
        // the pass's third stage lies in the d about to be written: both
        // warpgroups' products must be done with it
        named_sync(3, 256);
        // d into the resident tile: M row 64 wg + lr (+ 8), K2 column 256 p + col
        const int c0 = k0 + p * PASS;
        if constexpr (DW) {
          const int v = m0 + 64 * wg + lr;  // and v + 8
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int col = 8 * j + 2 * (t & 3);
            const RowD ra(in, c0 + col), rb(in, c0 + col + 1);
            unsigned char* blk = dsm + ((p * PASS + col) / BK) * BLOCK;
            store_swizzled(blk, 64 * wg + lr, col % BK, ra.d(acc[4 * j], v, V),
                           rb.d(acc[4 * j + 1], v, V));
            store_swizzled(blk, 64 * wg + lr + 8, col % BK, ra.d(acc[4 * j + 2], v + 8, V),
                           rb.d(acc[4 * j + 3], v + 8, V));
          }
        } else {
          const RowD r0(in, m0 + 64 * wg + lr), r1(in, m0 + 64 * wg + lr + 8);
#pragma unroll
          for (int j = 0; j < 32; ++j) {
            const int col = 8 * j + 2 * (t & 3);
            unsigned char* blk = dsm + ((p * PASS + col) / BK) * BLOCK;
            store_swizzled(blk, 64 * wg + lr, col % BK, r0.d(acc[4 * j], c0 + col, V),
                           r0.d(acc[4 * j + 1], c0 + col + 1, V));
            store_swizzled(blk, 64 * wg + lr + 8, col % BK, r1.d(acc[4 * j + 2], c0 + col, V),
                           r1.d(acc[4 * j + 3], c0 + col + 1, V));
          }
        }
      }
    }
    // dx reads only this warpgroup's d rows; dW reads all 128
    fence_proxy_async();
    if (DW) named_sync(1, 256);
    else if (wg == 0) named_sync(1, 128);
    else named_sync(2, 128);

    float acc_a[64], acc_b[64];
    for (int c = 0; c < chunks; c += 2) {
      grad_chunk<DW>(acc_a, acc_b, c, ring, cons, it, dsm, kv, out, m0, wg, in, h8, t);
      if (c + 1 < chunks)
        grad_chunk<DW>(acc_b, acc_a, c + 1, ring, cons, it, dsm, kv, out, m0, wg, in, h8, t);
    }
    if (chunks % 2) red_quarter<DW>(out, acc_a, -1, 0, m0, chunks - 1, wg, in, h8, t);
    else red_quarter<DW>(out, acc_b, -1, 0, m0, chunks - 1, wg, in, h8, t);
  }
}

template <bool DW>
int launch(const void* x, const void* w, const void* labels, const void* lse, const void* g,
           void* out, int n, int h, int V, void* stream) {
  const uint64_t h8 = (h + 7) & ~7, V8 = (V + 7) & ~7;
  CUtensorMap a1, b1, g2;
  int e;
  if (DW) {
    e = dstt::encode_tma_2d(&a1, w, V8, h8, V8, 64);
    if (!e) e = dstt::encode_tma_2d(&b1, x, h8, n, h8, PASS);
    if (!e) e = dstt::encode_tma_2d(&g2, x, h8, n, h8, 64);
  } else {
    e = dstt::encode_tma_2d(&a1, x, h8, n, h8, TILE);
    if (!e) e = dstt::encode_tma_2d(&b1, w, V8, h8, V8, 64);
    if (!e) e = dstt::encode_tma_2d(&g2, w, V8, h8, V8, CHUNK);
  }
  if (!e) {
    e = (int)cudaFuncSetAttribute(ce_bwd_kernel<DW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SMEM);
  }
  if (e) return e;
  const int tiles = ((DW ? V : n) + TILE - 1) / TILE;
  const int spans = ((DW ? n : V) + SPAN - 1) / SPAN;
  const RowIn in{static_cast<const int*>(labels), static_cast<const float*>(lse),
                 static_cast<const float*>(g), n, V};
  ce_bwd_kernel<DW><<<tiles * spans, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      a1, b1, g2, in, static_cast<float*>(out), (int)h8, tiles, spans);
  return (int)cudaGetLastError();
}

}  // namespace

// x [n, h8], w [h8, V8] bf16 row-major with h8 = ceil(h / 8) * 8, V8 =
// ceil(V / 8) * 8 (zero-padded; bases 16-byte aligned); labels [n] int32;
// lse, g [n] fp32; dx32 [n, h8] fp32, zeroed by the caller, summed into.
extern "C" int dstt_fused_ce_dx(const void* x, const void* w, const void* labels, const void* lse,
                                const void* g, void* dx32, int n, int h, int V, void* stream) {
  return launch<false>(x, w, labels, lse, g, dx32, n, h, V, stream);
}

// the same inputs; dw32 [h8, V8] fp32, zeroed by the caller, summed into.
extern "C" int dstt_fused_ce_dw(const void* x, const void* w, const void* labels, const void* lse,
                                const void* g, void* dw32, int n, int h, int V, void* stream) {
  return launch<true>(x, w, labels, lse, g, dw32, n, h, V, stream);
}
