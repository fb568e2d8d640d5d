// Fused LM head + cross-entropy forward for Hopper (sm_90a), on wgmma fed
// by TMA.
//
// Replaces: deepspeed_tpu/ops/fused_ce.py::_fwd_kernel (the pallas_call of
// _ce_call). For x [n, h], w [h, V] (both bf16, row-major) and labels [n]:
//
//   logits = x w (fp32 sums), lse_i = logsumexp_v logits_iv,
//   loss_i = lse_i - logits_i[label_i]   (a label outside [0, V): no logit)
//
// The [n, V] logits never reach device memory. (The backward kernels, dx
// and dW, are fused_ce_bwd.cu's.)
//
// Bound: operations. 2 n h V FLOPs against x, w and the per-row outputs
// read or written once: ~480 FLOPs per byte at n = h = 4096, V = 32000,
// above the card's ridge.
//
// Design. The TPU grid walks (rows, vocabulary) in order and keeps each
// row's running (max, sum-exp, target) resident; CTAs here run in no order,
// so each owns a span and a second kernel merges the spans:
//
//  * A CTA owns 128 rows x a span of the vocabulary (a multiple of 256
//    columns), walked in passes of 256 by the logits pass that dx and dW
//    recompute (fused_ce_hopper.cuh): one producer thread, TMA boxes into a
//    four-stage ring of 48 KB stages (no resident d here, so the ring takes
//    192 KB), two consumer warpgroups of 64 rows under setmaxnreg, one
//    m64n256k16 per 16 of h. The logits are those of dx and dW bit for bit.
//  * Per pass, in registers: columns at or past V are set to -inf (the
//    padding to V8 and the ragged last pass included), the pass's max of a
//    row over its 4 lanes, m' = max(m, m_t), l = l 2^((m - m') log2 e) +
//    sum 2^(s log2 e - m' log2 e); m' is finite, since a pass holds at
//    least one live column, so exp(-inf + inf) never forms. The thread
//    whose column is a row's label writes that logit to tgt (one CTA per
//    row holds it).
//  * At the span's end, (m, l) per row into a [spans, n] fp32 partial
//    plane. ce_fwd_merge_kernel folds the spans of a row in span order:
//    lse = M + log(max(L, 1e-30)), loss = lse - tgt (0 for a label outside
//    [0, V)). No atomics: loss and lse repeat bit for bit from launch to
//    launch.
//  * The epilogue is drained, then reduced: the 128-float accumulator of a
//    thread leaves no room for a second, and the two consumers share each
//    stage, so neither can run ahead of the other by more than the ring.
//  * Grid: (row tile, span) pairs walked in groups of 8 row tiles, row
//    tiles fastest (as dx), so that the CTAs in flight share slabs of w in
//    L2.
//
// Tails: the wrapper pads x and w with zeros to row lengths that are
// multiples of 8 (TMA's 16-byte strides; ops/fused_ce.py pad8), which
// changes no sum; rows past n come as TMA zero fill and are never stored;
// w boxes wholly past the padded vocabulary are not loaded, and their
// columns are masked.
#include "common.cuh"
#include "fused_ce_hopper.cuh"
#include "hopper_common.cuh"

namespace {

using namespace dstt::hopper;
using namespace dstt::fused_ce;  // BK, TILE, PASS, the ring, the logits pass

constexpr int S = 4;  // stages of the ring
constexpr int SMEM = 1024 + S * LOGITS_STAGE + 256;  // 1024: alignment slack
static_assert(SMEM <= 232448, "shared memory");
constexpr float LOG2E = 1.4426950408889634f;

struct Ring : Barriers<S> {
  unsigned char* base;
  __device__ explicit Ring(unsigned char* b) : Barriers<S>(b + S * LOGITS_STAGE), base(b) {}
  __device__ unsigned char* slot(int it) const { return base + (it % S) * LOGITS_STAGE; }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// max and sum over the 4 lanes that share an accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

struct RowIO {
  const int* labels;  // [n]
  float* pm;          // [spans, n]: each span's max of a row
  float* pl;          // [spans, n]: its sum of exp(logit - max)
  float* tgt;         // [n]: the label's logit (written where the label is in [0, V))
  int n, V;
};

__global__ void __launch_bounds__(THREADS, 1)
ce_fwd_kernel(const __grid_constant__ CUtensorMap x_map,  // x {64, 128}
              const __grid_constant__ CUtensorMap w_map,  // w {64, 64}
              RowIO io, int h8, int tiles, int spans, int span) {
  extern __shared__ unsigned char smem_raw[];
  Ring ring(aligned_smem(smem_raw));
  const TileSpan ts(tiles, spans, span);
  const int m0 = ts.m0, k0 = ts.k0, V = io.V, V8 = (V + 7) & ~7;
  const int passes = cdiv(min(span, V - k0), PASS);
  const int ksteps = cdiv(h8, BK);
  auto slot = [&](int it) { return ring.slot(it); };

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      tma_prefetch_desc(&x_map);
      tma_prefetch_desc(&w_map);
      int it = 0;
      for (int p = 0; p < passes; ++p)
        load_logits_pass<false>(ring, slot, &x_map, &w_map, m0, k0 + p * PASS, V8, ksteps, it);
    }
  } else {
    setmaxnreg_inc<232>();  // 128 x 40 + 256 x 232 <= 65536
    const int t = threadIdx.x % 128, q = t & 3;
    // this thread's accumulator rows: row[0], row[1] = row[0] + 8
    const int row0 = m0 + 64 * wg + 16 * (t >> 5) + ((t & 31) >> 2);
    const int row[2] = {row0, row0 + 8};
    int label[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) label[u] = row[u] < io.n ? __ldg(io.labels + row[u]) : -1;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    Consumer<Ring> cons(ring);
    int it = 0;
    float acc[128];
    for (int p = 0; p < passes; ++p) {
      logits_pass<false>(acc, cons, slot, ksteps, it, wg);
      // element i: row[(i / 2) % 2], column cq + 8 (i / 4) + i % 2
      const int c0 = k0 + p * PASS, cq = c0 + 2 * q;
      // the label's logit: offsets from cq; the thread whose pair holds it
      int off[2];
      bool hit[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        off[u] = label[u] - cq;
        hit[u] = label[u] < V && off[u] >= 0 && off[u] < PASS && (off[u] & 7) < 2;
      }
      if (__any_sync(0xffffffffu, hit[0] || hit[1])) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float v = 0.f;
#pragma unroll
          for (int j = 0; j < PASS / 8; ++j) {
            const float a = (off[u] & 1) ? acc[4 * j + 2 * u + 1] : acc[4 * j + 2 * u];
            v = (off[u] >> 3) == j ? a : v;
          }
          if (hit[u]) io.tgt[row[u]] = v;
        }
      }
      if (c0 + PASS > V) {  // the vocabulary's last pass: mask columns at or past V
#pragma unroll
        for (int i = 0; i < 128; ++i) {
          if (cq + 8 * (i >> 2) + (i & 1) >= V) acc[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 128; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], acc[i]);
      float nb[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float mn = fmaxf(m[u], quad_max(mx[u]));  // finite: a live column
        l[u] *= ex2((m[u] - mn) * LOG2E);               // 0 at the first pass
        m[u] = mn;
        nb[u] = -mn * LOG2E;
      }
#pragma unroll
      for (int i = 0; i < 128; ++i) rs[(i >> 1) & 1] += ex2(fmaf(acc[i], LOG2E, nb[(i >> 1) & 1]));
      l[0] += rs[0];
      l[1] += rs[1];
    }
    const int64_t at = (int64_t)(k0 / span) * io.n;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float lsum = quad_sum(l[u]);
      if (q == 0 && row[u] < io.n) {
        io.pm[at + row[u]] = m[u];
        io.pl[at + row[u]] = lsum;
      }
    }
  }
}

// One thread a row: the spans' (max, sum) folded in span order.
__global__ void ce_fwd_merge_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
                                    const float* __restrict__ tgt, const int* __restrict__ labels,
                                    float* __restrict__ loss, float* __restrict__ lse, int n, int V,
                                    int spans) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float M = -INFINITY;
  for (int j = 0; j < spans; ++j) M = fmaxf(M, pm[(int64_t)j * n + row]);
  float L = 0.f;
  for (int j = 0; j < spans; ++j) L += pl[(int64_t)j * n + row] * expf(pm[(int64_t)j * n + row] - M);
  const float v = M + logf(fmaxf(L, 1e-30f));
  const int label = labels[row];
  lse[row] = v;
  loss[row] = v - ((label >= 0 && label < V) ? tgt[row] : 0.f);
}

}  // namespace

// x [n, h8], w [h8, V8] bf16 row-major with h8 = ceil(h / 8) * 8, V8 =
// ceil(V / 8) * 8 (zero-padded; bases 16-byte aligned); labels [n] int32;
// span: vocabulary columns of a CTA, a multiple of 256; pm, pl
// [ceil(V / span), n] fp32 scratch; tgt [n] fp32 scratch; loss, lse [n]
// fp32 out.
extern "C" int dstt_fused_ce_fwd(const void* x, const void* w, const void* labels, void* pm,
                                 void* pl, void* tgt, void* loss, void* lse, int n, int h, int V,
                                 int span, void* stream) {
  if (span <= 0 || span % PASS != 0) return (int)cudaErrorInvalidValue;
  const uint64_t h8 = (h + 7) & ~7, V8 = (V + 7) & ~7;
  CUtensorMap x_map, w_map;
  int e = dstt::encode_tma_2d(&x_map, x, h8, n, h8, TILE);
  if (!e) e = dstt::encode_tma_2d(&w_map, w, V8, h8, V8, 64);
  if (!e) {
    e = (int)cudaFuncSetAttribute(ce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  }
  if (e) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (n + TILE - 1) / TILE, spans = (V + span - 1) / span;
  const RowIO io{static_cast<const int*>(labels), static_cast<float*>(pm),
                 static_cast<float*>(pl), static_cast<float*>(tgt), n, V};
  ce_fwd_kernel<<<tiles * spans, THREADS, SMEM, st>>>(x_map, w_map, io, (int)h8, tiles, spans,
                                                       span);
  e = (int)cudaGetLastError();
  if (e) return e;
  ce_fwd_merge_kernel<<<(n + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(pm), static_cast<const float*>(pl),
      static_cast<const float*>(tgt), static_cast<const int*>(labels), static_cast<float*>(loss),
      static_cast<float*>(lse), n, V, spans);
  return (int)cudaGetLastError();
}
