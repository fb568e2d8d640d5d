// The fused LM head's logits pass on wgmma fed by TMA, shared by the
// forward (fused_ce.cu) and the backward's dx and dW kernels
// (fused_ce_bwd.cu), so that the logits the forward reduces to lse are, bit
// for bit, the logits dx and dW recompute from it.
//
// A CTA owns a TILE of 128 and walks passes of PASS = 256 columns of the
// other side; a pass contracts over h in 64-deep steps, one ring stage a
// step:
//
//   forward and dx: acc[128 rows x 256 v]  = x (A, K-major) . w (B, MN-major)
//                   stage: an x box {64 h, 128 rows} and up to four w boxes
//                   {64 v, 64 h}
//   dW:             acc[128 v x 256 rows]  = w^T (A, MN-major) . x^T (B, K-major)
//                   stage: up to two w boxes {64 v, 64 h} and an x box
//                   {64 h, 256 rows}
//
// Each consumer warpgroup (of two) owns 64 of the 128 and issues one
// m64n256k16 per 16 of h; one producer thread keeps TMA loads in flight.
// Boxes wholly past the padded vocabulary are not loaded: the caller masks
// their columns (their shared memory holds an older stage's bytes, or
// nothing written yet).
//
// The ring: full / empty mbarriers per stage, load `it` in stage it % S.
// Where a stage lies is the caller's (the backward puts its third stage in
// its resident d), so the pass functions take a `slot(it)` callable.
#pragma once

#include "hopper_common.cuh"

namespace dstt {
namespace fused_ce {

using namespace dstt::hopper;

constexpr int BK = 64;           // a TMA box's inner width: 64 bf16 = 128 bytes
constexpr int BOX64 = 64 * 128;  // bytes of a [64 x 64] box
constexpr int TILE = 128;        // the CTA's M: rows (forward, dx), vocabulary columns (dW)
constexpr int PASS = 256;        // columns of a logits pass (N of m64n256k16)
constexpr int LOGITS_STAGE = 48 * 1024;  // the boxes of one 64-deep h step
constexpr int THREADS = 384;     // consumers: warpgroups 0-1; producer: warpgroup 2
constexpr int GROUP = 8;         // tiles walked together

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~uintptr_t(1023));
}

// (tile, span) of this CTA: groups of GROUP tiles, tiles fastest, so that
// the CTAs in flight share their tiles' slabs (and the span's) in L2
struct TileSpan {
  int m0, k0;
  __device__ TileSpan(int tiles, int spans, int span) {
    const int per_group = GROUP * spans;
    const int grp = blockIdx.x / per_group;
    const int local = blockIdx.x - grp * per_group;
    const int in_group = min(GROUP, tiles - grp * GROUP);
    m0 = (grp * GROUP + local % in_group) * TILE;
    k0 = (local / in_group) * span;
  }
};

// full / empty mbarriers of an S-stage ring
template <int S>
struct Barriers {
  static constexpr int STAGES = S;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit Barriers(void* at) {
    full = reinterpret_cast<uint64_t*>(at);
    empty = full + S;
  }
  __device__ void init() {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread releases
    }
    mbar_init_fence();
  }
  // producer: wait until stage it % S is free, announce `bytes`
  __device__ void acquire(int it, uint32_t bytes) {
    mbar_wait(&empty[it % S], ((it / S) & 1) ^ 1);
    mbar_arrive_expect_tx(&full[it % S], bytes);
  }
  // producer: wait until loads it - S .. it - 1 are all released
  __device__ void wait_released(int it) {
    for (int i = it; i < it + S; ++i) mbar_wait(&empty[i % S], ((i / S) & 1) ^ 1);
  }
  // consumer: wait until load `it` has landed
  __device__ void ready(int it) { mbar_wait(&full[it % S], (it / S) & 1); }
  __device__ void release(int it) { mbar_arrive(&empty[it % S]); }
};

// A consumer's in-flight bookkeeping: the wgmma group of step `it` is
// committed; the one before it is waited for and its stage released, so
// one group stays in flight while the next stage is awaited.
template <class Ring>
struct Consumer {
  Ring& ring;
  int held = -1;
  __device__ explicit Consumer(Ring& r) : ring(r) {}
  __device__ void step_done(int it) {
    wgmma_commit();
    wgmma_wait<1>();
    if (held >= 0) ring.release(held);
    held = it;
  }
  __device__ void drain() {
    wgmma_wait<0>();
    if (held >= 0) ring.release(held);
    held = -1;
  }
};

// Producer (one thread): the loads of one pass, ksteps stages from load
// `it` on. m0: the tile's first row (forward, dx) or vocabulary column
// (dW); c0: the pass's first column (vocabulary, or rows for dW); V8: the
// padded vocabulary. a1 / b1: forward and dx x {64, 128} / w {64, 64};
// dW w {64, 64} / x {64, 256}.
template <bool DW, class Ring, class Slot>
__device__ __forceinline__ void load_logits_pass(Ring& ring, Slot slot, const CUtensorMap* a1,
                                                 const CUtensorMap* b1, int m0, int c0, int V8,
                                                 int ksteps, int& it) {
  const int vboxes = DW ? min(2, cdiv(V8 - m0, BK)) : min(4, cdiv(V8 - c0, BK));
  for (int k = 0; k < ksteps; ++k, ++it) {
    uint64_t* bar = &ring.full[it % Ring::STAGES];
    unsigned char* st = slot(it);
    if constexpr (DW) {
      ring.acquire(it, vboxes * BOX64 + PASS * 128);
      for (int j = 0; j < vboxes; ++j) tma_load_2d(st + j * BOX64, a1, bar, m0 + j * BK, k * BK);
      tma_load_2d(st + 2 * BOX64, b1, bar, k * BK, c0);
    } else {
      ring.acquire(it, TILE * 128 + vboxes * BOX64);
      tma_load_2d(st, a1, bar, k * BK, m0);
      for (int j = 0; j < vboxes; ++j)
        tma_load_2d(st + 2 * BOX64 + j * BOX64, b1, bar, c0 + j * BK, k * BK);
    }
  }
}

// Consumer warpgroup wg: acc = its 64 x 256 of the pass's logits, from the
// ksteps stages from load `it` on; returns with every product done (a wait
// for all groups, then the accumulator fence: the caller may read acc) and
// every stage released.
template <bool DW, class Ring, class Slot>
__device__ __forceinline__ void logits_pass(float (&acc)[128], Consumer<Ring>& cons, Slot slot,
                                            int ksteps, int& it, int wg) {
  for (int k = 0; k < ksteps; ++k, ++it) {
    cons.ring.ready(it);
    const unsigned char* st = slot(it);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (DW) {
        const uint64_t a = desc_b128(st + wg * BOX64 + kk * 2048, BOX64, 1024);
        const uint64_t b = desc_b128(st + 2 * BOX64 + kk * 32, 16, 1024);
        wgmma_m64n256k16<1, 0>(acc, a, b, (k | kk) != 0);
      } else {
        const uint64_t a = desc_b128(st + wg * BOX64 + kk * 32, 16, 1024);
        const uint64_t b = desc_b128(st + 2 * BOX64 + kk * 2048, BOX64, 1024);
        wgmma_m64n256k16<0, 1>(acc, a, b, (k | kk) != 0);
      }
    }
    cons.step_done(it);
  }
  cons.drain();
  fence_acc(acc);
}

}  // namespace fused_ce
}  // namespace dstt
