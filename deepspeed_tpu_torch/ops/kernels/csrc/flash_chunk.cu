// Flash attention in carry mode for Hopper (sm_90a): the context-parallel
// ring's three chunk kernels, forward, dq and dk/dv.
//
// Replaces: deepspeed_tpu/ops/attention/flash_pallas.py::flash_fwd_chunk,
// ::flash_dq_chunk and ::flash_dkv_chunk (the Pallas bodies _fwd_kernel,
// _bwd_dq_kernel and _bwd_dkv_kernel run with carry refs). Each call folds
// one chunk into a carried raw state that the next ring hop continues:
//  * fwd: one visiting k/v chunk into the home queries' (m, l, acc);
//  * dq:  one visiting k/v chunk into the home queries' raw fp32 dq;
//  * dkv: one visiting q-side chunk (q, o, do, lse) into the home keys'
//    raw fp32 dk and dv, one carry per kv head (the GQA group summed in
//    the kernel, chunk by chunk).
// Carries: m, l [b, h, s] fp32 and acc/dq [b, h, s, d] fp32; dk, dv
// [b, h_kv, s, d] fp32; updated in place. ``flags``: LOAD reads the carry
// (else it is seeded as the single kernel seeds it: m = -inf, l = 0, acc
// = 0), FINAL writes the outputs instead of the raw carry, through the
// single kernels' own epilogues (flash_hopper.cuh's store_out: o / max(l,
// 1e-30) in bf16 and m + log(max(l, 1e-30)); flash_hopper_bwd.cuh's
// acc_store_bf16: dq * scale, dk * scale, dv in bf16).
//
// Bound: operations, as the single kernels (4, 6 and 8 * d FLOPs per
// visible pair), plus the carry: acc [s, d] and m, l read and written in
// fp32 per hop (about 2 x 4 bytes per element of a [s, d] head, small
// beside the pairs' work at chunks of thousands of rows).
//
// Design. Each kernel runs its single kernel's CTA body: the forward
// flash_hopper.cuh's (flash_fwd.cu), dq and dk/dv flash_hopper_bwd.cuh's
// (flash_bwd.cu): wgmma fed by TMA, the same tiles per d, pruning and
// visiting order, with the sums seeded from the carry (m, l per row; acc,
// dq, dk, dv in the wgmma accumulator layout, fp32, so nothing rounds
// between hops) and stored back to it. The ring hands chunks over in
// ascending global order (fwd and dq: keys 0 .. i, the diagonal last; dkv:
// queries i .. N-1, the diagonal first), and dk/dv walks query tiles outer
// and the GQA group's heads inner in both forms, so every accumulator sees
// the same tiles in the same order as in the single kernel and the results
// are its bits (dk/dv with GQA too) when the chunks are whole tiles of each
// (sharded.py). A non-diagonal chunk is called non-causal (every pair
// visible), the diagonal causal in local positions, so the tiles that run
// are the single kernel's. Segment ids come as two planes, the home
// chunk's and the visitor's.
#include "flash_hopper_bwd.cuh"

namespace {

using namespace dstt::flash;

constexpr int LOAD = 1;
constexpr int FINAL = 2;

// One chunk call: p.s is the chunk length of queries and keys alike,
// p.causal marks the diagonal chunk, p.seg is unused.
struct Chunk {
  Problem p;
  const int* seg_q;  // [b, s] query ids (the home chunk for fwd/dq) or null
  const int* seg_k;  // [b, s] key ids (the visitor for fwd/dq) or null
  int flags;
};

// ---------------------------------------------------------------------------
namespace fh = dstt::flash_hopper;

template <int D>
__global__ void __launch_bounds__(fh::THREADS, 1)
    flash_fwd_chunk_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, float* m_c, float* l_c,
                           float* acc_c, bf16* __restrict__ out, float* __restrict__ lse,
                           Chunk c) {
  extern __shared__ unsigned char smem_raw[];
  const Problem& p = c.p;
  const fh::Tile tile = fh::make_tile<fh::FwdTiles<D>::BQ>(p, c.seg_q, c.seg_k);
  const int64_t rows = (int64_t)tile.bh * p.s;
  fh::fwd_cta<D>(
      smem_raw, &qmap, &kmap, &vmap, p, tile,
      [&](auto& o, auto& m, auto& l, int row0, int row1, int tq) {
        if (c.flags & LOAD) {
          fh::carry_load<D>(o, m, l, m_c + rows, l_c + rows, acc_c + rows * D, row0, row1, p.s,
                            tq);
        } else {
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
          m[0] = m[1] = -INFINITY;
          l[0] = l[1] = 0.f;
        }
      },
      [&](const auto& o, const auto& m, const auto& l, int row0, int row1, int tq) {
        if (c.flags & FINAL) {
          fh::store_out<D>(out + rows * D, lse + rows, o, m, l, row0, row1, p.s, tq);
        } else {
          fh::carry_store<D>(m_c + rows, l_c + rows, acc_c + rows * D, o, m, l, row0, row1, p.s,
                             tq);
        }
      });
}

// ---------------------------------------------------------------------------
// maps: q, dO, k, v (fh::encode_dq_maps)
template <int D>
__global__ void __launch_bounds__(fh::THREADS, 1)
    flash_dq_chunk_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap domap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ o,
                          const bf16* __restrict__ dout, const float* __restrict__ lse,
                          float* dq_c, bf16* __restrict__ dq, Chunk c) {
  extern __shared__ unsigned char smem_raw[];
  const Problem& p = c.p;
  const CUtensorMap* maps[4] = {&qmap, &domap, &kmap, &vmap};
  const fh::Tile tile = fh::make_tile<fh::BwdTiles<D>::BQ>(p, c.seg_q, c.seg_k);
  const int64_t head = (int64_t)tile.bh * p.s;
  fh::dq_cta<D>(
      smem_raw, maps, p, tile, o + head * D, dout + head * D, lse + head,
      [&](auto& acc, int row0, int row1, int tq) {
        const int64_t at = (int64_t)blockIdx.x * p.s * D;  // the CTA's (batch, head)
        if (c.flags & LOAD) fh::acc_load<D>(acc, dq_c + at, row0, row1, p.s, 0, D, tq);
        else fh::acc_zero(acc);
      },
      [&](const auto& acc, int row0, int row1, int tq) {
        const int64_t at = (int64_t)blockIdx.x * p.s * D;
        if (c.flags & FINAL) {
          fh::acc_store_bf16<D>(dq + at, acc, p.scale, row0, row1, p.s, 0, D, tq);
        } else {
          fh::acc_store<D>(dq_c + at, acc, row0, row1, p.s, 0, D, tq);
        }
      });
}

// ---------------------------------------------------------------------------
// maps: k, v, q, dO, o (fh::encode_dkv_maps)
template <int D>
__global__ void __launch_bounds__(fh::THREADS, 1)
    flash_dkv_chunk_kernel(const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap domap,
                           const __grid_constant__ CUtensorMap omap, const float* __restrict__ lse,
                           float* dk_c, float* dv_c, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, Chunk c) {
  extern __shared__ unsigned char smem_raw[];
  const Problem& p = c.p;
  const CUtensorMap* maps[5] = {&kmap, &vmap, &qmap, &domap, &omap};
  const fh::KvTile kt = fh::make_kv_tile<D>(p, c.seg_q, c.seg_k);
  fh::dkv_cta<D>(
      smem_raw, maps, p, kt, lse,
      [&](auto& dka, auto& dva, int key0, int key1, int c0, int tq) {
        constexpr int DC = 2 * (int)(sizeof(dka) / sizeof(float));
        const int64_t at = (int64_t)blockIdx.x * p.s * D;  // the CTA's (batch, kv head)
        if (c.flags & LOAD) {
          fh::acc_load<DC>(dka, dk_c + at, key0, key1, p.s, c0, D, tq);
          fh::acc_load<DC>(dva, dv_c + at, key0, key1, p.s, c0, D, tq);
        } else {
          fh::acc_zero(dka);
          fh::acc_zero(dva);
        }
      },
      [&](const auto& dka, const auto& dva, int key0, int key1, int c0, int tq) {
        constexpr int DC = 2 * (int)(sizeof(dka) / sizeof(float));
        const int64_t at = (int64_t)blockIdx.x * p.s * D;
        if (c.flags & FINAL) {
          fh::acc_store_bf16<DC>(dk + at, dka, p.scale, key0, key1, p.s, c0, D, tq);
          fh::acc_store_bf16<DC>(dv + at, dva, 1.f, key0, key1, p.s, c0, D, tq);
        } else {
          fh::acc_store<DC>(dk_c + at, dka, key0, key1, p.s, c0, D, tq);
          fh::acc_store<DC>(dv_c + at, dva, key0, key1, p.s, c0, D, tq);
        }
      });
}

// ---------------------------------------------------------------------------
Chunk make_chunk(int b, int h, int h_kv, int s, float scale, int causal, const void* seg_q,
                 const void* seg_k, int flags) {
  Chunk c;
  c.p.b = b;
  c.p.h = h;
  c.p.h_kv = h_kv;
  c.p.s = s;
  c.p.scale = scale;
  c.p.causal = causal;
  c.p.window = 0;
  c.p.seg = nullptr;
  c.seg_q = static_cast<const int*>(seg_q);
  c.seg_k = static_cast<const int*>(seg_k);
  c.flags = flags;
  return c;
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* m, void* l, void* acc,
               void* out, void* lse, const Chunk& c, cudaStream_t stream) {
  CUtensorMap maps[3];
  if (int e = fh::encode_maps<D>(maps, q, k, v, c.p)) return e;
  constexpr int bytes = fh::Smem<D>::BYTES;
  static size_t have = 0;
  if (int e = set_max_smem(flash_fwd_chunk_kernel<D>, bytes, have)) return e;
  constexpr int BQF = fh::FwdTiles<D>::BQ;
  const dim3 grid((unsigned)(c.p.b * c.p.h), (unsigned)((c.p.s + BQF - 1) / BQF));
  flash_fwd_chunk_kernel<D><<<grid, fh::THREADS, bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(acc), static_cast<bf16*>(out), static_cast<float*>(lse), c);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const void* lse, void* dq_c, void* dq, const Chunk& c, cudaStream_t stream) {
  CUtensorMap maps[4];
  if (int e = fh::encode_dq_maps<D>(maps, q, dout, k, v, c.p)) return e;
  constexpr int bytes = fh::DqSmem<D>::BYTES;
  static size_t have = 0;
  if (int e = set_max_smem(flash_dq_chunk_kernel<D>, bytes, have)) return e;
  flash_dq_chunk_kernel<D><<<fh::dq_grid<D>(c.p), fh::THREADS, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<float*>(dq_c),
      static_cast<bf16*>(dq), c);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* dk_c, void* dv_c, void* dk, void* dv, const Chunk& c,
               cudaStream_t stream) {
  CUtensorMap maps[5];
  if (int e = fh::encode_dkv_maps<D>(maps, q, dout, o, k, v, c.p)) return e;
  constexpr int bytes = fh::DkvSmem<D>::BYTES;
  static size_t have = 0;
  if (int e = set_max_smem(flash_dkv_chunk_kernel<D>, bytes, have)) return e;
  flash_dkv_chunk_kernel<D><<<fh::dkv_grid<D>(c.p), fh::THREADS, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<const float*>(lse),
      static_cast<float*>(dk_c), static_cast<float*>(dv_c), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), c);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [b, h, s, d], k/v: [b, h_kv, s, d] bf16 (s: the chunk length, the same
// for both); seg_q/seg_k [b, s] int32, both or neither; m, l [b, h, s] and
// acc [b, h, s, d] fp32, read under LOAD (flags & 1) and written unless
// FINAL (flags & 2); out [b, h, s, d] bf16 and lse [b, h, s] fp32 written
// under FINAL. causal: the diagonal chunk. All contiguous, 16-byte aligned;
// d in {64, 128, 256}; scale > 0. Returns cudaGetLastError().
extern "C" int dstt_flash_fwd_chunk(const void* q, const void* k, const void* v,
                                    const void* seg_q, const void* seg_k, void* m, void* l,
                                    void* acc, void* out, void* lse, int b, int h, int h_kv,
                                    int s, int d, float scale, int causal, int flags,
                                    void* stream) {
  if (!(scale > 0.f)) return (int)cudaErrorInvalidValue;
  const Chunk c = make_chunk(b, h, h_kv, s, scale, causal, seg_q, seg_k, flags);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_fwd<64>(q, k, v, m, l, acc, out, lse, c, st);
    case 128: return launch_fwd<128>(q, k, v, m, l, acc, out, lse, c, st);
    case 256: return launch_fwd<256>(q, k, v, m, l, acc, out, lse, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// o, do [b, h, s, d] bf16 and lse [b, h, s] fp32 of the home queries (the
// final forward's); dq_c [b, h, s, d] fp32 (raw, unscaled) read under LOAD,
// written unless FINAL; dq [b, h, s, d] bf16 written under FINAL.
extern "C" int dstt_flash_dq_chunk(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, const void* seg_q,
                                   const void* seg_k, void* dq_c, void* dq, int b, int h,
                                   int h_kv, int s, int d, float scale, int causal, int flags,
                                   void* stream) {
  const Chunk c = make_chunk(b, h, h_kv, s, scale, causal, seg_q, seg_k, flags);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dq<64>(q, k, v, o, dout, lse, dq_c, dq, c, st);
    case 128: return launch_dq<128>(q, k, v, o, dout, lse, dq_c, dq, c, st);
    case 256: return launch_dq<256>(q, k, v, o, dout, lse, dq_c, dq, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q, o, do, lse, seg_q: the visiting chunk's; k, v, seg_k: the home chunk's;
// dk_c, dv_c [b, h_kv, s, d] fp32 (raw, unscaled, each summed over the kv
// head's group) read under LOAD, written unless FINAL; dk, dv [b, h_kv, s,
// d] bf16 written under FINAL.
extern "C" int dstt_flash_dkv_chunk(const void* q, const void* k, const void* v, const void* o,
                                    const void* dout, const void* lse, const void* seg_q,
                                    const void* seg_k, void* dk_c, void* dv_c, void* dk,
                                    void* dv, int b, int h, int h_kv, int s, int d, float scale,
                                    int causal, int flags, void* stream) {
  const Chunk c = make_chunk(b, h, h_kv, s, scale, causal, seg_q, seg_k, flags);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dkv<64>(q, k, v, o, dout, lse, dk_c, dv_c, dk, dv, c, st);
    case 128: return launch_dkv<128>(q, k, v, o, dout, lse, dk_c, dv_c, dk, dv, c, st);
    case 256: return launch_dkv<256>(q, k, v, o, dout, lse, dk_c, dv_c, dk, dv, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
