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
// 1e-30) in bf16 and m + log(max(l, 1e-30)); store_rows: dq * scale, dk *
// scale, dv in bf16).
//
// Bound: operations, as the single kernels (4, 6 and 8 * d FLOPs per
// visible pair), plus the carry: acc [s, d] and m, l read and written in
// fp32 per hop (about 2 x 4 bytes per element of a [s, d] head, small
// beside the pairs' work at chunks of thousands of rows).
//
// Design. The forward runs flash_hopper.cuh's CTA body, the single
// forward's (flash_fwd.cu): wgmma fed by TMA, 128-query tiles, key tiles
// of FwdTiles<d>::BK, the same pruning and visiting order, with the state
// seeded from the carry (m, l per row; acc in the wgmma accumulator
// layout, fp32, so nothing rounds between hops) and stored back to it.
// dq and dk/dv are the single backward kernels' CTAs (flash_bwd.cu: 4
// warps, 64-row tiles, mma.sync, flash_common.cuh's dq_tile / dkv_tile and
// the same tile ranges, pruning and visiting order), with the accumulators
// loaded from and stored to the carry in their fragment layout. The ring
// hands chunks over in ascending global order (fwd and dq: keys 0 .. i,
// the diagonal last; dkv: queries i .. N-1, the diagonal first), so every
// accumulator sees the same tiles in the same order as in the single
// kernel and the results are its bits, for dk/dv when h == h_kv, when the
// chunks are whole tiles of each (sharded.py). With GQA the single dk/dv
// kernel sums group head by group head over the whole sequence; the ring
// sums chunk by chunk, group inside, which rounds differently. A
// non-diagonal chunk is called non-causal (every pair visible), the
// diagonal causal in local positions, so the tiles that run are the single
// kernel's. Segment ids come as two planes, the home chunk's and the
// visitor's.
#include "flash_common.cuh"
#include "flash_hopper.cuh"

namespace {

using namespace dstt::flash;

constexpr int BQ = TILE;
constexpr int BK = TILE;
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

template <int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(bf16) * (2 * BQ + 2 * BK) * (D + PAD_H) +
         sizeof(float) * 2 * BQ + sizeof(int) * (BQ + BK + 2);
}

// The lane's rows row0 / row1 of an fp32 [s, D] carry, columns c0 .. c0 +
// DC, into C-tile accumulators (zeros past s) and back.
template <int D, int DC>
__device__ __forceinline__ void carry_load(float (&acc)[DC / 8][4], const float* base, int row0,
                                           int row1, int s, int c0, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) {
    const int c = c0 + j * 8 + 2 * t;
    const float2 a = row0 < s ? *reinterpret_cast<const float2*>(base + (int64_t)row0 * D + c)
                              : make_float2(0.f, 0.f);
    const float2 b = row1 < s ? *reinterpret_cast<const float2*>(base + (int64_t)row1 * D + c)
                              : make_float2(0.f, 0.f);
    acc[j][0] = a.x;
    acc[j][1] = a.y;
    acc[j][2] = b.x;
    acc[j][3] = b.y;
  }
}

template <int D, int DC>
__device__ __forceinline__ void carry_store(float* base, const float (&acc)[DC / 8][4], int row0,
                                            int row1, int s, int c0, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) {
    const int c = c0 + j * 8 + 2 * t;
    if (row0 < s)
      *reinterpret_cast<float2*>(base + (int64_t)row0 * D + c) = make_float2(acc[j][0], acc[j][1]);
    if (row1 < s)
      *reinterpret_cast<float2*>(base + (int64_t)row1 * D + c) = make_float2(acc[j][2], acc[j][3]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// The ids of a 64-row tile of one plane into shared memory and their
// [min, max] into range (when seg is set); ends with a barrier.
__device__ __forceinline__ void tile_ids(const int* seg, int r0, int s, int* ids, int* range) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    range[0] = 0x7fffffff;
    range[1] = -0x7fffffff - 1;
  }
  __syncthreads();
  if (seg && tid < TILE && r0 + tid < s) {
    const int sv = seg[r0 + tid];
    ids[tid] = sv;
    atomicMin(&range[0], sv);
    atomicMax(&range[1], sv);
  }
  __syncthreads();
}

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
  const fh::Tile tile = fh::make_tile<D>(p, c.seg_q, c.seg_k);
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
template <int D>
__global__ void __launch_bounds__(NTHREADS) flash_dq_chunk_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    float* dq_c, bf16* __restrict__ dq, Chunk c) {
  constexpr int LD = D + PAD_H;
  const Problem& p = c.p;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BQ * LD;
  bf16* Ks = dOs + BQ * LD;
  bf16* Vs = Ks + BK * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + BK * LD);
  float* delta_s = lse_s + BQ;
  int* segq = reinterpret_cast<int*>(delta_s + BQ);
  int* segk = segq + BQ;
  int* qrange = segk + BK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const int q0 = heavy_first_query_tile(p, gridDim.y) * BQ;
  const int bh = blockIdx.x;
  const int bi = bh / p.h, hi = bh % p.h;
  const int kvh = hi / (p.h / p.h_kv);
  const int64_t qoff = (int64_t)bh * p.s * D;
  const bf16* kb = k + ((int64_t)bi * p.h_kv + kvh) * p.s * D;
  const bf16* vb = v + ((int64_t)bi * p.h_kv + kvh) * p.s * D;
  const int* sq = c.seg_q ? c.seg_q + (int64_t)bi * p.s : nullptr;
  const int* sk = c.seg_k ? c.seg_k + (int64_t)bi * p.s : nullptr;
  const bool seg = sq != nullptr;

  load_tile<BQ, D>(Qs, q + qoff, q0, p.s);
  load_tile<BQ, D>(dOs, dout + qoff, q0, p.s);
  if (tid < BQ) lse_s[tid] = q0 + tid < p.s ? lse[(int64_t)bh * p.s + q0 + tid] : 0.f;
  tile_ids(sq, q0, p.s, segq, qrange);
  row_delta<D>(dOs, o + qoff, q0, p.s, delta_s);
  __syncthreads();
  const int qmin = qrange[0], qmax = qrange[1];

  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;
  const int row0 = q0 + lr0, row1 = q0 + lr1;
  const int sr0 = (seg && row0 < p.s) ? segq[lr0] : 0;
  const int sr1 = (seg && row1 < p.s) ? segq[lr1] : 0;
  const float lse_r[2] = {lse_s[lr0], lse_s[lr1]};
  const float del_r[2] = {delta_s[lr0], delta_s[lr1]};

  float acc[D / 8][4];
  if (c.flags & LOAD) {
    carry_load<D, D>(acc, dq_c + qoff, row0, row1, p.s, 0, lane);
  } else {
    zero(acc);
  }

  int lo, hi_k;
  key_tiles<BQ, BK>(p, q0, lo, hi_k);
  for (int k0 = lo; k0 < hi_k; k0 += BK) {
    int mine = 1, sv = 0;
    if (seg) {
      mine = 0;
      if (tid < BK && k0 + tid < p.s) {
        sv = sk[k0 + tid];
        mine = sv >= qmin && sv <= qmax;
      }
    }
    if (!__syncthreads_or(mine)) continue;
    if (seg && tid < BK) segk[tid] = sv;
    load_tile<BK, D>(Ks, kb, k0, p.s);
    load_tile<BK, D>(Vs, vb, k0, p.s);
    __syncthreads();

    dq_tile<D>(acc, Qs, dOs, Ks, Vs, p.scale, lse_r, del_r, [&](int col, bool upper) {
      const bool ok = visible(p, upper ? row0 : row1, k0 + col);
      return seg ? ok && segk[col] == (upper ? sr0 : sr1) : ok;
    }, warp, lane);
  }
  if (c.flags & FINAL) {
    store_rows<D, D>(dq + qoff, acc, p.scale, row0, row1, p.s, 0, lane);
  } else {
    carry_store<D, D>(dq_c + qoff, acc, row0, row1, p.s, 0, lane);
  }
}

// ---------------------------------------------------------------------------
template <int D, int DC>
__global__ void __launch_bounds__(NTHREADS) flash_dkv_chunk_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    float* dk_c, float* dv_c, bf16* __restrict__ dk, bf16* __restrict__ dv, Chunk c) {
  constexpr int LD = D + PAD_H;
  const Problem& p = c.p;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BQ * LD;
  bf16* Ks = dOs + BQ * LD;
  bf16* Vs = Ks + BK * LD;
  float* lse_s = reinterpret_cast<float*>(Vs + BK * LD);
  float* delta_s = lse_s + BQ;
  int* segq = reinterpret_cast<int*>(delta_s + BQ);
  int* segk = segq + BQ;
  int* krange = segk + BK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2;
  const int k0 = blockIdx.y * BK;
  const int bkv = blockIdx.x;
  const int bi = bkv / p.h_kv, kvh = bkv % p.h_kv;
  const int group = p.h / p.h_kv;
  const int64_t kvoff = (int64_t)bkv * p.s * D;
  const int* sq = c.seg_q ? c.seg_q + (int64_t)bi * p.s : nullptr;  // the visitor's
  const int* sk = c.seg_k ? c.seg_k + (int64_t)bi * p.s : nullptr;  // the home keys'
  const bool seg = sq != nullptr;

  load_tile<BK, D>(Ks, k + kvoff, k0, p.s);
  load_tile<BK, D>(Vs, v + kvoff, k0, p.s);
  tile_ids(sk, k0, p.s, segk, krange);
  const int kmin = krange[0], kmax = krange[1];

  const int lk0 = warp * 16 + g, lk1 = lk0 + 8;
  const int key0 = k0 + lk0, key1 = k0 + lk1;
  const int sk0 = (seg && key0 < p.s) ? segk[lk0] : 0;
  const int sk1 = (seg && key1 < p.s) ? segk[lk1] : 0;

  int lo, hi_q;
  query_tiles<BQ, BK>(p, k0, lo, hi_q);
  for (int c0 = 0; c0 < D; c0 += DC) {
    float dka[DC / 8][4], dva[DC / 8][4];
    if (c.flags & LOAD) {
      carry_load<D, DC>(dka, dk_c + kvoff, key0, key1, p.s, c0, lane);
      carry_load<D, DC>(dva, dv_c + kvoff, key0, key1, p.s, c0, lane);
    } else {
      zero(dka);
      zero(dva);
    }
    for (int gq = 0; gq < group; ++gq) {
      const int64_t qoff = ((int64_t)bi * p.h + kvh * group + gq) * p.s * D;
      const float* lseb = lse + ((int64_t)bi * p.h + kvh * group + gq) * p.s;
      for (int q0 = lo; q0 < hi_q; q0 += BQ) {
        int mine = 1, sv = 0;
        if (seg) {
          mine = 0;
          if (tid < BQ && q0 + tid < p.s) {
            sv = sq[q0 + tid];
            mine = sv >= kmin && sv <= kmax;
          }
        }
        if (!__syncthreads_or(mine)) continue;
        if (seg && tid < BQ) segq[tid] = sv;
        load_tile<BQ, D>(Qs, q + qoff, q0, p.s);
        load_tile<BQ, D>(dOs, dout + qoff, q0, p.s);
        if (tid < BQ) lse_s[tid] = q0 + tid < p.s ? lseb[q0 + tid] : 0.f;
        __syncthreads();
        row_delta<D>(dOs, o + qoff, q0, p.s, delta_s);
        __syncthreads();

        dkv_tile<D, DC>(dka, dva, Ks, Vs, Qs, dOs, lse_s, delta_s, p.scale,
                        [&](int col, bool upper) {
                          const bool ok = visible(p, q0 + col, upper ? key0 : key1);
                          return seg ? ok && segq[col] == (upper ? sk0 : sk1) : ok;
                        }, c0, warp, lane);
      }
    }
    if (c.flags & FINAL) {
      store_rows<D, DC>(dk + kvoff, dka, p.scale, key0, key1, p.s, c0, lane);
      store_rows<D, DC>(dv + kvoff, dva, 1.f, key0, key1, p.s, c0, lane);
    } else {
      carry_store<D, DC>(dk_c + kvoff, dka, key0, key1, p.s, c0, lane);
      carry_store<D, DC>(dv_c + kvoff, dva, key0, key1, p.s, c0, lane);
    }
  }
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
  const size_t bytes = bwd_smem_bytes<D>();
  static size_t have = 0;
  if (int e = set_max_smem(flash_dq_chunk_kernel<D>, bytes, have)) return e;
  const dim3 grid((unsigned)(c.p.b * c.p.h), (unsigned)((c.p.s + BQ - 1) / BQ));
  flash_dq_chunk_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(dq_c), static_cast<bf16*>(dq), c);
  return (int)cudaGetLastError();
}

template <int D, int DC>
int launch_dkv(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* dk_c, void* dv_c, void* dk, void* dv, const Chunk& c,
               cudaStream_t stream) {
  const size_t bytes = bwd_smem_bytes<D>();
  static size_t have = 0;
  if (int e = set_max_smem(flash_dkv_chunk_kernel<D, DC>, bytes, have)) return e;
  const dim3 grid((unsigned)(c.p.b * c.p.h_kv), (unsigned)((c.p.s + BK - 1) / BK));
  flash_dkv_chunk_kernel<D, DC><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(dk_c), static_cast<float*>(dv_c),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), c);
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
    case 64: return launch_dkv<64, 64>(q, k, v, o, dout, lse, dk_c, dv_c, dk, dv, c, st);
    case 128: return launch_dkv<128, 128>(q, k, v, o, dout, lse, dk_c, dv_c, dk, dv, c, st);
    case 256: return launch_dkv<256, 128>(q, k, v, o, dout, lse, dk_c, dv_c, dk, dv, c, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
