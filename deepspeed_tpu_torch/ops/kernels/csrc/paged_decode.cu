// Paged decode attention for Hopper (sm_90a): split-key decoding over an
// asynchronous copy ring.
//
// Replaces: deepspeed_tpu/ops/attention/paged_pallas.py::_paged_kernel
// (pallas_call in paged_attention): one query token per row attends over
// its block table into a flat multi-layer K/V pool [NBt, bs, nkv, d], plus
// E "extra" columns of not-yet-cached K/V [T, E, nkv, d], with an fp32
// softmax. Semantics kept exactly:
//   * pool key at position kpos is valid iff its block is not the trash id
//     and, with a pool limit, kpos < limit[t] && qpos >= 0, without one,
//     kpos <= qpos; with a window, also qpos - kpos < window;
//   * extra column e is valid iff epos >= 0 && epos <= qpos (and in window);
//   * q is scaled in fp32 (scale, else d^-0.5): on the fp32 path q itself,
//     on the bf16 tensor-core path the fp32 score (q enters the product
//     unscaled, as an int8 key's scale already multiplies its score), which
//     is the same up to fp32 rounding;
//   * GQA: query head h reads kv head h / (nh / nkv);
//   * a row with no valid key emits exactly 0;
//   * an int8 pool (dstt_paged_decode_int8) carries fp32 scale planes
//     [NBt, bs, nkv], one scalar per (token, kv head): the K scale
//     multiplies the key's score, the V scale its probability before P @ V,
//     and the softmax sum takes the probability unscaled. The extras stay in
//     q's dtype;
//   * pool offsets are 64-bit: the flat pool at Mistral-7B width holds more
//     than 2^31 elements.
//
// Bound: memory. Per row and kv head the kernel reads the valid keys' K and
// V once (2 * d * bytes each, plus two 4-byte scales for an int8 pool) and
// does 4 * group * d FLOPs per key: ~4 FLOP/byte in bf16 at group 4, far
// below the ~295 FLOP/byte ridge. The least time is the valid K/V bytes
// over HBM bandwidth.
//
// Design. The TPU kernel walks a (T, B + 1) grid in order and carries m, l
// and acc in scratch from block to block; on Hopper that sequential axis
// became one CTA's serial walk over a row's whole key range. Here the key
// axis is split across CTAs and the splits are merged:
//   * grid (row, kv head x chunk of <= 16 query heads, key split). A row's
//     valid pool range [lo, hi) (limit or causal bound, window) is cut into
//     pool splits of `split_keys` keys starting at lo; the E extras form
//     their own splits of the same size. The wrapper sizes split_keys
//     (a multiple of the tile, at least two tiles) so that the grid is
//     about two waves of CTAs (paged.decode_splits: at the serve round's
//     shape 2 pool splits of 320 keys and 1 extras split; more, shorter
//     splits measured slower, each CTA having a fixed cost). A split outside
//     [lo, hi), on trash blocks only, or over invalid extras only, writes
//     an empty state (m = -1e30, l = 0) and exits before copying a key;
//   * each split walks its keys in tiles of KT (64; 32 at d 256) through a
//     2-stage ring of cp.async.cg 16-byte copies (the gather is per key:
//     a key row is d contiguous elements, nkv * d apart in the pool); the
//     next tile's copies are issued before the current tile's wait, so they
//     fly while the current tile is scored. A thread looks up the sources
//     of all its keys of a tile first (independent loads), then issues
//     their copies; the queries come by cp.async beside the split's
//     emptiness check. Masked or out-of-range keys are zero-filled by the
//     copy itself (src-size 0) and never read from device memory. The int8
//     scale planes (4 bytes per key) come by 4-byte cp.async beside their
//     rows;
//   * warp w owns keys 16w .. 16w + 15 of each tile and keeps its own
//     online-softmax state (m, l, acc) for the group's query heads as the
//     16 rows of an mma tile (4 of 16 used at group 4): no barrier between
//     warps inside a tile. bf16: S = Q K^T and O += P V on mma.sync
//     m16n8k16 (fp32 accumulate), K and V fragments by ldmatrix from rows
//     padded by 16 bytes, P rounded to bf16 straight from the S
//     accumulators (as the flash kernels round it). int8 pools: each lane
//     reads its codes with 16-byte shared loads in a permuted order (the
//     head dim of Q and K permuted alike for the scores, V's columns for P
//     V, undone when O is stored) and converts them exactly to bf16 in
//     registers (byte permutes into an fp32 mantissa, one subtraction);
//     fp32 (q and extras fp32, pool fp32 or int8) runs the same fragment
//     layout on FFMA, P unrounded;
//   * at the split's end the warps' states merge in shared memory; a
//     single-split call writes the output there, otherwise the split writes
//     its fp32 partial (acc, m, l) to the wrapper's scratch [T, nh, S, d]
//     and a second kernel of the same call merges the S partials of each
//     (row, head): m = max m_s, l = sum l_s e^(m_s - m), acc likewise, out
//     = acc / max(l, 1e-30); a row whose m stays <= -5e29 writes exactly 0,
//     and an empty split's acc is never read. The merge kernel takes ~2.8
//     of the ~28 us of a call at the serve step; merging in the split that
//     arrives last would need a counter zeroed for every call (another
//     launch) and was not built.
#include <algorithm>
#include <type_traits>

#include "flash_common.cuh"

namespace {

using dstt::flash::bf16;
namespace fl = dstt::flash;

constexpr float NEG_INF = -1e30f;
constexpr float EMPTY = -5e29f;  // a running max at or below this saw no valid key
constexpr int STAGES = 2;
constexpr int HROWS = 16;  // query heads per CTA: the rows of an mma tile

template <int D>
__host__ __device__ constexpr int tile_keys() {
  return D == 256 ? 32 : 64;
}
template <int D>
__host__ __device__ constexpr int n_warps() {
  return tile_keys<D>() / 16;
}
template <typename T>
__host__ __device__ constexpr bool is_bf16() {
  return std::is_same<T, bf16>::value;
}
template <typename E>
__host__ __device__ constexpr bool is_i8() {
  return std::is_same<E, int8_t>::value;
}
// shared row stride in elements: 16 bytes of padding per row keep rows
// 16-byte aligned and put the rows one ldmatrix (or 8 lanes) read in
// different banks
template <typename E, int D>
__host__ __device__ constexpr int row_ld() {
  return D + 16 / (int)sizeof(E);
}

// One ring stage holding a tile of source element type E: K rows, V rows,
// the keys' K and V scales (int8 pools) and their validity.
template <typename E, int D>
struct Stage {
  static constexpr int KT = tile_keys<D>();
  static constexpr int LD = row_ld<E, D>();
  static constexpr size_t V = (size_t)KT * LD * sizeof(E);
  static constexpr size_t KS = 2 * V;
  static constexpr size_t VS = KS + KT * sizeof(float);
  static constexpr size_t OK = VS + KT * sizeof(float);
  static constexpr size_t BYTES = (OK + KT * sizeof(int) + 127) / 128 * 128;
};

template <typename T, typename P, int D>
__host__ __device__ constexpr size_t stage_bytes() {
  return Stage<P, D>::BYTES > Stage<T, D>::BYTES ? Stage<P, D>::BYTES : Stage<T, D>::BYTES;
}
// the staged queries: bf16 rows for the tensor cores, fp32 (scaled) for FFMA
template <typename T, int D>
__host__ __device__ constexpr size_t q_bytes() {
  return (size_t)HROWS * row_ld<T, D>() * sizeof(T);
}
template <typename T, typename P, int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return STAGES * stage_bytes<T, P, D>() + q_bytes<T, D>();
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;  // int8 pools: scale planes [NBt, bs, nkv]
  const float* vs;
  const int* tables;  // [T, B]
  const int* qpos;    // [T]
  const int* limit;   // [T] or null
  const void* ke;     // extras: row t at ke + t * x_stride, then [E, nkv, d]
  const void* ve;
  const int* epos;  // row t at epos + t * e_stride, then [E]
  void* out;        // [T, nh, d]
  float* part_acc;  // [T, nh, S, d] fp32 (S > 1)
  float* part_ml;   // [T, nh, S, 2] fp32 (S > 1)
  int n_tok, nh, nkv, bs, B, E;
  long long x_stride, e_stride;
  int trash, window, split_keys, pool_splits, extra_splits;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(fl::smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(fl::smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four int8 codes [x0, x1, x2, x3] as fp32 bit patterns, exactly: each byte
// (offset to unsigned) becomes the low mantissa byte of 2^23, then one
// subtraction of 2^23 + 128.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

// ... and as two bf16 pairs (x0, x1), (x2, x3), the lower element in the
// low half: a small integer's fp32 pattern has zero low 16 bits, so its bf16
// is its upper half.
__device__ __forceinline__ void i8x4_to_bf16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  float f[4];
  i8x4_to_f32(w, f);
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// N consecutive 32-bit words from shared memory (N * 4-byte aligned).
template <int N>
__device__ __forceinline__ void lds_words(uint32_t (&w)[N], const void* p) {
  static_assert(N == 2 || N % 4 == 0, "2 or a multiple of 4 words");
  if constexpr (N == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = u.x, w[4 * i + 1] = u.y, w[4 * i + 2] = u.z, w[4 * i + 3] = u.w;
    }
  }
}

// Four consecutive elements of a shared row as fp32 (fp32 or int8 codes).
__device__ __forceinline__ void lds4(const float* p, float (&f)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
}
__device__ __forceinline__ void lds4(const int8_t* p, float (&f)[4]) {
  i8x4_to_f32(*reinterpret_cast<const uint32_t*>(p), f);
}
__device__ __forceinline__ void lds2(const float* p, float& a, float& b) {
  const float2 u = *reinterpret_cast<const float2*>(p);
  a = u.x, b = u.y;
}
__device__ __forceinline__ void lds2(const int8_t* p, float& a, float& b) {
  a = (float)p[0], b = (float)p[1];
}

// The head-dim position that column c of k-step kk holds in the int8 score
// layout: lane t's B fragment of k-step kk is the 4 codes at t * D/4 + 4 kk
// (one word: (x0, x1) for k rows 2t, 2t+1 and (x2, x3) for 2t+8, 2t+9), so
// logical column 2t + e is d = t * D/4 + 4 kk + e and 8 + 2t + e is
// t * D/4 + 4 kk + 2 + e.
template <int D>
__device__ __forceinline__ int i8_score_dim(int kk, int c) {
  return ((c & 7) >> 1) * (D / 4) + 4 * kk + 2 * (c >> 3) + (c & 1);
}

// The output column of accumulator element (n-tile j, lane column t, e):
// natural (8 j + 2 t + e), or for the int8 P V layout, where lane g's B
// fragments of all n-tiles are the D/8 codes at g * D/8 of its V rows,
// (2 t + e) * D/8 + j.
template <bool PERM, int D>
__device__ __forceinline__ int out_col(int j, int t, int e) {
  return PERM ? (2 * t + e) * (D / 8) + j : 8 * j + 2 * t + e;
}

// One split of one (row, kv head, head chunk): its key range through the
// ring, each warp's online softmax, the warps' merge, then the output (one
// split) or the split's partial. E: the split's source element type (P for
// a pool split, T for an extras split).
template <typename T, typename P, typename E, int D, bool POOL>
__device__ __forceinline__ void split_body(const Args& a, unsigned char* smem, int t, int n,
                                           int head0, int gc, int s) {
  constexpr int KT = tile_keys<D>(), NW = n_warps<D>(), NT = 32 * NW;
  constexpr bool TC = is_bf16<T>();  // tensor cores; else FFMA in fp32
  constexpr bool I8 = is_i8<E>();
  constexpr bool PERM = TC && I8;  // the int8 fragment layouts
  using St = Stage<E, D>;
  constexpr int LD = St::LD;
  constexpr int LDQ = row_ld<T, D>();
  constexpr size_t SB = stage_bytes<T, P, D>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int S = a.pool_splits + a.extra_splits;
  const int qp = a.qpos[t];
  const int window = a.window;
  const int64_t row_stride = (int64_t)a.nkv * D;  // one token row of the pool / extras

  // this split's keys [k0, k1): pool positions or extra columns
  int k0, k1;
  if constexpr (POOL) {
    int hi = a.limit != nullptr ? (qp >= 0 ? a.limit[t] : 0) : qp + 1;
    hi = min(hi, a.B * a.bs);
    const int lo = window > 0 ? max(0, qp - window + 1) : 0;
    k0 = lo + s * a.split_keys;
    k1 = min(hi, k0 + a.split_keys);
  } else {
    k0 = (s - a.pool_splits) * a.split_keys;
    k1 = min(a.E, k0 + a.split_keys);
  }
  const int* tbl = a.tables + (int64_t)t * a.B;
  const int* ep = a.epos + (int64_t)t * a.e_stride;
  auto extra_ok = [&](int e) {
    const int p = __ldg(ep + e);
    return p >= 0 && p <= qp && !(window > 0 && qp - p >= window);
  };
  // the chunk's queries (rows >= gc zero): bf16 by cp.async, in flight
  // beside the checks below (int8 pools: 4-byte pairs into the permuted
  // score layout); fp32 scaled in fp32 once the split is known not empty
  T* Qs = reinterpret_cast<T*>(smem + STAGES * SB);
  const T* qg = static_cast<const T*>(a.q) + ((int64_t)t * a.nh + head0) * D;
  bool any = false;
  if (k0 < k1) {
    if constexpr (TC && !PERM) {
      for (int i = tid; i < HROWS * D / 8; i += NT) {
        const int r = i / (D / 8), c = (i % (D / 8)) * 8;
        cp_async16(Qs + r * LDQ + c, qg + (r < gc ? r * D + c : 0), r < gc);
      }
    } else if constexpr (TC) {
      for (int i = tid; i < HROWS * D / 2; i += NT) {
        const int r = i / (D / 2), c = (i % (D / 2)) * 2;
        cp_async4(Qs + r * LDQ + c, qg + (r < gc ? r * D + i8_score_dim<D>(c / 16, c % 16) : 0),
                  r < gc);
      }
    }
    cp_async_commit();
    if constexpr (POOL) {
      for (int j = k0 / a.bs + tid; j <= (k1 - 1) / a.bs; j += NT) any |= __ldg(tbl + j) != a.trash;
    } else {
      for (int e = k0 + tid; e < k1; e += NT) any |= extra_ok(e);
    }
  }
  T* out = static_cast<T*>(a.out);
  if (!__syncthreads_or(any)) {  // an empty split: nothing to read
    cp_async_wait<0>();
    for (int i = tid; i < gc * (S == 1 ? D : 1); i += NT) {
      const int64_t row = (int64_t)t * a.nh + head0 + (S == 1 ? i / D : i);
      if (S == 1) {
        out[row * D + i % D] = dstt::from_f<T>(0.f);
      } else {
        a.part_ml[(row * S + s) * 2] = NEG_INF;
        a.part_ml[(row * S + s) * 2 + 1] = 0.f;
      }
    }
    return;
  }
  if constexpr (!TC) {
    for (int i = tid; i < HROWS * D; i += NT) {
      const int r = i / D, c = i % D;
      // q scaled in fp32, as the plain version does
      Qs[r * LDQ + c] = r < gc ? qg[r * D + c] * a.scale : 0.f;
    }
  }

  const E* kp = static_cast<const E*>(POOL ? a.k : a.ke);
  const E* vp = static_cast<const E*>(POOL ? a.v : a.ve);
  const int ntiles = (k1 - k0 + KT - 1) / KT;
  // a pool block's index and row of a key position (a shift for the usual
  // power-of-two block size)
  const int bs_shift = (a.bs & (a.bs - 1)) == 0 ? __ffs(a.bs) - 1 : -1;
  // issue the copies of tile i into stage st: each thread copies one
  // 16-byte part of KPT keys; their sources are looked up first (loads
  // independent of each other), then all copies go out
  auto issue = [&](int i, int st) {
    unsigned char* base = smem + st * SB;
    E* Ks = reinterpret_cast<E*>(base);
    E* Vs = reinterpret_cast<E*>(base + St::V);
    float* kss = reinterpret_cast<float*>(base + St::KS);
    float* vss = reinterpret_cast<float*>(base + St::VS);
    int* okf = reinterpret_cast<int*>(base + St::OK);
    constexpr int EPC = 16 / (int)sizeof(E);  // elements per 16-byte copy
    constexpr int CPR = D / EPC;              // copies per key row
    static_assert(NT % CPR == 0, "a thread copies one part of each of its keys");
    constexpr int KSTEP = NT / CPR, KPT = KT / KSTEP;
    const int part = tid % CPR, kk0 = tid / CPR;
    const int kb = k0 + i * KT, nk = min(KT, k1 - kb);
    bool ok[KPT];
    int64_t srow[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kk = kk0 + j * KSTEP, key = kb + kk;
      ok[j] = false;
      srow[j] = 0;
      if (kk < nk) {
        if constexpr (POOL) {
          const int jb = bs_shift >= 0 ? key >> bs_shift : key / a.bs;
          const int blk = __ldg(tbl + jb);
          ok[j] = blk != a.trash;
          srow[j] = (int64_t)blk * a.bs + (key - jb * a.bs);  // token row in the pool
        } else {
          ok[j] = extra_ok(key);
          srow[j] = key;
        }
      }
    }
    const int64_t head = POOL ? (int64_t)n * D : (int64_t)t * a.x_stride + (int64_t)n * D;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kk = kk0 + j * KSTEP;
      // masked: zero-filled, nothing read
      const int64_t at = ok[j] ? srow[j] * row_stride + head + part * EPC : 0;
      cp_async16(Ks + kk * LD + part * EPC, kp + at, ok[j]);
      cp_async16(Vs + kk * LD + part * EPC, vp + at, ok[j]);
      if (part == 0) {
        okf[kk] = ok[j];
        if constexpr (POOL && I8) {
          const int64_t so = ok[j] ? srow[j] * a.nkv + n : 0;
          cp_async4(kss + kk, a.ks + so, ok[j]);
          cp_async4(vss + kk, a.vs + so, ok[j]);
        }
      }
    }
  };

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  issue(0, 0);
  cp_async_commit();
  for (int i = 0; i < ntiles; ++i) {
    // the next tile's copies fly while this one is scored
    if (i + 1 < ntiles) issue(i + 1, (i + 1) % STAGES);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* base = smem + (i % STAGES) * SB;
    const E* Ks = reinterpret_cast<const E*>(base) + warp * 16 * LD;  // the warp's 16 keys
    const E* Vs = reinterpret_cast<const E*>(base + St::V) + warp * 16 * LD;
    const float* kss = reinterpret_cast<const float*>(base + St::KS) + warp * 16;
    const float* vss = reinterpret_cast<const float*>(base + St::VS) + warp * 16;
    const int* okf = reinterpret_cast<const int*>(base + St::OK) + warp * 16;
    const uint32_t live = __ballot_sync(0xffffffffu, lane < 16 && okf[lane & 15] != 0);
    if (live != 0) {
      // S = Q K^T for the warp's 16 keys: s[j] = keys 8j .. 8j + 7
      float sc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      if constexpr (TC && !I8) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t qa[4], b[4];
          fl::ldsm_x4(qa, fl::a_addr<LDQ>(Qs, 0, kk * 16, lane));
          fl::ldsm_x4(b, fl::b_addr<LD>(Ks, 0, kk * 16, lane));
          fl::mma16816(sc[0], qa, b[0], b[1]);
          fl::mma16816(sc[1], qa, b[2], b[3]);
        }
      } else if constexpr (TC) {
        constexpr int KW = D / 16;  // words of a key row a lane reads
        uint32_t kw[2][KW];
        lds_words<KW>(kw[0], Ks + g * LD + tq * (D / 4));
        lds_words<KW>(kw[1], Ks + (8 + g) * LD + tq * (D / 4));
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t qa[4];
          fl::ldsm_x4(qa, fl::a_addr<LDQ>(Qs, 0, kk * 16, lane));
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t b0, b1;
            i8x4_to_bf16x2(kw[j][kk], b0, b1);
            fl::mma16816(sc[j], qa, b0, b1);
          }
        }
      } else {
        const float* qu = reinterpret_cast<const float*>(Qs) + g * LDQ;
        const float* ql = qu + 8 * LDQ;
#pragma unroll 2
        for (int d0 = 0; d0 < D; d0 += 4) {
          float u[4], w[4];
          lds4(qu + d0, u);
          lds4(ql + d0, w);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float kv[4];
              lds4(Ks + (8 * j + 2 * tq + e) * LD + d0, kv);
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                sc[j][e] = fmaf(u[x], kv[x], sc[j][e]);
                sc[j][2 + e] = fmaf(w[x], kv[x], sc[j][2 + e]);
              }
            }
          }
        }
      }

      // mask and scale, then the online softmax of the lane's rows g, g + 8
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j + 2 * tq + (e & 1);
          float mul = TC ? a.scale : 1.f;
          if constexpr (POOL && I8) mul *= kss[key];
          sc[j][e] = (live >> key) & 1u ? sc[j][e] * mul : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
        }
      }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float mn = fmaxf(m[u], fl::quad_max(mx[u]));
        corr[u] = m[u] == mn ? 1.f : expf(m[u] - mn);
        m[u] = mn;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = e >> 1;
          const float p = sc[j][e] > 0.5f * NEG_INF ? expf(sc[j][e] - m[u]) : 0.f;
          rs[u] += p;
          // the V scale rides on the probability; the sum takes it unscaled
          if constexpr (POOL && I8) {
            sc[j][e] = p * vss[8 * j + 2 * tq + (e & 1)];
          } else {
            sc[j][e] = p;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) l[u] = l[u] * corr[u] + fl::quad_sum(rs[u]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }

      // O += P V over the warp's 16 keys
      if constexpr (TC) {
        uint32_t pa[4];
        fl::c_to_a(pa, sc[0], sc[1]);
        if constexpr (!I8) {
#pragma unroll
          for (int dd = 0; dd < D / 16; ++dd) {
            uint32_t b[4];
            fl::ldsm_x4_t(b, fl::a_addr<LD>(Vs, 0, dd * 16, lane));
            fl::mma16816(acc[2 * dd], pa, b[0], b[1]);
            fl::mma16816(acc[2 * dd + 1], pa, b[2], b[3]);
          }
        } else {
          // lane (g, t): k rows (keys) 2t, 2t+1 and 2t+8, 2t+9, columns
          // g * D/8 .. + D/8 (one code per n-tile)
          constexpr int VW = D / 32;
          uint32_t r0[VW], r1[VW], r8[VW], r9[VW];
          const int8_t* vc = reinterpret_cast<const int8_t*>(Vs) + g * (D / 8);
          lds_words<VW>(r0, vc + (2 * tq) * LD);
          lds_words<VW>(r1, vc + (2 * tq + 1) * LD);
          lds_words<VW>(r8, vc + (2 * tq + 8) * LD);
          lds_words<VW>(r9, vc + (2 * tq + 9) * LD);
#pragma unroll
          for (int w = 0; w < VW; ++w) {
            uint32_t b0[4], b1[4];
            i8x4_to_bf16x2(__byte_perm(r0[w], r1[w], 0x5140), b0[0], b0[1]);
            i8x4_to_bf16x2(__byte_perm(r0[w], r1[w], 0x7362), b0[2], b0[3]);
            i8x4_to_bf16x2(__byte_perm(r8[w], r9[w], 0x5140), b1[0], b1[1]);
            i8x4_to_bf16x2(__byte_perm(r8[w], r9[w], 0x7362), b1[2], b1[3]);
#pragma unroll
            for (int x = 0; x < 4; ++x) fl::mma16816(acc[4 * w + x], pa, b0[x], b1[x]);
          }
        }
      } else {
        // fp32: each key's probabilities from the quad lane that holds them
#pragma unroll
        for (int key = 0; key < 16; ++key) {
          const int src = 4 * g + ((key & 7) >> 1);
          const float pu = __shfl_sync(0xffffffffu, sc[key >> 3][key & 1], src);
          const float pl = __shfl_sync(0xffffffffu, sc[key >> 3][2 + (key & 1)], src);
          const E* vr = Vs + key * LD + 2 * tq;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            float v0, v1;
            lds2(vr + 8 * j, v0, v1);
            acc[j][0] = fmaf(pu, v0, acc[j][0]);
            acc[j][1] = fmaf(pu, v1, acc[j][1]);
            acc[j][2] = fmaf(pl, v0, acc[j][2]);
            acc[j][3] = fmaf(pl, v1, acc[j][3]);
          }
        }
      }
    }
    __syncthreads();  // the stage is free for the copies of tile i + 2
  }

  // merge the warps' states in the (now idle) ring
  float* Wacc = reinterpret_cast<float*>(smem);  // [NW][16][D]
  float* Wml = Wacc + NW * HROWS * D;            // [NW][16][2]
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = g + 8 * u;
    if (r < gc) {
      float* dst = Wacc + (warp * HROWS + r) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        dst[out_col<PERM, D>(j, tq, 0)] = acc[j][2 * u];
        dst[out_col<PERM, D>(j, tq, 1)] = acc[j][2 * u + 1];
      }
      if (tq == 0) {
        Wml[(warp * HROWS + r) * 2] = m[u];
        Wml[(warp * HROWS + r) * 2 + 1] = l[u];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < gc * D; i += NT) {
    const int r = i / D, c = i % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, Wml[(w * HROWS + r) * 2]);
    float L = 0.f, A = 0.f;
    if (M > EMPTY) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float mw = Wml[(w * HROWS + r) * 2];
        if (mw <= EMPTY) continue;
        const float f = expf(mw - M);
        L += f * Wml[(w * HROWS + r) * 2 + 1];
        A += f * Wacc[(w * HROWS + r) * D + c];
      }
    }
    const int64_t row = (int64_t)t * a.nh + head0 + r;
    if (S == 1) {
      out[row * D + c] = dstt::from_f<T>(M > EMPTY ? A / fmaxf(L, 1e-30f) : 0.f);
    } else {
      a.part_acc[(row * S + s) * D + c] = A;
      if (c == 0) {
        a.part_ml[(row * S + s) * 2] = M;
        a.part_ml[(row * S + s) * 2 + 1] = L;
      }
    }
  }
}

template <typename T, typename P, int D>
__global__ void __launch_bounds__(32 * n_warps<D>()) paged_split_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int group = a.nh / a.nkv;
  const int chunks = (group + HROWS - 1) / HROWS;
  const int n = blockIdx.y / chunks, g0 = (blockIdx.y % chunks) * HROWS;
  const int gc = min(HROWS, group - g0);
  const int head0 = n * group + g0;
  const int s = blockIdx.z;
  if (s < a.pool_splits) {
    split_body<T, P, P, D, true>(a, smem, blockIdx.x, n, head0, gc, s);
  } else {
    split_body<T, P, T, D, false>(a, smem, blockIdx.x, n, head0, gc, s);
  }
}

// One warp per (token, head): the S partials merged in fp32.
template <typename T, int D>
__global__ void __launch_bounds__(128) paged_merge_kernel(const float* __restrict__ part_acc,
                                                          const float* __restrict__ part_ml,
                                                          T* __restrict__ out, int rows, int S) {
  constexpr int CPL = D / 32;  // columns per lane
  const int row = blockIdx.x * 4 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* ml = part_ml + (int64_t)row * S * 2;
  float M = NEG_INF;
  for (int s = lane; s < S; s += 32) M = fmaxf(M, ml[2 * s]);
  M = dstt::warp_max(M);
  float acc[CPL], L = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) acc[i] = 0.f;
  if (M > EMPTY) {
    for (int s = 0; s < S; ++s) {
      const float ms = ml[2 * s];
      if (ms <= EMPTY) continue;  // an empty split's acc was never written
      const float f = expf(ms - M);
      L += f * ml[2 * s + 1];
      const float* src = part_acc + ((int64_t)row * S + s) * D + lane * CPL;
#pragma unroll
      for (int i = 0; i < CPL; i += 2) {
        const float2 v = *reinterpret_cast<const float2*>(src + i);
        acc[i] = fmaf(f, v.x, acc[i]);
        acc[i + 1] = fmaf(f, v.y, acc[i + 1]);
      }
    }
  }
  T* dst = out + (int64_t)row * D + lane * CPL;
#pragma unroll
  for (int i = 0; i < CPL; ++i) dst[i] = dstt::from_f<T>(M > EMPTY ? acc[i] / fmaxf(L, 1e-30f) : 0.f);
}

template <typename T, typename P, int D>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int NT = 32 * n_warps<D>();
  constexpr size_t smem = smem_bytes<T, P, D>();
  static size_t have = 48 * 1024;
  const int e = fl::set_max_smem(paged_split_kernel<T, P, D>, smem, have);
  if (e != 0) return e;
  const int group = a.nh / a.nkv;
  const int S = a.pool_splits + a.extra_splits;
  const dim3 grid((unsigned)a.n_tok, (unsigned)(a.nkv * ((group + HROWS - 1) / HROWS)),
                  (unsigned)S);
  paged_split_kernel<T, P, D><<<grid, NT, smem, stream>>>(a);
  if (S > 1) {
    const int rows = a.n_tok * a.nh;
    paged_merge_kernel<T, D><<<(rows + 3) / 4, 128, 0, stream>>>(
        a.part_acc, a.part_ml, static_cast<T*>(a.out), rows, S);
  }
  return (int)cudaGetLastError();
}

// P = T (bf16/fp32 pool) or int8_t (with scale planes)
template <bool INT8>
int dispatch(int bf16_io, int d, const Args& a, cudaStream_t s) {
  if (d != 64 && d != 128 && d != 256) return (int)cudaErrorInvalidValue;
  const int kt = d == 256 ? tile_keys<256>() : tile_keys<64>();
  const long long span =
      (a.window > 0 && a.limit == nullptr) ? std::min(a.B * a.bs, a.window) : a.B * a.bs;
  const int S = a.pool_splits + a.extra_splits;
  if (a.split_keys <= 0 || a.split_keys % kt != 0 || a.pool_splits < 1 || a.extra_splits < 0 ||
      (long long)a.pool_splits * a.split_keys < span ||
      (long long)a.extra_splits * a.split_keys < a.E || S > 65535 ||
      (S > 1 && (a.part_acc == nullptr || a.part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
#define DSTT_PAGED_LAUNCH(T, D) \
  return launch<T, std::conditional_t<INT8, int8_t, T>, D>(a, s)
  if (bf16_io) {
    if (d == 64) DSTT_PAGED_LAUNCH(bf16, 64);
    if (d == 128) DSTT_PAGED_LAUNCH(bf16, 128);
    DSTT_PAGED_LAUNCH(bf16, 256);
  } else {
    if (d == 64) DSTT_PAGED_LAUNCH(float, 64);
    if (d == 128) DSTT_PAGED_LAUNCH(float, 128);
    DSTT_PAGED_LAUNCH(float, 256);
  }
#undef DSTT_PAGED_LAUNCH
}

Args make_args(const void* q, const void* k, const void* v, const float* ks, const float* vs,
               const int* tables, const int* qpos, const int* limit, const void* ke,
               const void* ve, const int* epos, void* out, float* part_acc, float* part_ml,
               int n_tok, int nh, int nkv, int bs, int B, int E, long long x_stride,
               long long e_stride, int trash, int window, int split_keys, int pool_splits,
               int extra_splits, float scale) {
  Args a;
  a.q = q, a.k = k, a.v = v, a.ks = ks, a.vs = vs, a.tables = tables, a.qpos = qpos;
  a.limit = limit, a.ke = ke, a.ve = ve, a.epos = epos, a.out = out;
  a.part_acc = part_acc, a.part_ml = part_ml;
  a.n_tok = n_tok, a.nh = nh, a.nkv = nkv, a.bs = bs, a.B = B, a.E = E;
  a.x_stride = x_stride, a.e_stride = e_stride;
  a.trash = trash, a.window = window, a.split_keys = split_keys;
  a.pool_splits = pool_splits, a.extra_splits = extra_splits, a.scale = scale;
  return a;
}

}  // namespace

// q, out: [n_tok, nh, d] contiguous; k, v: flat pool [NBt, bs, nkv, d];
// tables: [n_tok, B] int32 block ids (layer-offset by the caller); qpos:
// [n_tok]; limit: [n_tok] or null; ke, ve: extras whose row t starts
// x_stride elements after row t - 1 (0: one row for all) and holds [E, nkv,
// d] contiguously, and epos: row t at epos + t * e_stride, [E]; or null
// with E = 0. part_acc [n_tok, nh, S, d] and part_ml [n_tok, nh, S, 2] fp32
// scratch, S = pool_splits + extra_splits (null when S = 1); split_keys a
// multiple of the tile (64 keys; 32 at d 256) covering the pool span (B *
// bs, or the window without a limit) in pool_splits and E in extra_splits.
// One dtype (bf16=1 or fp32), pointers 16-byte aligned. window 0 = none.
// Launches the split kernel, and the merge kernel when S > 1. Returns
// cudaGetLastError() after launch (cudaErrorInvalidValue for an
// unsupported d or an inconsistent split plan).
extern "C" int dstt_paged_decode(const void* q, const void* k, const void* v,
                                 const int* tables, const int* qpos, const int* limit,
                                 const void* ke, const void* ve, const int* epos, void* out,
                                 float* part_acc, float* part_ml, int n_tok, int nh, int nkv,
                                 int d, int bs, int B, int E, long long x_stride,
                                 long long e_stride, int trash, int window, int split_keys,
                                 int pool_splits, int extra_splits, float scale, int bf16,
                                 void* stream) {
  const Args a = make_args(q, k, v, nullptr, nullptr, tables, qpos, limit, ke, ve, epos, out,
                           part_acc, part_ml, n_tok, nh, nkv, bs, B, E, x_stride, e_stride,
                           trash, window, split_keys, pool_splits, extra_splits, scale);
  return dispatch<false>(bf16, d, a, static_cast<cudaStream_t>(stream));
}

// The int8 pool form: k, v: int8 codes [NBt, bs, nkv, d]; ks, vs: fp32
// scale planes [NBt, bs, nkv]; q, out, ke, ve in bf16 (bf16=1) or fp32.
// Otherwise as dstt_paged_decode.
extern "C" int dstt_paged_decode_int8(const void* q, const void* k, const void* v,
                                      const float* ks, const float* vs, const int* tables,
                                      const int* qpos, const int* limit, const void* ke,
                                      const void* ve, const int* epos, void* out,
                                      float* part_acc, float* part_ml, int n_tok, int nh,
                                      int nkv, int d, int bs, int B, int E, long long x_stride,
                                      long long e_stride, int trash, int window, int split_keys,
                                      int pool_splits, int extra_splits, float scale, int bf16,
                                      void* stream) {
  const Args a = make_args(q, k, v, ks, vs, tables, qpos, limit, ke, ve, epos, out, part_acc,
                           part_ml, n_tok, nh, nkv, bs, B, E, x_stride, e_stride, trash, window,
                           split_keys, pool_splits, extra_splits, scale);
  return dispatch<true>(bf16, d, a, static_cast<cudaStream_t>(stream));
}
