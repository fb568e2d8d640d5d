// Evoformer attention forward for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/deepspeed4science/evoformer_attn.py::
// _fwd_kernel (the pallas_call in _evo_call): softmax(q k^T * scale + b1 +
// b2) v with an online softmax over key tiles, no causal mask, no GQA, every
// sum in fp32. Writes out in q's dtype and the fp32 log-sum-exp [B, h, s]; a
// row with no live logit writes 0 and -1e30.
//
// Bound: in bf16, bytes at the Evoformer's widths (d 32, s 384: 4d FLOPs
// per pair is ~190 FLOP per byte of q, k, v and out, under the card's ~295
// ridge); in fp32, operations (FFMA at 67 TFLOP/s). Below both sits the
// exponential of every pair (one MUFU operation each): 604 M at msa_row.
//
// Design. A CTA owns one (group of G flattened batch rows, head, 64-query
// tile), query tile fastest (G: ``rows_per_cta`` in evoformer_attn.py, as
// the backward), and runs NWG warpgroups of 128 threads side by side. Each
// warpgroup takes every NWG-th row of the group and walks, per row, the key
// tiles: S = Q K^T, per pair the logit (scaled product plus the summed
// bias), the online softmax (running max and sum, exp2 of the log2 e-scaled
// difference), O = O corr + P V, and at the row's last tile out = O / l
// and lse.
//  * The bias is read once per CTA where it can be: an operand with batch
//    stride 0 (AlphaFold's pair bias [1, h, s, s] under [1, n]) is staged
//    once for the CTA, its [64, s] slab resident in shared memory (96 KB of
//    fp32 at s 384) and read by every warpgroup and row of the group; a row
//    operand with batch stride 0 likewise as one row. An operand that
//    differs per batch row (the mask [*, 1, 1, s]) is copied per step, 64
//    keys of its row (or a [64, 64] tile where it has a query stride). An
//    absent operand reads a row of zeros, so the per-pair code adds both
//    operands with no branch. The bias sum stays fp32.
//  * Copies: cp.async (16 bytes a thread, zeros past s) into fwd_stages()
//    stages a warpgroup. With two a step issues the next step's copies
//    before its own products; measured at msa_row (PERF.md), bf16 ran 10%
//    faster with one (the warpgroups synchronise on their own named
//    barriers only, and the other warpgroups of the CTA hide a warpgroup's
//    waits), fp32 4% faster with two (taken up to d 64).
//  * bf16: S on wgmma m64n64k16 from the layouts of evoformer_common.cuh
//    (the 64-byte swizzle at d <= 32, d 16 zero-padded to 32 columns; the
//    128-byte swizzle at 64 and 128); O += P V on wgmma m64nN with P from
//    registers, rounded to bf16 as the flash kernels do (the row sums take
//    the unrounded p). fp32: evoformer_common.cuh's FFMA products in the
//    same fragment layout.
//  * Key columns past s are masked in the tail tile only; query rows past s
//    are computed on zeros and never stored.
// The layout (warpgroups a CTA, which operands are resident) is chosen on
// the host by what fits in shared memory, in that order of preference: the
// resident slab with at least two warpgroups, then more warpgroups.
#include "evoformer_common.cuh"

namespace {

using namespace dstt::evo;

constexpr int FWD_BLD = 72;  // row stride (floats) of a per-step bias tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr int FSTAGE_BYTES = NWARPS * 16 * STAGE_LD * 4;  // fp32: a warpgroup's buffers

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__host__ __device__ inline const Bias& bias_of(const Problem& p, int o) {
  return o ? p.b2 : p.b1;
}

// stages a warpgroup (1 or 2; fp32 at d 128 has room for one with a
// per-step bias tile)
template <typename T, int D>
__host__ __device__ constexpr int fwd_stages() {
  return is_bf16<T>() || D > 64 ? 1 : 2;
}

// How a bias operand reaches the per-pair code.
enum BiasMode { ABSENT = 0, RES_ROW, RES_TILE, STEP_ROW, STEP_TILE };

// warpgroups a CTA at most (the register cap: 128 a thread at four)
template <typename T, int D>
__host__ __device__ constexpr int max_wgs() {
  return is_bf16<T>() && D <= 64 ? 4 : 2;
}

// Byte offsets from a 1024-byte-aligned base (every region a multiple of
// 1024): the CTA's resident bias regions, a zero row, then NWG warpgroup
// regions of [S Q slots][S stages][fp32 staging buffers] (S =
// fwd_stages), a stage being [K tile][V tile][per-step bias regions].
struct FwdLayout {
  int nwg;
  int mode[2];   // BiasMode of b1, b2
  int res[2];    // resident regions
  int zeros;     // a row of 64 zeros
  int sp;        // row stride (floats) of a resident region
  int wg0, wg;   // the first warpgroup region, a region's bytes
  int stage0;    // stage 0 in a warpgroup region (the Q slots at 0)
  int stage;     // a stage's bytes
  int sb[2];     // per-step bias regions in a stage
  int fst;       // fp32 staging buffers in a warpgroup region
  int total;     // dynamic shared memory, alignment included
};

__host__ inline int round1024(int n) { return (n + 1023) / 1024 * 1024; }

template <typename T, int D>
__host__ inline FwdLayout make_fwd_layout(const Problem& p, int nt, int nwg, bool res_tile) {
  FwdLayout L{};
  L.nwg = nwg;
  L.sp = nt * TILE + 8;
  const Bias* b[2] = {&p.b1, &p.b2};
  int at = 0;
  for (int o = 0; o < 2; ++o) {
    const int kind = bias_kind(*b[o]);
    const bool inv = b[o]->sb == 0;  // one plane for every batch row
    L.mode[o] = kind == 0   ? ABSENT
                : kind == 1 ? (inv ? RES_ROW : STEP_ROW)
                            : (inv && res_tile ? RES_TILE : STEP_TILE);
    if (L.mode[o] == RES_ROW) {
      L.res[o] = at;
      at += round1024(nt * TILE * 4);
    } else if (L.mode[o] == RES_TILE) {
      L.res[o] = at;
      at += TILE * L.sp * 4;
    }
  }
  L.zeros = at;
  at += 1024;
  const int tb = tile_bytes<T, D>();
  int st = 2 * tb;
  for (int o = 0; o < 2; ++o) {
    if (L.mode[o] == STEP_ROW) {
      L.sb[o] = st;
      st += 1024;
    } else if (L.mode[o] == STEP_TILE) {
      L.sb[o] = st;
      st += TILE * FWD_BLD * 4;
    }
  }
  L.stage = st;
  L.stage0 = fwd_stages<T, D>() * tb;
  L.fst = L.stage0 + fwd_stages<T, D>() * st;
  L.wg = L.fst + (is_bf16<T>() ? 0 : FSTAGE_BYTES);
  L.wg0 = at;
  L.total = at + nwg * L.wg + 1024;
  return L;
}

// The layout a launch takes (false: none fits).
template <typename T, int D>
__host__ inline bool plan_layout(const Problem& p, int group, FwdLayout& L) {
  const int nt = n_tiles(p.s);
  const int most = group < max_wgs<T, D>() ? group : max_wgs<T, D>();
  auto fit = [&](bool res_tile, int least) {
    for (int nwg = most; nwg >= least; --nwg) {
      L = make_fwd_layout<T, D>(p, nt, nwg, res_tile);
      if (L.total <= SMEM_LIMIT) return true;
    }
    return false;
  };
  const bool slab = (bias_kind(p.b1) == 2 && p.b1.sb == 0) ||
                    (bias_kind(p.b2) == 2 && p.b2.sb == 0);
  return (slab && fit(true, most < 2 ? most : 2)) || fit(false, 1);
}

// Rows [0, rows) x keys [0, nkeys) of a bias operand's plane from query q0
// (ld 0: its one row) into a resident region, by `nthr` threads; zeros
// past s. vec: 16-byte copies.
__device__ __forceinline__ void load_bias_span(float* dst, int ld, int rows, const float* plane,
                                               long long sq, int q0, int nkeys, int s, bool vec,
                                               int tid, int nthr) {
  if (vec) {
    const int per = nkeys / 4;
    for (int i = tid; i < rows * per; i += nthr) {
      const int r = i / per, c = (i - r * per) * 4, qp = q0 + r;
      const int n = qp < s ? max(0, min(4, s - c)) : 0;
      cp16(dst + r * ld + c, plane + (n ? qp * sq + c : 0), n * 4);
    }
  } else {
    for (int i = tid; i < rows * nkeys; i += nthr) {
      const int r = i / nkeys, c = i - r * nkeys, qp = q0 + r;
      const bool ok = qp < s && c < s;
      cp4(dst + r * ld + c, plane + (ok ? qp * sq + c : 0), ok);
    }
  }
}

struct FwdArgs {
  const void *q, *k, *v;
  void* out;
  float* lse;
  int group;  // batch rows a CTA walks
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS * max_wgs<T, D>(), 1)
    evo_fwd_kernel(FwdArgs x, Problem p, FwdLayout L) {
  constexpr int TB = tile_bytes<T, D>();
  constexpr int NQ = is_bf16<T>() ? nq<D>() : D;  // O accumulator columns
  constexpr int S = fwd_stages<T, D>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = aligned_base(smem_raw);
  const int nt = n_tiles(p.s);
  const int qt = blockIdx.x % nt, hi = (blockIdx.x / nt) % p.h, grp = blockIdx.x / (nt * p.h);
  const int b0 = grp * x.group, q0 = qt * TILE;
  const int64_t stride = (int64_t)p.h * D;

  // zeros once: the tiles' padding columns (never copied) and the zero row
  for (int i = threadIdx.x * 16; i + 16 <= L.total - 1024; i += blockDim.x * 16)
    *reinterpret_cast<uint4*>(sm + i) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  // the resident regions, once for the CTA (their batch stride is 0)
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    if (L.mode[o] == RES_TILE || L.mode[o] == RES_ROW) {
      const bool tile = L.mode[o] == RES_TILE;
      const Bias& b = bias_of(p, o);
      load_bias_span(reinterpret_cast<float*>(sm + L.res[o]), tile ? L.sp : 0, tile ? TILE : 1,
                     bias_plane(b, b0, hi), b.sq, q0, nt * TILE, p.s, p.vec, threadIdx.x,
                     blockDim.x);
    }
  }
  cp_commit();
  cp_wait_all();
  __syncthreads();

  // this warpgroup: every nwg-th row of the group from row w
  const int w = __shfl_sync(0xffffffffu, (int)threadIdx.x / NTHREADS, 0);
  const int tid = threadIdx.x % NTHREADS, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3;
  const int rows_n = min(x.group, p.B - b0);
  // uniform to the compiler: the loop around the wgmmas
  const int nsteps =
      __shfl_sync(0xffffffffu, rows_n > w ? (rows_n - w + L.nwg - 1) / L.nwg * nt : 0, 0);
  unsigned char* const wr = sm + L.wg0 + w * L.wg;
  const int lr[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  const int row[2] = {q0 + lr[0], q0 + lr[1]};
  const int bar = 1 + w;  // this warpgroup's named barrier

  // step j: (row r of this warpgroup's, key tile kt); its copies, one
  // commit group
  auto issue = [&](int j) {
    const int r = j / nt, kt = j - r * nt, bi = b0 + w + L.nwg * r;
    const int64_t off = head_offset(bi, hi, p, D);
    unsigned char* stg = wr + L.stage0 + (j % S) * L.stage;
    if (kt == 0)
      load_tile_async<T, D>(wr + (r % S) * TB, static_cast<const T*>(x.q) + off, q0,
                            p.s, stride, tid);
    load_tile_async<T, D>(stg, static_cast<const T*>(x.k) + off, kt * TILE, p.s, stride, tid);
    load_tile_async<T, D>(stg + TB, static_cast<const T*>(x.v) + off, kt * TILE, p.s, stride,
                          tid);
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      if (L.mode[o] == STEP_TILE || L.mode[o] == STEP_ROW) {
        const Bias& b = bias_of(p, o);
        load_bias_async(reinterpret_cast<float*>(stg + L.sb[o]),
                        L.mode[o] == STEP_TILE ? FWD_BLD : 0, bias_plane(b, bi, hi), b.sq, q0,
                        kt * TILE, p.s, p.vec, tid);
      }
    }
    cp_commit();
  };
  // the summed bias of a step: an operand's region and row stride (0: a row)
  auto region = [&](int o, const unsigned char* stg, int k0, int& ld) {
    const int mode = L.mode[o];
    ld = mode == RES_TILE ? L.sp : mode == STEP_TILE ? FWD_BLD : 0;
    const unsigned char* at = mode == RES_TILE || mode == RES_ROW ? sm + L.res[o] + k0 * 4
                              : mode == ABSENT                    ? sm + L.zeros
                                                                  : stg + L.sb[o];
    return reinterpret_cast<const float*>(at);
  };

  float o[NQ / 8][4];
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  for (int i = 0; i < nsteps; ++i) {
    if constexpr (S == 2) {  // the next step's copies fly under this one's products
      if (i == 0) issue(0);
      if (i + 1 < nsteps) issue(i + 1);
      else cp_commit();
      cp_wait<1>();
    } else {
      issue(i);
      cp_wait<0>();
    }
    hp::fence_proxy_async();  // wgmma reads the tiles through the async proxy
    hp::named_sync(bar, NTHREADS);
    const int r = i / nt, kt = i - r * nt, bi = b0 + w + L.nwg * r, k0 = kt * TILE;
    const unsigned char* qs = wr + (r % S) * TB;
    const unsigned char* stg = wr + L.stage0 + (i % S) * L.stage;
    if (kt == 0) {  // a new row
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
      m[0] = m[1] = NEG_INF;
      l[0] = l[1] = 0.f;
    }

    // S = Q K^T
    float sc[TILE / 8][4];
    if constexpr (is_bf16<T>()) {
      hp::wgmma_fence();
      ss_product<D>(flat<32>(sc), qs, stg);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_acc(flat<32>(sc));
    } else {
      abt<T, D>(sc, reinterpret_cast<const T*>(qs), reinterpret_cast<const T*>(stg), warp * 16,
                lane);
    }

    // the logits and their row max: branch-free; the tail tile masks its
    // keys past s
    int ld1, ld2;
    const float* B1 = region(0, stg, k0, ld1);
    const float* B2 = region(1, stg, k0, ld2);
    const int kmax = p.s - k0;
    // the summed bias of this thread's two keys 8j + 2t, + 1 of row lr[u]
    // (8-byte loads: every region and row starts 8-byte aligned)
    auto bias_pair = [&](int u, int j) {
      const float2 a = *reinterpret_cast<const float2*>(B1 + lr[u] * ld1 + j * 8 + 2 * t);
      const float2 b = *reinterpret_cast<const float2*>(B2 + lr[u] * ld2 + j * 8 + 2 * t);
      return make_float2(a.x + b.x, a.y + b.y);
    };
    float mx[2] = {NEG_INF, NEG_INF};
    auto logits = [&](auto inside) {
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float2 bb = bias_pair(u, j);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int e = 2 * u + h2, c = j * 8 + 2 * t + h2;
            float xl = logit(sc[j][e], p.scale, h2 ? bb.y : bb.x);
            if (!decltype(inside)::value && c >= kmax) xl = NEG_INF;
            sc[j][e] = xl;
            mx[u] = fmaxf(mx[u], xl);
          }
        }
      }
    };
    if (kmax >= TILE) {
      logits(std::true_type{});
    } else {
      logits(std::false_type{});
    }

    // the online softmax: p = 2^((logit - m) log2 e), 0 for a dead logit
    // (while a row has no live logit, m is taken as 0 in the exponent)
    float corr[2], mz[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float mn = fmaxf(m[u], dstt::flash::quad_max(mx[u]));
      corr[u] = m[u] == mn ? 1.f : ex2((m[u] - mn) * LOG2E);
      m[u] = mn;
      mz[u] = mn > NEG_INF ? mn : 0.f;
    }
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = e >> 1;
        const float pe = ex2((sc[j][e] - mz[u]) * LOG2E);
        sc[j][e] = pe;
        rs[u] += pe;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) l[u] = l[u] * corr[u] + dstt::flash::quad_sum(rs[u]);
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // O += P V
    if constexpr (is_bf16<T>()) {
      uint32_t pa[TILE / 16][4];
      to_a(pa, sc);
      hp::fence_acc(flat<NQ / 2>(o));
      hp::wgmma_fence();
      rs_product<D>(flat<NQ / 2>(o), pa, stg + TB);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_acc(flat<NQ / 2>(o));
    } else {
      float* fst = reinterpret_cast<float*>(wr + L.fst) + warp * 16 * STAGE_LD;
      accum<T, D, D>(o, sc, reinterpret_cast<const T*>(stg + TB), 0, fst, lane);
    }

    // the row's last tile: out = O / max(l, 1e-30) rounded once, lse = m +
    // log(max(l, 1e-30))
    if (kt == nt - 1) {
      T* ob = static_cast<T*>(x.out) + head_offset(bi, hi, p, D);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (row[u] >= p.s) continue;
        const float ls = fmaxf(l[u], 1e-30f);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          store_pair<T>(ob + (int64_t)row[u] * stride + j * 8 + 2 * t, o[j][2 * u] / ls,
                        o[j][2 * u + 1] / ls);
        if (t == 0) x.lse[((int64_t)bi * p.h + hi) * p.s + row[u]] = m[u] + logf(ls);
      }
    }
    hp::named_sync(bar, NTHREADS);  // this step's stage (and Q slot) may be refilled
  }
}

template <typename T, int D>
int launch(const FwdArgs& x, const Problem& p, cudaStream_t stream) {
  FwdLayout L;
  if (x.group <= 0 || !plan_layout<T, D>(p, x.group, L)) return (int)cudaErrorInvalidValue;
  static size_t have = 48 * 1024;
  if (int e = set_max_smem(evo_fwd_kernel<T, D>, (size_t)L.total, have)) return e;
  const int64_t groups = (p.B + x.group - 1) / x.group;
  const dim3 grid((unsigned)(groups * p.h * n_tiles(p.s)));
  evo_fwd_kernel<T, D><<<grid, NTHREADS * L.nwg, L.total, stream>>>(x, p, L);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const FwdArgs& x, const Problem& p, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(x, p, st);
    case 32: return launch<T, 32>(x, p, st);
    case 64: return launch<T, 64>(x, p, st);
    case 128: return launch<T, 128>(x, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, out: [B, s, h, d] bf16 (fp32 = 0) or fp32 (fp32 = 1), contiguous,
// 16-byte aligned; lse: [B, h, s] fp32; b1, b2: fp32 bias operands or null,
// element (bi, hi, qp, kp) at bi * sb + hi * sh + qp * sq + kp. d in {16, 32,
// 64, 128}. vec: both operands' pointers 16-byte aligned and every stride a
// multiple of 4 (16-byte copies of the bias regions). group: batch rows a
// CTA walks. Returns cudaGetLastError() (cudaErrorInvalidValue for a
// layout over the card's shared memory).
extern "C" int dstt_evoformer_fwd(const void* q, const void* k, const void* v, const void* b1,
                                  const void* b2, void* out, void* lse, long long b1_sb,
                                  long long b1_sh, long long b1_sq, long long b2_sb,
                                  long long b2_sh, long long b2_sq, int B, int h, int s, int d,
                                  float scale, int fp32, int vec, int group, void* stream) {
  if (B <= 0 || h <= 0 || s <= 0) return (int)cudaErrorInvalidValue;
  Problem p{B, h, s, scale, {static_cast<const float*>(b1), b1_sb, b1_sh, b1_sq},
            {static_cast<const float*>(b2), b2_sb, b2_sh, b2_sq}, vec};
  const FwdArgs x{q, k, v, out, static_cast<float*>(lse), group};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fp32 ? dispatch<float>(d, x, p, st) : dispatch<bf16>(d, x, p, st);
}
