// Evoformer attention backward for Hopper (sm_90a): dq (with the bias
// gradients), dk/dv, and the merge that folds the bias gradients' partials.
//
// Replaces: deepspeed_tpu/ops/deepspeed4science/evoformer_attn.py::
// _bwd_dq_kernel and ::_bwd_dkv_kernel (the two pallas_calls in _evo_bwd);
// the merge finishes _bwd_dq_kernel's bias gradient, which the JAX package
// writes as the dS plane and sums to each bias's shape in XLA (the transpose
// of its broadcast_to). Both recompute p = exp(q k^T * scale + b1 + b2 -
// lse) from the forward's fp32 log-sum-exp; dS = p * (do v^T - delta) in
// fp32 is the gradient of the summed bias, delta = sum(do * o). A dead pair
// (see evoformer_common.cuh) has p = 0, so a row with no live logit gets
// zero dq and dS and adds exactly 0 to dk, dv and every bias gradient.
//
// Bound: at the Evoformer's widths (s 384, d 32) 6d and 8d FLOPs a pair put
// both kernels far under the card's ridge (~295 FLOP a byte in bf16), so
// they are bytes-bound: q, k, v, o, do, lse and their gradients, the biases,
// and the bias gradients. Written as the fp32 plane [B, h, s, s] (2.42 GB at
// msa_row) that last term is most of the bytes; reduced in the kernel to
// partials over the dims a bias is broadcast over (151 MB of pair partials
// at msa_row with 16 batch rows a CTA, 6.3 MB of mask partials) it is a
// small one. fp32 is operation-bound (FFMA). Measured (PERF.md) the kernels
// run ~10x their bounds: one warpgroup a CTA walks a dependent chain a
// step (copies, products, per-pair work, products), and three CTAs an SM
// hide only part of it.
//
// Design. Each CTA is one warpgroup (128 threads, 4 warps of 16 rows) and
// walks a group of G flattened batch rows (``rows_per_cta`` in
// evoformer_attn.py picks G), its tiles fed by cp.async copies (16 bytes a
// thread, zeros past s) in commit groups, waited for, fenced to the async
// proxy (wgmma reads shared memory through it) and published with one
// __syncthreads a step:
//  * Per batch row a CTA keeps resident tiles in a slot (dq: its Q, dO and O
//    tiles and lse; dk/dv: its K and V tiles), two slots where they fit
//    (fp32 at d 128 has one); one stage streams the rest (dq: K, V and the
//    bias regions of each key tile; dk/dv: Q, dO, lse, delta and the bias
//    regions of each query tile), issued at the top of a step and waited for
//    before its products. A CTA does not overlap its own copies with its
//    products: at one warpgroup a CTA the per-pair work is latency-bound, and
//    the three or four CTAs an SM (min_blocks) hide each other's copies. A
//    second stage, measured at msa_row, cost more in shared memory (CTAs an
//    SM, or L1) than its prefetch bought (PERF.md).
//  * cp.async rather than TMA: one loader for both element types, every head
//    dim, any s and any bias strides. The bf16 copies write the layouts
//    wgmma reads (hopper_common.cuh): up to d 32 rows of 64 bytes in the
//    64-byte swizzle (d 16 zero-padded to 32 columns), at d 64 and 128
//    64-column blocks in the 128-byte swizzle.
//  * dq: a CTA per (group, head, 64-query tile), qt fastest, walks its rows
//    (with two slots in pairs: the pair's rows take each key tile in turn)
//    and for each the key tiles: S = Q K^T and dP = dO V^T, per pair the
//    logit (the summed bias read from the staged regions: a [64, 64] tile of
//    an operand with a query stride, one row of 64 keys of one without, such
//    as the mask, a row of zeros for an absent one, so the per-pair code has
//    no branch), p and dS, then dQ += dS K. delta is taken once a row from
//    the resident dO and O tiles and written out [B, h, s] for dk/dv.
//  * dk/dv: a CTA per (group, head, 64-key tile) walks its rows and for each
//    the query tiles on the transposed products (S^T = K Q^T, dP^T = V
//    dO^T), reading the staged bias transposed and lse and delta from the
//    stage: dV += P^T dO, dK += dS^T Q. O is not read and delta not
//    recomputed.
//  * The bias gradients, in one of three forms the wrapper chooses by shape
//    (evoformer_attn.py, ``bias_grad_plan``): none; the plane (dS written
//    [B, h, s, s]); or reduced, where dq writes partials: ``rows``, dS summed
//    over the group's batch rows, [groups, h, s, s] (each element read,
//    added to and written back by the one thread whose fragment holds it,
//    in row order, in the CTA's own slice, which stays in L2: once a pair of
//    rows, the pair's two added in registers); and dk/dv
//    writes ``cols``, each key's dS summed over all queries, [B, h, 1, s]
//    (dS^T's rows in its registers: a thread's 16 columns in order, the
//    quad by shuffles, the query tiles in order). The merge kernel folds
//    partials over the remaining broadcast dims in index order. No float
//    atomics anywhere: two calls give the same bits.
// Tensor cores (bf16): S, dP (and S^T, dP^T) are wgmma m64n64 with both
// operands in shared memory, K-major; dQ, dV and dK are wgmma m64nN with dS
// or P from registers (the accumulators rounded to bf16, as the flash
// kernels do) and K, dO or Q as the MN-major B operand, N = max(32, d). At
// d 16 the products of width d run at N 32 over the zero-padded columns and
// S and dP take one 16-deep step: one layout and one code path for every
// head dim below 64.
// fp32 keeps evoformer_common.cuh's FFMA products (TF32 would lose the
// fp32 contract's digits) in the same fragment layout, so the per-pair
// code is one; its tiles are rows of d + 4 floats and its dk/dv takes d 128
// in two 64-column passes (accumulators in registers).
#include "evoformer_common.cuh"

namespace {

using namespace dstt::evo;

constexpr int DQ_BLD = 72;          // row stride (floats) of a staged bias tile: dq
constexpr int DKV_BLD = 68;         // dk/dv (read transposed: no bank conflict)
constexpr int AUX = 1024;           // 64 lse and 64 delta, and a row bias region

// an absent operand keeps a region of zeros (never copied into), read as a
// row: the summed bias is b1 + b2 with no branch per pair
__host__ __device__ inline int bias_region(int kind, int bld) {
  return kind == 2 ? TILE * bld * 4 : AUX;
}

// Where a CTA keeps what, in bytes from a 1024-byte-aligned base (every
// region a multiple of 1024): `res_slots` resident slots, then the stage,
// then (fp32) the warps' staging buffers.
struct Layout {
  int tile, res, stg;  // a tile, a resident slot, the stage
  int aux;             // offset of lse and delta: dq in the slot, dk/dv in the stage
  int bias1, bias2;    // offsets of the bias regions in a stage
  int ld1, ld2;        // their row strides in floats (0: a row)
  int fstage, total;
};

template <typename T, int D>
__host__ __device__ inline Layout make_layout(bool dq, int k1, int k2, int res_slots) {
  Layout L{};
  const int bld = dq ? DQ_BLD : DKV_BLD;
  L.tile = tile_bytes<T, D>();
  L.res = dq ? 3 * L.tile + AUX : 2 * L.tile;
  L.aux = dq ? 3 * L.tile : 2 * L.tile;
  L.bias1 = dq ? 2 * L.tile : 2 * L.tile + AUX;
  L.bias2 = L.bias1 + bias_region(k1, bld);
  L.stg = L.bias2 + bias_region(k2, bld);
  L.ld1 = k1 == 2 ? bld : 0;
  L.ld2 = k2 == 2 ? bld : 0;
  int at = res_slots * L.res + L.stg;
  L.fstage = at;
  if (!is_bf16<T>()) at += NWARPS * 16 * STAGE_LD * 4;
  L.total = at + 1024;  // the base's alignment
  return L;
}

// sum over half `half` of the columns of row r of dO * O (two resident
// tiles), in order, fp32
template <typename T, int D>
__device__ __forceinline__ float tile_row_dot(const unsigned char* a, const unsigned char* b, int r,
                                              int half) {
  constexpr int CH = D * (int)sizeof(T) / 16;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < CH / 2; ++i) {
    const int off = tile_off<T, D>(r, half * (CH / 2) + i);
    if constexpr (is_bf16<T>()) {
      const uint4 x = *reinterpret_cast<const uint4*>(a + off);
      const uint4 y = *reinterpret_cast<const uint4*>(b + off);
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fx = __bfloat1622float2(xp[e]), fy = __bfloat1622float2(yp[e]);
        acc = fmaf(fx.x, fy.x, acc);
        acc = fmaf(fx.y, fy.y, acc);
      }
    } else {
      const float4 x = *reinterpret_cast<const float4*>(a + off);
      const float4 y = *reinterpret_cast<const float4*>(b + off);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
      acc = fmaf(x.z, y.z, acc);
      acc = fmaf(x.w, y.w, acc);
    }
  }
  return acc;
}

// The row sums of a dq CTA live in its own slice of the row partials
// ([s, s] of (group, head), rows of its query tile): each element is read,
// added to and written back by the one thread whose fragment holds it, a
// batch row at a time, in row order (the first row of the group starts
// from zero). The slice stays in L2 between a CTA's rows. pairs: s even, so
// float2 accesses stay aligned.
__device__ __forceinline__ void rows_load(float (&ra)[TILE / 8][4], const float* plane,
                                          const int (&row)[2], int k0, int t, int s, bool read) {
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) ra[j][0] = ra[j][1] = ra[j][2] = ra[j][3] = 0.f;
  if (!read) return;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (row[u] >= s) continue;
    const float* r = plane + (int64_t)row[u] * s;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const int kp = k0 + j * 8 + 2 * t;
      if ((s & 1) == 0) {
        if (kp < s) {
          const float2 w = __ldcg(reinterpret_cast<const float2*>(r + kp));
          ra[j][2 * u] = w.x;
          ra[j][2 * u + 1] = w.y;
        }
      } else {
        if (kp < s) ra[j][2 * u] = __ldcg(r + kp);
        if (kp + 1 < s) ra[j][2 * u + 1] = __ldcg(r + kp + 1);
      }
    }
  }
}

__device__ __forceinline__ void rows_store(const float (&ra)[TILE / 8][4], float* plane,
                                           const int (&row)[2], int k0, int t, int s) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    if (row[u] >= s) continue;
    float* r = plane + (int64_t)row[u] * s;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const int kp = k0 + j * 8 + 2 * t;
      if ((s & 1) == 0) {
        if (kp < s) *reinterpret_cast<float2*>(r + kp) = make_float2(ra[j][2 * u], ra[j][2 * u + 1]);
      } else {
        if (kp < s) r[kp] = ra[j][2 * u];
        if (kp + 1 < s) r[kp + 1] = ra[j][2 * u + 1];
      }
    }
  }
}

// CTAs an SM keeps (the register cap): the per-pair work is latency-bound
// at one warpgroup a CTA, so bf16 up to d 64 runs three CTAs an SM (168
// registers a thread), dk/dv up to d 32 four (128: a few spills, yet
// faster at msa_row than three); fp32 and d 128 keep the registers their
// accumulators need (two CTAs fit at 255).
template <typename T, int D, bool DQ>
__host__ __device__ constexpr int min_blocks() {
  return !is_bf16<T>() || D > 64 ? 1 : (!DQ && D <= 32) ? 4 : 3;
}

// ---------------------------------------------------------------------------
struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;  // [B, h, s]: dq writes it, dk/dv reads it
  void *a, *b;   // dq (b unused), or dk and dv
  float* ds;     // the plane [B, h, s, s], or null
  float* rows;   // dq: [groups, h, s, s] partials, or null
  float* cols;   // dk/dv: [B, h, 1, s] partials, or null
  int group;      // batch rows a CTA walks
  int res_slots;  // resident slots: 2 where they fit, else 1
};

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, (min_blocks<T, D, true>()))
    evo_dq_kernel(Args x, Problem p) {
  constexpr int TB = tile_bytes<T, D>();
  constexpr int NQ = is_bf16<T>() ? nq<D>() : D;  // dQ accumulator columns
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = aligned_base(smem_raw);
  const int k1 = bias_kind(p.b1), k2 = bias_kind(p.b2);
  const Layout L = make_layout<T, D>(true, k1, k2, x.res_slots);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nt = n_tiles(p.s);
  const int qt = blockIdx.x % nt, hi = (blockIdx.x / nt) % p.h, grp = blockIdx.x / (nt * p.h);
  const int b0 = grp * x.group, q0 = qt * TILE, RS = x.res_slots;
  // uniform to the compiler: the loop around the wgmmas
  const int nsteps = __shfl_sync(0xffffffffu, min(x.group, p.B - b0) * nt, 0);
  const int64_t stride = (int64_t)p.h * D;
  const int lr[2] = {warp * 16 + g, warp * 16 + g + 8};
  const int row[2] = {q0 + lr[0], q0 + lr[1]};

  // zeros once: the tiles' padding columns (never copied) and the sums
  for (int i = tid * 16; i + 16 <= L.total - 1024; i += NTHREADS * 16)
    *reinterpret_cast<uint4*>(sm + i) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // a batch row's resident tiles: its Q, dO and O tiles and lse
  auto load_resident = [&](int bl) {
    const int bi = b0 + bl;
    const int64_t off = head_offset(bi, hi, p, D);
    unsigned char* r = sm + (bl % RS) * L.res;
    load_tile_async<T, D>(r, static_cast<const T*>(x.q) + off, q0, p.s, stride, tid);
    load_tile_async<T, D>(r + TB, static_cast<const T*>(x.dout) + off, q0, p.s, stride, tid);
    load_tile_async<T, D>(r + 2 * TB, static_cast<const T*>(x.o) + off, q0, p.s, stride, tid);
    if (tid < TILE) {
      const bool ok = q0 + tid < p.s;
      cp4(reinterpret_cast<float*>(r + L.aux) + tid,
          x.lse + ((int64_t)bi * p.h + hi) * p.s + (ok ? q0 + tid : 0), ok);
    }
  };
  // The steps: with two resident slots the group's batch rows go in pairs,
  // the pair's two rows taking each key tile in turn (b, kt), (b + 1, kt),
  // so a thread's row sums of a key tile take both rows in registers and
  // go to L2 once a pair (a last odd row alone); with one slot a row at a
  // time. Step j is (row bl of the group, key tile kt, sub = its place in
  // its pair, rows of its pair).
  const int rows_n = min(x.group, p.B - b0), full = rows_n / RS;
  auto step_of = [&](int j, int& bl, int& kt, int& sub, int& pair_rows) {
    const int pr = j / (RS * nt);
    if (pr < full) {
      const int w = j - RS * nt * pr;
      kt = w / RS;
      sub = w - kt * RS;
      bl = RS * pr + sub;
      pair_rows = RS;
    } else {
      kt = j - RS * nt * full;
      sub = 0;
      bl = RS * full;
      pair_rows = 1;
    }
  };
  unsigned char* const stg = sm + RS * L.res;  // the stage
  // step j's copies, one commit group
  auto issue = [&](int j) {
    int bl, kt, sub, pr;
    step_of(j, bl, kt, sub, pr);
    const int bi = b0 + bl;
    const int64_t off = head_offset(bi, hi, p, D);
    if (kt == 0) load_resident(bl);
    load_tile_async<T, D>(stg, static_cast<const T*>(x.k) + off, kt * TILE, p.s, stride, tid);
    load_tile_async<T, D>(stg + TB, static_cast<const T*>(x.v) + off, kt * TILE, p.s, stride,
                          tid);
    load_bias_async(reinterpret_cast<float*>(stg + L.bias1), L.ld1, bias_plane(p.b1, bi, hi),
                    p.b1.sq, q0, kt * TILE, p.s, p.vec, tid);
    load_bias_async(reinterpret_cast<float*>(stg + L.bias2), L.ld2, bias_plane(p.b2, bi, hi),
                    p.b2.sq, q0, kt * TILE, p.s, p.vec, tid);
    cp_commit();
  };

  // this row's lse, delta and dQ sums, and (with two slots) its pair
  // partner's, swapped at each step of a pair of two
  float lse_r[2] = {0.f, 0.f}, del_r[2] = {0.f, 0.f};
  float lse_o[2] = {0.f, 0.f}, del_o[2] = {0.f, 0.f};
  float dqa[NQ / 8][4], dqo[NQ / 8][4];
#pragma unroll
  for (int j = 0; j < NQ / 8; ++j) {
    dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
    dqo[j][0] = dqo[j][1] = dqo[j][2] = dqo[j][3] = 0.f;
  }
  float ra[TILE / 8][4];  // the row sums of this thread's elements of the step's key tile

  for (int i = 0; i < nsteps; ++i) {
    int bl, kt, sub, pair_rows;
    step_of(i, bl, kt, sub, pair_rows);
    const int bi = b0 + bl, k0 = kt * TILE;
    issue(i);
    // the sums so far, read while the copies land
    if (x.rows && sub == 0)
      rows_load(ra, x.rows + (((int64_t)grp * p.h + hi) * p.s) * p.s, row, k0, t, p.s, bl > 0);
    cp_wait_all();
    hp::fence_proxy_async();
    __syncthreads();
    unsigned char* res = sm + (bl % RS) * L.res;
    float* aux = reinterpret_cast<float*>(res + L.aux);  // lse [64], delta [64]

    if (kt == 0) {  // a new batch row: its delta, once
      const int r = tid >> 1, half = tid & 1;
      float dl = tile_row_dot<T, D>(res + TB, res + 2 * TB, r, half);
      dl += __shfl_xor_sync(0xffffffffu, dl, 1);
      if (!half) {
        aux[TILE + r] = dl;
        if (q0 + r < p.s) x.delta[((int64_t)bi * p.h + hi) * p.s + q0 + r] = dl;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        lse_r[u] = aux[lr[u]];
        del_r[u] = aux[TILE + lr[u]];
      }
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
    }

    // S = Q K^T, dP = dO V^T
    float sc[TILE / 8][4], ds[TILE / 8][4];
    if constexpr (is_bf16<T>()) {
      hp::wgmma_fence();
      ss_product<D>(flat<32>(sc), res, stg);
      ss_product<D>(flat<32>(ds), res + TB, stg + TB);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_acc(flat<32>(sc));
      hp::fence_acc(flat<32>(ds));
    } else {
      abt<T, D>(sc, reinterpret_cast<const T*>(res), reinterpret_cast<const T*>(stg), warp * 16,
                lane);
      abt<T, D>(ds, reinterpret_cast<const T*>(res + TB), reinterpret_cast<const T*>(stg + TB),
                warp * 16, lane);
    }

    // p and dS per pair, in place in ds: branch-free, 32 independent chains
    // a thread; a tile inside s checks no bounds
    const float* B1 = reinterpret_cast<const float*>(stg + L.bias1);
    const float* B2 = reinterpret_cast<const float*>(stg + L.bias2);
    const int kmax = p.s - k0;
    auto pairs = [&](auto inside) {
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = e >> 1, c = j * 8 + 2 * t + (e & 1);
          const float xl =
              logit(sc[j][e], p.scale, B1[lr[u] * L.ld1 + c] + B2[lr[u] * L.ld2 + c]);
          const bool live =
              (decltype(inside)::value || (row[u] < p.s && c < kmax)) && xl > NEG_INF;
          const float pe = live ? __expf(xl - lse_r[u]) : 0.f;
          ds[j][e] = pe * (ds[j][e] - del_r[u]);
        }
      }
    };
    if (q0 + TILE <= p.s && k0 + TILE <= p.s) {
      pairs(std::true_type{});
    } else {
      pairs(std::false_type{});
    }

    if (x.ds) {  // the plane
      float* dSb = x.ds + ((int64_t)bi * p.h + hi) * p.s * p.s;
      const bool even = (p.s & 1) == 0;  // float2 stores stay aligned
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (row[u] >= p.s) continue;
        float* drow = dSb + (int64_t)row[u] * p.s;
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          const int kp = k0 + j * 8 + 2 * t;
          if (even) {
            if (kp < p.s)
              *reinterpret_cast<float2*>(drow + kp) = make_float2(ds[j][2 * u], ds[j][2 * u + 1]);
          } else {
            if (kp < p.s) drow[kp] = ds[j][2 * u];
            if (kp + 1 < p.s) drow[kp + 1] = ds[j][2 * u + 1];
          }
        }
      }
    }
    if (x.rows) {  // summed over the group's batch rows, in row order
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ra[j][e] += ds[j][e];
      }
      if (sub == pair_rows - 1)
        rows_store(ra, x.rows + (((int64_t)grp * p.h + hi) * p.s) * p.s, row, k0, t, p.s);
    }
    // dQ += dS K
    if constexpr (is_bf16<T>()) {
      uint32_t df[TILE / 16][4];
      to_a(df, ds);
      hp::fence_acc(flat<NQ / 2>(dqa));
      hp::wgmma_fence();
      rs_product<D>(flat<NQ / 2>(dqa), df, stg);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_acc(flat<NQ / 2>(dqa));
    } else {
      float* fst = reinterpret_cast<float*>(sm + L.fstage) + warp * 16 * STAGE_LD;
      accum<T, D, D>(dqa, ds, reinterpret_cast<const T*>(stg), 0, fst, lane);
    }

    if (kt == nt - 1) {  // the row's dq, scaled once
      T* dq = static_cast<T*>(x.a) + head_offset(bi, hi, p, D);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (row[u] >= p.s) continue;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          store_pair<T>(dq + (int64_t)row[u] * stride + j * 8 + 2 * t, dqa[j][2 * u] * p.scale,
                        dqa[j][2 * u + 1] * p.scale);
        }
      }
    }
    if (pair_rows == 2) {  // the partner's turn next
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float w = dqa[j][e];
          dqa[j][e] = dqo[j][e];
          dqo[j][e] = w;
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float w = lse_r[u];
        lse_r[u] = lse_o[u];
        lse_o[u] = w;
        w = del_r[u];
        del_r[u] = del_o[u];
        del_o[u] = w;
      }
    }
    __syncthreads();  // this step's stage and (at a row's end) slot may be refilled
  }
}

// ---------------------------------------------------------------------------
// dk/dv
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, (min_blocks<T, D, false>()))
    evo_dkv_kernel(Args x, Problem p) {
  constexpr int TB = tile_bytes<T, D>();
  // accumulator columns a pass: bf16 one pass (64, or 128 at d 128); fp32 d
  // 128 in two passes of 64 (the accumulators stay in registers)
  constexpr int DC = is_bf16<T>() ? nq<D>() : (D > 64 ? 64 : D);
  constexpr int NPASS = is_bf16<T>() ? 1 : D / DC;
  constexpr int JN = (D < DC ? D : DC) / 8;  // live 8-column groups a pass
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = aligned_base(smem_raw);
  const int k1 = bias_kind(p.b1), k2 = bias_kind(p.b2);
  const Layout L = make_layout<T, D>(false, k1, k2, x.res_slots);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nt = n_tiles(p.s);
  const int kt = blockIdx.x % nt, hi = (blockIdx.x / nt) % p.h, grp = blockIdx.x / (nt * p.h);
  const int b0 = grp * x.group, k0 = kt * TILE, RS = x.res_slots;
  const int per_row = NPASS * nt;
  const int nsteps = __shfl_sync(0xffffffffu, min(x.group, p.B - b0) * per_row, 0);
  const int64_t stride = (int64_t)p.h * D;
  // this lane's two keys (fragment rows g and g + 8 of the warp's 16)
  const int lk[2] = {warp * 16 + g, warp * 16 + g + 8};
  const int key[2] = {k0 + lk[0], k0 + lk[1]};

  for (int i = tid * 16; i + 16 <= L.total - 1024; i += NTHREADS * 16)
    *reinterpret_cast<uint4*>(sm + i) = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // a batch row's resident K and V tiles
  auto load_resident = [&](int bl) {
    const int64_t off = head_offset(b0 + bl, hi, p, D);
    unsigned char* r = sm + (bl % RS) * L.res;
    load_tile_async<T, D>(r, static_cast<const T*>(x.k) + off, k0, p.s, stride, tid);
    load_tile_async<T, D>(r + TB, static_cast<const T*>(x.v) + off, k0, p.s, stride, tid);
  };
  unsigned char* const stg = sm + RS * L.res;  // the stage
  auto issue = [&](int j) {  // as in dq
    const int bl = j / per_row, rem = j % per_row, bi = b0 + bl;
    const int q0 = (rem % nt) * TILE;
    const int64_t off = head_offset(bi, hi, p, D);
    if (rem == 0) load_resident(bl);
    load_tile_async<T, D>(stg, static_cast<const T*>(x.q) + off, q0, p.s, stride, tid);
    load_tile_async<T, D>(stg + TB, static_cast<const T*>(x.dout) + off, q0, p.s, stride, tid);
    if (tid < 2 * TILE) {  // lse, then delta
      const int c = tid & 63;
      const bool ok = q0 + c < p.s;
      const float* src = tid < TILE ? x.lse : x.delta;
      cp4(reinterpret_cast<float*>(stg + L.aux) + tid,
          src + ((int64_t)bi * p.h + hi) * p.s + (ok ? q0 + c : 0), ok);
    }
    load_bias_async(reinterpret_cast<float*>(stg + L.bias1), L.ld1, bias_plane(p.b1, bi, hi),
                    p.b1.sq, q0, k0, p.s, p.vec, tid);
    load_bias_async(reinterpret_cast<float*>(stg + L.bias2), L.ld2, bias_plane(p.b2, bi, hi),
                    p.b2.sq, q0, k0, p.s, p.vec, tid);
    cp_commit();
  };

  float csum[2] = {0.f, 0.f};  // this lane's two keys' dS summed over the row's queries
  float dka[DC / 8][4], dva[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) {
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
    dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
  }

  for (int i = 0; i < nsteps; ++i) {
    issue(i);
    cp_wait_all();
    hp::fence_proxy_async();
    __syncthreads();
    const int bl = i / per_row, rem = i % per_row, bi = b0 + bl;
    const int pass = rem / nt, qt = rem % nt, q0 = qt * TILE, c0 = pass * DC;
    const unsigned char* res = sm + (bl % RS) * L.res;
    const float* lse_s = reinterpret_cast<const float*>(stg + L.aux);
    const float* delta_s = lse_s + TILE;

    if (qt == 0) {  // a new (row, pass)
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
        dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
        dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
      }
      csum[0] = csum[1] = 0.f;
    }

    // S^T = K Q^T, dP^T = V dO^T (rows: this CTA's keys; columns: the
    // tile's queries)
    float pt[TILE / 8][4], dst[TILE / 8][4];
    if constexpr (is_bf16<T>()) {
      hp::wgmma_fence();
      ss_product<D>(flat<32>(pt), res, stg);
      ss_product<D>(flat<32>(dst), res + TB, stg + TB);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_acc(flat<32>(pt));
      hp::fence_acc(flat<32>(dst));
    } else {
      abt<T, D>(pt, reinterpret_cast<const T*>(res), reinterpret_cast<const T*>(stg), warp * 16,
                lane);
      abt<T, D>(dst, reinterpret_cast<const T*>(res + TB), reinterpret_cast<const T*>(stg + TB),
                warp * 16, lane);
    }

    const float* B1 = reinterpret_cast<const float*>(stg + L.bias1);
    const float* B2 = reinterpret_cast<const float*>(stg + L.bias2);
    const int qmax = p.s - q0;
    // one copy of the per-pair code (dq's two, inside s and at its edge,
    // cost dk/dv spills beside its column sums)
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = e >> 1, c = j * 8 + 2 * t + (e & 1);  // query within the tile
        // the bias regions are [query][key]: read transposed
        const float xl = logit(pt[j][e], p.scale, B1[c * L.ld1 + lk[u]] + B2[c * L.ld2 + lk[u]]);
        const bool live = c < qmax && key[u] < p.s && xl > NEG_INF;
        const float pe = live ? __expf(xl - lse_s[c]) : 0.f;
        pt[j][e] = pe;
        dst[j][e] = pe * (dst[j][e] - delta_s[c]);
      }
    }

    if (x.cols && pass == 0) {  // each key's dS over the tile's queries, in order
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float w = 0.f;
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) w += dst[j][2 * u] + dst[j][2 * u + 1];
        w += __shfl_xor_sync(0xffffffffu, w, 1);
        w += __shfl_xor_sync(0xffffffffu, w, 2);
        csum[u] += w;
      }
    }

    // dV += P^T dO, dK += dS^T Q
    if constexpr (is_bf16<T>()) {
      uint32_t pf[TILE / 16][4], df[TILE / 16][4];
      to_a(pf, pt);
      to_a(df, dst);
      hp::fence_acc(flat<DC / 2>(dva));
      hp::fence_acc(flat<DC / 2>(dka));
      hp::wgmma_fence();
      rs_product<D>(flat<DC / 2>(dva), pf, stg + TB);
      rs_product<D>(flat<DC / 2>(dka), df, stg);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_acc(flat<DC / 2>(dva));
      hp::fence_acc(flat<DC / 2>(dka));
    } else {
      float* fst = reinterpret_cast<float*>(sm + L.fstage) + warp * 16 * STAGE_LD;
      accum<T, D, DC>(dva, pt, reinterpret_cast<const T*>(stg + TB), c0, fst, lane);
      accum<T, D, DC>(dka, dst, reinterpret_cast<const T*>(stg), c0, fst, lane);
    }

    if (qt == nt - 1) {  // the (row, pass)'s dk (scaled once) and dv
      const int64_t off = head_offset(bi, hi, p, D);
      if (x.cols && pass == 0 && t == 0) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (key[u] < p.s) x.cols[((int64_t)bi * p.h + hi) * p.s + key[u]] = csum[u];
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (key[u] >= p.s) continue;
        T* krow = static_cast<T*>(x.a) + off + (int64_t)key[u] * stride + c0;
        T* vrow = static_cast<T*>(x.b) + off + (int64_t)key[u] * stride + c0;
#pragma unroll
        for (int j = 0; j < JN; ++j) {
          const int c = j * 8 + 2 * t;
          store_pair<T>(krow + c, dka[j][2 * u] * p.scale, dka[j][2 * u + 1] * p.scale);
          store_pair<T>(vrow + c, dva[j][2 * u], dva[j][2 * u + 1]);
        }
      }
    }
    __syncthreads();  // this step's stage and (at a row's end) slot may be refilled
  }
}

// ---------------------------------------------------------------------------
// merge: dst = src [a0, a1, a2, n] summed over the flagged axes (bit i: axis
// i) in index order, fp32; dst [a0 or 1, a1 or 1, a2 or 1, n], contiguous.
// One thread V consecutive outputs (V = 4: 16-byte loads, n a multiple of
// 4); each sum's order is fixed, so are its bits. Bytes-bound: the partials
// are read once.
// ---------------------------------------------------------------------------
struct MergeJob {
  const float* src;
  float* dst;
  int a0, a1, a2, n, flags;
};

template <int V>
__global__ void __launch_bounds__(256) evo_merge_kernel(MergeJob j0, MergeJob j1) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const MergeJob j = blockIdx.y ? j1 : j0;
  const bool s0 = j.flags & 1, s1 = j.flags & 2, s2 = j.flags & 4;
  const int o0 = s0 ? 1 : j.a0, o1 = s1 ? 1 : j.a1, o2 = s2 ? 1 : j.a2;
  const int nv = j.n / V;
  const int64_t total = (int64_t)o0 * o1 * o2 * nv;
  const Vec* src = reinterpret_cast<const Vec*>(j.src);
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(e % nv);
    int64_t r = e / nv;
    const int i2 = (int)(r % o2);
    r /= o2;
    const int i1 = (int)(r % o1), i0 = (int)(r / o1);
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int x0 = s0 ? 0 : i0; x0 < (s0 ? j.a0 : i0 + 1); ++x0)
      for (int x1 = s1 ? 0 : i1; x1 < (s1 ? j.a1 : i1 + 1); ++x1)
#pragma unroll 4
        for (int x2 = s2 ? 0 : i2; x2 < (s2 ? j.a2 : i2 + 1); ++x2) {
          const Vec w = __ldcs(src + (((int64_t)x0 * j.a1 + x1) * j.a2 + x2) * nv + c);
          const float* f = reinterpret_cast<const float*>(&w);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] += f[v];
        }
    if constexpr (V == 4) {
      reinterpret_cast<float4*>(j.dst)[e] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      j.dst[e] = acc[0];
    }
  }
}

// ---------------------------------------------------------------------------
template <typename T, int D, bool DQ>
int launch(const Args& x, const Problem& p, cudaStream_t stream) {
  // two resident slots where they fit (fp32 at d 128 takes one): a row's
  // resident tiles are loaded with its first step
  Args y = x;
  y.res_slots = 2;
  Layout L = make_layout<T, D>(DQ, bias_kind(p.b1), bias_kind(p.b2), 2);
  if (L.total > SMEM_LIMIT) {
    y.res_slots = 1;
    L = make_layout<T, D>(DQ, bias_kind(p.b1), bias_kind(p.b2), 1);
  }
  if (L.total > SMEM_LIMIT || y.group <= 0) return (int)cudaErrorInvalidValue;
  void (*kernel)(Args, Problem) = DQ ? evo_dq_kernel<T, D> : evo_dkv_kernel<T, D>;
  static size_t have = 48 * 1024;
  if (int e = set_max_smem(kernel, (size_t)L.total, have)) return e;
  const int64_t groups = (p.B + x.group - 1) / x.group;
  const dim3 grid((unsigned)(groups * p.h * n_tiles(p.s)));
  kernel<<<grid, NTHREADS, L.total, stream>>>(y, p);
  return (int)cudaGetLastError();
}

template <bool DQ, typename T>
int dispatch(int d, const Args& x, const Problem& p, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16, DQ>(x, p, st);
    case 32: return launch<T, 32, DQ>(x, p, st);
    case 64: return launch<T, 64, DQ>(x, p, st);
    case 128: return launch<T, 128, DQ>(x, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool DQ>
int entry(const Args& x, const void* b1, const void* b2, long long b1_sb, long long b1_sh,
          long long b1_sq, long long b2_sb, long long b2_sh, long long b2_sq, int B, int h,
          int s, int d, float scale, int fp32, int vec, void* stream) {
  if (B <= 0 || h <= 0 || s <= 0) return (int)cudaErrorInvalidValue;
  Problem p{B, h, s, scale, {static_cast<const float*>(b1), b1_sb, b1_sh, b1_sq},
            {static_cast<const float*>(b2), b2_sb, b2_sh, b2_sq}, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return fp32 ? dispatch<DQ, float>(d, x, p, st) : dispatch<DQ, bf16>(d, x, p, st);
}

}  // namespace

// q, k, v, o, do, dq: [B, s, h, d] bf16 (fp32 = 0) or fp32 (fp32 = 1),
// contiguous, 16-byte aligned; lse: [B, h, s] fp32 from dstt_evoformer_fwd;
// delta: [B, h, s] fp32, written (sum(do * o) per query row); b1, b2: the
// forward's bias operands (fp32 or null, element (bi, hi, qp, kp) at bi * sb
// + hi * sh + qp * sq + kp). The bias gradient, each output null to skip
// it: ds the fp32 plane [B, h, s, s]; rows fp32 [ceil(B / group), h, s, s],
// dS summed over each group's batch rows. group: batch rows a CTA walks. d
// in {16, 32, 64, 128}. vec: as in dstt_evoformer_fwd. Returns
// cudaGetLastError() (cudaErrorInvalidValue for a layout over the card's
// shared memory).
extern "C" int dstt_evoformer_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, const void* b1,
                                     const void* b2, void* dq, void* delta, void* ds, void* rows,
                                     long long b1_sb, long long b1_sh, long long b1_sq,
                                     long long b2_sb, long long b2_sh, long long b2_sq, int B,
                                     int h, int s, int d, float scale, int fp32, int vec,
                                     int group, void* stream) {
  const Args x{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
               dq, nullptr, static_cast<float*>(ds), static_cast<float*>(rows), nullptr, group, 0};
  return entry<true>(x, b1, b2, b1_sb, b1_sh, b1_sq, b2_sb, b2_sh, b2_sq, B, h, s, d, scale, fp32,
                     vec, stream);
}

// dk, dv: [B, s, h, d] in q's dtype; delta: dstt_evoformer_bwd_dq's (it
// runs first on the stream); cols: fp32 [B, h, 1, s], each key's dS summed
// over all queries, or null to skip it; the rest as dstt_evoformer_bwd_dq.
extern "C" int dstt_evoformer_bwd_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* delta,
                                      const void* b1, const void* b2, void* dk, void* dv,
                                      void* cols, long long b1_sb, long long b1_sh,
                                      long long b1_sq, long long b2_sb, long long b2_sh,
                                      long long b2_sq, int B, int h, int s, int d, float scale,
                                      int fp32, int vec, int group, void* stream) {
  const Args x{q, k, v, nullptr, dout, static_cast<const float*>(lse),
               const_cast<float*>(static_cast<const float*>(delta)), dk, dv, nullptr, nullptr,
               static_cast<float*>(cols), group, 0};
  return entry<false>(x, b1, b2, b1_sb, b1_sh, b1_sq, b2_sb, b2_sh, b2_sq, B, h, s, d, scale,
                      fp32, vec, stream);
}

// Up to two merges in one launch (jobs 1 or 2): src fp32 [a0, a1, a2, n]
// contiguous summed over the axes flagged in `flags` (bit i: axis i) into
// dst [a0 or 1, a1 or 1, a2 or 1, n]. Returns cudaGetLastError().
extern "C" int dstt_evoformer_bias_grad_merge(const void* src0, void* dst0, int a0, int a1,
                                              int a2, int n, int flags0, const void* src1,
                                              void* dst1, int c0, int c1, int c2, int m,
                                              int flags1, int jobs, void* stream) {
  if (jobs < 1 || jobs > 2) return (int)cudaErrorInvalidValue;
  const MergeJob j0{static_cast<const float*>(src0), static_cast<float*>(dst0), a0, a1, a2, n,
                    flags0};
  const MergeJob j1 = jobs == 2 ? MergeJob{static_cast<const float*>(src1),
                                           static_cast<float*>(dst1), c0, c1, c2, m, flags1}
                                : j0;
  const bool vec = j0.n % 4 == 0 && j1.n % 4 == 0;
  auto outputs = [&](const MergeJob& j) {
    return (int64_t)(j.flags & 1 ? 1 : j.a0) * (j.flags & 2 ? 1 : j.a1) *
           (j.flags & 4 ? 1 : j.a2) * (vec ? j.n / 4 : j.n);
  };
  const int64_t most = outputs(j0) > outputs(j1) ? outputs(j0) : outputs(j1);
  const int64_t blocks = (most + 255) / 256;
  const dim3 grid((unsigned)(blocks < 8192 ? (blocks > 0 ? blocks : 1) : 8192), (unsigned)jobs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    evo_merge_kernel<4><<<grid, 256, 0, st>>>(j0, j1);
  } else {
    evo_merge_kernel<1><<<grid, 256, 0, st>>>(j0, j1);
  }
  return (int)cudaGetLastError();
}
