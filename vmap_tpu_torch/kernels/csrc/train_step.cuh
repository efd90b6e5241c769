// The train-frame pieces shared by train_step.cu (the float policies'
// tile) and train_step_q8.cu (the int8 policies' tile): the policies, the
// parameter offsets, the staged bf16 weights and the partial-gradient row
// layout, the float tile's shape per width, the tensor-core product
// helpers (stage_slab, dgrad_mma, wgrad_mma), the points and PE, the
// per-ray render and losses, and the float tile's backward
// (float_backward), which the int8_fwd policies' f32 backward runs too.
// See train_step.cu and train_step_q8.cu for the designs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"
#include "update_plan.cuh"

namespace {

constexpr int MAX_S = 32;
constexpr int MAX_RT = 64;

// matmul operand policies: F32, BWD_BF16, BF16 are the index in
// vmap_tpu_torch/ops/mlp.py POLICIES (train_step.cu); INT8 (int8 and
// int8_static) and INT8_FWD (int8_fwd and int8_static_fwd) are the two
// int8 tiles of train_step_q8.cu, static or dynamic scales a runtime choice
enum Policy : int { F32 = 0, BWD_BF16 = 1, BF16 = 2, INT8 = 3, INT8_FWD = 4 };

// x rounded to the nearest bf16 (ties to even), back in f32, when R
template <bool R>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (R)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

// rows [n][LDP] (their first P entries) rounded to bf16 in place
template <int NT>
__device__ void round_rows(float* x, int n, int P, int LDP) {
  for (int idx = threadIdx.x; idx < n * P; idx += NT) {
    const int i = idx / P, p = idx % P;
    x[i * LDP + p] = rnd<true>(x[i * LDP + p]);
  }
}

// Offsets of each tensor inside one slot's flat parameter vector (the
// BankSpec order of the Python side).
struct Offsets {
  int dirs, w_in, b_in, w_mid1, b_mid1, w_cat, b_cat, w_mid2, b_mid2,
      w_alpha, b_alpha, w_col, b_col, w_col_out, b_col_out;
};

__device__ __forceinline__ float sgnf(float x) {
  return (float)((x > 0.f) - (x < 0.f));
}

// G[i * ldw + col0 + k] (+)= sum_p dout[i][p] * in[k][p]  (i < n_out,
// k < n_in), f32; add: accumulate onto the row (a block's later tiles)
template <int NT>
__device__ void wgrad(float* __restrict__ G, int ldw, int col0,
                      const float* dout, int n_out, const float* in, int n_in,
                      int P, int LDP, bool add) {
  for (int idx = threadIdx.x; idx < n_out * n_in; idx += NT) {
    const int i = idx / n_in, k = idx % n_in;
    const float* d = dout + i * LDP;
    const float* x = in + k * LDP;
    float acc = 0.f;
    for (int p = 0; p < P; ++p) acc = fmaf(d[p], x[p], acc);
    float* g = G + (size_t)i * ldw + col0 + k;
    *g = add ? *g + acc : acc;
  }
}

// G[i] (+)= sum_p dout[i][p]   (bias gradients)
template <int NT>
__device__ void bgrad(float* __restrict__ G, const float* dout, int n_out,
                      int P, int LDP, bool add) {
  for (int i = threadIdx.x; i < n_out; i += NT) {
    const float* d = dout + i * LDP;
    float acc = 0.f;
    for (int p = 0; p < P; ++p) acc += d[p];
    G[i] = add ? G[i] + acc : acc;
  }
}

// dE/dproj_j of the band-b sin entry whose upstream gradient is g.
__device__ __forceinline__ float band_grad(float g, float proj, int b) {
  const float f = (float)(1 << b);
  return g * cospif(proj * f) * (PI_F * f);
}

// Under a bf16 backward policy: the bias gradient of the upstream
// gradients dout [n][LDP] from their f32 values, then dout rounded in
// place for the weight and input products that read it next.
template <int NT>
__device__ void bgrad_round(float* __restrict__ G, float* dout, int n, int P,
                            int LDP, bool add) {
  bgrad<NT>(G, dout, n, P, LDP, add);
  __syncthreads();
  round_rows<NT>(dout, n, P, LDP);
  __syncthreads();
}

// A partial-gradient row (every policy): update_plan.cuh grad_row.

// Whether the dirs and biases lie within the first rest_size(H) parameters,
// where a partial-gradient row keeps them
inline bool rest_fits(const Offsets& o, int H) {
  const int n = rest_size(H);
  const int ends[] = {o.dirs + 3 * NDIR, o.b_in + H, o.b_mid1 + H,
                      o.b_cat + H, o.b_mid2 + H, o.b_alpha + 1, o.b_col + H,
                      o.b_col_out + 3};
  for (int e : ends)
    if (e > n) return false;
  return true;
}

// ---- the float tile's shape per width. NT threads, MINB blocks an SM
// the registers must allow (h=32: two, as its shared memory does); RA
// whether the weight gradients read the partial row ahead (wgrad_mma:
// h=256, whose rows sit past L2; at h=32 the registers it takes cost more
// than it saves); FP the most points of a tile (kernels.FLOAT_POINTS); KF
// the forward slab's columns (fwd_kf), KB the input-gradient slab's rows;
// (FWM, FWN, FMU) the forward's warp tile (16-row x 8-column mma tiles)
// and the most such units a warp holds at once, (DWM, DWN, DMU) the input
// gradients'. FMU / DMU cover the largest product at FP points: units =
// ceil(rows / 16 WM) * (P16 / 8 WN).
template <int H>
struct Tile;
template <>
struct Tile<32> {
  static constexpr bool RA = false;
  static constexpr int NT = 256, MINB = 2, FP = 64, KF = 64, KB = 16;
  static constexpr int FWM = 1, FWN = 2, FMU = 1, DWM = 1, DWN = 2, DMU = 4;
};
template <>
struct Tile<128> {
  static constexpr bool RA = false;
  static constexpr int NT = 256, MINB = 1, FP = 56, KF = 32, KB = 16;
  static constexpr int FWM = 2, FWN = 2, FMU = 2, DWM = 2, DWN = 2, DMU = 4;
};
template <>
struct Tile<256> {
  static constexpr bool RA = true;
  static constexpr int NT = 512, MINB = 1, FP = 56, KF = 16, KB = 16;
  static constexpr int FWM = 2, FWN = 2, FMU = 2, DWM = 2, DWN = 2, DMU = 3;
};

// The pieces of each operand of the forward and the backward products
// (mma_pieces): F32 2 and 2 (three passes); BWD_BF16 3 (six passes: its
// saved activations are rounded to bf16 for the backward, so the forward
// that makes them must be f32-accurate, or more of them round to the
// other side of a bf16 step than the f32 plain version's) and 1; BF16 1
// and 1
template <int POL>
__host__ __device__ constexpr int fwd_pieces() {
  return POL == F32 ? 2 : POL == BWD_BF16 ? 3 : 1;
}
template <int POL>
__host__ __device__ constexpr int bwd_pieces() { return POL == F32 ? 2 : 1; }

// the forward slab's columns: Tile<H>::KF, less where three pieces would
// not fit a ring of two beside the tile (h=128), or two blocks an SM (h=32)
template <int H, int NP>
__host__ __device__ constexpr int fwd_kf() {
  return NP < 3 ? Tile<H>::KF : H == 128 ? 16 : H == 32 ? 48 : Tile<H>::KF;
}

// bytes of one slab buffer (its pieces' planes), the larger of the two
// kinds
template <int H, int POL>
__host__ __device__ constexpr size_t slab_bytes() {
  constexpr int NF = fwd_pieces<POL>(), NB = bwd_pieces<POL>();
  constexpr size_t fwd = 2 * NF * (size_t)H * (fwd_kf<H, NF>() + 8);
  constexpr size_t bwd = 2 * NB * (size_t)Tile<H>::KB * (up16(H + EMB1) + 8);
  return fwd > bwd ? fwd : bwd;
}

// cp.async copy of rows [r0, r0 + nr) x columns [c0, c0 + nc) of a staged
// matrix (row length C; its planes NS apart, PL of them) to dst [PL][nr][ld]
// (c0, nc multiples of 8), as one commit group
template <int NT, int PL>
__device__ __forceinline__ void stage_slab(bf16* dst, int ld,
                                           const bf16* __restrict__ src,
                                           int NS, int C, int r0, int nr,
                                           int c0, int nc) {
  const int per_row = nc >> 3, per_plane = nr * per_row;
  const uint64_t pol = l2_evict_last();
  for (int idx = threadIdx.x; idx < PL * per_plane; idx += NT) {
    const int pl = idx / per_plane, rem = idx - pl * per_plane;
    const int r = rem / per_row, c = (rem - r * per_row) << 3;
    cp_async16(dst + (pl * nr + r) * ld + c,
               src + (size_t)pl * NS + (size_t)(r0 + r) * C + c0 + c, pol);
  }
  cp_async_commit();
}

// B fragment of rows k.. (kv of them valid) and column p (< P) of the f32
// rows x [][LDP], as NP pieces
template <int NP>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[NP][2],
                                            const float* x, int LDP, int p,
                                            int P, int kv, int t) {
  float v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = 2 * t + (q & 1) + (q >> 1) * 8;
    v[q] = (p < P && r < kv) ? x[r * LDP + p] : 0.f;
  }
  uint32_t b0[NP], b1[NP];
  split<NP>(v[0], v[1], b0);
  split<NP>(v[2], v[3], b1);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    b[i][0] = b0[i];
    b[i][1] = b1[i];
  }
}

// A fragment of rows i0.. (< n valid) and columns p0.. (< P) of the f32
// rows d [][LDP], as NP pieces
template <int NP>
__device__ __forceinline__ void load_a_pts(uint32_t (&a)[NP][4],
                                           const float* d, int LDP, int i0,
                                           int n, int p0, int P, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = i0 + g + (q & 1) * 8, p = p0 + 2 * t + (q >> 1) * 8;
    const float* r = d + i * LDP + p;
    const bool ok = i < n;
    uint32_t v[NP];
    split<NP>(ok && p < P ? r[0] : 0.f, ok && p + 1 < P ? r[1] : 0.f, v);
#pragma unroll
    for (int j = 0; j < NP; ++j) a[j][q] = v[j];
  }
}

// epi(k, p, sum_i W[i][k] d[i][p]) for every staged column k < up16(n_in)
// and p < P, where W is staged matrix m (ws: its slot's pieces, NS apart)
// and d its upstream gradient rows (n_out of them). The slabs: a ring of
// two (the next in flight while one computes), or one (slab1 == slab0).
// Starts by staging its first slab; ends with the slabs free (the block
// synchronised after its last read of them), the epilogue run but not yet
// synchronised.
template <int H, int WM, int WN, int MU, int NP, class Epi>
__device__ void dgrad_mma(const bf16* __restrict__ ws, int NS, int m,
                          const float* d, int P, int LDP, bf16* slab0,
                          bf16* slab1, Epi epi) {
  constexpr int NT = Tile<H>::NT, NW = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_out = mat_out(H, m), Rr = up16(n_out), C = up16(mat_in(H, m));
  const int KB = Rr < Tile<H>::KB ? Rr : Tile<H>::KB, LD = C + 8;
  const int un = ((P + 15) / 16 * 2) / WN;
  const int units = (C / 16 + WM - 1) / WM * un;
  if (units > MU * NW) __trap();   // Tile<H> does not cover this product
  const bf16* src = ws + mat_off(H, m);
  float acc[MU][WM][WN][4] = {};
  bf16* buf[2] = {slab0, slab1};
  const bool ring = slab1 != slab0;
  const int ns = Rr / KB;
  stage_slab<NT, NP>(buf[0], LD, src, NS, C, 0, KB, 0, C);
  for (int s = 0; s < ns; ++s) {
    const int i0 = s * KB;
    if (ring && s + 1 < ns) {
      stage_slab<NT, NP>(buf[(s + 1) & 1], LD, src, NS, C, i0 + KB, KB, 0, C);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sh = buf[s & 1];   // piece i at sh + i KB LD
#pragma unroll
    for (int j = 0; j < MU; ++j) {
      const int u = warp + j * NW;
      if (u < units) {
        const int m0 = u / un * 16 * WM, n0 = u % un * 8 * WN;
        for (int kk = 0; kk < KB; kk += 16) {
          const int i = i0 + kk;
          uint32_t b[WN][NP][2];
#pragma unroll
          for (int wn = 0; wn < WN; ++wn)
            load_b_rows<NP>(b[wn], d + i * LDP, LDP,
                            n0 + 8 * wn + (lane >> 2), P, n_out - i,
                            lane & 3);
#pragma unroll
          for (int wm = 0; wm < WM; ++wm) {
            if (m0 + 16 * wm >= C) continue;
            uint32_t a[NP][4];
#pragma unroll
            for (int pc = 0; pc < NP; ++pc)
              load_a_trans(a[pc], sh + pc * KB * LD, LD, m0 + 16 * wm, kk,
                           lane);
#pragma unroll
            for (int wn = 0; wn < WN; ++wn)
              mma_pieces<NP>(acc[j][wm][wn], a, b[wn]);
          }
        }
      }
    }
    __syncthreads();
    if (!ring && s + 1 < ns)
      stage_slab<NT, NP>(slab0, LD, src, NS, C, i0 + KB, KB, 0, C);
  }
#pragma unroll
  for (int j = 0; j < MU; ++j) {
    const int u = warp + j * NW;
    if (u >= units) continue;
    const int m0 = u / un * 16 * WM, n0 = u % un * 8 * WN;
#pragma unroll
    for (int wm = 0; wm < WM; ++wm)
#pragma unroll
      for (int wn = 0; wn < WN; ++wn)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = m0 + 16 * wm + (lane >> 2) + (q >> 1) * 8;
          const int p = n0 + 8 * wn + 2 * (lane & 3) + (q & 1);
          if (k < C && p < P) epi(k, p, acc[j][wm][wn][q]);
        }
  }
}

// The 16-byte group of an m16 x n8 accumulator tile that lane (g, t)
// writes: lanes t and t ^ 1 swap half their accumulators, so that even t
// holds row g, columns 2t .. 2t + 3, and odd t row g + 8, columns
// 2t - 2 .. 2t + 1 (c: the lane's d0..d3)
__device__ __forceinline__ float4 acc_quad(const float (&c)[4], bool odd) {
  const float s0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
  const float s1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
  return odd ? make_float4(s0, s1, c[2], c[3])
             : make_float4(c[0], c[1], s0, s1);
}

// G[i * up16(na + nb) + k] (+)= sum_p d[i][p] x[k][p], the product
// weight's gradient in the staged layout (its partial-gradient row's
// weight block, grad_row): every i < up16(n_out), k < up16(na + nb), the
// padding zero; x the rows ina (na) then inb. add: onto the row (a block's
// later tiles). Each lane writes 4 consecutive floats of one row
// (acc_quad), 16-byte aligned: whole 32-byte sectors, read and written
// past L1 and first out of L2 (the row is read back once per tile, the
// staged weights by every tile). Reads only the tile's rows; no
// synchronisation.
template <int NT, int WM, int WN, int NP, bool RA>
__device__ void wgrad_mma(float* __restrict__ G, const float* d, int n_out,
                          const float* ina, int na, const float* inb, int nb,
                          int P, int LDP, bool add) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
  const int n_in = na + nb, ldg = up16(n_in), rows = up16(n_out);
  const int um = (rows / 16 + WM - 1) / WM;
  const int un = ((n_in + 7) / 8 + WN - 1) / WN;
  const int units = um * un;
  // this lane's 4 floats of output tile (wm, wn) of unit u
  auto out = [&](int u, int wm, int wn) {
    return reinterpret_cast<float4*>(
        G + (size_t)(u / un * 16 * WM + 16 * wm + g + (odd ? 8 : 0)) * ldg +
        u % un * 8 * WN + 8 * wn + 2 * t - (odd ? 2 : 0));
  };
  // RA (read ahead), with add: the row's values of the warp's next unit
  // are read while the current one computes, two units' reads in flight
  // a warp (else each unit reads its own before it writes)
  float4 next[WM][WN];
  auto fetch = [&](int u) {
#pragma unroll
    for (int wm = 0; wm < WM; ++wm)
#pragma unroll
      for (int wn = 0; wn < WN; ++wn)
        if (u / un * 16 * WM + 16 * wm < rows)
          next[wm][wn] = __ldcs(out(u, wm, wn));
  };
  if (RA && add && warp < units) fetch(warp);
  for (int u = warp; u < units; u += NW) {
    const int m0 = u / un * 16 * WM, n0 = u % un * 8 * WN;
    float4 prev[WM][WN];
#pragma unroll
    for (int wm = 0; wm < WM; ++wm)
#pragma unroll
      for (int wn = 0; wn < WN; ++wn) prev[wm][wn] = next[wm][wn];
    if (RA && add && u + NW < units) fetch(u + NW);
    const float* xr[WN];
#pragma unroll
    for (int wn = 0; wn < WN; ++wn) {
      const int k = n0 + 8 * wn + g;
      xr[wn] = k >= n_in ? nullptr : k < na ? ina + k * LDP
                                            : inb + (k - na) * LDP;
    }
    float acc[WM][WN][4] = {};
    for (int p0 = 0; p0 < P; p0 += 16) {
      uint32_t b[WN][NP][2];
#pragma unroll
      for (int wn = 0; wn < WN; ++wn)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int p = p0 + 2 * t + 8 * q;
          const float* x = xr[wn];
          uint32_t v[NP];
          split<NP>(x && p < P ? x[p] : 0.f, x && p + 1 < P ? x[p + 1] : 0.f,
                    v);
#pragma unroll
          for (int i = 0; i < NP; ++i) b[wn][i][q] = v[i];
        }
#pragma unroll
      for (int wm = 0; wm < WM; ++wm) {
        if (m0 + 16 * wm >= n_out) continue;
        uint32_t a[NP][4];
        load_a_pts<NP>(a, d, LDP, m0 + 16 * wm, n_out, p0, P, lane);
#pragma unroll
        for (int wn = 0; wn < WN; ++wn)
          mma_pieces<NP>(acc[wm][wn], a, b[wn]);
      }
    }
#pragma unroll
    for (int wm = 0; wm < WM; ++wm)
#pragma unroll
      for (int wn = 0; wn < WN; ++wn) {
        float4 v = acc_quad(acc[wm][wn], odd);
        if (m0 + 16 * wm >= rows) continue;
        if (add) {
          const float4 w = RA ? prev[wm][wn] : __ldcs(out(u, wm, wn));
          v = make_float4(w.x + v.x, w.y + v.y, w.z + v.z, w.w + v.w);
        }
        __stcs(out(u, wm, wn), v);
      }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Section timing of the tile, built only with -DK1_PROFILE (the measuring
// library of chip_smoke.py --sections, never the port's): block (0, 0)'s
// thread 0 adds the clocks of each section, the block synchronised at
// both ends, to k1_prof (each source file its own): 0 points and PE,
// 1 forward products, 2 render and losses, 3 weight gradients, 4 input
// gradients, 5 the rest (bias gradients, band folds, activation reloads,
// the dirs gradient), 6 the int8 tile's quantisation passes and scale
// reductions.
#ifdef K1_PROFILE
__device__ unsigned long long k1_prof[8];
__device__ long long k1_clock;
#define K1_IS_PROFILER() \
  (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0)
#define K1_MARK_START()                        \
  do {                                         \
    if (K1_IS_PROFILER()) k1_clock = clock64(); \
  } while (0)
#define K1_MARK(n)                         \
  do {                                     \
    __syncthreads();                       \
    if (K1_IS_PROFILER()) {                \
      const long long k1_t = clock64();    \
      k1_prof[n] += k1_t - k1_clock;       \
      k1_clock = k1_t;                     \
    }                                      \
  } while (0)
#else
#define K1_MARK_START()
#define K1_MARK(n)
#endif

// 1. points xs = (o + z d) / scale of the tile's P = RT S points into
// emb's rows 0..2, the dirs projection into proj, and the sin bands into
// emb's rows 3.. (ray r of the tile at row rbase + ray0 + r; rays past
// n_per are zero). Ends with the block synchronised.
template <int NT>
__device__ __forceinline__ void tile_points(const float* __restrict__ W,
                                            const float* __restrict__ od,
                                            const float* __restrict__ zs,
                                            float sc, const Offsets& off,
                                            float* emb, float* proj,
                                            size_t rbase, int ray0,
                                            int n_per, int S, int P,
                                            int LDP) {
  for (int p = threadIdx.x; p < P; p += NT) {
    const int r = p / S, s = p % S;
    float x0 = 0.f, x1 = 0.f, x2 = 0.f;
    if (ray0 + r < n_per) {
      const size_t gr = rbase + ray0 + r;
      const float* o = od + gr * 6;
      const float z = zs[gr * S + s];
      x0 = (o[0] + o[3] * z) / sc;
      x1 = (o[1] + o[4] * z) / sc;
      x2 = (o[2] + o[5] * z) / sc;
    }
    emb[0 * LDP + p] = x0;
    emb[1 * LDP + p] = x1;
    emb[2 * LDP + p] = x2;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < NDIR * P; idx += NT) {
    const int j = idx / P, p = idx % P;
    const float* d = W + off.dirs + j * 3;
    const float pr =
        emb[p] * d[0] + emb[LDP + p] * d[1] + emb[2 * LDP + p] * d[2];
    proj[j * LDP + p] = pr;
#pragma unroll
    for (int bd = 0; bd < NBAND; ++bd)
      emb[(3 + bd * NDIR + j) * LDP + p] = sinpif(pr * (float)(1 << bd));
  }
  __syncthreads();
}

// Per ray, a warp each, lane s = sample s: render, losses, render backward
// -> dal, dy, and rl[r] the ray's loss, with prefix / suffix scans for the
// serial loops
template <int NT>
__device__ void render_rays(const float* __restrict__ zs,
                            const float* __restrict__ ray,
                            const float* __restrict__ wm, const float* alp,
                            const float* col, float* dal, float* dy, float* rl,
                            size_t rbase, int ray0, int n_per, int S, int RT,
                            int LDP, float cs, float osc) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < RT; r += NT / 32) {
    const int p = r * S + lane;
    const bool on = lane < S;
    if (ray0 + r >= n_per) {
      if (on) {
        dal[p] = 0.f;
        dy[p] = dy[LDP + p] = dy[2 * LDP + p] = 0.f;
      }
      if (lane == 0) rl[r] = 0.f;
      continue;
    }
    const size_t gr = rbase + ray0 + r;
    const float* rp = ray + gr * 8;   // depth, r, g, b, m_obj, m_sem, m_do
    const float z = on ? zs[gr * S + lane] : 0.f;
    const float o = on ? sigmoidf_(alp[p] * 10.f) : 0.f;
    const float fr = on ? (1.f - o) + 1e-10f : 1.f;
    // T_s = prod_{j<s} free_j: inclusive prefix product, shifted
    float incl = fr;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl *= v;
    }
    float T = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) T = 1.f;
    const float term = o * T;
    float c[3], rc[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c[k] = on ? sigmoidf_(col[k * LDP + p]) : 0.f;
      rc[k] = warp_sum(term * c[k]);
    }
    const float dep = warp_sum(term * z), op = warp_sum(term);
    const float dz = z - dep;
    const float var = warp_sum(term * (dz * dz));
    const float info = 1.f / (sqrtf(var) + 1e-4f);
    const float m_obj = rp[4], m_sem = rp[5], m_do = rp[6];
    const float wd = wm[0], wc = wm[1], wo = wm[2];
    const float ld = fabsf(dep - rp[0]) * m_do;
    float lc = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) lc += fabsf(rc[k] - rp[1 + k]);
    lc *= m_obj;
    const float lo = fabsf(op - m_obj) * m_sem;
    if (lane == 0) rl[r] = wd * (ld * info) + cs * (wc * lc) + osc * (wo * lo);

    const float g_d = wd * m_do * info * sgnf(dep - rp[0]);
    float g_c[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      g_c[k] = cs * wc * m_obj * sgnf(rc[k] - rp[1 + k]);
    const float g_o = osc * wo * m_sem * sgnf(op - m_obj);
    // docc_s = T_s (dterm_s - R_s), R_s = sum_{i>s} dterm_i occ_i
    // prod_{s<j<i} free_j: Q_i = a_i + b_i Q_{i+1} with a = dterm occ,
    // b = free, as an inclusive suffix scan of affine maps, shifted
    const float dterm = g_d * z + g_c[0] * c[0] + g_c[1] * c[1]
                        + g_c[2] * c[2] + g_o;
    float A = dterm * o, B = fr;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float a2 = __shfl_down_sync(FULL, A, d);
      const float b2 = __shfl_down_sync(FULL, B, d);
      if (lane + d < 32) {
        A = A + B * a2;
        B = B * b2;
      }
    }
    float R = __shfl_down_sync(FULL, A, 1);
    if (lane == 31) R = 0.f;
    if (on) {
      const float docc = T * (dterm - R);
      dal[p] = 10.f * (docc * o * (1.f - o));
#pragma unroll
      for (int k = 0; k < 3; ++k)
        dy[k * LDP + p] = g_c[k] * term * c[k] * (1.f - c[k]);
    }
  }
}

// 3. render_rays, then the tile's loss (the sum of rl) to *loss (added
// onto it with add). Ends with the block synchronised.
template <int NT>
__device__ __forceinline__ void render_loss(
    const float* __restrict__ zs, const float* __restrict__ ray,
    const float* __restrict__ wm, const float* alp, const float* col,
    float* dal, float* dy, float* rl, float* __restrict__ loss, bool add,
    size_t rbase, int ray0, int n_per, int S, int RT, int LDP, float cs,
    float osc) {
  render_rays<NT>(zs, ray, wm, alp, col, dal, dy, rl, rbase, ray0, n_per, S,
                  RT, LDP, cs, osc);
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int r = 0; r < RT; ++r) acc += rl[r];
    *loss = add ? *loss + acc : acc;
  }
}

// dproj[j][p] (+)= sum over bands b0 .. b0 + nb - 1 of
// band_grad(gb[(b - b0) NDIR + j][p], proj[j][p], b): the bands' input
// gradients gb folded into the projection's
template <int NT>
__device__ void fold_bands(float* dproj, const float* gb, const float* proj,
                           int b0, int nb, int P, int LDP, bool add) {
  for (int idx = threadIdx.x; idx < NDIR * P; idx += NT) {
    const int j = idx / P, p = idx % P;
    float acc = add ? dproj[j * LDP + p] : 0.f;
    for (int b = 0; b < nb; ++b)
      acc += band_grad(gb[(b * NDIR + j) * LDP + p], proj[j * LDP + p],
                       b0 + b);
    dproj[j * LDP + p] = acc;
  }
}

// The float tile's shared-memory rows, each [LDP] (point index fastest)
// but rl [RT]: the embedding (xs rows 0..2, bands), the projection and its
// gradient, two hidden-activation buffers a and b (float_backward names
// what each holds when), the heads' outputs and gradients, 42 rows for band
// gradients, the per-ray losses (train_step.cu float_smem_bytes).
template <int H>
struct FloatBufs {
  float *emb, *proj, *dproj, *a, *b, *alp, *col, *dal, *dy, *band, *rl;
  __device__ __forceinline__ FloatBufs(float* sm, int LDP)
      : emb(sm), proj(emb + EMB * LDP), dproj(proj + NDIR * LDP),
        a(dproj + NDIR * LDP), b(a + H * LDP), alp(b + H * LDP),
        col(alp + LDP), dal(col + 3 * LDP), dy(dal + LDP),
        band(dy + 3 * LDP), rl(band + 2 * NDIR * LDP) {}
};
// FloatBufs' floats up to rl: EMB + 4 NDIR + 2 H + 8 rows of LDP
__host__ __device__ constexpr size_t float_rows(int H) {
  return EMB + 4 * NDIR + 2 * H + 8;
}

// rows [H][LDP] (their first P entries) between shared memory and the
// block's activation scratch in global memory (L2-resident: a tile's h1,
// h2, h3, written in the forward and read once in the backward); a reload
// rounds to bf16 under R (the saved activations a bf16 backward reads)
template <int NT>
__device__ __forceinline__ void save_rows(float* __restrict__ g,
                                          const float* s, int n, int P,
                                          int LDP) {
  for (int idx = threadIdx.x; idx < n * P; idx += NT) {
    const int i = idx / P, p = idx % P;
    g[i * LDP + p] = s[i * LDP + p];
  }
}
template <int NT, bool R>
__device__ __forceinline__ void load_rows(float* s,
                                          const float* __restrict__ g, int n,
                                          int P, int LDP) {
  for (int idx = threadIdx.x; idx < n * P; idx += NT) {
    const int i = idx / P, p = idx % P;
    s[i * LDP + p] = rnd<R>(g[i * LDP + p]);
  }
}

// 4. The float tile's MLP backward under policy POL, after the render:
// FloatBufs a holds hc (the colour head's hidden layer), b h4, the
// activation scratch hs h1, h2, h3 ([3][H][LDP]), emb the embedding, dal
// and dy the heads' output gradients. Each activation buffer becomes its
// pre-activation gradient once its own weight gradient has been taken; h3,
// h2, h1 come back from the scratch into the buffer whose gradient has
// just been consumed. Under a bf16 backward policy each gradient's bias
// gradient comes first, from its f32 values (bgrad_round), and the
// products then read it rounded. The weight gradients go to G (the row's
// weights, staged) and G + NS (its dirs and biases). Ends with the block
// synchronised.
template <int H, int POL>
__device__ __forceinline__ void float_backward(
    const float* __restrict__ W, const bf16* __restrict__ ws, int NS,
    float* __restrict__ G, const float* __restrict__ hs, Offsets off,
    const FloatBufs<H>& bufs, int P, int LDP, bool add, bf16* slab0,
    bf16* slab1) {
  using T = Tile<H>;
  constexpr int NT = T::NT;
  constexpr bool RB = POL == BWD_BF16 || POL == BF16;   // backward rounded
  constexpr int NB = bwd_pieces<POL>();
  constexpr int DWM = T::DWM, DWN = T::DWN, DMU = T::DMU;
  float *emb = bufs.emb, *proj = bufs.proj, *dproj = bufs.dproj;
  float *a = bufs.a, *b = bufs.b, *dal = bufs.dal, *dy = bufs.dy;
  float *band = bufs.band, *emb2 = emb + EMB1 * LDP;
  const float *s1 = hs, *s2 = hs + H * LDP, *s3 = hs + 2 * H * LDP;
  float* Gx = G + NS;   // the row's dirs and biases (grad_row)

  if constexpr (RB) {
    bgrad_round<NT>(Gx + off.b_col_out, dy, 3, P, LDP, add);
    bgrad_round<NT>(Gx + off.b_alpha, dal, 1, P, LDP, add);
  }
  K1_MARK(5);
  wgrad_mma<NT, 1, 2, NB, T::RA>(G + mat_off(H, M_OUT), dy, 3, a, H, nullptr,
                                 0, P, LDP, add);
  wgrad_mma<NT, 1, 2, NB, T::RA>(G + mat_off(H, M_ALPHA), dal, 1, b, H,
                                 nullptr, 0, P, LDP, add);
  K1_MARK(3);
  if constexpr (!RB) {
    bgrad<NT>(Gx + off.b_col_out, dy, 3, P, LDP, add);
    bgrad<NT>(Gx + off.b_alpha, dal, 1, P, LDP, add);
  }
  K1_MARK(5);
  dgrad_mma<H, DWM, DWN, DMU, NB>(ws, NS, M_OUT, dy, P, LDP, slab0, slab1,
      [&](int k, int p, float g) {   // a: hc -> dhc
        if (k < H) a[k * LDP + p] = a[k * LDP + p] > 0.f ? g : 0.f;
      });
  __syncthreads();
  K1_MARK(4);
  if constexpr (RB) bgrad_round<NT>(Gx + off.b_col, a, H, P, LDP, add);
  K1_MARK(5);
  wgrad_mma<NT, 2, 2, NB, T::RA>(G + mat_off(H, M_COL), a, H, b, H, emb2, EMB2,
                                 P, LDP, add);
  K1_MARK(3);
  if constexpr (!RB) bgrad<NT>(Gx + off.b_col, a, H, P, LDP, add);
  // b: h4 -> its gradient, w_col^T dhc + w_alpha^T dal (the alpha head's
  // rank-one term in f32, from the weight the policy's products read); the
  // band columns' gradients into emb2's rows, dead once w_col's weight
  // gradient is taken
  const float* wa = W + off.w_alpha;
  const bf16* wah = ws + mat_off(H, M_ALPHA);
  K1_MARK(5);
  dgrad_mma<H, DWM, DWN, DMU, NB>(ws, NS, M_COL, a, P, LDP, slab0, slab1,
      [&](int k, int p, float g) {
        if (k < H) {
          const float w = RB ? __bfloat162float(wah[k]) : wa[k];
          b[k * LDP + p] = b[k * LDP + p] > 0.f ? g + w * dal[p] : 0.f;
        } else if (k < H + EMB2) {
          emb2[(k - H) * LDP + p] = g;
        }
      });
  __syncthreads();
  K1_MARK(4);
  fold_bands<NT>(dproj, emb2, proj, 4, 2, P, LDP, false);
  load_rows<NT, RB>(a, s3, H, P, LDP);   // a: h3
  __syncthreads();
  if constexpr (RB) bgrad_round<NT>(Gx + off.b_mid2, b, H, P, LDP, add);
  K1_MARK(5);
  wgrad_mma<NT, 2, 2, NB, T::RA>(G + mat_off(H, M_MID2), b, H, a, H, nullptr,
                                 0, P, LDP, add);
  K1_MARK(3);
  if constexpr (!RB) bgrad<NT>(Gx + off.b_mid2, b, H, P, LDP, add);
  K1_MARK(5);
  dgrad_mma<H, DWM, DWN, DMU, NB>(ws, NS, M_MID2, b, P, LDP, slab0, slab1,
      [&](int k, int p, float g) {   // a: h3 -> dh3
        if (k < H) a[k * LDP + p] = a[k * LDP + p] > 0.f ? g : 0.f;
      });
  __syncthreads();
  K1_MARK(4);
  load_rows<NT, RB>(b, s2, H, P, LDP);   // b: h2
  __syncthreads();
  if constexpr (RB) bgrad_round<NT>(Gx + off.b_cat, a, H, P, LDP, add);
  K1_MARK(5);
  wgrad_mma<NT, 2, 2, NB, T::RA>(G + mat_off(H, M_CAT), a, H, b, H, emb, EMB1,
                                 P, LDP, add);
  K1_MARK(3);
  if constexpr (!RB) bgrad<NT>(Gx + off.b_cat, a, H, P, LDP, add);
  // b: h2 -> dh2; the trunk's band columns (emb1 without xs): bands 0, 1
  // into emb2's rows (dead since their fold), bands 2, 3 into band
  K1_MARK(5);
  dgrad_mma<H, DWM, DWN, DMU, NB>(ws, NS, M_CAT, a, P, LDP, slab0, slab1,
      [&](int k, int p, float g) {
        if (k < H)
          b[k * LDP + p] = b[k * LDP + p] > 0.f ? g : 0.f;
        else if (k >= H + 3 && k < H + EMB1)
          (k < H + 3 + 2 * NDIR ? emb2 + (k - H - 3) * LDP
                                : band + (k - H - 3 - 2 * NDIR) * LDP)[p] = g;
      });
  __syncthreads();
  K1_MARK(4);
  fold_bands<NT>(dproj, emb2, proj, 0, 2, P, LDP, true);
  fold_bands<NT>(dproj, band, proj, 2, 2, P, LDP, true);
  load_rows<NT, RB>(a, s1, H, P, LDP);   // a: h1
  __syncthreads();
  if constexpr (RB) bgrad_round<NT>(Gx + off.b_mid1, b, H, P, LDP, add);
  K1_MARK(5);
  wgrad_mma<NT, 2, 2, NB, T::RA>(G + mat_off(H, M_MID1), b, H, a, H, nullptr,
                                 0, P, LDP, add);
  K1_MARK(3);
  if constexpr (!RB) bgrad<NT>(Gx + off.b_mid1, b, H, P, LDP, add);
  K1_MARK(5);
  dgrad_mma<H, DWM, DWN, DMU, NB>(ws, NS, M_MID1, b, P, LDP, slab0, slab1,
      [&](int k, int p, float g) {   // a: h1 -> dh1
        if (k < H) a[k * LDP + p] = a[k * LDP + p] > 0.f ? g : 0.f;
      });
  __syncthreads();
  K1_MARK(4);
  if constexpr (RB) bgrad_round<NT>(Gx + off.b_in, a, H, P, LDP, add);
  K1_MARK(5);
  wgrad_mma<NT, 2, 2, NB, T::RA>(G + mat_off(H, M_IN), a, H, emb, EMB1,
                                 nullptr, 0, P, LDP, add);
  K1_MARK(3);
  if constexpr (!RB) bgrad<NT>(Gx + off.b_in, a, H, P, LDP, add);
  // the band columns' gradients into emb1's band rows, dead once w_in's
  // weight gradient is taken (xs, rows 0..2, stays for the dirs gradient)
  K1_MARK(5);
  dgrad_mma<H, DWM, DWN, DMU, NB>(ws, NS, M_IN, a, P, LDP, slab0, slab1,
      [&](int k, int p, float g) {
        if (k >= 3 && k < EMB1) emb[k * LDP + p] = g;
      });
  __syncthreads();
  K1_MARK(4);
  fold_bands<NT>(dproj, emb + 3 * LDP, proj, 0, 4, P, LDP, true);
  __syncthreads();
  if constexpr (RB) {
    round_rows<NT>(dproj, NDIR, P, LDP);
    __syncthreads();
  }
  // d dirs[j][k] = sum_p dproj[j][p] xs[k][p]
  wgrad<NT>(Gx + off.dirs, 3, 0, dproj, NDIR, emb, 3, P, LDP, add);
  __syncthreads();
  K1_MARK(5);
}

// the SM count of the current device (the launchers' grids: field_plan.cuh,
// update_plan.cuh)
inline int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// The offsets array of a C entry (the order of kernels/train_step.py
// OFFSET_NAMES).
inline Offsets offsets_from(const int* o) {
  return {o[0], o[1], o[2],  o[3],  o[4],  o[5],  o[6], o[7],
          o[8], o[9], o[10], o[11], o[12], o[13], o[14]};
}

// The geometry checks shared by the train_grad C entries.
inline bool grad_args_ok(int cap, int n_per, int n_iter, int n_eff, int it,
                         int S, int RT, int n_tiles, int n_rows) {
  return S >= 1 && S <= MAX_S && RT >= 1 && RT <= MAX_RT &&
         n_tiles * RT >= n_per && n_rows >= 1 && n_rows <= n_tiles &&
         it >= 0 && it < n_iter && n_eff >= 1 && n_iter % n_eff == 0 &&
         cap >= 1;
}

}  // namespace
