// K1's int8 tile and its weights' quantisation (train_step_q8.cu's
// design comment): the tile, train_grad_q8_kernel, quant_weights_kernel
// and the launch of one width's instances. train_step_q8.cu instantiates
// them at h = 32, 128 and 256, train_step_q8_narrow.cu at h = 16 and 64,
// in a translation unit of its own so that the build's files compile side
// by side.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "train_step.cuh"

namespace cg = cooperative_groups;

namespace {

// the xs rows of the trunk's embedding quantise x127 / XS_RANGE (4)
constexpr float XS_MUL = 127.f / 4.f;
constexpr float INV_XS = 1.f / XS_MUL;
constexpr float INV_127 = 1.f / 127.f;

// x * mul rounded (half to even) to an integer in [-127, 127]
__device__ __forceinline__ float q8(float x, float mul) {
  return rintf(fminf(fmaxf(__fmul_rn(x, mul), -127.f), 127.f));
}
__device__ __forceinline__ int8_t to_s8(float q) { return (int8_t)(int)q; }

__host__ __device__ constexpr int up8(int x) { return (x + 7) / 8 * 8; }

// the nine quantised weight tensors (QW_*) and their staged s8 copies
// (q8_layout: qw_off, qwt_off, q8_size) are update_plan.cuh's

// ---- the int8 tile's shape per width (threads: Tile<H>::NT). FP the most
// points of a tile (kernels.MAX_POINTS, the scale granularity); a warp's
// product unit is one 16-row m tile by WN 8-point n tiles; KS the slab's
// columns; MINB the blocks an SM the registers must allow. h=16 and h=64
// take the plan of the width next to them (h=32's blocks an SM, h=128's),
// with WN set so that a hidden layer's units are the block's 8 warps (h=16:
// one 16-row tile by 8 n tiles of one; h=64: four by 2 of 4).
template <int H>
struct Q8Tile;
template <>
struct Q8Tile<16> {
  static constexpr int FP = 64, WN = 1, KS = 96, MINB = 2;
};
template <>
struct Q8Tile<32> {
  static constexpr int FP = 64, WN = 2, KS = 96, MINB = 2;
};
template <>
struct Q8Tile<64> {
  static constexpr int FP = 56, WN = 4, KS = 96, MINB = 1;
};
template <>
struct Q8Tile<128> {
  static constexpr int FP = 56, WN = 7, KS = 128, MINB = 1;
};
template <>
struct Q8Tile<256> {
  static constexpr int FP = 38, WN = 5, KS = 64, MINB = 1;
};

// n units of a product at FP points; units a warp holds for M rows
template <int H>
__host__ __device__ constexpr int q8_nu() {
  return ((Q8Tile<H>::FP + 7) / 8 + Q8Tile<H>::WN - 1) / Q8Tile<H>::WN;
}
template <int H>
__host__ __device__ constexpr int q8_mu(int M) {
  return (M / 16 * q8_nu<H>() + Tile<H>::NT / 32 - 1) / (Tile<H>::NT / 32);
}

// bytes of one slab: the largest product's rows x (its columns, at most
// KS, + 16): the forward's H rows over up to max(96, H) columns, the input
// gradients' up to 96 rows (the embedding's) over up32(H) (a hidden
// depth's whole k32 steps: q8_tile)
template <int H>
__host__ __device__ constexpr size_t q8_slab_s8() {
  constexpr int KS = Q8Tile<H>::KS;
  constexpr int kf = (H > 96 ? H : 96) < KS ? (H > 96 ? H : 96) : KS;
  constexpr int kb = up32(H) < KS ? up32(H) : KS;
  constexpr size_t f = (size_t)H * (kf + 16), b = (size_t)96 * (kb + 16);
  return f > b ? f : b;
}
// QB (INT8): the s8 slabs; INT8_FWD also the float backward's bf16 slabs
template <int H, bool QB>
__host__ __device__ constexpr size_t q8_slab() {
  return QB || q8_slab_s8<H>() > slab_bytes<H, F32>() ? q8_slab_s8<H>()
                                                       : slab_bytes<H, F32>();
}

// The tile's shared memory after the two slabs: f32 rows of LDP, then
// the s8 copies (16-byte aligned).
//   QB: emb [EMB], proj, dproj [NDIR], alp, col [3], dal, dy [3], rl [RT],
//       red [32], bpart [H][q8_nu] (the bias gradients' partials);
//   INT8_FWD: FloatBufs' rows, rl [RT], red [32].
// s8: point-major copies [up8(P)][K + 16]: ph (K = H), pe1 (96), pe2 (64),
// and under QB pdl, pda (32, the head gradients); QB also feature-major
// copies [rows][up32(P) + 16]: fe1 (96), fe2 (64), fh1..fh4, fc (H each),
// fdl, fda (16).
template <int H, bool QB>
__host__ __device__ constexpr size_t q8_f32_bytes(int LDP, int RT) {
  return (4 * ((QB ? (size_t)(EMB + 2 * NDIR + 8) * LDP + H * q8_nu<H>()
                   : float_rows(H) * LDP) + RT + 32) + 15) / 16 * 16;
}
template <int H, bool QB>
__host__ __device__ constexpr size_t q8_s8_bytes(int P) {
  return (size_t)up8(P) * (H + 16 + 112 + 80 + (QB ? 2 * 48 : 0)) +
         (QB ? (size_t)(up32(P) + 16) * (96 + 64 + 5 * H + 32) : 0);
}
template <int H, bool QB>
__host__ __device__ constexpr size_t q8_smem_bytes(int P, int RT) {
  return 2 * q8_slab<H, QB>() + q8_f32_bytes<H, QB>(P | 1, RT) +
         q8_s8_bytes<H, QB>(P);
}

// acc (and acc1: TWO) += this warp's units of A x B over segment 0 (and
// segment 1, into acc1): A global [M][K] s8 row-major (K a multiple of 32,
// streamed through the two slabs), B shared [points][ldb] s8 point-major.
// Unit u: m tile u / un, n tiles from (u % un) WN; only the n tiles with
// points are computed. Starts by staging its first slab; ends with the
// slabs free (the block synchronised after its last read of them and of
// B).
template <int H, int MU, bool TWO>
__device__ __forceinline__ void prod_s8(
    int (&acc)[MU][Q8Tile<H>::WN][4], int (&acc1)[MU][Q8Tile<H>::WN][4],
    const int8_t* __restrict__ A0, int K0, const int8_t* B0, int ldb0,
    const int8_t* __restrict__ A1, int K1, const int8_t* B1, int ldb1,
    int M, int P, int8_t* slab0, int8_t* slab1) {
  constexpr int NT = Tile<H>::NT, NW = NT / 32, WN = Q8Tile<H>::WN;
  constexpr int KS = Q8Tile<H>::KS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt = (P + 7) >> 3, un = (nt + WN - 1) / WN, units = M / 16 * un;
  if (units > MU * NW) __trap();   // Q8Tile<H> does not cover this product
#pragma unroll
  for (int j = 0; j < MU; ++j)
#pragma unroll
    for (int wn = 0; wn < WN; ++wn)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[j][wn][q] = 0;
        if constexpr (TWO) acc1[j][wn][q] = 0;
      }
  const int kmax = TWO && K1 > K0 ? K1 : K0;
  const int LD = (kmax < KS ? kmax : KS) + 16;
  const int ns0 = (K0 + KS - 1) / KS;
  const int ns = ns0 + (TWO ? (K1 + KS - 1) / KS : 0);
  int8_t* buf[2] = {slab0, slab1};
  auto stage = [&](int s) {   // columns [c0, c0 + kw) of the segment's A
    const bool seg1 = TWO && s >= ns0;
    const int K = seg1 ? K1 : K0, c0 = (seg1 ? s - ns0 : s) * KS;
    const int kw = K - c0 < KS ? K - c0 : KS;
    // the copies' destinations run from the slab's first byte to row M - 1,
    // column kw - 16 (16 bytes each, in order)
    SMEM_CHECK(buf[s & 1], buf[s & 1], 16, 1);
    SMEM_CHECK(buf[s & 1], buf[s & 1] + (M - 1) * LD + kw - 16, 16, 2);
    stage_slab<NT, 1>(reinterpret_cast<bf16*>(buf[s & 1]), LD / 2,
                      reinterpret_cast<const bf16*>(seg1 ? A1 : A0), 0,
                      K / 2, 0, M, c0 / 2, kw / 2);
  };
  stage(0);
  for (int s = 0; s < ns; ++s) {
    if (s + 1 < ns) {
      stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool seg1 = TWO && s >= ns0;
    const int K = seg1 ? K1 : K0, c0 = (seg1 ? s - ns0 : s) * KS;
    const int kw = K - c0 < KS ? K - c0 : KS;
    const int8_t* B = seg1 ? B1 : B0;
    const int ldb = seg1 ? ldb1 : ldb0;
    const int8_t* sh = buf[s & 1];
#pragma unroll
    for (int j = 0; j < MU; ++j) {
      const int u = warp + j * NW;
      if (u < units) {
        const int m0 = u / un * 16, n0 = u % un * WN;   // n0 in n tiles
        for (int kk = 0; kk < kw; kk += 32) {
          uint32_t a[4];
          load_a_s8(a, sh, LD, m0, kk, lane);
#pragma unroll
          for (int wn = 0; wn < WN; ++wn) {
            if (n0 + wn >= nt) continue;
            uint32_t b[2];
            load_b_s8(b, B, ldb, 8 * (n0 + wn), c0 + kk, lane);
            if (seg1)
              mma_s8(acc1[j][wn], a, b);
            else
              mma_s8(acc[j][wn], a, b);
          }
        }
      }
    }
    __syncthreads();
  }
}

// f(j, wn, q, i, p) for every accumulator element of this warp's units of
// an M-row product: row i, point p (p may pass P; f checks it)
template <int H, int MU, class F>
__device__ __forceinline__ void for_acc(int M, int P, F f) {
  constexpr int NW = Tile<H>::NT / 32, WN = Q8Tile<H>::WN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt = (P + 7) >> 3, un = (nt + WN - 1) / WN, units = M / 16 * un;
#pragma unroll
  for (int j = 0; j < MU; ++j) {
    const int u = warp + j * NW;
    if (u >= units) continue;
    const int m0 = u / un * 16, n0 = u % un * WN * 8;
#pragma unroll
    for (int wn = 0; wn < WN; ++wn)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        f(j, wn, q, m0 + (lane >> 2) + (q >> 1) * 8,
          n0 + 8 * wn + 2 * (lane & 3) + (q & 1));
  }
}

// the largest m over the block, in every thread; starts and ends with the
// block synchronised after its use of red
template <int NT>
__device__ __forceinline__ float block_max(float m, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = 0.f;
  for (int w = 0; w < NT / 32; ++w) m = fmaxf(m, red[w]);
  __syncthreads();   // red is free for the next reduction
  return m;
}

struct QScale {
  float s, inv;   // the scale, and the multiplier that quantises
};

// the static pair st (scale, 127 / maximum), or where st is null the
// dynamic scale of a tensor whose abs-max over the tile is amax
__device__ __forceinline__ QScale q_scale(const float* st, float amax) {
  if (st) return {st[0], st[1]};
  const float s = __fadd_rn(__fmul_rn(amax, INV_127), 1e-30f);
  return {s, 1.f / s};
}

// this warp's values v (f32 bits, rows i < n, points p < P) quantised at
// inv into fm [][LDQ] (if not null) and pm [][ldpm]
template <int H, int MU>
__device__ __forceinline__ void store_q8(
    const int (&v)[MU][Q8Tile<H>::WN][4], int M, int n, int P, float inv,
    int8_t* fm, int LDQ, int8_t* pm, int ldpm) {
  for_acc<H, MU>(M, P, [&](int j, int wn, int q, int i, int p) {
    if (i < n && p < P) {
      const int8_t c = to_s8(q8(__int_as_float(v[j][wn][q]), inv));
      if (fm) {
        SMEM_CHECK(fm, fm + i * LDQ + p, 1, 7);
        fm[i * LDQ + p] = c;
      }
      SMEM_CHECK(pm, pm + p * ldpm + i, 1, 8);
      pm[p * ldpm + i] = c;
    }
  });
}

// One hidden layer of the s8 forward: y = relu(acc0 sa (+ acc1 sb) + b)
// for the tile's points, its scale (the static pair st, else the abs-max
// over the tile's first PV points, those of its rays within n_per: the
// plain version's tiles hold no padded rays),
// y quantised into pm [up8(P)][H + 16] (the next products' B) and, with
// fm, into fm [H][LDQ] (the backward's); with f32, y itself to f32
// [H][LDP] (int8_fwd's f32 backward). Returns the scale. Ends with the
// copies written, not synchronised.
template <int H, bool TWO>
__device__ __forceinline__ float fwd_layer(
    const int8_t* A0, int K0, const int8_t* B0, int ldb0, float sa,
    const int8_t* A1, int K1, const int8_t* B1, int ldb1, float sb,
    const float* __restrict__ bias, const float* st, float* red, int8_t* fm,
    int LDQ, int8_t* pm, float* f32, int LDP, int P, int PV, int8_t* slab0,
    int8_t* slab1) {
  constexpr int MU = q8_mu<H>(H), WN = Q8Tile<H>::WN;
  int acc[MU][WN][4], acc1[MU][WN][4];
  prod_s8<H, MU, TWO>(acc, acc1, A0, K0, B0, ldb0, A1, K1, B1, ldb1, H, P,
                      slab0, slab1);
  K1_MARK(1);
  float m = 0.f;
  for_acc<H, MU>(H, P, [&](int j, int wn, int q, int i, int p) {
    float y = __fmul_rn((float)acc[j][wn][q], sa);
    if constexpr (TWO) y = __fadd_rn(y, __fmul_rn((float)acc1[j][wn][q], sb));
    y = fmaxf(__fadd_rn(y, bias[i]), 0.f);
    if (f32 && p < P) f32[i * LDP + p] = y;
    if (p < PV) m = fmaxf(m, y);
    acc[j][wn][q] = __float_as_int(y);
  });
  const QScale qs = q_scale(st, st ? 0.f : block_max<Tile<H>::NT>(m, red));
  store_q8<H, MU>(acc, H, H, P, qs.inv, fm, LDQ, pm, H + 16);
  K1_MARK(6);
  return qs.s;
}

// A head of the s8 forward: out[i][p] = acc s + b[i] (i < n: the alpha
// head 1, the colour head 3), A [16][H], B the point-major pm [][H + 16]
template <int H>
__device__ __forceinline__ void head_layer(const int8_t* A, const int8_t* B,
                                           float s,
                                           const float* __restrict__ bias,
                                           float* out, int n, int LDP, int P,
                                           int8_t* slab0, int8_t* slab1) {
  constexpr int MU = q8_mu<H>(16), WN = Q8Tile<H>::WN;
  int acc[MU][WN][4];
  prod_s8<H, MU, false>(acc, acc, A, up32(H), B, H + 16, nullptr, 0,
                        nullptr, 0, 16, P, slab0, slab1);
  for_acc<H, MU>(16, P, [&](int j, int wn, int q, int i, int p) {
    if (i < n && p < P)
      out[i * LDP + p] = __fadd_rn(__fmul_rn((float)acc[j][wn][q], s),
                                   bias[i]);
  });
  K1_MARK(1);
}

// The input gradient of a hidden layer under the s8 backward: g = acc0 sa
// (+ acc1 sb) where the layer's quantised activation (fm, feature-major)
// is > 0, else 0. Its f32 bias gradient to Gb (added with add): each row's
// sum over the tile's points, a quad's lanes by shuffles, then one partial
// per (row, n unit) in bpart, added in unit order. Its scale (st, else the
// abs-max), then g quantised in place over the activation in fm [H][LDQ]
// (the mask read, its own element, before) and into pm [][H + 16].
// Returns the scale. Ends with the copies written, not synchronised.
template <int H, bool TWO>
__device__ __forceinline__ float bwd_layer(
    const int8_t* A0, int K0, const int8_t* B0, int ldb0, float sa,
    const int8_t* A1, int K1, const int8_t* B1, int ldb1, float sb,
    const float* st, float* red, float* bpart, float* __restrict__ Gb,
    bool add, int8_t* fm, int LDQ, int8_t* pm, int P, int8_t* slab0,
    int8_t* slab1) {
  constexpr int NT = Tile<H>::NT, NW = NT / 32, WN = Q8Tile<H>::WN;
  constexpr int MU = q8_mu<H>(H), NU = q8_nu<H>();
  int acc[MU][WN][4], acc1[MU][WN][4];
  prod_s8<H, MU, TWO>(acc, acc1, A0, K0, B0, ldb0, A1, K1, B1, ldb1, H, P,
                      slab0, slab1);
  float m = 0.f;
  for_acc<H, MU>(H, P, [&](int j, int wn, int q, int i, int p) {
    float g = __fmul_rn((float)acc[j][wn][q], sa);
    if constexpr (TWO) g = __fadd_rn(g, __fmul_rn((float)acc1[j][wn][q], sb));
    if (p < P) SMEM_CHECK(fm, fm + i * LDQ + p, 1, 13);
    if (!(p < P && fm[i * LDQ + p] > 0)) g = 0.f;
    m = fmaxf(m, fabsf(g));
    acc[j][wn][q] = __float_as_int(g);
  });
  // (a section mark right after prod_s8 here, at h=128, made the
  // K1_PROFILE build trap with an illegal instruction; after the mask it
  // does not: kernels/q8_profile_fault.py)
  K1_MARK(4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt = (P + 7) >> 3, un = (nt + WN - 1) / WN, units = H / 16 * un;
#pragma unroll
  for (int j = 0; j < MU; ++j) {
    const int u = warp + j * NW;
    if (u >= units) continue;
    float r0 = 0.f, r1 = 0.f;   // rows g and g + 8 of the unit
#pragma unroll
    for (int wn = 0; wn < WN; ++wn)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = __int_as_float(acc[j][wn][q]);
        if (q < 2)
          r0 += v;
        else
          r1 += v;
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      r0 += __shfl_xor_sync(0xffffffffu, r0, o);
      r1 += __shfl_xor_sync(0xffffffffu, r1, o);
    }
    if ((lane & 3) == 0) {
      const int i = u / un * 16 + (lane >> 2);
      SMEM_CHECK(bpart, bpart + i * NU + u % un, 4, 14);
      SMEM_CHECK(bpart, bpart + (i + 8) * NU + u % un, 4, 14);
      bpart[i * NU + u % un] = r0;
      bpart[(i + 8) * NU + u % un] = r1;
    }
  }
  __syncthreads();
  const QScale qs = q_scale(st, st ? 0.f : block_max<NT>(m, red));
  for (int i = threadIdx.x; i < H; i += NT) {
    float s = 0.f;
    for (int k = 0; k < un; ++k) {
      SMEM_CHECK(bpart, bpart + i * NU + k, 4, 15);
      s += bpart[i * NU + k];
    }
    Gb[i] = add ? Gb[i] + s : s;
  }
  store_q8<H, MU>(acc, H, H, P, qs.inv, fm, LDQ, pm, H + 16);
  K1_MARK(6);
  return qs.s;
}

// The embedding columns' input gradients of the s8 backward: g = (acc s)
// 127 (the row scale 127 of the band rows, ops/quant.py) of rows [i0, i1)
// of an M-row product (A: the transpose [M][H] of w_col_x, w_cat_x or
// w_in; B the gradient's point-major copy) into the f32 rows dst[i][LDP],
// for fold_bands. Ends with the rows written, not synchronised.
template <int H, int M>
__device__ __forceinline__ void band_layer(const int8_t* A, const int8_t* B,
                                           float s, float* dst, int i0,
                                           int i1, int LDP, int P,
                                           int8_t* slab0, int8_t* slab1) {
  constexpr int MU = q8_mu<H>(M), WN = Q8Tile<H>::WN;
  int acc[MU][WN][4];
  prod_s8<H, MU, false>(acc, acc, A, up32(H), B, H + 16, nullptr, 0,
                        nullptr, 0, M, P, slab0, slab1);
  for_acc<H, MU>(M, P, [&](int j, int wn, int q, int i, int p) {
    if (i >= i0 && i < i1 && p < P)
      dst[i * LDP + p] =
          __fmul_rn(__fmul_rn((float)acc[j][wn][q], s), 127.f);
  });
}

// G[i * ldg + k] (+)= (sum_p D[i][p] X[k][p]) s, times 1 / XS_MUL (k < 3)
// or 1 / 127 under emb (the trunk's embedding columns: their static row
// scale divides the gradient once more), for every i < up16(n_out) and
// k < N (a multiple of 16): D and X feature-major s8 [][LDQ], the points
// padded to P32 with zeros; the weight's gradient in the staged layout of
// its partial-gradient row, 16 bytes a lane (acc_quad) past L1 as
// wgrad_mma; RA: the next unit's row values read ahead. Reads only the
// tile's copies; no synchronisation.
template <int NT, int WM, bool RA>
__device__ void wgrad_s8(float* __restrict__ G, int ldg, const int8_t* D,
                         int n_out, const int8_t* X, int N, int P32, int LDQ,
                         float s, bool emb, bool add) {
  constexpr int NW = NT / 32, WN = 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
  const int rows = up16(n_out), um = (rows / 16 + WM - 1) / WM;
  const int un = N / (8 * WN), units = um * un;
  auto out = [&](int u, int wm, int wn) {
    return reinterpret_cast<float4*>(
        G + (size_t)(u / un * 16 * WM + 16 * wm + g + (odd ? 8 : 0)) * ldg +
        u % un * 8 * WN + 8 * wn + 2 * t - (odd ? 2 : 0));
  };
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
    int acc[WM][WN][4] = {};
    for (int p0 = 0; p0 < P32; p0 += 32) {
      uint32_t b[WN][2];
#pragma unroll
      for (int wn = 0; wn < WN; ++wn)
        load_b_s8(b[wn], X, LDQ, n0 + 8 * wn, p0, lane);
#pragma unroll
      for (int wm = 0; wm < WM; ++wm) {
        if (m0 + 16 * wm >= n_out) continue;
        uint32_t a[4];
        load_a_s8(a, D, LDQ, m0 + 16 * wm, p0, lane);
#pragma unroll
        for (int wn = 0; wn < WN; ++wn) mma_s8(acc[wm][wn], a, b[wn]);
      }
    }
#pragma unroll
    for (int wm = 0; wm < WM; ++wm)
#pragma unroll
      for (int wn = 0; wn < WN; ++wn) {
        float c[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = n0 + 8 * wn + 2 * t + (q & 1);
          c[q] = __fmul_rn((float)acc[wm][wn][q], s);
          if (emb) c[q] = __fmul_rn(c[q], k < 3 ? INV_XS : INV_127);
        }
        float4 v = acc_quad(c, odd);
        if (m0 + 16 * wm >= rows) continue;
        if (add) {
          const float4 w = RA ? prev[wm][wn] : __ldcs(out(u, wm, wn));
          v = make_float4(w.x + v.x, w.y + v.y, w.z + v.z, w.w + v.w);
        }
        __stcs(out(u, wm, wn), v);
      }
  }
}

// The embedding at its static row scales (x XS_MUL the xs rows, x127 the
// sin rows; saturating): the trunk's 87 rows into pe1 [][112] and (FM)
// fe1 [96][LDQ], the colour head's 42 into pe2 [][80] and fe2 [64][LDQ]
template <int NT, bool FM>
__device__ void quant_emb(const float* emb, int P, int LDP, int8_t* fe1,
                          int8_t* fe2, int LDQ, int8_t* pe1, int8_t* pe2) {
  for (int idx = threadIdx.x; idx < EMB * P; idx += NT) {
    const int i = idx / P, p = idx % P;
    const int8_t c = to_s8(q8(emb[i * LDP + p], i < 3 ? XS_MUL : 127.f));
    if (i < EMB1) {
      if (FM) {
        SMEM_CHECK(fe1, fe1 + i * LDQ + p, 1, 9);
        fe1[i * LDQ + p] = c;
      }
      SMEM_CHECK(pe1, pe1 + p * 112 + i, 1, 10);
      pe1[p * 112 + i] = c;
    } else {
      if (FM) {
        SMEM_CHECK(fe2, fe2 + (i - EMB1) * LDQ + p, 1, 9);
        fe2[(i - EMB1) * LDQ + p] = c;
      }
      SMEM_CHECK(pe2, pe2 + p * 80 + i - EMB1, 1, 10);
      pe2[p * 80 + i - EMB1] = c;
    }
  }
}

// A head gradient x [n][LDP] (f32: dlogits, dalpha) at its tile scale
// (st, else the abs-max) into fm [16][LDQ] and pm [][48]; returns the
// scale. Ends with the block synchronised after the reduction, the copies
// written but not synchronised.
template <int NT>
__device__ float quant_head(const float* x, int n, int P, int LDP,
                            const float* st, float* red, int8_t* fm, int LDQ,
                            int8_t* pm) {
  float m = 0.f;
  if (!st)
    for (int idx = threadIdx.x; idx < n * P; idx += NT)
      m = fmaxf(m, fabsf(x[idx / P * LDP + idx % P]));
  const QScale qs = q_scale(st, st ? 0.f : block_max<NT>(m, red));
  for (int idx = threadIdx.x; idx < n * P; idx += NT) {
    const int i = idx / P, p = idx % P;
    const int8_t c = to_s8(q8(x[i * LDP + p], qs.inv));
    SMEM_CHECK(fm, fm + i * LDQ + p, 1, 11);
    SMEM_CHECK(pm, pm + p * 48 + i, 1, 12);
    fm[i * LDQ + p] = c;
    pm[p * 48 + i] = c;
  }
  return qs.s;
}

// One ray tile under an int8 policy (the float tile's contract,
// train_step.cu float_tile): W the slot's f32 parameters, wq its s8 weights
// (q8_layout) with scales wsc, qs the static pairs (null: dynamic), ws its
// staged bf16 pieces and hs the block's activation scratch (INT8_FWD's f32
// backward); sm the f32 rows and s8 the s8 copies (q8_smem_bytes), whose
// padding is zero. Not inlined, as float_tile.
template <int H, int POL>
__device__ __noinline__ void q8_tile(const float* __restrict__ W,
                          const int8_t* __restrict__ wq,
                          const float* __restrict__ wsc,
                          const float* __restrict__ qs,
                          const bf16* __restrict__ ws, int NS,
                          const float* __restrict__ od,
                          const float* __restrict__ zs,
                          const float* __restrict__ ray,
                          const float* __restrict__ wm, float sc,
                          float* __restrict__ G, float* __restrict__ loss,
                          float* __restrict__ hs, Offsets off, size_t rbase,
                          int ray0, int n_per, int S, int RT, int LDP,
                          float cs, float osc, bool add, float* sm,
                          int8_t* s8, int8_t* slab0, int8_t* slab1) {
  constexpr bool QB = POL == INT8;
  constexpr int NT = Tile<H>::NT;
  const int P = RT * S, P8 = up8(P), P32 = up32(P), LDQ = P32 + 16;
  // a hidden depth as whole k32 steps: at h=16 half a step, whose other
  // half reads zero bytes (the s8 weights' copies and transposes are
  // zero-padded to up32 columns, q8_layout, and the point-major copies'
  // columns H .. H + 15 are never written), so the s32 sums stay exact
  constexpr int KH = up32(H);
  // the points of the tile's rays within n_per (a partial last tile's
  // padded rays enter no scale: their gradients are zero, and the forward
  // abs-max skips them)
  const int PV = (n_per - ray0 < RT ? n_per - ray0 : RT) * S;
  // f32 rows (q8_f32_bytes; INT8_FWD: FloatBufs' order)
  float* emb = sm;
  float* proj = emb + EMB * LDP;
  float* dproj = proj + NDIR * LDP;
  float* ha = dproj + NDIR * LDP;          // INT8_FWD: hc, then h4 at hb
  float* hb = ha + H * LDP;
  float* alp = QB ? ha : hb + H * LDP;
  float *col = alp + LDP, *dal = col + 3 * LDP, *dy = dal + LDP;
  float* rl = dy + 3 * LDP + (QB ? 0 : 2 * NDIR * LDP);
  float* red = rl + RT;
  float* bpart = red + 32;
  // s8 copies (q8_s8_bytes)
  int8_t* ph = s8;
  int8_t* pe1 = ph + P8 * (H + 16);
  int8_t* pe2 = pe1 + P8 * 112;
  int8_t* pdl = pe2 + P8 * 80;
  int8_t* pda = pdl + P8 * 48;
  int8_t* fe1 = pda + P8 * 48;
  int8_t* fe2 = fe1 + 96 * LDQ;
  int8_t* fh1 = fe2 + 64 * LDQ;
  int8_t *fh2 = fh1 + H * LDQ, *fh3 = fh2 + H * LDQ, *fh4 = fh3 + H * LDQ;
  int8_t* fc = fh4 + H * LDQ;
  int8_t* fdl = fc + H * LDQ;
  int8_t* fda = fdl + 16 * LDQ;
  const float* act = qs;
  const float* head = qs ? qs + 2 : nullptr;
  const float* hid = qs ? qs + 4 : nullptr;
  auto Wq = [&](int t) { return wq + qw_off(H, t); };
  auto WqT = [&](int t) { return wq + qwt_off(H, t); };
#ifdef VMAP_SMEM_CHECK
  // q8_plan: the regions of q8_smem_bytes, in its order (the block's
  // earlier tile has synchronised after its last access)
  if (threadIdx.x == 0) {
    const size_t SB = slab1 - slab0;
    smem_plan_reset();
    smem_plan_add(slab0, SB);
    smem_plan_add(slab1, SB);
    smem_plan_add(sm, q8_f32_bytes<H, QB>(LDP, RT));
    int8_t* const copies[] = {ph, pe1, pe2, pdl, pda, fe1, fe2, fh1,
                              fh2, fh3, fh4, fc, fdl, fda};
    const size_t bytes[] = {
        (size_t)P8 * (H + 16), (size_t)P8 * 112, (size_t)P8 * 80,
        (size_t)P8 * 48, (size_t)P8 * 48, (size_t)96 * LDQ,
        (size_t)64 * LDQ, (size_t)H * LDQ, (size_t)H * LDQ,
        (size_t)H * LDQ, (size_t)H * LDQ, (size_t)H * LDQ,
        (size_t)16 * LDQ, (size_t)16 * LDQ};
    for (int c = 0; c < (QB ? 14 : 3); ++c)
      smem_plan_add(copies[c], bytes[c]);
    // the copies end where q8_s8_bytes says they do
    if (copies[QB ? 13 : 2] + bytes[QB ? 13 : 2] !=
        s8 + q8_s8_bytes<H, QB>(P))
      smem_trap(0, smem_u32(copies[QB ? 13 : 2]), 0, smem_u32(s8),
                smem_u32(s8) + (uint32_t)q8_s8_bytes<H, QB>(P));
  }
  __syncthreads();
#endif
  K1_MARK_START();

  // 1. points, projection, sin bands; the embedding's s8 copies
  tile_points<NT>(W, od, zs, sc, off, emb, proj, rbase, ray0, n_per, S, P,
                  LDP);
  K1_MARK(0);
  quant_emb<NT, QB>(emb, P, LDP, fe1, fe2, LDQ, pe1, pe2);
  K1_MARK(6);

  // 2. the s8 forward; under INT8_FWD h1..h3 to the scratch, h4 to hb, hc
  //    to ha (f32), for the float backward
  const float s1 = fwd_layer<H, false>(
      Wq(QW_IN), 96, pe1, 112, wsc[QW_IN], nullptr, 0, nullptr, 0, 0.f,
      W + off.b_in, act, red, QB ? fh1 : nullptr, LDQ, ph, QB ? nullptr : hs,
      LDP, P, PV, slab0, slab1);
  const float s2 = fwd_layer<H, false>(
      Wq(QW_MID1), KH, ph, H + 16, __fmul_rn(wsc[QW_MID1], s1), nullptr, 0,
      nullptr, 0, 0.f, W + off.b_mid1, act, red, QB ? fh2 : nullptr, LDQ, ph,
      QB ? nullptr : hs + H * LDP, LDP, P, PV, slab0, slab1);
  const float s3 = fwd_layer<H, true>(
      Wq(QW_CAT_H), KH, ph, H + 16, __fmul_rn(wsc[QW_CAT_H], s2), Wq(QW_CAT_X),
      96, pe1, 112, wsc[QW_CAT_X], W + off.b_cat, act, red,
      QB ? fh3 : nullptr, LDQ, ph, QB ? nullptr : hs + 2 * H * LDP, LDP, P,
      PV, slab0, slab1);
  const float s4 = fwd_layer<H, false>(
      Wq(QW_MID2), KH, ph, H + 16, __fmul_rn(wsc[QW_MID2], s3), nullptr, 0,
      nullptr, 0, 0.f, W + off.b_mid2, act, red, QB ? fh4 : nullptr, LDQ, ph,
      QB ? nullptr : hb, LDP, P, PV, slab0, slab1);
  head_layer<H>(Wq(QW_ALPHA), ph, __fmul_rn(wsc[QW_ALPHA], s4),
                W + off.b_alpha, alp, 1, LDP, P, slab0, slab1);
  const float s_c = fwd_layer<H, true>(
      Wq(QW_COL_H), KH, ph, H + 16, __fmul_rn(wsc[QW_COL_H], s4), Wq(QW_COL_X),
      64, pe2, 80, wsc[QW_COL_X], W + off.b_col, act, red, QB ? fc : nullptr,
      LDQ, ph, QB ? nullptr : ha, LDP, P, PV, slab0, slab1);
  head_layer<H>(Wq(QW_OUT), ph, __fmul_rn(wsc[QW_OUT], s_c),
                W + off.b_col_out, col, 3, LDP, P, slab0, slab1);
  __syncthreads();

  // 3. per ray: render, losses, render backward -> dal, dy
  render_loss<NT>(zs, ray, wm, alp, col, dal, dy, rl, loss, add, rbase, ray0,
                  n_per, S, RT, LDP, cs, osc);
  K1_MARK(2);

  if constexpr (!QB) {
    // 4. int8_fwd: the float tile's f32 backward, three bf16 passes
    const FloatBufs<H> bufs(sm, LDP);
    float_backward<H, F32>(W, ws, NS, G, hs, off, bufs, P, LDP, add,
                           reinterpret_cast<bf16*>(slab0),
                           reinterpret_cast<bf16*>(slab1));
    return;
  }

  // 4. the s8 backward (bwd_chunk_q8). Each output gradient's bias
  //    gradient from its f32 values, then the gradient quantised once (the
  //    heads' with the head scale, the others with the hidden one) and read
  //    by its weight- and input-gradient products; each hidden gradient
  //    over its activation's feature-major copy, the point-major one
  //    shared (a product that reads it runs before the next quantisation
  //    writes it).
  constexpr bool RA = Tile<H>::RA;
  float* Gx = G + NS;   // the row's dirs and biases (grad_row)
  bgrad<NT>(Gx + off.b_col_out, dy, 3, P, LDP, add);
  bgrad<NT>(Gx + off.b_alpha, dal, 1, P, LDP, add);
  K1_MARK(5);
  const float sdl = quant_head<NT>(dy, 3, P, LDP, head, red, fdl, LDQ, pdl);
  const float sda = quant_head<NT>(dal, 1, P, LDP, head, red, fda, LDQ, pda);
  __syncthreads();
  K1_MARK(6);
  wgrad_s8<NT, 1, RA>(G + mat_off(H, M_OUT), H, fdl, 3, fc, H, P32, LDQ,
                      __fmul_rn(sdl, s_c), false, add);
  wgrad_s8<NT, 1, RA>(G + mat_off(H, M_ALPHA), H, fda, 1, fh4, H, P32, LDQ,
                      __fmul_rn(sda, s4), false, add);
  K1_MARK(3);
  // dhc: w_out^T dlogits, over hc
  const float sdc = bwd_layer<H, false>(
      WqT(QW_OUT), 32, pdl, 48, __fmul_rn(wsc[QW_OUT], sdl), nullptr, 0,
      nullptr, 0, 0.f, hid, red, bpart, Gx + off.b_col, add, fc, LDQ, ph, P,
      slab0, slab1);
  __syncthreads();
  constexpr int LC = up16(H + EMB2), LT = up16(H + EMB1);
  wgrad_s8<NT, 2, RA>(G + mat_off(H, M_COL), LC, fc, H, fh4, H, P32, LDQ,
                      __fmul_rn(sdc, s4), false, add);
  wgrad_s8<NT, 2, RA>(G + mat_off(H, M_COL) + H, LC, fc, H, fe2, 48, P32,
                      LDQ, __fmul_rn(sdc, INV_127), false, add);
  K1_MARK(3);
  // bands 4, 5: w_col_x^T dhc into emb's colour-head rows (dead since
  // their quantisation)
  band_layer<H, 48>(WqT(QW_COL_X), ph, __fmul_rn(wsc[QW_COL_X], sdc),
                    emb + EMB1 * LDP, 0, EMB2, LDP, P, slab0, slab1);
  __syncthreads();
  K1_MARK(4);
  fold_bands<NT>(dproj, emb + EMB1 * LDP, proj, 4, 2, P, LDP, false);
  K1_MARK(5);
  // dh4: w_col_h^T dhc + w_alpha^T dalpha, over h4
  const float sdh4 = bwd_layer<H, true>(
      WqT(QW_COL_H), KH, ph, H + 16, __fmul_rn(wsc[QW_COL_H], sdc),
      WqT(QW_ALPHA), 32, pda, 48, __fmul_rn(wsc[QW_ALPHA], sda), hid, red,
      bpart, Gx + off.b_mid2, add, fh4, LDQ, ph, P, slab0, slab1);
  __syncthreads();
  wgrad_s8<NT, 2, RA>(G + mat_off(H, M_MID2), H, fh4, H, fh3, H, P32, LDQ,
                      __fmul_rn(sdh4, s3), false, add);
  K1_MARK(3);
  const float sdh3 = bwd_layer<H, false>(
      WqT(QW_MID2), KH, ph, H + 16, __fmul_rn(wsc[QW_MID2], sdh4), nullptr, 0,
      nullptr, 0, 0.f, hid, red, bpart, Gx + off.b_cat, add, fh3, LDQ, ph, P,
      slab0, slab1);
  __syncthreads();
  wgrad_s8<NT, 2, RA>(G + mat_off(H, M_CAT), LT, fh3, H, fh2, H, P32, LDQ,
                      __fmul_rn(sdh3, s2), false, add);
  wgrad_s8<NT, 2, RA>(G + mat_off(H, M_CAT) + H, LT, fh3, H, fe1, 96, P32,
                      LDQ, sdh3, true, add);
  K1_MARK(3);
  // bands 0..3: w_cat_x^T dh3 into emb's trunk band rows
  band_layer<H, 96>(WqT(QW_CAT_X), ph, __fmul_rn(wsc[QW_CAT_X], sdh3), emb,
                    3, EMB1, LDP, P, slab0, slab1);
  __syncthreads();
  K1_MARK(4);
  fold_bands<NT>(dproj, emb + 3 * LDP, proj, 0, 4, P, LDP, true);
  K1_MARK(5);
  const float sdh2 = bwd_layer<H, false>(
      WqT(QW_CAT_H), KH, ph, H + 16, __fmul_rn(wsc[QW_CAT_H], sdh3), nullptr,
      0, nullptr, 0, 0.f, hid, red, bpart, Gx + off.b_mid1, add, fh2, LDQ, ph,
      P, slab0, slab1);
  __syncthreads();
  wgrad_s8<NT, 2, RA>(G + mat_off(H, M_MID1), H, fh2, H, fh1, H, P32, LDQ,
                      __fmul_rn(sdh2, s1), false, add);
  K1_MARK(3);
  const float sdh1 = bwd_layer<H, false>(
      WqT(QW_MID1), KH, ph, H + 16, __fmul_rn(wsc[QW_MID1], sdh2), nullptr, 0,
      nullptr, 0, 0.f, hid, red, bpart, Gx + off.b_in, add, fh1, LDQ, ph, P,
      slab0, slab1);
  __syncthreads();
  wgrad_s8<NT, 2, RA>(G + mat_off(H, M_IN), up16(EMB1), fh1, H, fe1, 96, P32,
                      LDQ, sdh1, true, add);
  K1_MARK(3);
  band_layer<H, 96>(WqT(QW_IN), ph, __fmul_rn(wsc[QW_IN], sdh1), emb, 3, EMB1,
                    LDP, P, slab0, slab1);
  __syncthreads();
  K1_MARK(4);
  fold_bands<NT>(dproj, emb + 3 * LDP, proj, 0, 4, P, LDP, true);
  __syncthreads();
  // d dirs[j][k] = sum_p dproj[j][p] xs[k][p], f32
  wgrad<NT>(Gx + off.dirs, 3, 0, dproj, NDIR, emb, 3, P, LDP, add);
  __syncthreads();
  K1_MARK(5);
}

// train_grad_kernel under an int8 policy: the same grid of (partial row,
// slot) and tile order. sample_reuse is a runtime offset here (with n_eff
// == n_iter it is 0).
template <int H, int POL>
__global__ void __launch_bounds__(Tile<H>::NT, Q8Tile<H>::MINB)
train_grad_q8_kernel(const float* __restrict__ params,   // [cap, NP]
                     const bf16* __restrict__ ws,        // [cap, 3, NS]
                     const int8_t* __restrict__ wq,      // [cap, q8_size]
                     const float* __restrict__ wscale,   // [cap, NQW]
                     const float* __restrict__ qs,       // [6] or null
                     const float* __restrict__ od,       // [cap, NE, 6]
                     const float* __restrict__ zs,       // [cap, NR, S]
                     const float* __restrict__ ray,      // [cap, NE, 8]
                     const float* __restrict__ wmul,     // [cap, n_eff, 4]
                     const float* __restrict__ scale,    // [cap]
                     const int* __restrict__ active,     // [cap]
                     float* __restrict__ grad_part,  // [cap, n_rows, NG]
                     float* __restrict__ loss_part,      // [cap, n_rows]
                     float* __restrict__ act_part,  // INT8_FWD [.., 3, H, LDP]
                     Offsets off, int n_params, int n_rays, int n_per,
                     int n_iter, int it, int S, int RT, int n_tiles, int LDP,
                     float cs, float osc, int n_eff) {
  constexpr bool QB = POL == INT8;
  constexpr int NT = Tile<H>::NT, NS = staged_size(H);
  constexpr size_t SB = q8_slab<H, QB>();
  const int row = blockIdx.x, slot = blockIdx.y, n_rows = gridDim.x;
  if (!active[slot]) return;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* slab0 = reinterpret_cast<int8_t*>(smem);
  int8_t* slab1 = slab0 + SB;
  float* sm = reinterpret_cast<float*>(smem + 2 * SB);
  int8_t* s8 = reinterpret_cast<int8_t*>(smem + 2 * SB +
                                         q8_f32_bytes<H, QB>(LDP, RT));
  // the s8 copies zeroed once: each pass writes its tensor's elements only,
  // so their padding (rows, columns and points past the tile's) stays zero
  const int n16 = (int)(q8_s8_bytes<H, QB>(RT * S) / 16);
  for (int i = threadIdx.x; i < n16; i += NT)
    reinterpret_cast<uint4*>(s8)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  // pixel rows of block it mod n_eff; z advanced to this iteration's rows
  const size_t rbase = ((size_t)slot * n_eff + it % n_eff) * n_per;
  zs += ((size_t)slot * n_rays + (size_t)it * n_per - rbase) * S;
  const float* wm = wmul + ((size_t)slot * n_eff + it % n_eff) * 4;
  const size_t blk = (size_t)slot * n_rows + row;
  for (int tile = row; tile < n_tiles; tile += n_rows)
    q8_tile<H, POL>(params + (size_t)slot * n_params,
                    wq + (size_t)slot * q8_size(H), wscale + (size_t)slot * NQW,
                    qs, QB ? nullptr : ws + (size_t)slot * STAGED_PIECES * NS,
                    NS, od, zs,
                    ray, wm, scale[slot], grad_part + blk * grad_row(H),
                    loss_part + blk,
                    QB ? nullptr : act_part + blk * 3 * H * LDP, off, rbase,
                    tile * RT, n_per, S, RT, LDP, cs, osc, tile != row, sm,
                    s8, slab0, slab1);
}

// w after its tensor's fold (qw_fold) at column c of the tensor
__device__ __forceinline__ float fold_w(float w, int fold, int c) {
  if (fold == 1) return __fmul_rn(w, c < 3 ? INV_XS : INV_127);
  if (fold == 2) return __fmul_rn(w, INV_127);
  return w;
}

// the two halves of a thread-block cluster barrier (cg's sync is both):
// arrive (this block's earlier shared-memory accesses released to the
// cluster), then wait until every block of the cluster has arrived
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// source matrix m's offset in a slot's parameters (update_plan.cuh QMat)
__device__ __forceinline__ int qm_param_off(const Offsets& o, int m) {
  switch (m) {
    case QM_IN: return o.w_in;
    case QM_MID1: return o.w_mid1;
    case QM_CAT: return o.w_cat;
    case QM_MID2: return o.w_mid2;
    case QM_ALPHA: return o.w_alpha;
    case QM_COL: return o.w_col;
    default: return o.w_col_out;
  }
}

// The s8 copy of every active slot's nine QW tensors and their scales:
// clusters of q_cluster(H) blocks, block k of a cluster band k of the
// unit's matrix, as update_plan.cuh states (the band's one read, the
// cluster's maxima through distributed shared memory, the s8 bands in
// shared memory written as 16-byte stores, padding included: q8_layout).
template <int H>
__global__ void __launch_bounds__(q_threads(H), q_bps(H))
quant_weights_kernel(const float* __restrict__ p, int8_t* __restrict__ wq,
                     float* __restrict__ wscale,
                     const int* __restrict__ active, Offsets off, int cap,
                     int n_params) {
  constexpr int NT = q_threads(H), CL = q_cluster(H), NW = NT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  // the copy band [QBAND][up32(n_in)], then the transpose band
  // [up16(n_in)][QTRS bytes]
  int8_t* qc = reinterpret_cast<int8_t*>(smem + q_stage_bytes(H));
  float* bmax = reinterpret_cast<float*>(smem + q_smem(H)) - 2 - 2 * NW;
  float* red = bmax + 2;
  // h=32's matrices are one band: a block alone, launched as no cluster
  const int k = CL > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int G = gridDim.x / CL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t total = (size_t)cap * n_params;
  for (int u = blockIdx.x / CL; u < cap * NQM; u += G) {
    const int slot = u / NQM, mat = u - slot * NQM;
    if (!active[slot]) continue;   // the same for the whole cluster
    const int ld = qm_ld(H, mat), nsrc = q_src_rows(H, mat, k);
    // 1. the band's rows: one span of the parameters, from the 16-byte
    // boundary at or before it
    const size_t a = (size_t)slot * n_params + qm_param_off(off, mat) +
                     (size_t)QBAND * k * ld;
    const size_t A = a & ~(size_t)3;
    const int lead = (int)(a - A);
    const int nchunk = nsrc ? (lead + nsrc * ld + 3) >> 2 : 0;
    for (int c = tid; c < nchunk; c += NT) {
      const size_t e = A + 4 * (size_t)c;
      if (e + 4 <= total)
        cp_async16_once(stage + 4 * c, p + e);
      else   // past the parameters' last whole 16 bytes
        for (int i = 0; i < 4 && e + i < total; ++i)
          stage[4 * c + i] = p[e + i];
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // 2. each tensor's abs-max after the fold, over the cluster. The fold
    // multiplies a column by a positive constant and rounding is
    // monotonic, so the folded maximum is the fold of the raw |w|
    // maximum of each column class (fold 1: the xs columns c < 3 and the
    // rest), bit for bit: the warps' raw maxima in red, warp 0's fold and
    // reduction of them in bmax
    const int t0 = qm_first(mat), nt = qm_count(mat);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i >= nt) break;
      const int t = t0 + i, cols = qw_in(H, t), fold = qw_fold(t);
      float mx = 0.f, mr = 0.f;   // the xs columns', the rest's
      for (int r = warp; r < nsrc; r += NW) {
        const float* row = stage + lead + r * ld + qw_col0(H, t);
#pragma unroll 4
        for (int c = lane; c < cols; c += 32) {
          const float a = fabsf(row[c]);
          if (fold == 1 && c < 3)
            mx = fmaxf(mx, a);
          else
            mr = fmaxf(mr, a);
        }
      }
      mx = fmaxf(fold_w(mx, fold, 0), fold_w(mr, fold, 3));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (lane == 0) red[i * NW + warp] = mx;
    }
    __syncthreads();
    if (warp == 0)
      for (int i = 0; i < 2; ++i) {
        float m = lane < NW && i < nt ? red[i * NW + lane] : 0.f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        if (lane == 0) bmax[i] = m;
      }
    float mx[2];
    if constexpr (CL > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();   // every block's maxima written
      // lane r of warp 0 reads block r's, the warp reduces them and
      // leaves the cluster's in red (read by this block alone)
      if (warp == 0)
        for (int i = 0; i < 2; ++i) {
          float m = lane < CL ? cluster.map_shared_rank(bmax, lane)[i] : 0.f;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
          if (lane == 0) red[i] = m;
        }
      __syncthreads();
      mx[0] = red[0];
      mx[1] = red[1];
      // read: the others may overwrite bmax once every block has arrived
      // here, which the wait at the unit's end holds them to
      cluster_arrive();
    } else {
      __syncthreads();
      mx[0] = bmax[0];
      mx[1] = bmax[1];
    }

    // 3. quantise both tensors into their s8 bands, then 16-byte stores
    int8_t* dst = wq + (size_t)slot * q8_size(H);
    const int ncopy = q_copy_rows(H, mat, k);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i >= nt) break;
      const int t = t0 + i, cols = qw_in(H, t), fold = qw_fold(t);
      const int CW = up32(cols), TR = up16(cols);
      const float s = __fadd_rn(__fmul_rn(mx[i], INV_127), 1e-30f);
      const float inv = 1.f / s;
      if (k == 0 && tid == 0) wscale[(size_t)slot * NQW + t] = s;
      int8_t* qb = qc + (i ? q_s8_band(H, t0) : 0);
      int8_t* qt = qb + QBAND * CW;
      // a warp: rows 4 q4 .. 4 q4 + 3 of 32 columns, lane = column
      for (int wc = warp; wc < (QBAND / 4) * (CW / 32); wc += NW) {
        const int q4 = wc % (QBAND / 4), c = wc / (QBAND / 4) * 32 + lane;
        const float* row = stage + lead + 4 * q4 * ld + qw_col0(H, t) + c;
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 4 * q4 + e;
          const int8_t q =
              r < nsrc && c < cols
                  ? to_s8(rintf(__fmul_rn(fold_w(row[e * ld], fold, c),
                                          inv)))
                  : (int8_t)0;
          qb[r * CW + c] = q;
          word |= (uint32_t)(uint8_t)q << (8 * e);
        }
        if (c < TR)
          *reinterpret_cast<uint32_t*>(qt + c * QTRS + 4 * q4) = word;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (i >= nt) break;
      const int t = t0 + i, CW = up32(qw_in(H, t)), TR = up16(qw_in(H, t));
      const int8_t* qb = qc + (i ? q_s8_band(H, t0) : 0);
      const int8_t* qt = qb + QBAND * CW;
      // the copy band: rows 32k .. 32k + ncopy - 1, one contiguous range
      uint4* dc =
          reinterpret_cast<uint4*>(dst + qw_off(H, t) + QBAND * k * CW);
      for (int c = tid; c < ncopy * CW / 16; c += NT)
        dc[c] = reinterpret_cast<const uint4*>(qb)[c];
      // the transpose band: 32 bytes of each of the transpose's TR rows
      if (q_has_tr(H, mat, k)) {
        int8_t* dt = dst + qwt_off(H, t) + QBAND * k;
        const int RW = up32(qw_out(H, t));
        for (int c = tid; c < 2 * TR; c += NT) {
          const uint32_t* w = reinterpret_cast<const uint32_t*>(
              qt + (c >> 1) * QTRS + 16 * (c & 1));
          *reinterpret_cast<uint4*>(dt + (size_t)(c >> 1) * RW +
                                    16 * (c & 1)) =
              make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
    }
    // the next unit writes the stage and the s8 bands only after barriers
    // that every thread reaches once its stores are issued
    if constexpr (CL > 1) cluster_wait();
  }
}

template <int H>
int launch_quant(const float* p, int8_t* wq, float* wscale,
                 const int* active, const Offsets& off, int cap,
                 int n_params, int sms, cudaStream_t stream) {
  auto kernel = quant_weights_kernel<H>;
  const size_t smem = q_smem(H);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)   // all of L1 as shared memory: q_bps blocks
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(q_clusters(sms, cap, H) * q_cluster(H));
  cfg.blockDim = dim3(q_threads(H));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = q_cluster(H);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = q_cluster(H) > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p, wq, wscale, active, off, cap,
                           n_params);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The operands and geometry of one int8 train_grad launch.
struct Q8Args {
  const float* params;
  const bf16* ws;
  const int8_t* wq;
  const float *wscale, *qs, *od, *z, *ray, *wmul, *scale;
  const int* active;
  float *grad_part, *loss_part, *act_part;
  Offsets off;
  int cap, n_params, n_per, n_iter, n_eff, it, S, RT, n_tiles, n_rows;
  float cs, osc;
};

template <int H, int POL>
int launch_q8(const Q8Args& a, cudaStream_t stream) {
  const int P = a.RT * a.S;
  if (P > Q8Tile<H>::FP) return (int)cudaErrorInvalidValue;
  const int LDP = P | 1;   // odd row stride: conflict-free column reads
  const size_t smem = q8_smem_bytes<H, POL == INT8>(P, a.RT);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = train_grad_q8_kernel<H, POL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)   // all of L1 as shared memory: two h=32 blocks
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.n_rows, a.cap);
  kernel<<<grid, Tile<H>::NT, smem, stream>>>(
      a.params, a.ws, a.wq, a.wscale, a.qs, a.od, a.z, a.ray, a.wmul,
      a.scale, a.active, a.grad_part, a.loss_part, a.act_part, a.off,
      a.n_params, a.n_iter * a.n_per, a.n_per, a.n_iter, a.it, a.S, a.RT,
      a.n_tiles, LDP, a.cs, a.osc, a.n_eff);
  return (int)cudaGetLastError();
}

}  // namespace

// The arguments of vmap_train_grad_q8 (train_step_q8.cu) past its q8b and
// width, which each width's entry takes in the same order
#define VMAP_Q8_PARAMS                                                      \
  const float *params, const void *ws, const void *wq, const float *wscale, \
      const float *qs, const float *od, const float *z, const float *ray,   \
      const float *wmul, const float *scale, const int *active,             \
      float *grad_part, float *loss_part, float *act_part,                  \
      const int *offsets, int cap, int n_params, int n_per, int n_iter,     \
      int n_eff, int it, int S, int RT, int n_tiles, int n_rows, float cs,  \
      float osc, void *stream
#define VMAP_Q8_ARGS                                                        \
  params, ws, wq, wscale, qs, od, z, ray, wmul, scale, active, grad_part,   \
      loss_part, act_part, offsets, cap, n_params, n_per, n_iter, n_eff,    \
      it, S, RT, n_tiles, n_rows, cs, osc, stream

namespace {

// vmap_train_grad_q8 at width H: the arguments checked, then INT8 (q8b)
// or INT8_FWD's instance
template <int H>
int train_grad_q8_at(int q8b, VMAP_Q8_PARAMS) {
  const Offsets off = offsets_from(offsets);
  if (!grad_args_ok(cap, n_per, n_iter, n_eff, it, S, RT, n_tiles, n_rows) ||
      wq == nullptr || wscale == nullptr ||
      (!q8b && (ws == nullptr || act_part == nullptr)) ||
      !rest_fits(off, H))
    return (int)cudaErrorInvalidValue;
  const Q8Args a = {params, static_cast<const bf16*>(ws),
                    static_cast<const int8_t*>(wq), wscale, qs, od, z, ray,
                    wmul, scale, active, grad_part, loss_part, act_part, off,
                    cap, n_params, n_per, n_iter, n_eff, it, S, RT, n_tiles,
                    n_rows, cs, osc};
  cudaStream_t st = (cudaStream_t)stream;
  return q8b ? launch_q8<H, INT8>(a, st) : launch_q8<H, INT8_FWD>(a, st);
}

// vmap_train_quant_w at width H (its arguments checked by the entry)
template <int H>
int quant_w_at(const float* p, void* wq, float* wscale, const int* active,
               const int* offsets, int cap, int n_params, void* stream) {
  int sms = 0;
  if (const int err = sm_count(&sms)) return err;
  return launch_quant<H>(p, static_cast<int8_t*>(wq), wscale, active,
                         offsets_from(offsets), cap, n_params, sms,
                         (cudaStream_t)stream);
}

// vmap_q8_smem at width H
template <int H>
int q8_smem_at(int q8b, int S, int RT) {
  const int P = RT * S;
  return (int)(q8b ? q8_smem_bytes<H, true>(P, RT)
                   : q8_smem_bytes<H, false>(P, RT));
}

}  // namespace
