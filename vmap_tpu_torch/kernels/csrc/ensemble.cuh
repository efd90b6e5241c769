// The field kernels K2 and K3 (ensemble.cu's design comment): their
// tiles' code, the kernels and the launch of one width's instances.
// ensemble.cu instantiates them at h = 32, 128 and 256, ensemble_narrow.cu
// at h = 16 and 64, in a translation unit of its own so that the build's
// files compile side by side.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "field_plan.cuh"
#include "train_step.cuh"

namespace {

constexpr int EMB_PAD = 128;   // row stride of w_in, w_cat_x, w_col_x
constexpr int N_PREP = 17;     // prepared tensors per object

// Offsets of the prepared tensors inside one object's packed row, in the
// order of kernels/ensemble.py W_NAMES.
struct Prep {
  int dirs, w_in, b_in, w_mid1, b_mid1, w_cat_h, w_cat_x, b_cat, w_mid2,
      b_mid2, w_alpha, b_alpha, w_col_h, b_col, w_out, b_out, w_col_x;
};

// ---- helpers

// (v0, v1) as NP pieces into rows x [piece ps apart][.][LDB] at row i,
// points p, p + 1 (p even)
template <int NP>
__device__ __forceinline__ void store_pair(bf16* x, int ps, int LDB, int i,
                                           int p, float v0, float v1) {
  uint32_t u[NP];
  split<NP>(v0, v1, u);
#pragma unroll
  for (int pc = 0; pc < NP; ++pc)
    *reinterpret_cast<uint32_t*>(x + pc * ps + i * LDB + p) = u[pc];
}
// one value's NP pieces (mma.cuh split)
template <int NP>
__device__ __forceinline__ void store_one(bf16* x, int ps, int idx, float v) {
#pragma unroll
  for (int pc = 0; pc < NP; ++pc) {
    const bf16 h = __float2bfloat16_rn(v);
    x[pc * ps + idx] = h;
    v -= __bfloat162float(h);
  }
}
// a ReLU output's mask from its first piece (bf16x2 u: points p, p + 1):
// bf16(y) > 0 exactly where y > 0 for every y >= 2^-133
__device__ __forceinline__ bool pos_lo(uint32_t u) {
  return (u & 0x7fffu) != 0 && !(u & 0x8000u);
}
__device__ __forceinline__ bool pos_hi(uint32_t u) { return pos_lo(u >> 16); }

// epi(i, p, v0, v1) for every element pair of this warp's units: rows
// m0 + .. < rows, points p, p + 1
template <int NT, int WM, int WN, int MU, class Epi>
__device__ __forceinline__ void run_epi(const float (&acc)[MU][WM][WN][4],
                                        int units, int un, int rows,
                                        Epi& epi) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < MU; ++j) {
    const int u = warp + j * NW;
    if (u >= units) continue;
    const int m0 = u / un * 16 * WM, n0 = u % un * 8 * WN;
#pragma unroll
    for (int wm = 0; wm < WM; ++wm)
#pragma unroll
      for (int wn = 0; wn < WN; ++wn) {
        const int i = m0 + 16 * wm + g, p = n0 + 8 * wn + 2 * t;
        if (i < rows) epi(i, p, acc[j][wm][wn][0], acc[j][wm][wn][1]);
        if (i + 8 < rows) epi(i + 8, p, acc[j][wm][wn][2], acc[j][wm][wn][3]);
      }
  }
}

// The forward product of staged matrix m over a tile's P points on
// T::NF pieces: sum_k W[i][k] x[k][p] for x the rows xa [0, na) then xb
// (the matrix's up16 columns; the padding rows of xb zero), bf16 pieces
// [NF][rows][LDB] (pieces psa / psb apart); then epi(i, p, v0, v1) for
// every i < n_out and point pair. A: the resident weights wr (T::RES;
// matrix m at res_off) or ws's staged pieces (NS apart) streamed through
// slab0 / slab1, T::KF columns a slab. Starts by staging its first slab;
// the block synchronises before its first read of x and the weights and
// after its last; ends with epi run, not synchronised (so epi may
// overwrite x).
template <int H, class T, int WM, int WN, int MU, class Epi>
__device__ __forceinline__ void fwd_prod(const bf16* __restrict__ ws, int NS,
                                         const bf16* wr, int m, const bf16* xa,
                                         int na, int psa, const bf16* xb,
                                         int psb, bf16* slab0, bf16* slab1,
                                         Epi epi) {
  constexpr int NT = T::NT, NW = NT / 32, P = T::P, LDB = P + 8, NP = T::NF;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_out = mat_out(H, m), Rr = mat_rows(H, m), C = mat_cols(H, m);
  const int kf = T::RES ? C : T::KF, LD = kf + 8;
  constexpr int un = P / (8 * WN);
  const int units = (Rr / 16 + WM - 1) / WM * un;
  if (units > MU * NW) __trap();   // FTile does not cover this product
  float acc[MU][WM][WN][4] = {};
  bf16* buf[2] = {slab0, slab1};
  const bf16* src = ws + mat_off(H, m);
  const int ns = (C + kf - 1) / kf;
  if constexpr (!T::RES)
    stage_slab<NT, NP>(buf[0], LD, src, NS, C, 0, Rr, 0, C < kf ? C : kf);
  for (int s = 0; s < ns; ++s) {
    const int k0 = s * kf, kw = C - k0 < kf ? C - k0 : kf;
    if constexpr (!T::RES) {
      if (s + 1 < ns) {
        const int k1 = k0 + kf;
        stage_slab<NT, NP>(buf[(s + 1) & 1], LD, src, NS, C, 0, Rr, k1,
                           C - k1 < kf ? C - k1 : kf);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    }
    __syncthreads();
    const bf16* sh = T::RES ? wr + res_off(H, m, NP) : buf[s & 1];
#pragma unroll
    for (int j = 0; j < MU; ++j) {
      const int u = warp + j * NW;
      if (u < units) {
        const int m0 = u / un * 16 * WM, n0 = u % un * 8 * WN;
        for (int kk = 0; kk < kw; kk += 16) {
          const int k = k0 + kk;
          const bf16* xr = k < na ? xa + k * LDB : xb + (k - na) * LDB;
          const int ps = k < na ? psa : psb;
          uint32_t b[WN][NP][2];
#pragma unroll
          for (int pc = 0; pc < NP; ++pc)
#pragma unroll
            for (int w2 = 0; w2 < WN; w2 += 2) {
              uint32_t bb[2][2];
              load_b_kn(bb, xr + pc * ps, LDB, 0, n0 + 8 * w2, lane);
              b[w2][pc][0] = bb[0][0];
              b[w2][pc][1] = bb[0][1];
              b[w2 + 1][pc][0] = bb[1][0];
              b[w2 + 1][pc][1] = bb[1][1];
            }
#pragma unroll
          for (int wm = 0; wm < WM; ++wm) {
            if (m0 + 16 * wm >= Rr) continue;
            uint32_t a[NP][4];
#pragma unroll
            for (int pc = 0; pc < NP; ++pc)
              load_a_ldsm(a[pc], sh + pc * Rr * LD, LD, m0 + 16 * wm, kk,
                          lane);
#pragma unroll
            for (int wn = 0; wn < WN; ++wn) {
              if constexpr (NP == 3) {
                // six passes into a fresh accumulator, then one f32 add
                // (round to nearest): the tensor cores' own accumulation
                // truncates, and over a layer's k steps that alone put
                // more ReLU masks on the wrong side of 0 than the f32
                // plain version's rounding does
                float t[4] = {0.f, 0.f, 0.f, 0.f};
                mma_pieces<NP>(t, a, b[wn]);
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[j][wm][wn][q] += t[q];
              } else {
                mma_pieces<NP>(acc[j][wm][wn], a, b[wn]);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }
  run_epi<NT, WM, WN, MU>(acc, units, un, n_out, epi);
}

// The input gradients through staged matrix m on NB pieces: sum_i W[i][k]
// d[i][p] for every staged column k < up16(n_in) and point pair: epi(k, p,
// v0, v1). d: the matrix's up16(n_out) rows (those past n_out zero),
// pieces psd apart. A = W^T, one ldmatrix .trans a fragment, from the
// resident weights (their first NB pieces) or slabs of T::KB rows (all
// columns). The same synchronisation as fwd_prod.
template <int H, class T, int WM, int WN, int MU, class Epi>
__device__ __forceinline__ void dgrad_prod(const bf16* __restrict__ ws,
                                           int NS, const bf16* wr, int m,
                                           const bf16* d, int psd,
                                           bf16* slab0, bf16* slab1,
                                           Epi epi) {
  constexpr int NT = T::NT, NW = NT / 32, P = T::P, LDB = P + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Rr = mat_rows(H, m), C = mat_cols(H, m), LD = C + 8;
  const int kb = T::RES ? Rr : (Rr < T::KB ? Rr : T::KB);
  constexpr int un = P / (8 * WN);
  const int units = (C / 16 + WM - 1) / WM * un;
  if (units > MU * NW) __trap();   // FTile does not cover this product
  float acc[MU][WM][WN][4] = {};
  bf16* buf[2] = {slab0, slab1};
  const bf16* src = ws + mat_off(H, m);
  const int ns = Rr / kb;
  if constexpr (!T::RES)
    stage_slab<NT, NB>(buf[0], LD, src, NS, C, 0, kb, 0, C);
  for (int s = 0; s < ns; ++s) {
    const int i0 = s * kb;
    if constexpr (!T::RES) {
      if (s + 1 < ns) {
        stage_slab<NT, NB>(buf[(s + 1) & 1], LD, src, NS, C, i0 + kb, kb, 0,
                           C);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    }
    __syncthreads();
    // piece pc of the slab's rows at sh + pc kb LD (RES: the matrix, row i0)
    const bf16* sh = T::RES ? wr + res_off(H, m, T::NF) : buf[s & 1];
    const int r0 = T::RES ? i0 : 0;
#pragma unroll
    for (int j = 0; j < MU; ++j) {
      const int u = warp + j * NW;
      if (u < units) {
        const int m0 = u / un * 16 * WM, n0 = u % un * 8 * WN;
        for (int kk = 0; kk < kb; kk += 16) {
          uint32_t b[WN][NB][2];
#pragma unroll
          for (int pc = 0; pc < NB; ++pc)
#pragma unroll
            for (int w2 = 0; w2 < WN; w2 += 2) {
              uint32_t bb[2][2];
              load_b_kn(bb, d + pc * psd + (i0 + kk) * LDB, LDB, 0,
                        n0 + 8 * w2, lane);
              b[w2][pc][0] = bb[0][0];
              b[w2][pc][1] = bb[0][1];
              b[w2 + 1][pc][0] = bb[1][0];
              b[w2 + 1][pc][1] = bb[1][1];
            }
#pragma unroll
          for (int wm = 0; wm < WM; ++wm) {
            if (m0 + 16 * wm >= C) continue;
            uint32_t a[NB][4];
#pragma unroll
            for (int pc = 0; pc < NB; ++pc)
              load_a_trans(a[pc], sh + pc * kb * LD, LD, m0 + 16 * wm,
                           r0 + kk, lane);
#pragma unroll
            for (int wn = 0; wn < WN; ++wn)
              mma_pieces<NB>(acc[j][wm][wn], a, b[wn]);
          }
        }
      }
    }
    __syncthreads();
  }
  run_epi<NT, WM, WN, MU>(acc, units, un, C, epi);
}

// Every matrix's first NP pieces (ws, NS apart) into the resident layout
// wr, as one commit group per matrix; ends with this thread's copies
// landed (the caller synchronises before they are read)
template <int H, int NT, int NP>
__device__ void stage_resident(bf16* wr, const bf16* __restrict__ ws, int NS) {
#pragma unroll 1
  for (int m = 0; m < NMAT; ++m)
    stage_slab<NT, NP>(wr + res_off(H, m, NP), mat_cols(H, m) + 8,
                       ws + mat_off(H, m), NS, mat_cols(H, m), 0,
                       mat_rows(H, m), 0, mat_cols(H, m));
  cp_async_wait<0>();
}

// sin(pi 2^b pr), b = 0 .. NB - 1, into s: sinpif of each band, or
// (LADDER) sincospif of band 0 and the double angles s' = 2 s c, c' = 1 -
// 2 s^2
template <int NB, bool LADDER>
__device__ __forceinline__ void bands(float pr, float (&s)[NB]) {
  if constexpr (LADDER) {
    float sn, cs;
    sincospif(pr, &sn, &cs);
    s[0] = sn;
#pragma unroll
    for (int b = 1; b < NB; ++b) {
      const float s2 = 2.f * sn * cs;
      cs = 1.f - 2.f * sn * sn;
      sn = s2;
      s[b] = sn;
    }
  } else {
#pragma unroll
    for (int b = 0; b < NB; ++b) s[b] = sinpif(pr * (float)(1 << b));
  }
}

// the projection dirs_j . xs of point p (xs [3][P])
template <int P>
__device__ __forceinline__ float project(const float* xs, const float* dirs,
                                         int j, int p) {
  const float* d = dirs + j * 3;
  return xs[p] * __ldg(d) + xs[P + p] * __ldg(d + 1) +
         xs[2 * P + p] * __ldg(d + 2);
}

// The tile's points: xs = pts / scale (0 past M) into xs [3][P]; the
// trunk's embedding emb_a (xs, bands 0..3) as NP pieces into emb's rows
// 0..86 (its rows 87..95 stay zero); proj (if given) the f32 projection
// [21][P]. Ends with the block synchronised.
template <int NT, int P, int NP, bool LADDER>
__device__ void pe_trunk(const float* __restrict__ pts, float sc,
                         const float* __restrict__ dirs, int M, int p0,
                         float* xs, float* proj, bf16* emb) {
  constexpr int LDB = P + 8, PSE = EROWS * LDB;
  for (int p = threadIdx.x; p < P; p += NT) {
    const int gp = p0 + p;
    float x[3] = {0.f, 0.f, 0.f};
    if (gp < M) {
      const float* q = pts + (size_t)gp * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) x[k] = q[k] / sc;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      xs[k * P + p] = x[k];
      store_one<NP>(emb, PSE, k * LDB + p, x[k]);
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < NDIR * P; idx += NT) {
    const int j = idx / P, p = idx % P;
    const float pr = project<P>(xs, dirs, j, p);
    if (proj) proj[j * P + p] = pr;
    float s[4];
    bands<4, LADDER>(pr, s);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      store_one<NP>(emb, PSE, (3 + b * NDIR + j) * LDB + p, s[b]);
  }
  __syncthreads();
}

// The colour head's embedding emb_b (bands 4, 5) as NP pieces into emb's
// rows 0..41, rows 42..47 zero, from xs (or the kept projection proj).
// Not synchronised.
template <int NT, int P, int NP, bool LADDER>
__device__ void pe_head(const float* xs, const float* proj,
                        const float* __restrict__ dirs, bf16* emb) {
  constexpr int LDB = P + 8, PSE = EROWS * LDB;
  for (int idx = threadIdx.x; idx < NDIR * P; idx += NT) {
    const int j = idx / P, p = idx % P;
    const float pr = proj ? proj[j * P + p] : project<P>(xs, dirs, j, p);
    float s[2];
    if constexpr (LADDER) {
      float all[6];
      bands<6, true>(pr, all);
      s[0] = all[4];
      s[1] = all[5];
    } else {
      s[0] = sinpif(pr * 16.f);
      s[1] = sinpif(pr * 32.f);
    }
    store_one<NP>(emb, PSE, j * LDB + p, s[0]);
    store_one<NP>(emb, PSE, (NDIR + j) * LDB + p, s[1]);
  }
  for (int idx = threadIdx.x; idx < NP * (EBROWS - EMB2) * P; idx += NT) {
    const int pc = idx / ((EBROWS - EMB2) * P), r = idx % ((EBROWS - EMB2) * P);
    emb[pc * PSE + (EMB2 + r / P) * LDB + r % P] = __float2bfloat16_rn(0.f);
  }
}

// rows 87..95 of the embedding region (its NP pieces) zeroed
template <int NT, int P, int NP>
__device__ void zero_emb_pad(bf16* emb) {
  constexpr int LDB = P + 8;
  for (int idx = threadIdx.x; idx < NP * (EROWS - EMB1) * LDB; idx += NT) {
    const int pc = idx / ((EROWS - EMB1) * LDB);
    const int r = idx % ((EROWS - EMB1) * LDB);
    emb[pc * EROWS * LDB + EMB1 * LDB + r] = __float2bfloat16_rn(0.f);
  }
}

template <int H>
__global__ void __launch_bounds__(FTile<H, false>::NT, FTile<H, false>::MINB)
field_fwd_kernel(const float* __restrict__ params, int n_params, Prep off,
                 const bf16* __restrict__ ws,       // [O, WP, NS]
                 const float* __restrict__ scale,   // [O]
                 const float* __restrict__ pts,     // [O, M, 3]
                 int M, int O, int n_tiles,
                 float* __restrict__ alpha,         // [O, M]
                 float* __restrict__ color) {       // [O, M, 3]
  using T = FTile<H, false>;
  using L = Plan<H, false>;
  constexpr int NT = T::NT, P = T::P, LDB = P + 8, NS = staged_size(H);
  constexpr int PSE = EROWS * LDB, PSH = H * LDB, NF = T::NF;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* wr = reinterpret_cast<bf16*>(smem);
  bf16* slab0 = wr;
  bf16* slab1 = reinterpret_cast<bf16*>(smem + L::slab);
  bf16* emb = reinterpret_cast<bf16*>(smem + L::emb);
  bf16* act = reinterpret_cast<bf16*>(smem + L::act);
  float* xs = reinterpret_cast<float*>(smem + L::f32);   // [3][P]
  float* out4 = xs + 3 * P;                               // [4][P]
  zero_emb_pad<NT, P, NF>(emb);
  const long long items = (long long)O * n_tiles;
  const long long it0 = items * blockIdx.x / gridDim.x;
  const long long it1 = items * (blockIdx.x + 1) / gridDim.x;
  int cur = -1;
  for (long long it = it0; it < it1; ++it) {
    const int o = (int)(it / n_tiles), p0 = (int)(it % n_tiles) * P;
    const float* W = params + (size_t)o * n_params;
    const bf16* wo = ws + (size_t)o * WP * NS;
    if constexpr (T::RES) {   // the last product's barrier ended its reads
      if (o != cur) stage_resident<H, NT, NF>(wr, wo, NS);
      cur = o;
    }
    pe_trunk<NT, P, NF, true>(pts + (size_t)o * M * 3, scale[o], W + off.dirs,
                              M, p0, xs, nullptr, emb);
    auto hidden = [&](const float* b) {
      return [=](int i, int p, float v0, float v1) {
        const float bb = b[i];
        store_pair<NF>(act, PSH, LDB, i, p, fmaxf(v0 + bb, 0.f),
                       fmaxf(v1 + bb, 0.f));
      };
    };
    auto head = [&](const float* b, float* out) {
      return [=](int i, int p, float v0, float v1) {
        out[i * P + p] = v0 + b[i];
        out[i * P + p + 1] = v1 + b[i];
      };
    };
    constexpr int WM = T::FWM, WN = T::FWN, MU = T::FMU;
    fwd_prod<H, T, WM, WN, MU>(wo, NS, wr, M_IN, nullptr, 0, 0, emb, PSE,
                               slab0, slab1, hidden(W + off.b_in));
    fwd_prod<H, T, WM, WN, MU>(wo, NS, wr, M_MID1, act, H, PSH, nullptr, 0,
                               slab0, slab1, hidden(W + off.b_mid1));
    fwd_prod<H, T, WM, WN, MU>(wo, NS, wr, M_CAT, act, H, PSH, emb, PSE,
                               slab0, slab1, hidden(W + off.b_cat));
    fwd_prod<H, T, WM, WN, MU>(wo, NS, wr, M_MID2, act, H, PSH, nullptr, 0,
                               slab0, slab1, hidden(W + off.b_mid2));
    fwd_prod<H, T, 1, WN, 1>(wo, NS, wr, M_ALPHA, act, H, PSH, nullptr, 0,
                             slab0, slab1, head(W + off.b_alpha, out4));
    // emb_a's last reader (M_CAT) has passed its barriers
    pe_head<NT, P, NF, true>(xs, nullptr, W + off.dirs, emb);
    fwd_prod<H, T, WM, WN, MU>(wo, NS, wr, M_COL, act, H, PSH, emb, PSE,
                               slab0, slab1, hidden(W + off.b_col));
    fwd_prod<H, T, 1, WN, 1>(wo, NS, wr, M_OUT, act, H, PSH, nullptr, 0,
                             slab0, slab1, head(W + off.b_out, out4 + P));
    __syncthreads();
    for (int idx = threadIdx.x; idx < 4 * P; idx += NT) {
      const int r = idx / P, p = idx % P, gp = p0 + p;
      if (gp >= M) continue;
      const float v = out4[r * P + p];
      const size_t q = (size_t)o * M + gp;
      if (r == 0)
        alpha[q] = v * 10.f;
      else
        color[q * 3 + (r - 1)] = sigmoidf_(v);
    }
  }
}

// rows [0, n) of x (their first NB bf16 pieces [.][LDB], ps apart) to the
// scratch rows dst [piece pss apart][.][Mp] at the tile's points (P of
// them): a warp a row, a lane two points a 64-point segment (coalesced
// 4-byte stores); with bias, the row's sum over the tile's points (p0 +
// p1) added to bias[row] by the row's warp; with mbits, the row's ReLU
// mask (first piece > 0) as bits [row][segment][even, odd points]. Reads
// x only.
template <int NT, int P>
__device__ void save_rows(const bf16* x, int ps, int n, bf16* __restrict__ dst,
                          size_t pss, int Mp, float* bias, uint32_t* mbits) {
  constexpr int NW = NT / 32, LDB = P + 8, NSEG = (P + 63) / 64;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < n; r += NW) {
    float s = 0.f;
#pragma unroll
    for (int it = 0; it < NSEG; ++it) {
      const int p = 2 * lane + 64 * it;
      const bool ok = p < P;
      uint32_t u0 = 0;
#pragma unroll
      for (int pc = 0; pc < NB; ++pc) {
        if (!ok) continue;
        const uint32_t u =
            *reinterpret_cast<const uint32_t*>(x + pc * ps + r * LDB + p);
        *reinterpret_cast<uint32_t*>(dst + pc * pss + (size_t)r * Mp + p) = u;
        s += __uint_as_float(u << 16) + __uint_as_float(u & 0xffff0000u);
        if (pc == 0) u0 = u;
      }
      if (mbits) {
        const uint32_t ev = __ballot_sync(0xffffffffu, ok && pos_lo(u0));
        const uint32_t od = __ballot_sync(0xffffffffu, ok && pos_hi(u0));
        if (lane == 0) {
          mbits[(r * NSEG + it) * 2] = ev;
          mbits[(r * NSEG + it) * 2 + 1] = od;
        }
      }
    }
    if (bias) {
      s = warp_sum(s);
      if (lane == 0) bias[r] += s;
    }
  }
}

// dproj[j][p] (= 0 if init) += sum_{b < nb} pi 2^(b0+b)
//     cospif(2^(b0+b) proj[j][p]) gb[(b NDIR + j)][p]   (gb rows of LDF)
template <int NT, int P>
__device__ void fold(float* dproj, const float* proj, const float* gb, int b0,
                     int nb, bool init) {
  constexpr int LDF = band_ld<P>();
  for (int idx = threadIdx.x; idx < NDIR * P; idx += NT) {
    const int j = idx / P, p = idx % P;
    const float pr = proj[j * P + p];
    float acc = init ? 0.f : dproj[j * P + p];
    for (int b = 0; b < nb; ++b) {
      const float f = (float)(1 << (b0 + b));
      acc += (PI_F * f) * cospif(pr * f) * gb[(b * NDIR + j) * LDF + p];
    }
    dproj[j * P + p] = acc;
  }
}

template <int H>
__global__ void __launch_bounds__(FTile<H, true>::NT, FTile<H, true>::MINB)
field_bwd_kernel(const float* __restrict__ params, int n_params, Prep off,
                 const bf16* __restrict__ ws,         // [O, WP, NS]
                 const float* __restrict__ scale,     // [O]
                 const float* __restrict__ pts,       // [O, M, 3]
                 const float* __restrict__ g_alpha,   // [O, M]
                 const float* __restrict__ g_color,   // [O, M, 3]
                 int M, int n_tiles,
                 bf16* __restrict__ scr,              // [O, NB, SR, Mp]
                 int Mp,
                 float* __restrict__ rest_part) {     // [O, blocks, RP]
  using T = FTile<H, true>;
  using L = Plan<H, true>;
  constexpr int NT = T::NT, P = T::P, LDB = P + 8, NS = staged_size(H);
  constexpr int PSE = EROWS * LDB, PSH = H * LDB, LDF = band_ld<P>();
  constexpr int RP = rest_floats(H), SR = scratch_rows(H), NF = T::NF;
  constexpr int WM = T::FWM, WN = T::FWN, MU = T::FMU;
  constexpr int DM = T::DWM, DN = T::DWN, DU = T::DMU;
  const int o = blockIdx.y, b = blockIdx.x, nb = gridDim.x;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* wr = reinterpret_cast<bf16*>(smem);
  bf16* slab0 = wr;
  bf16* slab1 = reinterpret_cast<bf16*>(smem + L::slab);
  bf16* emb = reinterpret_cast<bf16*>(smem + L::emb);
  float* bandf = reinterpret_cast<float*>(smem + L::emb);   // [84][LDF]
  bf16* act = reinterpret_cast<bf16*>(smem + L::act);
  float* xs = reinterpret_cast<float*>(smem + L::f32);       // [3][P]
  float* proj = xs + 3 * P;                                  // [21][P]
  float* dproj = proj + NDIR * P;                            // [21][P]
  float* lg = dproj + NDIR * P;   // [4][P]: row 0 d alpha-layer, 1..3 logits
  float* rest = reinterpret_cast<float*>(smem + L::rest);   // [RP]
  // h1..h4's ReLU masks [4][H][NSEG][2]
  uint32_t* mbits = reinterpret_cast<uint32_t*>(smem + L::mask);
  constexpr int NSEG = L::NSEG;
  auto mk = [&](int l) { return mbits + (size_t)(l - 1) * H * NSEG * 2; };
  const float* W = params + (size_t)o * n_params;
  const bf16* wo = ws + (size_t)o * WP * NS;
  bf16* S = scr + (size_t)o * NB * SR * Mp;
  const size_t PSS = (size_t)SR * Mp;
  for (int i = threadIdx.x; i < RP; i += NT) rest[i] = 0.f;
  if constexpr (T::RES) stage_resident<H, NT, NF>(wr, wo, NS);
  const float* wa = W + off.w_alpha;

  auto hidden = [&](const float* bias) {
    return [=](int i, int p, float v0, float v1) {
      const float bb = bias[i];
      store_pair<NF>(act, PSH, LDB, i, p, fmaxf(v0 + bb, 0.f),
                     fmaxf(v1 + bb, 0.f));
    };
  };
  for (int tile = n_tiles * b / nb; tile < n_tiles * (b + 1) / nb; ++tile) {
    const int p0 = tile * P;
    bf16* Sx = S + p0;   // row r of the scratch at Sx + r Mp
    // 1. the forward, each activation saved to the scratch (the embedding
    //    region's pad rows zeroed again: the last tile's band gradients
    //    overwrote them)
    zero_emb_pad<NT, P, NF>(emb);
    pe_trunk<NT, P, NF, false>(pts + (size_t)o * M * 3, scale[o], W + off.dirs,
                           M, p0, xs, proj, emb);
    save_rows<NT, P>(emb, PSE, EROWS, Sx + (size_t)xr_ea(H) * Mp, PSS, Mp,
                     nullptr, nullptr);
    fwd_prod<H, T, WM, WN, MU>(wo, NS, wr, M_IN, nullptr, 0, 0, emb, PSE,
                               slab0, slab1, hidden(W + off.b_in));
    __syncthreads();
    save_rows<NT, P>(act, PSH, H, Sx + (size_t)xr_h(H, 1) * Mp, PSS, Mp,
                     nullptr, mk(1));
    fwd_prod<H, T, WM, WN, MU>(wo, NS, wr, M_MID1, act, H, PSH, nullptr, 0,
                               slab0, slab1, hidden(W + off.b_mid1));
    __syncthreads();
    save_rows<NT, P>(act, PSH, H, Sx + (size_t)xr_h(H, 2) * Mp, PSS, Mp,
                     nullptr, mk(2));
    fwd_prod<H, T, WM, WN, MU>(wo, NS, wr, M_CAT, act, H, PSH, emb, PSE,
                               slab0, slab1, hidden(W + off.b_cat));
    __syncthreads();
    save_rows<NT, P>(act, PSH, H, Sx + (size_t)xr_h(H, 3) * Mp, PSS, Mp,
                     nullptr, mk(3));
    fwd_prod<H, T, WM, WN, MU>(wo, NS, wr, M_MID2, act, H, PSH, nullptr, 0,
                               slab0, slab1, hidden(W + off.b_mid2));
    pe_head<NT, P, NF, false>(xs, proj, W + off.dirs, emb);
    __syncthreads();
    save_rows<NT, P>(act, PSH, H, Sx + (size_t)xr_h(H, 4) * Mp, PSS, Mp,
                     nullptr, mk(4));
    save_rows<NT, P>(emb, PSE, EBROWS, Sx + (size_t)xr_eb(H) * Mp, PSS, Mp,
                     nullptr, nullptr);
    fwd_prod<H, T, WM, WN, MU>(wo, NS, wr, M_COL, act, H, PSH, emb, PSE,
                               slab0, slab1, hidden(W + off.b_col));
    __syncthreads();
    save_rows<NT, P>(act, PSH, H, Sx + (size_t)xr_c(H) * Mp, PSS, Mp,
                     nullptr, nullptr);
    fwd_prod<H, T, 1, WN, 1>(
        wo, NS, wr, M_OUT, act, H, PSH, nullptr, 0, slab0, slab1,
        [=](int i, int p, float v0, float v1) {
          lg[(1 + i) * P + p] = v0 + W[off.b_out + i];
          lg[(1 + i) * P + p + 1] = v1 + W[off.b_out + i];
        });
    __syncthreads();

    // 2. the cotangents: lg row 0 d alpha-layer = 10 g_alpha, rows 1..3 d
    //    logits = g_c s (1 - s), 0 past M; as pieces into emb's rows 0..2
    //    (rows 3..15 zero: the colour head's input-gradient operand) and
    //    16 (17..31 zero), saved as the heads' gradient rows
    for (int p = threadIdx.x; p < P; p += NT) {
      const int gp = p0 + p;
      const bool ok = gp < M;
      const size_t q = (size_t)o * M + gp;
      const float da = ok ? g_alpha[q] * 10.f : 0.f;
      lg[p] = da;
      store_one<NB>(emb, PSE, 16 * LDB + p, da);
      for (int k = 0; k < 3; ++k) {
        const float s = sigmoidf_(lg[(1 + k) * P + p]);
        const float g = ok ? g_color[q * 3 + k] : 0.f;
        const float dl = g * s * (1.f - s);
        lg[(1 + k) * P + p] = dl;
        store_one<NB>(emb, PSE, k * LDB + p, dl);
      }
    }
    for (int idx = threadIdx.x; idx < NB * 28 * P; idx += NT) {
      const int pc = idx / (28 * P), r = idx % (28 * P) / P, p = idx % P;
      const int row = r < 13 ? 3 + r : 17 + (r - 13);
      emb[pc * PSE + row * LDB + p] = __float2bfloat16_rn(0.f);
    }
    __syncthreads();
    if (threadIdx.x < 128) {   // the heads' bias gradients, f32: a warp a row
      const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
      float s = 0.f;
      for (int p = lane; p < P; p += 32) s += lg[r * P + p];
      s = warp_sum(s);
      if (lane == 0) rest[r == 0 ? r_b_alpha(H) : r_b_out(H) + r - 1] += s;
    }
    save_rows<NT, P>(emb, PSE, 32, Sx + (size_t)dr_out(H) * Mp, PSS, Mp,
                     nullptr, nullptr);

    // 3. the input gradients, each pre-activation gradient over its
    //    activation in act, saved with its bias gradient
    auto masked = [=](bool m0, bool m1, int k, int p, float v0, float v1) {
      store_pair<NB>(act, PSH, LDB, k, p, m0 ? v0 : 0.f, m1 ? v1 : 0.f);
    };
    // h_l's mask bits of points p, p + 1 (p even) at row k
    auto bits = [=](int l, int k, int p, bool& m0, bool& m1) {
      const uint32_t* w =
          mbits + (((size_t)(l - 1) * H + k) * NSEG + (p >> 6)) * 2;
      const int sh = (p & 63) >> 1;
      m0 = (w[0] >> sh) & 1u;
      m1 = (w[1] >> sh) & 1u;
    };
    auto masked_h = [=](int l, int k, int p, float v0, float v1) {
      bool m0, m1;
      bits(l, k, p, m0, m1);
      masked(m0, m1, k, p, v0, v1);
    };
    // dc = relu'(c) W_out^T dlogits (c: act)
    dgrad_prod<H, T, DM, DN, DU>(
        wo, NS, wr, M_OUT, emb, PSE, slab0, slab1,
        [=](int k, int p, float v0, float v1) {
          const uint32_t u = *reinterpret_cast<const uint32_t*>(
              act + k * LDB + p);
          masked(pos_lo(u), pos_hi(u), k, p, v0, v1);
        });
    __syncthreads();
    save_rows<NT, P>(act, PSH, H, Sx + (size_t)dr_c(H) * Mp, PSS, Mp,
                     rest + r_b_col(H), nullptr);
    // dh4 = relu'(h4) (W_col_h^T dc + w_alpha^T dalpha); bands 4, 5 of
    // W_col_x^T dc into bandf
    dgrad_prod<H, T, DM, DN, DU>(
        wo, NS, wr, M_COL, act, PSH, slab0, slab1,
        [=](int k, int p, float v0, float v1) {
          if (k < H) {
            const float w = wa[k];
            masked_h(4, k, p, v0 + w * lg[p], v1 + w * lg[p + 1]);
          } else if (k < H + EMB2) {
            bandf[(k - H) * LDF + p] = v0;
            bandf[(k - H) * LDF + p + 1] = v1;
          }
        });
    __syncthreads();
    save_rows<NT, P>(act, PSH, H, Sx + (size_t)dr_h(H, 4) * Mp, PSS, Mp,
                     rest + r_b_mid2(H), nullptr);
    fold<NT, P>(dproj, proj, bandf, 4, 2, true);
    // dh3 = relu'(h3) W_mid2^T dh4
    dgrad_prod<H, T, DM, DN, DU>(
        wo, NS, wr, M_MID2, act, PSH, slab0, slab1,
        [=](int k, int p, float v0, float v1) { masked_h(3, k, p, v0, v1); });
    __syncthreads();
    save_rows<NT, P>(act, PSH, H, Sx + (size_t)dr_h(H, 3) * Mp, PSS, Mp,
                     rest + r_b_cat(H), nullptr);
    // dh2 = relu'(h2) W_cat_h^T dh3; bands 0..3 of W_cat_x^T dh3 (emb_a's
    // columns past xs) into bandf
    dgrad_prod<H, T, DM, DN, DU>(
        wo, NS, wr, M_CAT, act, PSH, slab0, slab1,
        [=](int k, int p, float v0, float v1) {
          if (k < H) {
            masked_h(2, k, p, v0, v1);
          } else if (k >= H + 3 && k < H + EMB1) {
            bandf[(k - H - 3) * LDF + p] = v0;
            bandf[(k - H - 3) * LDF + p + 1] = v1;
          }
        });
    __syncthreads();
    save_rows<NT, P>(act, PSH, H, Sx + (size_t)dr_h(H, 2) * Mp, PSS, Mp,
                     rest + r_b_mid1(H), nullptr);
    // dh1 = relu'(h1) W_mid1^T dh2
    dgrad_prod<H, T, DM, DN, DU>(
        wo, NS, wr, M_MID1, act, PSH, slab0, slab1,
        [=](int k, int p, float v0, float v1) { masked_h(1, k, p, v0, v1); });
    __syncthreads();
    save_rows<NT, P>(act, PSH, H, Sx + (size_t)dr_h(H, 1) * Mp, PSS, Mp,
                     rest + r_b_in(H), nullptr);
    // bands 0..3 of W_in^T dh1 added into bandf (W_cat_x's share there),
    // then folded once
    dgrad_prod<H, T, DM, DN, DU>(
        wo, NS, wr, M_IN, act, PSH, slab0, slab1,
        [=](int k, int p, float v0, float v1) {
          if (k >= 3 && k < EMB1) {
            bandf[(k - 3) * LDF + p] += v0;
            bandf[(k - 3) * LDF + p + 1] += v1;
          }
        });
    __syncthreads();
    fold<NT, P>(dproj, proj, bandf, 0, 4, false);
    __syncthreads();
    // d dirs[j][k] = sum_p dproj[j][p] xs[k][p]: a warp a (j, k)
    for (int idx = threadIdx.x >> 5; idx < NDIR * 3; idx += NT / 32) {
      const int j = idx / 3, k = idx % 3, lane = threadIdx.x & 31;
      float acc = 0.f;
      for (int p = lane; p < P; p += 32)
        acc = fmaf(dproj[j * P + p], xs[k * P + p], acc);
      acc = warp_sum(acc);
      if (lane == 0) rest[R_DIRS + idx] += acc;
    }
    __syncthreads();   // the next tile overwrites xs, proj, emb
  }
  float* out = rest_part + ((size_t)o * nb + b) * RP;
  for (int i = threadIdx.x; i < RP; i += NT) out[i] = rest[i];
}

// K3's weight gradients: block (tile t + T s, object o) sums tile t of
// the gradient of staged matrix m, rows i0.. (TI), columns k0.. (TK), over
// the points of split s (units of `unit` points [s nu / S, (s + 1) nu /
// S)), from the scratch's pieces: D[i][p] x X[k][p], three passes, a
// 4-stage cp.async ring of 32-point steps (each panel row found through a
// table of row pointers made once); writes the tile once to part[o, s] in
// the staged layout. Warps: TI = 128 a 2 x 4 grid of 64 x 32 warp tiles,
// TI = 64 a 2 x 4 grid of 32 x 32, TI = 32 a 1 x 8 grid of 32 x 16.
template <int H>
__global__ void __launch_bounds__(WG_NT, wg_minb(H))
field_wgrad_kernel(const bf16* __restrict__ scr, int Mp, int unit,
                   int n_splits, float* __restrict__ part) {
  constexpr int TI = wg_ti(H), TK = WG_TK, NTL = wg_tiles(H);
  constexpr int NS = staged_size(H), SR = scratch_rows(H);
  constexpr int LD = WG_LD, KP = WG_KP, ROWS = TI + TK;
  constexpr int WM = TI == 128 ? 4 : 2, WN = TI == 32 ? 2 : 4;
  constexpr int WC = TK / (8 * WN);                       // warp columns
  constexpr size_t STAGE = (size_t)NB * ROWS * LD;        // elements
  const int t = blockIdx.x % NTL, s = blockIdx.x / NTL, o = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int m = 0, tl = t;
  while (tl >= wg_tiles(H, m)) tl -= wg_tiles(H, m++);
  const int Rr = mat_rows(H, m), C = mat_cols(H, m);
  const int nck = (C + TK - 1) / TK;
  const int i0 = tl / nck * TI, k0 = tl % nck * TK;
  const int rv = Rr - i0 < TI ? Rr - i0 : TI;        // rows of the tile
  const int cv = C - k0 < TK ? C - k0 : TK;          // columns
  const int nu = (Mp + unit - 1) / unit;
  const int pb = (int)((long long)nu * s / n_splits) * unit;
  int pe = (int)((long long)nu * (s + 1) / n_splits) * unit;
  if (pe > Mp) pe = Mp;
  const int n = pe > pb ? (pe - pb) / KP : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);   // [ST][NB][ROWS][LD]
  const bf16** rowp = reinterpret_cast<const bf16**>(
      smem + (size_t)WG_ST * STAGE * 2);         // [ROWS]
  const bf16* So = scr + (size_t)o * NB * SR * Mp;
  const size_t PSS = (size_t)SR * Mp;
  for (int r = threadIdx.x; r < ROWS; r += WG_NT) {
    const int sr = r < TI ? (r < rv ? d_row(H, m, i0 + r) : -1)
                          : (r - TI < cv ? x_row(H, m, k0 + r - TI) : -1);
    rowp[r] = sr < 0 ? nullptr : So + (size_t)sr * Mp;
  }
  // the panels' rows past the tile's (never copied) zeroed once
  for (int idx = threadIdx.x; idx < WG_ST * NB * ROWS * LD; idx += WG_NT) {
    const int r = idx / LD % ROWS;
    if (r < TI ? r >= rv : r - TI >= cv) ring[idx] = __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  const uint64_t pol = l2_evict_last();
  auto stage = [&](int st, int pp) {   // points pp .. pp + KP into stage st
    bf16* dst = ring + st * STAGE;
    for (int idx = threadIdx.x; idx < NB * ROWS * (KP / 8); idx += WG_NT) {
      const int pc = idx / (ROWS * (KP / 8)), r = idx / (KP / 8) % ROWS;
      const int c = idx % (KP / 8);
      const bf16* src = rowp[r];
      if (src)
        cp_async16(dst + (pc * ROWS + r) * LD + c * 8,
                   src + pc * PSS + pp + c * 8, pol);
    }
  };
  const int wr0 = warp / WC * 16 * WM, wc0 = warp % WC * 8 * WN;
  float acc[WM][WN][4] = {};
#pragma unroll
  for (int st = 0; st < WG_ST - 1; ++st) {
    if (st < n) stage(st, pb + st * KP);
    cp_async_commit();
  }
  for (int step = 0; step < n; ++step) {
    cp_async_wait<WG_ST - 2>();
    __syncthreads();
    const int nx = step + WG_ST - 1;
    if (nx < n) stage(nx % WG_ST, pb + nx * KP);
    cp_async_commit();
    const bf16* Dp = ring + (step % WG_ST) * STAGE;   // [NB][ROWS][LD]
    const bf16* Xp = Dp + TI * LD;
#pragma unroll
    for (int kk = 0; kk < KP; kk += 16) {
      uint32_t b[WN][NB][2];
#pragma unroll
      for (int pc = 0; pc < NB; ++pc)
#pragma unroll
        for (int w2 = 0; w2 < WN; w2 += 2) {
          uint32_t bb[2][2];
          load_b_nk(bb, Xp + pc * ROWS * LD, LD, wc0 + 8 * w2, kk, lane);
          b[w2][pc][0] = bb[0][0];
          b[w2][pc][1] = bb[0][1];
          b[w2 + 1][pc][0] = bb[1][0];
          b[w2 + 1][pc][1] = bb[1][1];
        }
#pragma unroll
      for (int wm = 0; wm < WM; ++wm) {
        if (wr0 + 16 * wm >= rv) continue;
        uint32_t a[NB][4];
#pragma unroll
        for (int pc = 0; pc < NB; ++pc)
          load_a_ldsm(a[pc], Dp + pc * ROWS * LD, LD, wr0 + 16 * wm, kk,
                      lane);
#pragma unroll
        for (int wn = 0; wn < WN; ++wn) mma_pieces<NB>(acc[wm][wn], a, b[wn]);
      }
    }
  }
  cp_async_wait<0>();
  const int g = lane >> 2, tq = lane & 3;
  const bool odd = tq & 1;
  float* G = part + ((size_t)o * n_splits + s) * NS + mat_off(H, m);
#pragma unroll
  for (int wm = 0; wm < WM; ++wm)
#pragma unroll
    for (int wn = 0; wn < WN; ++wn) {
      const float4 v = acc_quad(acc[wm][wn], odd);
      const int i = wr0 + 16 * wm + g + (odd ? 8 : 0);
      const int k = wc0 + 8 * wn + 2 * tq - (odd ? 2 : 0);
      if (wr0 + 16 * wm < rv && k < cv)
        *reinterpret_cast<float4*>(G + (size_t)(i0 + i) * C + k0 + k) = v;
    }
}

Prep make_prep(const int* v) {
  return Prep{v[0], v[1], v[2],  v[3],  v[4],  v[5],  v[6],  v[7], v[8],
              v[9], v[10], v[11], v[12], v[13], v[14], v[15], v[16]};
}

bool bad_shape(int hidden, const int* offsets, int n_params, int O, int M) {
  return O < 1 || O > 65535 || M < 1 || n_params < 1 ||
         offsets[N_PREP - 1] + hidden * EMB_PAD > n_params;
}

template <class K>
cudaError_t set_smem(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int H>
int launch_fwd(const float* params, int n_params, const Prep& off,
               const bf16* ws, const float* scale, const float* pts, int O,
               int M, int sms, float* alpha, float* color,
               cudaStream_t stream) {
  using T = FTile<H, false>;
  constexpr size_t smem = Plan<H, false>::bytes;
  const int n_tiles = (M + T::P - 1) / T::P;
  auto kernel = field_fwd_kernel<H>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<fwd_blocks<H>(sms, O, M), T::NT, smem, stream>>>(
      params, n_params, off, ws, scale, pts, M, O, n_tiles, alpha, color);
  return (int)cudaGetLastError();
}

template <int H>
int launch_bwd(const float* params, int n_params, const Prep& off,
               const bf16* ws, const float* scale, const float* pts,
               const float* g_alpha, const float* g_color, int O, int M,
               int tile_m, int sms, bf16* scr, float* rest_part,
               cudaStream_t stream) {
  using T = FTile<H, true>;
  constexpr size_t smem = Plan<H, true>::bytes;
  // the tiles cover the scratch's Mp points (those past M with zero
  // cotangents), so the weight gradients read no unwritten row
  const BwdGrid g = bwd_grid<H>(sms, O, M, tile_m);
  auto kernel = field_bwd_kernel<H>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(g.per_obj, O), T::NT, smem, stream>>>(
      params, n_params, off, ws, scale, pts, g_alpha, g_color, M,
      g.Mp / T::P, scr, g.Mp, rest_part);
  return (int)cudaGetLastError();
}

template <int H>
int launch_wgrad(const bf16* scr, int O, int M, int tile_m, int sms,
                 float* part, cudaStream_t stream) {
  constexpr size_t smem = wg_smem(H);
  const BwdGrid g = bwd_grid<H>(sms, O, M, tile_m);
  auto kernel = field_wgrad_kernel<H>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(wg_tiles(H) * g.splits, O), WG_NT, smem, stream>>>(
      scr, g.Mp, g.unit, g.splits, part);
  return (int)cudaGetLastError();
}

}  // namespace
