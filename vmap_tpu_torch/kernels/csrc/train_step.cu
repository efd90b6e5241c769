// Hand-written CUDA train-frame kernels for the vMAP object / background
// banks and the iMAP scene field under the float matmul policies (sm_90a,
// plain C interface, loaded with ctypes).
//
// Replaces the TPU kernel vmap_tpu/kernels/train_step.py::_make_kernel
// (launched by fused_frame_prepared; its products mm / mmT / mTv). The
// contract is the math on flat banks, not the TPU layout: no
// block-diagonal object packing, no row merges, no polynomial sin/cos or
// fast sigmoid.
//
// One optimisation iteration of one bank is two launches:
//   train_grad_kernel   grid (partial row, slot). A ray tile is RT whole
//       rays with all S samples of each (the termination cumprod runs along
//       the ray), at most Tile<H>::FP points (kernels.FLOAT_POINTS). A
//       block takes the tiles row, row + n_rows, ... in order; for each it
//       builds the points and the PE, runs the 7-layer MLP forward, renders
//       depth / colour / opacity / detached variance, forms the
//       normaliser-weighted masked L1 losses, and runs the hand-derived
//       backward (the dirs gradient through cos(pi 2^k proj) pi 2^k
//       included). The block's first tile writes its partial gradients to
//       its row grad_part[slot, row, :] (grad_row: the weights in the
//       staged layout below, then the biases and dirs) and its loss to
//       loss_part[slot, row]; later tiles add to them in tile order: no
//       atomics, deterministic (kernels/train_step.py frame_geometry).
//   adamw_kernel        grid (param chunk, slot). Sums a parameter's row
//       partials in a fixed order (deterministic), then applies masked
//       AdamW (torch semantics: p *= 1 - lr wd first, betas 0.9 / 0.999,
//       eps 1e-8, per-slot bias corrections 1 - b^t precomputed on the
//       host), and writes the staged copy of the updated product weights.
//       Inactive slots are not touched, so they stay bit-identical.
//
// The products run on tensor cores: mma.sync m16n8k16, bf16 operands, f32
// accumulation (mma.cuh); each warp owns a register tile of WM x WN 16 x 8
// output tiles, up to MU such units at once (Tile<H>):
//   forward       out[i][p] = W[i][k] x[k][p]: A = W from shared memory,
//                 B = the f32 activations, split into bf16 pieces as read;
//   input grads   dx[k][p] = W[i][k] d[i][p]: A = W^T, one ldmatrix .trans
//                 a fragment, B = the upstream gradient;
//   weight grads  dW[i][k] = d[i][p] x[k][p] over the tile's points, both
//                 operands from the activations, added to the block's row
//                 as whole 16-byte groups (wgrad_mma).
// The weights are staged: adamw_kernel (and, before a frame's first
// iteration, kernels/train_step.py stage_weights) writes each product
// weight as three bf16 pieces w = p0 + p1 + p2, each matrix padded to
// whole 16 x 16 tiles (staged_layout), so no tile splits or pads a weight.
// A block streams each layer's pieces through a ring of two slabs in
// shared memory with 16-byte cp.async copies that keep the weights in L2
// (evict_last), the next slab in flight while the current one computes:
// the forward in slabs of fwd_kf columns, the input gradients in slabs of
// KB rows. (At h=256 a layer's pieces are up to 540 KB: they never fit at
// once.)
//
// Matmul policies (the JAX kernel's _mm_policy, a template parameter POL)
// and the pieces each product's operands are split into (mma_pieces):
//   F32       two pieces, three passes p0 p0 + p0 p1 + p1 p0 (not TF32,
//             which stays off): a product's error is at most (3 2^-16 + K
//             2^-24) sum_k |a_k b_k|, the dropped p1 p1, the split's
//             remainders and the f32 sum over K terms
//             (tests/test_torch_k1_design.py holds its plain version,
//             mm_bf16_pieces, to it against f64 at K1's layer shapes).
//             The TPU's own f32 dots ran at bf16 single-pass precision
//             (docs/round_notes.md:192).
//   BWD_BF16  the forward on three pieces, six passes, within (4 + K) 2^-24
//             of the f32 product: its saved activations are rounded to
//             bf16 for the backward, and the three-pass forward put enough
//             of them on the other side of a bf16 step from the f32 plain
//             version's to miss the policy tier in d w_col, d b_col and
//             d w_cat (chip_smoke.py phase 10 holds the error norm under
//             0.1 of the policy's effect). The backward
//             products on bf16 operands (upstream gradients, saved
//             activations, weights, and dproj / xs of the dirs gradient),
//             one pass;
//   BF16      also the forward products' operands (weights, embedding) and
//             the stored ReLU activations rounded, one pass.
// A product of two bf16 values is exact in f32, so the one-pass products
// compute what the TPU kernel's bf16 dots compute, up to summation order.
// Each rounded operand is rounded once where it is made, not in the
// products: the weights by adamw_kernel (piece p0); the embedding and
// activations in place once the f32 forward no longer reads them (the
// spilled ones as they come back); each upstream gradient in place once
// its f32 bias gradient is taken. Biases, their gradients, the dirs
// projection, PE, render, losses and AdamW stay f32.
//
// The tile's activations live in shared memory, f32, [row][LDP] with the
// point index fastest (FloatBufs), and are overwritten in place by their
// gradients on the way back. Only two hidden-activation buffers stay: h1,
// h2, h3 are copied to the block's activation scratch in global memory (L2
// resident) as the forward moves on and come back in the backward, so a
// tile holds more points: 56 at h=128 and h=256 (4 rays of 14 samples: 167
// KB at h=256, beside 49 KB of slabs, one block of 512 threads an SM;
// with all five buffers it held 28), 60 of 64 at h=32 (88 KB, two blocks
// an SM). Where two slabs do not fit beside a tile (bwd_bf16's three
// forward pieces at h=256) the block streams through one.
//
// Per ray (render, losses, render backward) a warp takes a ray, lane s its
// sample s (S <= 32): the transmittance is a prefix product and the
// render backward's suffix sum R_s = sum_{i>s} dterm_i occ_i
// prod_{s<j<i} free_j an affine suffix scan, both by warp shuffles, the
// sums warp reductions: dependent chains of log2(32) steps, not S.
//
// What bounds it on the card (chip_smoke.py --sections times each section;
// PERF.md): at h=256 the weight gradients' read-modify-write of the
// block's 1.33 MB partial row per tile (132 rows, 176 MB, past L2), then
// the forward and input-gradient products' slab steps (three or four
// slabs in flight did not shorten them, so not the weights' latency); at
// h=32 / 128 the chain of slab steps, barriers and per-tile sections.
// The work's own bound is far below: the products are 3 x 11,200
// multiply-adds a point at h=32, 3 x 318,000 at h=256.
//
// sin / cos use sinpif / cospif (exact-argument sin(pi x)); the build does
// not pass --use_fast_math: the band-5 argument reaches 32 pi |proj|.
//
// sample_reuse: od, ray and wmul hold n_eff = n_iter / reuse iterations
// of pixels; iteration it reads pixel block it mod n_eff and its own z
// (a REUSE instance of train_grad_kernel; n_eff == n_iter runs the
// plain one).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "train_step.cuh"

namespace {

// ---- the staged product weights (kernels/train_step.py staged_layout):
// the seven weight matrices [n_out][n_in] in this order, each as bf16
// [up16(n_out)][up16(n_in)] row-major with zero padding; a slot holds
// STAGED_PIECES planes of staged_size(H) elements: bf16 pieces p0 = bf16(w),
// p1 = bf16(w - p0), p2 = bf16(w - p0 - p1) (mma.cuh split)
enum WMat : int { M_IN, M_MID1, M_CAT, M_MID2, M_ALPHA, M_COL, M_OUT, NMAT };

__host__ __device__ constexpr int up16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ constexpr int mat_out(int H, int m) {
  return m == M_ALPHA ? 1 : m == M_OUT ? 3 : H;
}
__host__ __device__ constexpr int mat_in(int H, int m) {
  return m == M_IN ? EMB1 : m == M_CAT ? H + EMB1 : m == M_COL ? H + EMB2 : H;
}
__host__ __device__ constexpr int mat_off(int H, int m) {
  int s = 0;
  for (int i = 0; i < m; ++i) s += up16(mat_out(H, i)) * up16(mat_in(H, i));
  return s;
}
__host__ __device__ constexpr int staged_size(int H) {
  return mat_off(H, NMAT);
}
constexpr int STAGED_PIECES = 3;

// A float-policy partial-gradient row: the product weights' gradients in
// the staged layout (wgrad_mma's 16-byte writes), then the other
// parameters, the dirs and biases, which lead the parameter layout
// (BankSpec: the PE's dirs, then the MLP's names sorted, b_* before w_*):
// parameter j < rest_size(H) at staged_size(H) + j. grad_row floats, a
// multiple of 16, so every row starts 64-byte aligned. kernels/train_step.py
// grad_row_index gives each parameter's place.
__host__ __device__ constexpr int rest_size(int H) {
  return 3 * NDIR + 5 * H + 4;   // dirs, five [H] biases, b_alpha, b_col_out
}
__host__ __device__ constexpr int grad_row(int H) {
  return staged_size(H) + up16(rest_size(H));
}

// Whether the dirs and biases lie within the first rest_size(H) parameters,
// where a float-policy row keeps them
bool rest_fits(const Offsets& o, int H) {
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

constexpr size_t SMEM_MAX = 232448;   // the most a block may use

// The float tile's shared memory (kernels/train_step.py float_smem_bytes):
// nbuf slab buffers, then FloatBufs' rows (EMB + 4 NDIR + 2 H + 8 of LDP)
// and the per-ray losses
template <int H, int POL>
size_t float_smem_bytes(int LDP, int RT, int nbuf) {
  return nbuf * slab_bytes<H, POL>() +
         sizeof(float) * ((size_t)LDP * (EMB + 4 * NDIR + 2 * H + 8) + RT);
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

// out[i][p] = act(b[i] + sum_k W[i][k] x[k][p]) for i < n_out, p < P, where
// W is staged matrix m (ws: its slot's pieces, NS apart) and x the
// rows ina (na) then inb (nb, na a multiple of 16). relu: max(., 0), stored
// rounded to bf16 under R. The slabs: a ring of two (the next in flight
// while one computes), or one (slab1 == slab0, where two do not fit beside
// the tile). Starts by staging its first slab; ends with the slabs free
// (the block synchronised after its last read of them), out written but
// not yet synchronised.
template <int H, int WM, int WN, int MU, int NP, bool R>
__device__ void fwd_mma(const bf16* __restrict__ ws, int NS, int m,
                        const float* __restrict__ bias, const float* ina,
                        int na, const float* inb, int nb, float* out, int P,
                        int LDP, bool relu, bf16* slab0, bf16* slab1) {
  constexpr int NT = Tile<H>::NT, NW = NT / 32, KF = fwd_kf<H, NP>();
  constexpr int LD = KF + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_out = mat_out(H, m), Rr = up16(n_out), C = up16(na + nb);
  const int un = ((P + 15) / 16 * 2) / WN;
  const int units = (Rr / 16 + WM - 1) / WM * un;
  if (units > MU * NW) __trap();   // Tile<H> does not cover this product
  const bf16* src = ws + mat_off(H, m);
  float acc[MU][WM][WN][4] = {};
  bf16* buf[2] = {slab0, slab1};
  const bool ring = slab1 != slab0;
  const int ns = (C + KF - 1) / KF;
  stage_slab<NT, NP>(buf[0], LD, src, NS, C, 0, Rr, 0, C < KF ? C : KF);
  for (int s = 0; s < ns; ++s) {
    const int k0 = s * KF, kw = C - k0 < KF ? C - k0 : KF, k1 = k0 + KF;
    if (ring && s + 1 < ns) {
      stage_slab<NT, NP>(buf[(s + 1) & 1], LD, src, NS, C, 0, Rr, k1,
                         C - k1 < KF ? C - k1 : KF);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sh = buf[s & 1];   // piece i at sh + i Rr LD
#pragma unroll
    for (int j = 0; j < MU; ++j) {
      const int u = warp + j * NW;
      if (u < units) {
        const int m0 = u / un * 16 * WM, n0 = u % un * 8 * WN;
        for (int kk = 0; kk < kw; kk += 16) {
          const int k = k0 + kk;
          const float* xb = k < na ? ina + k * LDP : inb + (k - na) * LDP;
          const int kv = k < na ? na - k : nb - (k - na);
          uint32_t b[WN][NP][2];
#pragma unroll
          for (int wn = 0; wn < WN; ++wn)
            load_b_rows<NP>(b[wn], xb, LDP, n0 + 8 * wn + (lane >> 2), P, kv,
                            lane & 3);
#pragma unroll
          for (int wm = 0; wm < WM; ++wm) {
            if (m0 + 16 * wm >= Rr) continue;
            uint32_t a[NP][4];
#pragma unroll
            for (int i = 0; i < NP; ++i)
              load_a_rows(a[i], sh + i * Rr * LD, LD, m0 + 16 * wm, kk, lane);
#pragma unroll
            for (int wn = 0; wn < WN; ++wn)
              mma_pieces<NP>(acc[j][wm][wn], a, b[wn]);
          }
        }
      }
    }
    __syncthreads();
    if (!ring && s + 1 < ns)
      stage_slab<NT, NP>(slab0, LD, src, NS, C, 0, Rr, k1,
                         C - k1 < KF ? C - k1 : KF);
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
          const int i = m0 + 16 * wm + (lane >> 2) + (q >> 1) * 8;
          const int p = n0 + 8 * wn + 2 * (lane & 3) + (q & 1);
          if (i < n_out && p < P) {
            const float v = acc[j][wm][wn][q] + bias[i];
            out[i * LDP + p] = relu ? rnd<R>(fmaxf(v, 0.f)) : v;
          }
        }
  }
}

// epi(k, p, sum_i W[i][k] d[i][p]) for every staged column k < up16(n_in)
// and p < P, where W is staged matrix m and d its upstream gradient rows
// (n_out of them). The slabs and the synchronisation as fwd_mma.
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

// G[i * up16(na + nb) + k] (+)= sum_p d[i][p] x[k][p], the product
// weight's gradient in the staged layout (its partial-gradient row's
// weight block, grad_row): every i < up16(n_out), k < up16(na + nb), the
// padding zero; x the rows ina (na) then inb. add: onto the row (a block's
// later tiles). Lanes t and t ^ 1 swap half their accumulators, so each
// writes 4 consecutive floats of one row, 16-byte aligned: whole 32-byte
// sectors, read and written past L1 and first out of L2 (the row is read
// back once per tile, the staged weights by every tile). Reads only the
// tile's rows; no synchronisation.
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
  // this lane's 4 floats of output tile (wm, wn) of unit u: even t row g,
  // columns 2t .. 2t + 3; odd t row g + 8, columns 2t - 2 .. 2t + 1
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
        const float* c = acc[wm][wn];
        const float s0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
        const float s1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
        if (m0 + 16 * wm >= rows) continue;
        float4 v = odd ? make_float4(s0, s1, c[2], c[3])
                       : make_float4(c[0], c[1], s0, s1);
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

// Per ray, a warp each, lane s = sample s: render, losses, render backward
// -> dal, dy, and rl[r] the ray's loss (the loss of tile_body's section 3,
// with prefix / suffix scans for its serial loops)
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
// gradient, two hidden-activation buffers a and b (float_tile names what
// each holds when), the heads' outputs and gradients, 42 rows for band
// gradients, the per-ray losses (float_smem_bytes).
template <int H>
struct FloatBufs {
  float *emb, *proj, *dproj, *a, *b, *alp, *col, *dal, *dy, *band, *rl;
  __device__ __forceinline__ FloatBufs(float* sm, int LDP)
      : emb(sm), proj(emb + EMB * LDP), dproj(proj + NDIR * LDP),
        a(dproj + NDIR * LDP), b(a + H * LDP), alp(b + H * LDP),
        col(alp + LDP), dal(col + 3 * LDP), dy(dal + LDP),
        band(dy + 3 * LDP), rl(band + 2 * NDIR * LDP) {}
};

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

// Section timing of the tile, built only with -DK1_PROFILE (the measuring
// library of chip_smoke.py --sections, never the port's): block (0, 0)'s
// thread 0 adds the clocks of each section, the block synchronised at
// both ends, to k1_prof: 0 points and PE, 1 forward, 2 render and losses,
// 3 weight gradients, 4 input gradients, 5 the rest (bias gradients, band
// folds, activation reloads, the dirs gradient).
#ifdef K1_PROFILE
__device__ unsigned long long k1_prof[8];
#define K1_MARK_START() long long k1_t0 = clock64()
#define K1_MARK(n)                                                   \
  do {                                                               \
    __syncthreads();                                                 \
    if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) {    \
      const long long k1_t = clock64();                              \
      k1_prof[n] += k1_t - k1_t0;                                    \
      k1_t0 = k1_t;                                                  \
    }                                                                \
  } while (0)
#else
#define K1_MARK_START()
#define K1_MARK(n)
#endif

// One ray tile (rays ray0 .. ray0 + RT of this iteration, past n_per
// padded) of one slot under a float policy: points, forward, render,
// losses, backward. Ray r of the tile reads od, ray and zs at row rbase +
// ray0 + r. W holds the slot's f32 parameters, ws its staged weights (NS
// apart per piece), hs the block's activation scratch [3][H][LDP]. The
// gradients go to the block's row G (grad_row: the weights staged) and the
// tile's loss to *loss; with add, both are added onto what the block's
// earlier tiles left there. Ends with the block synchronised, so the next
// tile may reuse sm. Not inlined: inlined into the kernel's tile loop, the
// loop-invariant addresses were hoisted into registers.
template <int H, int POL>
__device__ __noinline__ void float_tile(const float* __restrict__ W,
                          const bf16* __restrict__ ws, int NS,
                          const float* __restrict__ od,
                          const float* __restrict__ zs,
                          const float* __restrict__ ray,
                          const float* __restrict__ wm, float sc,
                          float* __restrict__ G, float* __restrict__ loss,
                          float* __restrict__ hs, Offsets off, size_t rbase,
                          int ray0, int n_per, int S, int RT, int LDP,
                          float cs, float osc, bool add, float* sm,
                          bf16* slab0, bf16* slab1) {
  using T = Tile<H>;
  constexpr int NT = T::NT;
  constexpr bool RF = POL == BF16;                      // forward rounded
  constexpr bool RB = POL == BWD_BF16 || POL == BF16;   // backward rounded
  constexpr int NF = fwd_pieces<POL>(), NB = bwd_pieces<POL>();
  constexpr int FWM = T::FWM, FWN = T::FWN, FMU = T::FMU;
  constexpr int DWM = T::DWM, DWN = T::DWN, DMU = T::DMU;
  const int P = RT * S;
  const FloatBufs<H> bufs(sm, LDP);
  float *emb = bufs.emb, *proj = bufs.proj, *dproj = bufs.dproj;
  float *a = bufs.a, *b = bufs.b, *alp = bufs.alp, *col = bufs.col;
  float *dal = bufs.dal, *dy = bufs.dy, *band = bufs.band, *rl = bufs.rl;
  float* emb2 = emb + EMB1 * LDP;
  float *s1 = hs, *s2 = hs + H * LDP, *s3 = hs + 2 * H * LDP;
  float* Gx = G + NS;   // the row's dirs and biases (grad_row)
  K1_MARK_START();

  // 1. points xs = (o + z d) / scale, projection, sin bands
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
  if constexpr (RF) {   // the projection has read xs: emb is a product operand
    round_rows<NT>(emb, EMB, P, LDP);
    __syncthreads();
  }

  K1_MARK(0);
  // 2. MLP forward. Each product synchronises before it reads its input
  //    and after its last read, so a buffer a product has read may be
  //    saved while the next product runs: h1 -> a -> s1, h2 -> b -> s2,
  //    h3 -> a -> s3, h4 -> b, hc -> a.
  fwd_mma<H, FWM, FWN, FMU, NF, RF>(ws, NS, M_IN, W + off.b_in, emb, EMB1,
                                    nullptr, 0, a, P, LDP, true, slab0,
                                    slab1);
  fwd_mma<H, FWM, FWN, FMU, NF, RF>(ws, NS, M_MID1, W + off.b_mid1, a, H,
                                    nullptr, 0, b, P, LDP, true, slab0,
                                    slab1);
  save_rows<NT>(s1, a, H, P, LDP);
  fwd_mma<H, FWM, FWN, FMU, NF, RF>(ws, NS, M_CAT, W + off.b_cat, b, H, emb,
                                    EMB1, a, P, LDP, true, slab0, slab1);
  save_rows<NT>(s2, b, H, P, LDP);
  fwd_mma<H, FWM, FWN, FMU, NF, RF>(ws, NS, M_MID2, W + off.b_mid2, a, H,
                                    nullptr, 0, b, P, LDP, true, slab0,
                                    slab1);
  save_rows<NT>(s3, a, H, P, LDP);
  fwd_mma<H, 1, FWN, 1, NF, RF>(ws, NS, M_ALPHA, W + off.b_alpha, b, H,
                                nullptr, 0, alp, P, LDP, false, slab0,
                                slab1);
  fwd_mma<H, FWM, FWN, FMU, NF, RF>(ws, NS, M_COL, W + off.b_col, b, H, emb2,
                                    EMB2, a, P, LDP, true, slab0, slab1);
  fwd_mma<H, 1, FWN, 1, NF, RF>(ws, NS, M_OUT, W + off.b_col_out, a, H,
                                nullptr, 0, col, P, LDP, false, slab0,
                                slab1);
  __syncthreads();
  if constexpr (POL == BWD_BF16) {
    // the f32 forward is done: from here on the saved activations are
    // read by the backward products (and, sign unchanged, the ReLU masks);
    // s1 .. s3 are rounded as they are reloaded
    round_rows<NT>(emb, EMB, P, LDP);
    round_rows<NT>(a, H, P, LDP);
    round_rows<NT>(b, H, P, LDP);
  }

  K1_MARK(1);
  // 3. per ray: render, losses, render backward -> dal, dy
  render_rays<NT>(zs, ray, wm, alp, col, dal, dy, rl, rbase, ray0, n_per, S,
                  RT, LDP, cs, osc);
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int r = 0; r < RT; ++r) acc += rl[r];
    *loss = add ? *loss + acc : acc;
  }
  K1_MARK(2);

  // 4. MLP backward. Each activation buffer becomes its pre-activation
  //    gradient once its own weight gradient has been taken; h3, h2, h1
  //    come back from the scratch into the buffer whose gradient has just
  //    been consumed. Under a bf16 backward policy each gradient's bias
  //    gradient comes first, from its f32 values (bgrad_round), and the
  //    products then read it rounded.
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

template <int H, int POL, bool REUSE>
__global__ void __launch_bounds__(Tile<H>::NT, Tile<H>::MINB)
train_grad_kernel(const float* __restrict__ params,   // [cap, NP]
                  const bf16* __restrict__ ws,        // [cap, 2, NS] staged
                  const float* __restrict__ od,       // [cap, NE, 6]
                  const float* __restrict__ zs,       // [cap, NR, S]
                  const float* __restrict__ ray,      // [cap, NE, 8]
                  const float* __restrict__ wmul,     // [cap, n_eff, 4]
                  const float* __restrict__ scale,    // [cap]
                  const int* __restrict__ active,     // [cap]
                  float* __restrict__ grad_part,      // [cap, n_rows, NG]
                  float* __restrict__ loss_part,      // [cap, n_rows]
                  float* __restrict__ act_part,  // [cap, n_rows, 3, H, LDP]
                  Offsets off, int n_params, int n_rays, int n_per,
                  int n_iter, int it, int S, int RT, int n_tiles, int LDP,
                  float cs, float osc, int n_eff, int nbuf) {
  const int row = blockIdx.x, slot = blockIdx.y, n_rows = gridDim.x;
  if (!active[slot]) return;
  extern __shared__ __align__(16) unsigned char smem[];
  // nbuf slab buffers (a ring of two, or one), then the tile's rows
  bf16* slab0 = reinterpret_cast<bf16*>(smem);
  constexpr size_t SB = slab_bytes<H, POL>();
  bf16* slab1 = reinterpret_cast<bf16*>(smem + (nbuf - 1) * SB);
  float* sm = reinterpret_cast<float*>(smem + nbuf * SB);
  constexpr int NS = staged_size(H);
  size_t rbase = (size_t)slot * n_rays + (size_t)it * n_per;
  const float* wm = wmul + ((size_t)slot * n_iter + it) * 4;
  if constexpr (REUSE) {
    // od, ray and wmul hold n_eff iterations of pixels per slot (NE =
    // n_eff * n_per): rows from pixel block it mod n_eff, and z advanced
    // so that the same rows read this iteration's own samples
    const int pit = it % n_eff;
    const size_t pbase = ((size_t)slot * n_eff + pit) * n_per;
    zs += (rbase - pbase) * S;
    wm = wmul + ((size_t)slot * n_eff + pit) * 4;
    rbase = pbase;
  }
  const size_t blk = (size_t)slot * n_rows + row;
  for (int tile = row; tile < n_tiles; tile += n_rows)
    float_tile<H, POL>(params + (size_t)slot * n_params,
                       ws + (size_t)slot * STAGED_PIECES * NS, NS, od, zs,
                       ray, wm, scale[slot],
                       grad_part + blk * grad_row(H),
                       loss_part + blk, act_part + blk * 3 * H * LDP, off,
                       rbase, tile * RT, n_per, S, RT, LDP, cs, osc,
                       tile != row, sm, slab0, slab1);
}

constexpr int ADAM_THREADS = 256;

// RW: a float policy's rows (grad_row; gidx[j] parameter j's place, as
// kernels/train_step.py grad_row_index gives it), and write the updated
// product weights' staged copy to ws ([cap, STAGED_PIECES,
// staged_size(hidden)] bf16), which the next iteration's train_grad reads
template <bool RW>
__global__ void __launch_bounds__(ADAM_THREADS)
adamw_kernel(float* __restrict__ p, bf16* __restrict__ ws,
             const int* __restrict__ gidx, float* __restrict__ m,
             float* __restrict__ v, const float* __restrict__ grad_part,
             const float* __restrict__ loss_part, float* __restrict__ losses,
             const int* __restrict__ active, const float* __restrict__ bc1,
             const float* __restrict__ bc2, int hidden, int n_params,
             int n_rows, int n_iter, int it, float lr, float decay) {
  const int slot = blockIdx.y;
  const int j = blockIdx.x * ADAM_THREADS + threadIdx.x;
  const bool act = active[slot] != 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    float acc = 0.f;
    if (act)
      for (int t = 0; t < n_rows; ++t)
        acc += loss_part[(size_t)slot * n_rows + t];
    losses[(size_t)slot * n_iter + it] = acc;
  }
  if (!act || j >= n_params) return;
  // a float policy's rows (RW) hold the weights staged (grad_row)
  const int ng = RW ? grad_row(hidden) : n_params;
  const int gj = RW ? gidx[j] : j;
  const float* gp = grad_part + (size_t)slot * n_rows * ng + gj;
  float g = 0.f;
  for (int t = 0; t < n_rows; ++t) g += gp[(size_t)t * ng];
  // betas as the f32 roundings of 0.9, 1 - 0.9, 0.999, 1 - 0.999 (the
  // constants the plain PyTorch and JAX updates multiply by)
  const float b1 = 0.9f, omb1 = (float)(1.0 - 0.9);
  const float b2 = 0.999f, omb2 = (float)(1.0 - 0.999);
  const size_t q = (size_t)slot * n_params + j;
  const float mn = b1 * m[q] + omb1 * g;
  const float vn = b2 * v[q] + omb2 * g * g;
  const float mhat = mn / bc1[(size_t)slot * n_iter + it];
  const float vhat = vn / bc2[(size_t)slot * n_iter + it];
  const float pn = p[q] * decay - lr * mhat / (sqrtf(vhat) + 1e-8f);
  p[q] = pn;
  if constexpr (RW) {
    const int NS = staged_size(hidden);
    if (gj < NS) {   // a product weight, at its staged index
      bf16* w = ws + (size_t)slot * STAGED_PIECES * NS + gj;
      float r = pn;
      for (int i = 0; i < STAGED_PIECES; ++i) {   // mma.cuh split
        w[(size_t)i * NS] = __float2bfloat16_rn(r);
        r -= __bfloat162float(w[(size_t)i * NS]);
      }
    }
  }
  m[q] = mn;
  v[q] = vn;
}

// The operands and geometry of one train_grad launch (vmap_train_grad).
struct GradArgs {
  const float* params;
  const bf16* ws;
  const float *od, *z, *ray, *wmul, *scale;
  const int* active;
  float *grad_part, *loss_part, *act_part;
  Offsets off;
  int cap, n_params, n_per, n_iter, n_eff, it, S, RT, n_tiles, n_rows;
  float cs, osc;
};

template <int H, int POL, bool REUSE>
int launch_grad(const GradArgs& a, cudaStream_t stream) {
  const int P = a.RT * a.S;
  if (P > Tile<H>::FP) return (int)cudaErrorInvalidValue;
  const int LDP = P | 1;   // odd row stride: conflict-free column reads
  // a ring of two slabs where it fits beside the tile, else one
  const int nbuf =
      float_smem_bytes<H, POL>(LDP, a.RT, 2) <= SMEM_MAX ? 2 : 1;
  const size_t smem = float_smem_bytes<H, POL>(LDP, a.RT, nbuf);
  cudaError_t err = cudaFuncSetAttribute(
      train_grad_kernel<H, POL, REUSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)   // all of L1 as shared memory: two h=32 blocks
    err = cudaFuncSetAttribute(train_grad_kernel<H, POL, REUSE>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.n_rows, a.cap);
  train_grad_kernel<H, POL, REUSE><<<grid, Tile<H>::NT, smem, stream>>>(
      a.params, a.ws, a.od, a.z, a.ray, a.wmul, a.scale, a.active,
      a.grad_part, a.loss_part, a.act_part, a.off, a.n_params,
      a.n_iter * a.n_per,
      a.n_per, a.n_iter, a.it, a.S, a.RT, a.n_tiles, LDP, a.cs, a.osc,
      a.n_eff, nbuf);
  return (int)cudaGetLastError();
}

template <int POL, bool REUSE>
int launch_width(int hidden, const GradArgs& a, cudaStream_t stream) {
  if (hidden == 32) return launch_grad<32, POL, REUSE>(a, stream);
  if (hidden == 128) return launch_grad<128, POL, REUSE>(a, stream);
  if (hidden == 256) return launch_grad<256, POL, REUSE>(a, stream);
  return (int)cudaErrorInvalidValue;
}

template <int POL>
int launch_policy(int hidden, const GradArgs& a, cudaStream_t stream) {
  return a.n_eff == a.n_iter ? launch_width<POL, false>(hidden, a, stream)
                             : launch_width<POL, true>(hidden, a, stream);
}

}  // namespace

extern "C" {

// The staged weights' elements per plane and the floats of a float-policy
// partial-gradient row at a kernel width (0 for any other):
// kernels/train_step.py holds its staged_layout and grad_row_size to them.
int vmap_staged_size(int hidden) {
  return hidden == 32 || hidden == 128 || hidden == 256 ? staged_size(hidden)
                                                        : 0;
}
int vmap_grad_row(int hidden) {
  return vmap_staged_size(hidden) ? grad_row(hidden) : 0;
}

// One iteration's forward + backward of one bank under a matmul policy
// (0 F32, 1 BWD_BF16, 2 BF16): n_tiles ray tiles of RT rays per slot,
// spread over n_rows blocks per slot (block `row` takes the tiles row,
// row + n_rows, ...), each writing one partial row grad_part[slot, row, :]
// of grad_row(hidden) floats (the weights in the staged layout, then the
// dirs and biases) and loss_part[slot, row]; act_part: each block's
// activation scratch, [cap, n_rows, 3, hidden, (RT S) | 1] floats. ws:
// the product weights' staged bf16 copy [cap, 3, staged_size(hidden)]
// (vmap_train_adamw). od / ray / wmul hold n_eff iterations of pixels
// (n_eff = n_iter / sample_reuse), z all n_iter. The offsets must put the
// dirs and biases first (rest_fits). Returns a cudaError_t code (0 on success); invalid arguments
// give cudaErrorInvalidValue.
int vmap_train_grad(int policy, int hidden, const float* params,
                    const void* ws, const float* od, const float* z,
                    const float* ray, const float* wmul, const float* scale,
                    const int* active, float* grad_part, float* loss_part,
                    float* act_part, const int* offsets,
                    int cap, int n_params, int n_per, int n_iter, int n_eff,
                    int it, int S, int RT, int n_tiles, int n_rows, float cs,
                    float osc, void* stream) {
  const Offsets off = offsets_from(offsets);
  if (!grad_args_ok(cap, n_per, n_iter, n_eff, it, S, RT, n_tiles, n_rows) ||
      ws == nullptr || act_part == nullptr || !rest_fits(off, hidden))
    return (int)cudaErrorInvalidValue;
  const GradArgs a = {params, static_cast<const bf16*>(ws), od, z, ray, wmul,
                      scale, active, grad_part, loss_part, act_part,
                      off, cap, n_params, n_per, n_iter,
                      n_eff, it, S, RT, n_tiles, n_rows, cs, osc};
  cudaStream_t st = (cudaStream_t)stream;
  if (policy == F32) return launch_policy<F32>(hidden, a, st);
  if (policy == BWD_BF16) return launch_policy<BWD_BF16>(hidden, a, st);
  if (policy == BF16) return launch_policy<BF16>(hidden, a, st);
  return (int)cudaErrorInvalidValue;
}

// Row-partial reduction + masked AdamW of one bank for iteration `it`;
// also writes losses[slot, it]. Unless ws is null (an int8 policy's rows,
// n_params floats): the rows are a float policy's (grad_row; gidx [n_params]
// each parameter's place in them), and the updated product weights' staged
// bf16 copy goes to ws [cap, 3, staged_size(hidden)] (the float policies'
// train_grad operand).
int vmap_train_adamw(float* p, void* ws, const int* gidx, float* m, float* v,
                     const float* grad_part, const float* loss_part,
                     float* losses, const int* active, const float* bc1,
                     const float* bc2, int hidden, int cap, int n_params,
                     int n_rows, int n_iter, int it, float lr, float decay,
                     void* stream) {
  if (cap < 1 || n_params < 1 || n_rows < 1 || it < 0 || it >= n_iter ||
      (ws != nullptr && (vmap_staged_size(hidden) == 0 || gidx == nullptr)))
    return (int)cudaErrorInvalidValue;
  dim3 grid((n_params + ADAM_THREADS - 1) / ADAM_THREADS, cap);
  cudaStream_t st = (cudaStream_t)stream;
  if (ws)
    adamw_kernel<true><<<grid, ADAM_THREADS, 0, st>>>(
        p, static_cast<bf16*>(ws), gidx, m, v, grad_part, loss_part, losses,
        active, bc1, bc2, hidden, n_params, n_rows, n_iter, it, lr, decay);
  else
    adamw_kernel<false><<<grid, ADAM_THREADS, 0, st>>>(
        p, nullptr, nullptr, m, v, grad_part, loss_part, losses, active, bc1,
        bc2, hidden, n_params, n_rows, n_iter, it, lr, decay);
  return (int)cudaGetLastError();
}

#ifdef K1_PROFILE
// the section clocks of the measuring build (k1_prof) into host[8], then
// zeroed
int vmap_k1_profile(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, k1_prof, sizeof(k1_prof));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(k1_prof, zero, sizeof(k1_prof));
}
#endif

const char* vmap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
