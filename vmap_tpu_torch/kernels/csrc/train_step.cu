// Hand-written CUDA train-frame kernels for the vMAP object / background
// banks and the iMAP scene field (sm_90a, plain C interface, loaded with
// ctypes).
//
// Replaces the TPU kernel vmap_tpu/kernels/train_step.py::_make_kernel
// (launched by fused_frame_prepared). The contract is the math on flat
// banks, not the TPU layout: no block-diagonal object packing, no row
// merges, no polynomial sin/cos or fast sigmoid.
//
// One optimisation iteration of one bank is two launches:
//   train_grad_kernel   grid (partial row, slot). A ray tile is RT whole
//       rays with all S samples of each (the termination cumprod runs along
//       the ray). A block takes the tiles row, row + n_rows, ... in order;
//       for each it builds the points, runs the PE and the 7-layer MLP
//       forward in FP32 FMA loops (no tensor cores, so the f32 policy stays
//       IEEE), renders depth / colour / opacity / detached variance, forms
//       the normaliser-weighted masked L1 losses, and runs the hand-derived
//       backward (the dirs gradient through cos(pi 2^k proj) pi 2^k
//       included). Activations live in shared memory and are overwritten in
//       place by their gradients on the way back. The block's first tile
//       writes its partial weight gradients to grad_part[slot, row, :] and
//       its loss to loss_part[slot, row]; later tiles add to them in tile
//       order: no atomics, deterministic. With n_rows == n_tiles (every
//       width's geometry while the scratch is small) each block takes one
//       tile; the iMAP field (h=256, 4800 rays x 14 samples, 2 rays per
//       tile) takes a grid of one block per SM instead, so its scratch is
//       132 rows and not 2400 (see kernels/train_step.py frame_geometry).
//   adamw_kernel        grid (param chunk, slot). Sums a parameter's row
//       partials in a fixed order (deterministic), then applies masked
//       AdamW (torch semantics: p *= 1 - lr wd first, betas 0.9 / 0.999,
//       eps 1e-8, per-slot bias corrections 1 - b^t precomputed on the
//       host). Inactive slots are not touched, so they stay bit-identical.
//
// What bounds it on the card: FP32 FMA work and the loads that feed it. A
// 20-iteration frame of the Replica vMAP configuration (100 objects at
// h=32, 120 rays x 10 samples; background h=128, 1200 rays x 14 samples)
// is about 350 GFLOP of forward and backward MLP work, the iMAP frame
// (h=256, 4800 rays x 14 samples) about 2.6 TFLOP, against 67 TFLOP/s of
// FP32 FMA on an H100 SXM. This first design keeps every matrix operand in
// shared memory with the point index fastest (conflict-free reads, weights
// broadcast from L1/L2: the h=128 background is 377 KB, the h=256 field
// 1.28 MB, both L2-resident), gives each thread four output rows in the
// forward products, and spreads the work over (partial row, slot) blocks.
// At h=256 one point's activations take 5.8 KB, so a tile is 2 rays (28
// points, 169 KB) and one block fits an SM: that instance runs 512
// threads to keep 16 warps in flight. It is shared-memory and load-issue
// bound rather than FMA bound; register tiling of the products is the
// next step.
//
// sin / cos use sinpif / cospif (exact-argument sin(pi x)); the build does
// not pass --use_fast_math: the band-5 argument reaches 32 pi |proj|.
//
// Matmul policies (the JAX kernel's _mm_policy, a template parameter POL
// of train_grad_kernel): F32; BWD_BF16 rounds every operand of the
// backward products (upstream gradients, saved activations, weights, and
// dproj / xs of the dirs gradient) to bf16 with __float2bfloat16_rn; BF16
// rounds the forward products' operands (weights, embedding) and stores
// the ReLU activations rounded too. Accumulation stays f32, and a product
// of two bf16 values is exact in f32, so the same FMA loops compute what
// the TPU kernel's bf16 dots compute, up to summation order. Each operand
// is rounded once where it is made, not in the loops: the weights by
// adamw_kernel, which keeps a rounded copy wr of the parameters; the
// embedding and activations in place once the f32 forward no longer
// reads them; each upstream gradient in place once its f32 bias gradient
// is taken. Biases, their gradients, the dirs projection, PE, render,
// losses and AdamW stay f32. None of this is compiled into the F32 tile
// (grad_tile, which reads W alone) or kernels, so the f32 instances keep
// their registers.
//
// sample_reuse: od, ray and wmul hold n_eff = n_iter / reuse iterations
// of pixels; iteration it reads pixel block it mod n_eff and its own z
// (a REUSE instance of train_grad_kernel; n_eff == n_iter runs the
// plain one).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int MAX_S = 32;
constexpr int MAX_RT = 64;

// matmul operand policies: the index in vmap_tpu_torch/ops/mlp.py POLICIES
enum Policy : int { F32 = 0, BWD_BF16 = 1, BF16 = 2 };

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

// out[i][p] = act(b[i] + sum_k w[i][k] ina[k][p] + sum_k w[i][na+k] inb[k][p])
// for i < n_out (n_out % TI == 0), p < P. w is row-major [n_out, ldw].
// R: a ReLU output is stored rounded to bf16.
template <int TI, int NT, bool R>
__device__ void dense(const float* __restrict__ w, const float* __restrict__ b,
                      int n_out, int ldw, const float* ina, int na,
                      const float* inb, int nb, float* out, int P, int LDP,
                      bool relu) {
  const int n_items = (n_out / TI) * P;
  for (int idx = threadIdx.x; idx < n_items; idx += NT) {
    const int i0 = (idx / P) * TI, p = idx % P;
    const float* wr = w + (size_t)i0 * ldw;
    float acc[TI];
#pragma unroll
    for (int t = 0; t < TI; ++t) acc[t] = b[i0 + t];
    for (int k = 0; k < na; ++k) {
      const float x = ina[k * LDP + p];
#pragma unroll
      for (int t = 0; t < TI; ++t) acc[t] = fmaf(wr[t * ldw + k], x, acc[t]);
    }
    for (int k = 0; k < nb; ++k) {
      const float x = inb[k * LDP + p];
#pragma unroll
      for (int t = 0; t < TI; ++t)
        acc[t] = fmaf(wr[t * ldw + na + k], x, acc[t]);
    }
#pragma unroll
    for (int t = 0; t < TI; ++t)
      out[(i0 + t) * LDP + p] = relu ? rnd<R>(fmaxf(acc[t], 0.f)) : acc[t];
  }
}

// G[i * ldw + col0 + k] (+)= sum_p dout[i][p] * in[k][p]  (i < n_out,
// k < n_in); add: accumulate onto the row (a block's later tiles)
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

// sum_i w[i][col] * dout[i][p]   (one element of W^T dout)
__device__ __forceinline__ float dot_col(const float* __restrict__ w, int ldw,
                                         int col, const float* dout, int n_out,
                                         int p, int LDP) {
  float acc = 0.f;
  for (int i = 0; i < n_out; ++i)
    acc = fmaf(w[(size_t)i * ldw + col], dout[i * LDP + p], acc);
  return acc;
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

// One ray tile (rays ray0 .. ray0 + RT of this iteration, past n_per
// padded) of one slot: points, forward, render, losses, backward. Ray r of
// the tile reads od, ray and zs at row rbase + ray0 + r. The weight
// gradients go to the block's row G and the tile's loss to *loss; with
// add, both are added onto what the block's earlier tiles left there.
// Ends with the block synchronised, so the next tile may reuse sm. W holds
// the f32 parameters; Wr their bf16 rounding, read for the weights of the
// products the policy rounds (Wr == W under F32).
template <int H, int NT, int POL>
__device__ __forceinline__ void tile_body(const float* __restrict__ W,
                          const float* __restrict__ Wr,
                          const float* __restrict__ od,
                          const float* __restrict__ zs,
                          const float* __restrict__ ray,
                          const float* __restrict__ wm, float sc,
                          float* __restrict__ G, float* __restrict__ loss,
                          Offsets off, size_t rbase, int ray0,
                          int n_per, int S, int RT, int LDP, float cs,
                          float osc, bool add, float* sm) {
  constexpr bool RF = POL == BF16;   // forward operands rounded
  constexpr bool RB = POL != F32;    // backward operands rounded
  const float* Wf = RF ? Wr : W;     // forward product weights
  const float* Wb = RB ? Wr : W;     // backward product weights
  const int P = RT * S;
  float* emb = sm;                      // [EMB][LDP]: xs rows 0..2, bands
  float* proj = emb + EMB * LDP;        // [NDIR][LDP]
  float* dproj = proj + NDIR * LDP;     // [NDIR][LDP]
  float* h1 = dproj + NDIR * LDP;       // [H][LDP] each, then their grads
  float* h2 = h1 + H * LDP;
  float* h3 = h2 + H * LDP;
  float* h4 = h3 + H * LDP;
  float* hc = h4 + H * LDP;
  float* alp = hc + H * LDP;            // [1][LDP] raw alpha-layer output
  float* col = alp + LDP;               // [3][LDP] raw colour-layer output
  float* dal = col + 3 * LDP;           // [1][LDP] dL / d alpha-layer output
  float* dy = dal + LDP;                // [3][LDP] dL / d colour-layer output
  float* rl = dy + 3 * LDP;             // [RT] per-ray loss

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
    const float pr = emb[p] * d[0] + emb[LDP + p] * d[1] + emb[2 * LDP + p] * d[2];
    proj[j * LDP + p] = pr;
#pragma unroll
    for (int b = 0; b < NBAND; ++b)
      emb[(3 + b * NDIR + j) * LDP + p] = sinpif(pr * (float)(1 << b));
  }
  __syncthreads();
  if constexpr (RF) {   // the projection has read xs: emb is a product operand
    round_rows<NT>(emb, EMB, P, LDP);
    __syncthreads();
  }

  // 2. MLP forward
  dense<4, NT, RF>(Wf + off.w_in, W + off.b_in, H, EMB1, emb, EMB1, nullptr,
                   0, h1, P, LDP, true);
  __syncthreads();
  dense<4, NT, RF>(Wf + off.w_mid1, W + off.b_mid1, H, H, h1, H, nullptr, 0,
                   h2, P, LDP, true);
  __syncthreads();
  dense<4, NT, RF>(Wf + off.w_cat, W + off.b_cat, H, H + EMB1, h2, H, emb,
                   EMB1, h3, P, LDP, true);
  __syncthreads();
  dense<4, NT, RF>(Wf + off.w_mid2, W + off.b_mid2, H, H, h3, H, nullptr, 0,
                   h4, P, LDP, true);
  __syncthreads();
  dense<1, NT, RF>(Wf + off.w_alpha, W + off.b_alpha, 1, H, h4, H, nullptr,
                   0, alp, P, LDP, false);
  dense<4, NT, RF>(Wf + off.w_col, W + off.b_col, H, H + EMB2, h4, H,
                   emb + EMB1 * LDP, EMB2, hc, P, LDP, true);
  __syncthreads();
  dense<1, NT, RF>(Wf + off.w_col_out, W + off.b_col_out, 3, H, hc, H,
                   nullptr, 0, col, P, LDP, false);
  __syncthreads();
  if constexpr (POL == BWD_BF16) {
    // the f32 forward is done: from here on the saved activations are
    // read by the backward products (and, sign unchanged, the ReLU masks)
    round_rows<NT>(emb, EMB, P, LDP);
    round_rows<NT>(h1, 5 * H, P, LDP);
  }

  // 3. per ray: render, losses, render backward -> dal, dy
  if (threadIdx.x < RT) {
    const int r = threadIdx.x;
    const int p0 = r * S;
    if (ray0 + r >= n_per) {
      for (int s = 0; s < S; ++s) {
        dal[p0 + s] = 0.f;
        dy[p0 + s] = dy[LDP + p0 + s] = dy[2 * LDP + p0 + s] = 0.f;
      }
      rl[r] = 0.f;
    } else {
      const size_t gr = rbase + ray0 + r;
      const float* rp = ray + gr * 8;   // depth, r, g, b, m_obj, m_sem, m_do
      const float* z = zs + gr * S;
      float occ[MAX_S], T[MAX_S], term[MAX_S], c[3][MAX_S];
      float Tc = 1.f, dep = 0.f, op = 0.f, rc[3] = {0.f, 0.f, 0.f};
      for (int s = 0; s < S; ++s) {
        const int p = p0 + s;
        const float o = sigmoidf_(alp[p] * 10.f);
        occ[s] = o;
        T[s] = Tc;
        term[s] = o * Tc;
        for (int k = 0; k < 3; ++k) {
          c[k][s] = sigmoidf_(col[k * LDP + p]);
          rc[k] += term[s] * c[k][s];
        }
        dep += term[s] * z[s];
        op += term[s];
        Tc *= (1.f - o) + 1e-10f;
      }
      float var = 0.f;
      for (int s = 0; s < S; ++s) {
        const float dz = z[s] - dep;
        var += term[s] * (dz * dz);
      }
      const float info = 1.f / (sqrtf(var) + 1e-4f);
      const float m_obj = rp[4], m_sem = rp[5], m_do = rp[6];
      const float wd = wm[0], wc = wm[1], wo = wm[2];
      const float ld = fabsf(dep - rp[0]) * m_do;
      float lc = 0.f;
      for (int k = 0; k < 3; ++k) lc += fabsf(rc[k] - rp[1 + k]);
      lc *= m_obj;
      const float lo = fabsf(op - m_obj) * m_sem;
      rl[r] = wd * (ld * info) + cs * (wc * lc) + osc * (wo * lo);

      const float g_d = wd * m_do * info * sgnf(dep - rp[0]);
      float g_c[3];
      for (int k = 0; k < 3; ++k)
        g_c[k] = cs * wc * m_obj * sgnf(rc[k] - rp[1 + k]);
      const float g_o = osc * wo * m_sem * sgnf(op - m_obj);
      // term_i = occ_i T_i with T_i = prod_{j<i} (1 - occ_j + 1e-10):
      // docc_k = T_k (dterm_k - R_k), R_k = sum_{i>k} dterm_i occ_i
      // prod_{k<j<i} free_j, run backwards without dividing by free.
      float R = 0.f;
      for (int s = S - 1; s >= 0; --s) {
        const int p = p0 + s;
        const float dterm = g_d * z[s] + g_c[0] * c[0][s] + g_c[1] * c[1][s]
                            + g_c[2] * c[2][s] + g_o;
        const float docc = T[s] * (dterm - R);
        R = dterm * occ[s] + ((1.f - occ[s]) + 1e-10f) * R;
        dal[p] = 10.f * (docc * occ[s] * (1.f - occ[s]));
        for (int k = 0; k < 3; ++k)
          dy[k * LDP + p] = g_c[k] * term[s] * c[k][s] * (1.f - c[k][s]);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int r = 0; r < RT; ++r) acc += rl[r];
    *loss = add ? *loss + acc : acc;
  }

  // 4. MLP backward; each activation buffer becomes its pre-activation
  //    gradient once its own weight gradient has been taken. Under a bf16
  //    backward policy each gradient's bias gradient comes first, from its
  //    f32 values (bgrad_round), and the products then read it rounded.
  if constexpr (RB) {
    bgrad_round<NT>(G + off.b_col_out, dy, 3, P, LDP, add);
    bgrad_round<NT>(G + off.b_alpha, dal, 1, P, LDP, add);
  }
  wgrad<NT>(G + off.w_col_out, H, 0, dy, 3, hc, H, P, LDP, add);
  if constexpr (!RB) bgrad<NT>(G + off.b_col_out, dy, 3, P, LDP, add);
  wgrad<NT>(G + off.w_alpha, H, 0, dal, 1, h4, H, P, LDP, add);
  if constexpr (!RB) bgrad<NT>(G + off.b_alpha, dal, 1, P, LDP, add);
  __syncthreads();
  for (int idx = threadIdx.x; idx < H * P; idx += NT) {
    const int k = idx / P, p = idx % P;
    const float g = dot_col(Wb + off.w_col_out, H, k, dy, 3, p, LDP);
    hc[k * LDP + p] = hc[k * LDP + p] > 0.f ? g : 0.f;
  }
  __syncthreads();
  if constexpr (RB) bgrad_round<NT>(G + off.b_col, hc, H, P, LDP, add);
  wgrad<NT>(G + off.w_col, H + EMB2, 0, hc, H, h4, H, P, LDP, add);
  wgrad<NT>(G + off.w_col, H + EMB2, H, hc, H, emb + EMB1 * LDP, EMB2, P,
            LDP, add);
  if constexpr (!RB) bgrad<NT>(G + off.b_col, hc, H, P, LDP, add);
  __syncthreads();
  for (int idx = threadIdx.x; idx < (H + NDIR) * P; idx += NT) {
    const int k = idx / P, p = idx % P;
    if (k < H) {
      const float g = dot_col(Wb + off.w_col, H + EMB2, k, hc, H, p, LDP)
                      + Wb[off.w_alpha + k] * dal[p];
      h4[k * LDP + p] = h4[k * LDP + p] > 0.f ? g : 0.f;
    } else {
      const int j = k - H;
      float acc = 0.f;
      for (int b = 4; b < NBAND; ++b) {
        const int e = (b - 4) * NDIR + j;   // column within emb2
        const float g = dot_col(Wb + off.w_col, H + EMB2, H + e, hc, H, p, LDP);
        acc += band_grad(g, proj[j * LDP + p], b);
      }
      dproj[j * LDP + p] = acc;
    }
  }
  __syncthreads();
  if constexpr (RB) bgrad_round<NT>(G + off.b_mid2, h4, H, P, LDP, add);
  wgrad<NT>(G + off.w_mid2, H, 0, h4, H, h3, H, P, LDP, add);
  if constexpr (!RB) bgrad<NT>(G + off.b_mid2, h4, H, P, LDP, add);
  __syncthreads();
  for (int idx = threadIdx.x; idx < H * P; idx += NT) {
    const int k = idx / P, p = idx % P;
    const float g = dot_col(Wb + off.w_mid2, H, k, h4, H, p, LDP);
    h3[k * LDP + p] = h3[k * LDP + p] > 0.f ? g : 0.f;
  }
  __syncthreads();
  if constexpr (RB) bgrad_round<NT>(G + off.b_cat, h3, H, P, LDP, add);
  wgrad<NT>(G + off.w_cat, H + EMB1, 0, h3, H, h2, H, P, LDP, add);
  wgrad<NT>(G + off.w_cat, H + EMB1, H, h3, H, emb, EMB1, P, LDP, add);
  if constexpr (!RB) bgrad<NT>(G + off.b_cat, h3, H, P, LDP, add);
  __syncthreads();
  for (int idx = threadIdx.x; idx < (H + NDIR) * P; idx += NT) {
    const int k = idx / P, p = idx % P;
    if (k < H) {
      const float g = dot_col(Wb + off.w_cat, H + EMB1, k, h3, H, p, LDP);
      h2[k * LDP + p] = h2[k * LDP + p] > 0.f ? g : 0.f;
    } else {
      const int j = k - H;
      float acc = dproj[j * LDP + p];
      for (int b = 0; b < 4; ++b) {
        const int e = 3 + b * NDIR + j;     // column within emb1
        const float g = dot_col(Wb + off.w_cat, H + EMB1, H + e, h3, H, p, LDP);
        acc += band_grad(g, proj[j * LDP + p], b);
      }
      dproj[j * LDP + p] = acc;
    }
  }
  __syncthreads();
  if constexpr (RB) bgrad_round<NT>(G + off.b_mid1, h2, H, P, LDP, add);
  wgrad<NT>(G + off.w_mid1, H, 0, h2, H, h1, H, P, LDP, add);
  if constexpr (!RB) bgrad<NT>(G + off.b_mid1, h2, H, P, LDP, add);
  __syncthreads();
  for (int idx = threadIdx.x; idx < H * P; idx += NT) {
    const int k = idx / P, p = idx % P;
    const float g = dot_col(Wb + off.w_mid1, H, k, h2, H, p, LDP);
    h1[k * LDP + p] = h1[k * LDP + p] > 0.f ? g : 0.f;
  }
  __syncthreads();
  if constexpr (RB) bgrad_round<NT>(G + off.b_in, h1, H, P, LDP, add);
  wgrad<NT>(G + off.w_in, EMB1, 0, h1, H, emb, EMB1, P, LDP, add);
  if constexpr (!RB) bgrad<NT>(G + off.b_in, h1, H, P, LDP, add);
  for (int idx = threadIdx.x; idx < NDIR * P; idx += NT) {
    const int j = idx / P, p = idx % P;
    float acc = dproj[j * LDP + p];
    for (int b = 0; b < 4; ++b) {
      const int e = 3 + b * NDIR + j;
      const float g = dot_col(Wb + off.w_in, EMB1, e, h1, H, p, LDP);
      acc += band_grad(g, proj[j * LDP + p], b);
    }
    dproj[j * LDP + p] = acc;
  }
  __syncthreads();
  if constexpr (RB) {
    round_rows<NT>(dproj, NDIR, P, LDP);
    __syncthreads();
  }
  // d dirs[j][k] = sum_p dproj[j][p] xs[k][p]
  wgrad<NT>(G + off.dirs, 3, 0, dproj, NDIR, emb, 3, P, LDP, add);
  __syncthreads();
}

// The tile as a function of its own. Not inlined: inlined into the
// kernel's tile loop, its loop-invariant addresses were hoisted and took
// 255 registers at h=32 / h=128 (63 / 48 in one tile per block), which
// cost h=32 its second block per SM. grad_tile is the f32 tile,
// grad_tile_bf16 the tile under a bf16 policy (it also reads Wr).
template <int H, int NT>
__device__ __noinline__ void grad_tile(const float* __restrict__ W,
                          const float* __restrict__ od,
                          const float* __restrict__ zs,
                          const float* __restrict__ ray,
                          const float* __restrict__ wm, float sc,
                          float* __restrict__ G, float* __restrict__ loss,
                          Offsets off, size_t rbase, int ray0,
                          int n_per, int S, int RT, int LDP, float cs,
                          float osc, bool add, float* sm) {
  tile_body<H, NT, F32>(W, W, od, zs, ray, wm, sc, G, loss, off, rbase, ray0,
                        n_per, S, RT, LDP, cs, osc, add, sm);
}

template <int H, int NT, int POL>
__device__ __noinline__ void grad_tile_bf16(const float* __restrict__ W,
                          const float* __restrict__ Wr,
                          const float* __restrict__ od,
                          const float* __restrict__ zs,
                          const float* __restrict__ ray,
                          const float* __restrict__ wm, float sc,
                          float* __restrict__ G, float* __restrict__ loss,
                          Offsets off, size_t rbase, int ray0,
                          int n_per, int S, int RT, int LDP, float cs,
                          float osc, bool add, float* sm) {
  tile_body<H, NT, POL>(W, Wr, od, zs, ray, wm, sc, G, loss, off, rbase,
                        ray0, n_per, S, RT, LDP, cs, osc, add, sm);
}

template <int H, int NT, int POL, bool REUSE>
__global__ void __launch_bounds__(NT)
train_grad_kernel(const float* __restrict__ params,   // [cap, NP]
                  const float* __restrict__ wr,       // [cap, NP] bf16-rounded
                  const float* __restrict__ od,       // [cap, NE, 6]
                  const float* __restrict__ zs,       // [cap, NR, S]
                  const float* __restrict__ ray,      // [cap, NE, 8]
                  const float* __restrict__ wmul,     // [cap, n_eff, 4]
                  const float* __restrict__ scale,    // [cap]
                  const int* __restrict__ active,     // [cap]
                  float* __restrict__ grad_part,      // [cap, n_rows, NP]
                  float* __restrict__ loss_part,      // [cap, n_rows]
                  Offsets off, int n_params, int n_rays, int n_per,
                  int n_iter, int it, int S, int RT, int n_tiles, int LDP,
                  float cs, float osc, int n_eff) {
  const int row = blockIdx.x, slot = blockIdx.y, n_rows = gridDim.x;
  if (!active[slot]) return;
  extern __shared__ float sm[];
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
  for (int tile = row; tile < n_tiles; tile += n_rows) {
    float* G = grad_part + ((size_t)slot * n_rows + row) * n_params;
    float* loss = loss_part + (size_t)slot * n_rows + row;
    if constexpr (POL == F32)
      grad_tile<H, NT>(params + (size_t)slot * n_params, od, zs, ray, wm,
                       scale[slot], G, loss, off, rbase, tile * RT, n_per, S,
                       RT, LDP, cs, osc, tile != row, sm);
    else
      grad_tile_bf16<H, NT, POL>(params + (size_t)slot * n_params,
                                 wr + (size_t)slot * n_params, od, zs, ray,
                                 wm, scale[slot], G, loss, off, rbase,
                                 tile * RT, n_per, S, RT, LDP, cs, osc,
                                 tile != row, sm);
  }
}

constexpr int ADAM_THREADS = 256;

// RW: also write the updated parameters rounded to bf16 to pr, the copy
// the next iteration's train_grad reads under a bf16 policy
template <bool RW>
__global__ void __launch_bounds__(ADAM_THREADS)
adamw_kernel(float* __restrict__ p, float* __restrict__ pr,
             float* __restrict__ m,
             float* __restrict__ v, const float* __restrict__ grad_part,
             const float* __restrict__ loss_part, float* __restrict__ losses,
             const int* __restrict__ active, const float* __restrict__ bc1,
             const float* __restrict__ bc2, int n_params, int n_rows,
             int n_iter, int it, float lr, float decay) {
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
  const float* gp = grad_part + (size_t)slot * n_rows * n_params + j;
  float g = 0.f;
  for (int t = 0; t < n_rows; ++t) g += gp[(size_t)t * n_params];
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
  if constexpr (RW) pr[q] = rnd<true>(pn);
  m[q] = mn;
  v[q] = vn;
}

size_t grad_smem_bytes(int H, int LDP, int RT) {
  return sizeof(float) *
         ((size_t)LDP * (EMB + 2 * NDIR + 5 * H + 8) + (size_t)RT);
}

// The operands and geometry of one train_grad launch (vmap_train_grad).
struct GradArgs {
  const float *params, *wr, *od, *z, *ray, *wmul, *scale;
  const int* active;
  float *grad_part, *loss_part;
  Offsets off;
  int cap, n_params, n_per, n_iter, n_eff, it, S, RT, n_tiles, n_rows;
  float cs, osc;
};

// NT: threads per block. h=32 / h=128 run 256; the h=256 block fills an
// SM's shared memory alone, so it runs 512 to keep 16 warps in flight.
template <int H, int NT, int POL, bool REUSE>
int launch_grad(const GradArgs& a, cudaStream_t stream) {
  if (a.RT > NT) return (int)cudaErrorInvalidValue;
  const int P = a.RT * a.S;
  const int LDP = P | 1;   // odd row stride: conflict-free column reads
  const size_t smem = grad_smem_bytes(H, LDP, a.RT);
  cudaError_t err = cudaFuncSetAttribute(
      train_grad_kernel<H, NT, POL, REUSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.n_rows, a.cap);
  train_grad_kernel<H, NT, POL, REUSE><<<grid, NT, smem, stream>>>(
      a.params, a.wr, a.od, a.z, a.ray, a.wmul, a.scale, a.active,
      a.grad_part, a.loss_part, a.off, a.n_params, a.n_iter * a.n_per,
      a.n_per, a.n_iter, a.it, a.S, a.RT, a.n_tiles, LDP, a.cs, a.osc,
      a.n_eff);
  return (int)cudaGetLastError();
}

template <int POL, bool REUSE>
int launch_width(int hidden, const GradArgs& a, cudaStream_t stream) {
  if (hidden == 32) return launch_grad<32, 256, POL, REUSE>(a, stream);
  if (hidden == 128) return launch_grad<128, 256, POL, REUSE>(a, stream);
  if (hidden == 256) return launch_grad<256, 512, POL, REUSE>(a, stream);
  return (int)cudaErrorInvalidValue;
}

template <int POL>
int launch_policy(int hidden, const GradArgs& a, cudaStream_t stream) {
  if (POL != F32 && a.wr == nullptr) return (int)cudaErrorInvalidValue;
  return a.n_eff == a.n_iter ? launch_width<POL, false>(hidden, a, stream)
                             : launch_width<POL, true>(hidden, a, stream);
}

}  // namespace

extern "C" {

// One iteration's forward + backward of one bank under a matmul policy
// (0 F32, 1 BWD_BF16, 2 BF16): n_tiles ray tiles of RT rays per slot,
// spread over n_rows blocks per slot (block `row` takes the tiles row,
// row + n_rows, ...), each writing one partial row grad_part[slot, row, :]
// and loss_part[slot, row]. wr: params rounded to bf16 (the bf16 policies;
// null under F32). od / ray / wmul hold n_eff iterations of pixels (n_eff
// = n_iter / sample_reuse), z all n_iter. Returns a cudaError_t code (0
// on success); invalid arguments give cudaErrorInvalidValue.
int vmap_train_grad(int policy, int hidden, const float* params,
                    const float* wr, const float* od, const float* z,
                    const float* ray, const float* wmul, const float* scale,
                    const int* active, float* grad_part, float* loss_part,
                    const int* offsets,
                    int cap, int n_params, int n_per, int n_iter, int n_eff,
                    int it, int S, int RT, int n_tiles, int n_rows, float cs,
                    float osc, void* stream) {
  if (S < 1 || S > MAX_S || RT < 1 || RT > MAX_RT ||
      n_tiles * RT < n_per || n_rows < 1 || n_rows > n_tiles || it < 0 ||
      it >= n_iter || n_eff < 1 || n_iter % n_eff != 0 || cap < 1)
    return (int)cudaErrorInvalidValue;
  const Offsets off = {offsets[0],  offsets[1],  offsets[2],  offsets[3],
                       offsets[4],  offsets[5],  offsets[6],  offsets[7],
                       offsets[8],  offsets[9],  offsets[10], offsets[11],
                       offsets[12], offsets[13], offsets[14]};
  const GradArgs a = {params, wr, od, z, ray, wmul, scale, active,
                      grad_part, loss_part, off, cap, n_params, n_per,
                      n_iter, n_eff, it, S, RT, n_tiles, n_rows, cs, osc};
  cudaStream_t st = (cudaStream_t)stream;
  if (policy == F32) return launch_policy<F32>(hidden, a, st);
  if (policy == BWD_BF16) return launch_policy<BWD_BF16>(hidden, a, st);
  if (policy == BF16) return launch_policy<BF16>(hidden, a, st);
  return (int)cudaErrorInvalidValue;
}

// Row-partial reduction + masked AdamW of one bank for iteration `it`;
// also writes losses[slot, it], and, unless pr is null, the updated
// parameters rounded to bf16 to pr.
int vmap_train_adamw(float* p, float* pr, float* m, float* v,
                     const float* grad_part,
                     const float* loss_part, float* losses, const int* active,
                     const float* bc1, const float* bc2, int cap,
                     int n_params, int n_rows, int n_iter, int it, float lr,
                     float decay, void* stream) {
  if (cap < 1 || n_params < 1 || n_rows < 1 || it < 0 || it >= n_iter)
    return (int)cudaErrorInvalidValue;
  dim3 grid((n_params + ADAM_THREADS - 1) / ADAM_THREADS, cap);
  cudaStream_t st = (cudaStream_t)stream;
  if (pr)
    adamw_kernel<true><<<grid, ADAM_THREADS, 0, st>>>(
        p, pr, m, v, grad_part, loss_part, losses, active, bc1, bc2,
        n_params, n_rows, n_iter, it, lr, decay);
  else
    adamw_kernel<false><<<grid, ADAM_THREADS, 0, st>>>(
        p, pr, m, v, grad_part, loss_part, losses, active, bc1, bc2,
        n_params, n_rows, n_iter, it, lr, decay);
  return (int)cudaGetLastError();
}

const char* vmap_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
