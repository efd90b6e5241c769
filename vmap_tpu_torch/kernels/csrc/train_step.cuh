// The train-frame helpers shared by train_step.cu (the float policies'
// tensor-core tile) and train_step_q8.cu (the int8 policies): the
// operand helpers, and the int8 tile: its shared-memory buffers and
// tile_body, one ray tile of one slot on FP32 FMA loops. See
// train_step.cu and train_step_q8.cu for the designs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

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

// The shared-memory buffers of one tile, each [rows][LDP] (point index
// fastest) but rl [RT] and red [32]. grad_smem_bytes counts them up to rl;
// xs (the f32 xs rows) and red (a block reduction's scratch) are the int8
// tile's own.
template <int H>
struct TileBufs {
  float *emb, *proj, *dproj, *h1, *h2, *h3, *h4, *hc, *alp, *col, *dal, *dy,
      *rl, *xs, *red;
  __device__ __forceinline__ TileBufs(float* sm, int LDP, int RT)
      : emb(sm),                       // [EMB]: xs rows 0..2, bands
        proj(emb + EMB * LDP),         // [NDIR]
        dproj(proj + NDIR * LDP),      // [NDIR]
        h1(dproj + NDIR * LDP),        // [H] each, then their gradients
        h2(h1 + H * LDP), h3(h2 + H * LDP), h4(h3 + H * LDP),
        hc(h4 + H * LDP),
        alp(hc + H * LDP),             // [1] raw alpha-layer output
        col(alp + LDP),                // [3] raw colour-layer output
        dal(col + 3 * LDP),            // [1] dL / d alpha-layer output
        dy(dal + LDP),                 // [3] dL / d colour-layer output
        rl(dy + 3 * LDP),              // [RT] per-ray loss
        xs(rl + RT), red(xs + 3 * LDP) {}
};

// The int8 sections of tile_body, defined in train_step_q8.cu (the only
// file that instantiates an int8 tile). Q8Act: one tile's activation
// scales (h1..h4 and the colour head's hidden layer).
struct Q8Act {
  float s1, s2, s3, s4, sc;
};
template <int H, int NT>
__device__ __forceinline__ void quant_emb_q8(const TileBufs<H>& b, int P,
                                             int LDP);
template <int H, int NT, bool QR>
__device__ __forceinline__ Q8Act forward_q8(
    const float* __restrict__ W, const float* __restrict__ Wq,
    const float* __restrict__ wsc, const float* __restrict__ qs, Offsets off,
    const TileBufs<H>& b, int P, int LDP);
template <int H, int NT>
__device__ __forceinline__ void backward_q8(
    const float* __restrict__ Wq, const float* __restrict__ wsc,
    const float* __restrict__ qs, const Q8Act& a, float* __restrict__ G,
    Offsets off, const TileBufs<H>& b, int P, int LDP, bool add);

// One ray tile (rays ray0 .. ray0 + RT of this iteration, past n_per
// padded) of one slot under an int8 policy: points, forward, render,
// losses, backward. Ray r of the tile reads od, ray and zs at row rbase +
// ray0 + r. The weight gradients go to the block's row G and the tile's
// loss to *loss; with add, both are added onto what the block's earlier
// tiles left there. Ends with the block synchronised, so the next tile may
// reuse sm. W holds the f32 parameters; Wr the quantised weights, with wsc
// their scales and qs the static scales (null: dynamic;
// train_step_q8.cu). Under INT8_FWD the backward is FP32 on W.
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
                          float osc, bool add, float* sm,
                          const float* __restrict__ wsc = nullptr,
                          const float* __restrict__ qs = nullptr) {
  static_assert(POL == INT8 || POL == INT8_FWD, "the int8 tile");
  const int P = RT * S;
  const TileBufs<H> bufs(sm, LDP, RT);
  float *emb = bufs.emb, *proj = bufs.proj, *dproj = bufs.dproj;
  float *h1 = bufs.h1, *h2 = bufs.h2, *h3 = bufs.h3, *h4 = bufs.h4;
  float *hc = bufs.hc, *alp = bufs.alp, *col = bufs.col, *dal = bufs.dal;
  float *dy = bufs.dy, *rl = bufs.rl;

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
  if constexpr (POL == INT8) {   // emb quantised in place, xs kept in f32
    quant_emb_q8<H, NT>(bufs, P, LDP);
    __syncthreads();
  }

  // 2. MLP forward
  const Q8Act qa = forward_q8<H, NT, POL == INT8_FWD>(W, Wr, wsc, qs, off,
                                                      bufs, P, LDP);
  __syncthreads();

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

  if constexpr (POL == INT8) {
    backward_q8<H, NT>(Wr, wsc, qs, qa, G, off, bufs, P, LDP, add);
    return;
  }

  // 4. MLP backward (INT8_FWD: f32); each activation buffer becomes its
  //    pre-activation gradient once its own weight gradient has been taken.
  const float* Wb = W;
  wgrad<NT>(G + off.w_col_out, H, 0, dy, 3, hc, H, P, LDP, add);
  bgrad<NT>(G + off.b_col_out, dy, 3, P, LDP, add);
  wgrad<NT>(G + off.w_alpha, H, 0, dal, 1, h4, H, P, LDP, add);
  bgrad<NT>(G + off.b_alpha, dal, 1, P, LDP, add);
  __syncthreads();
  for (int idx = threadIdx.x; idx < H * P; idx += NT) {
    const int k = idx / P, p = idx % P;
    const float g = dot_col(Wb + off.w_col_out, H, k, dy, 3, p, LDP);
    hc[k * LDP + p] = hc[k * LDP + p] > 0.f ? g : 0.f;
  }
  __syncthreads();
  wgrad<NT>(G + off.w_col, H + EMB2, 0, hc, H, h4, H, P, LDP, add);
  wgrad<NT>(G + off.w_col, H + EMB2, H, hc, H, emb + EMB1 * LDP, EMB2, P,
            LDP, add);
  bgrad<NT>(G + off.b_col, hc, H, P, LDP, add);
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
  wgrad<NT>(G + off.w_mid2, H, 0, h4, H, h3, H, P, LDP, add);
  bgrad<NT>(G + off.b_mid2, h4, H, P, LDP, add);
  __syncthreads();
  for (int idx = threadIdx.x; idx < H * P; idx += NT) {
    const int k = idx / P, p = idx % P;
    const float g = dot_col(Wb + off.w_mid2, H, k, h4, H, p, LDP);
    h3[k * LDP + p] = h3[k * LDP + p] > 0.f ? g : 0.f;
  }
  __syncthreads();
  wgrad<NT>(G + off.w_cat, H + EMB1, 0, h3, H, h2, H, P, LDP, add);
  wgrad<NT>(G + off.w_cat, H + EMB1, H, h3, H, emb, EMB1, P, LDP, add);
  bgrad<NT>(G + off.b_cat, h3, H, P, LDP, add);
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
  wgrad<NT>(G + off.w_mid1, H, 0, h2, H, h1, H, P, LDP, add);
  bgrad<NT>(G + off.b_mid1, h2, H, P, LDP, add);
  __syncthreads();
  for (int idx = threadIdx.x; idx < H * P; idx += NT) {
    const int k = idx / P, p = idx % P;
    const float g = dot_col(Wb + off.w_mid1, H, k, h2, H, p, LDP);
    h1[k * LDP + p] = h1[k * LDP + p] > 0.f ? g : 0.f;
  }
  __syncthreads();
  wgrad<NT>(G + off.w_in, EMB1, 0, h1, H, emb, EMB1, P, LDP, add);
  bgrad<NT>(G + off.b_in, h1, H, P, LDP, add);
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
  // d dirs[j][k] = sum_p dproj[j][p] xs[k][p]
  wgrad<NT>(G + off.dirs, 3, 0, dproj, NDIR, emb, 3, P, LDP, add);
  __syncthreads();
}

size_t grad_smem_bytes(int H, int LDP, int RT) {
  return sizeof(float) *
         ((size_t)LDP * (EMB + 2 * NDIR + 5 * H + 8) + (size_t)RT);
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
