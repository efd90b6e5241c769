// The train-frame kernel under the int8 matmul policies (sm_90a, plain C
// interface, loaded with ctypes).
//
// Replaces the int8 paths of the TPU kernel
// vmap_tpu/kernels/train_step.py::_make_kernel: quant_dyn / quant_static /
// quant_weights (:501-590), the quantised forward of fwd_mlp (:803-846) and
// the quantised backward bwd_chunk_q8 (:1050-1117). The plain version, and
// the statement of the scale granularity this kernel computes, is
// vmap_tpu_torch/ops/quant.py.
//
// The tile is train_step.cuh's tile_body, under two policies of its own:
//   INT8      (int8, int8_static): the embedding is quantised in place
//       after the PE (its f32 xs rows kept for the dirs gradient), each
//       ReLU output in place once its scale is known, and every product,
//       forward and backward, reads integer-valued operands;
//   INT8_FWD  (int8_fwd, int8_static_fwd): the forward products quantise
//       their operands as they read them, so the activations and the
//       embedding stay f32 for tile_body's f32 backward.
// Static or dynamic scales are a runtime choice: qs points to the static
// (scale, 127 / maximum) pairs of the activations, head gradients and
// hidden gradients, or is null. A dynamic scale is the abs-max of one
// tensor over the tile (max |x| / 127 + 1e-30), one block reduction each:
// max is order-free, so the result does not depend on the reduction order.
//
// Exact s32 sums on FP32 FMA loops: every quantised operand is held as an
// integer-valued float, and an s8 x s8 sum is exact in f32 while it stays
// under 2^24 (forward contractions over <= h + 87 = 343 inputs: 5.5 M;
// input gradients over <= 256 rows: 4.1 M; weight gradients over one tile's
// <= MAX_POINTS = 64 points: 1.0 M). So each tile's product equals the TPU's
// s32 result, and it is scaled in f32 in the same order (acc * (s_a *
// s_b)), with __fmul_rn / __fadd_rn so that no multiply-add is contracted.
//
// The weights are quantised once per iteration by quant_weights_kernel, one
// block per (tensor, slot): a block reduction gives the tensor's scale, then
// the block writes the integer-valued copy wq (the layout of the
// parameters) and the scale. The wrapper launches it after each
// train_adamw, and once before the frame's first iteration.
//
// What bounds it on the card: FP32 FMA issue over shared-memory operands
// (the tile the float policies ran before they moved to tensor cores in
// train_step.cu), plus 11 block reductions and in-place
// quantisation passes per tile (about 10 H + 150 values per point against
// about 3 x 11,199 multiply-adds per point at h=32). Tensor-core s8
// products (mma.sync / wgmma) are a later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

#include "train_step.cuh"

namespace {

// the nine quantised weight tensors of a slot: ops/quant.py QW_NAMES
enum QW : int {
  QW_IN, QW_MID1, QW_CAT_H, QW_CAT_X, QW_MID2, QW_ALPHA, QW_COL_H, QW_COL_X,
  QW_OUT, NQW
};
// the xs rows of the trunk's embedding quantise x127 / XS_RANGE (4)
constexpr float XS_MUL = 127.f / 4.f;
constexpr float INV_XS = 1.f / XS_MUL;
constexpr float INV_127 = 1.f / 127.f;

// x * mul rounded (half to even) to an integer in [-127, 127]
__device__ __forceinline__ float q8(float x, float mul) {
  return rintf(fminf(fmaxf(__fmul_rn(x, mul), -127.f), 127.f));
}

// max |x| over rows [n][LDP] (their first P entries), in every thread
template <int NT>
__device__ float block_amax(const float* x, int n, int P, int LDP,
                            float* red) {
  float m = 0.f;
  for (int idx = threadIdx.x; idx < n * P; idx += NT) {
    const int i = idx / P, p = idx % P;
    m = fmaxf(m, fabsf(x[i * LDP + p]));
  }
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

// The scale of rows [n][LDP] over the tile: the static pair st (scale,
// 127 / maximum), or, where st is null, the dynamic one. With inplace the
// rows are quantised in place. Starts and ends with the block
// synchronised.
template <int NT>
__device__ QScale quant_rows(float* x, int n, int P, int LDP,
                             const float* st, float* red, bool inplace) {
  __syncthreads();
  QScale q;
  if (st) {
    q.s = st[0];
    q.inv = st[1];
  } else {
    q.s = __fadd_rn(__fmul_rn(block_amax<NT>(x, n, P, LDP, red), INV_127),
                    1e-30f);
    q.inv = 1.f / q.s;
  }
  if (inplace) {
    for (int idx = threadIdx.x; idx < n * P; idx += NT) {
      const int i = idx / P, p = idx % P;
      x[i * LDP + p] = q8(x[i * LDP + p], q.inv);
    }
    __syncthreads();
  }
  return q;
}

// The embedding quantised in place at its static row scales, its f32 xs
// rows kept in xs for the dirs gradient
template <int H, int NT>
__device__ __forceinline__ void quant_emb_q8(const TileBufs<H>& t, int P,
                                             int LDP) {
  for (int idx = threadIdx.x; idx < EMB * P; idx += NT) {
    const int i = idx / P, p = idx % P;
    const float x = t.emb[i * LDP + p];
    if (i < 3) t.xs[i * LDP + p] = x;
    t.emb[i * LDP + p] = q8(x, i < 3 ? XS_MUL : 127.f);
  }
}

// out[i][p] = act(acc_a[i][p] * sa + acc_b[i][p] * sb + b[i]) with
// acc_a = sum_k wq[i][k] ina[k][p], acc_b = sum_k wq[i][na+k] inb[k][p]
// over integer operands (exact). QR: ina / inb hold f32 values that are
// quantised as they are read, x mula / mulb, their first nxa / nxb rows
// (the embedding's xs rows) x XS_MUL.
template <int TI, int NT, bool QR>
__device__ void dense_q8(const float* __restrict__ wq,
                         const float* __restrict__ b, int n_out, int ldw,
                         const float* ina, int na, int nxa, float mula,
                         float sa, const float* inb, int nb, int nxb,
                         float mulb, float sb, float* out, int P, int LDP,
                         bool relu) {
  const int n_items = (n_out / TI) * P;
  for (int idx = threadIdx.x; idx < n_items; idx += NT) {
    const int i0 = (idx / P) * TI, p = idx % P;
    const float* wr = wq + (size_t)i0 * ldw;
    float acc[TI], accb[TI];
#pragma unroll
    for (int t = 0; t < TI; ++t) acc[t] = accb[t] = 0.f;
    for (int k = 0; k < na; ++k) {
      float x = ina[k * LDP + p];
      if constexpr (QR) x = q8(x, k < nxa ? XS_MUL : mula);
#pragma unroll
      for (int t = 0; t < TI; ++t) acc[t] = fmaf(wr[t * ldw + k], x, acc[t]);
    }
    for (int k = 0; k < nb; ++k) {
      float x = inb[k * LDP + p];
      if constexpr (QR) x = q8(x, k < nxb ? XS_MUL : mulb);
#pragma unroll
      for (int t = 0; t < TI; ++t)
        accb[t] = fmaf(wr[t * ldw + na + k], x, accb[t]);
    }
#pragma unroll
    for (int t = 0; t < TI; ++t) {
      float y = __fmul_rn(acc[t], sa);
      if (nb) y = __fadd_rn(y, __fmul_rn(accb[t], sb));
      y = __fadd_rn(y, b[i0 + t]);
      out[(i0 + t) * LDP + p] = relu ? fmaxf(y, 0.f) : y;
    }
  }
}

// The int8 forward (fwd_mlp under q8f): W for the biases, Wq the quantised
// weights with scales wsc. QR (INT8_FWD): the rows keep their f32 values
// and each product quantises what it reads; else each ReLU output is
// quantised in place once its scale is known. Ends with the block
// synchronised.
template <int H, int NT, bool QR>
__device__ __forceinline__ Q8Act forward_q8(
    const float* __restrict__ W, const float* __restrict__ Wq,
    const float* __restrict__ wsc, const float* __restrict__ qs, Offsets off,
    const TileBufs<H>& t, int P, int LDP) {
  float *emb = t.emb, *red = t.red;
  Q8Act a;
  dense_q8<4, NT, QR>(Wq + off.w_in, W + off.b_in, H, EMB1, emb, EMB1, 3,
                      127.f, wsc[QW_IN], nullptr, 0, 0, 0.f, 0.f, t.h1, P,
                      LDP, true);
  const QScale q1 = quant_rows<NT>(t.h1, H, P, LDP, qs, red, !QR);
  a.s1 = q1.s;
  dense_q8<4, NT, QR>(Wq + off.w_mid1, W + off.b_mid1, H, H, t.h1, H, 0,
                      q1.inv, __fmul_rn(wsc[QW_MID1], q1.s), nullptr, 0, 0,
                      0.f, 0.f, t.h2, P, LDP, true);
  const QScale q2 = quant_rows<NT>(t.h2, H, P, LDP, qs, red, !QR);
  a.s2 = q2.s;
  dense_q8<4, NT, QR>(Wq + off.w_cat, W + off.b_cat, H, H + EMB1, t.h2, H, 0,
                      q2.inv, __fmul_rn(wsc[QW_CAT_H], q2.s), emb, EMB1, 3,
                      127.f, wsc[QW_CAT_X], t.h3, P, LDP, true);
  const QScale q3 = quant_rows<NT>(t.h3, H, P, LDP, qs, red, !QR);
  a.s3 = q3.s;
  dense_q8<4, NT, QR>(Wq + off.w_mid2, W + off.b_mid2, H, H, t.h3, H, 0,
                      q3.inv, __fmul_rn(wsc[QW_MID2], q3.s), nullptr, 0, 0,
                      0.f, 0.f, t.h4, P, LDP, true);
  const QScale q4 = quant_rows<NT>(t.h4, H, P, LDP, qs, red, !QR);
  a.s4 = q4.s;
  dense_q8<1, NT, QR>(Wq + off.w_alpha, W + off.b_alpha, 1, H, t.h4, H, 0,
                      q4.inv, __fmul_rn(wsc[QW_ALPHA], q4.s), nullptr, 0, 0,
                      0.f, 0.f, t.alp, P, LDP, false);
  dense_q8<4, NT, QR>(Wq + off.w_col, W + off.b_col, H, H + EMB2, t.h4, H, 0,
                      q4.inv, __fmul_rn(wsc[QW_COL_H], q4.s),
                      emb + EMB1 * LDP, EMB2, 0, 127.f, wsc[QW_COL_X], t.hc,
                      P, LDP, true);
  const QScale qc = quant_rows<NT>(t.hc, H, P, LDP, qs, red, !QR);
  a.sc = qc.s;
  dense_q8<1, NT, QR>(Wq + off.w_col_out, W + off.b_col_out, 3, H, t.hc, H,
                      0, qc.inv, __fmul_rn(wsc[QW_OUT], qc.s), nullptr, 0, 0,
                      0.f, 0.f, t.col, P, LDP, false);
  __syncthreads();
  return a;
}

// G[i * ldw + col0 + k] (+)= (sum_p dout[i][p] in[k][p]) * s over integer
// operands; emb: the columns are the trunk's embedding rows, whose static
// row scale divides the gradient once more (1 / XS_MUL for the xs rows,
// 1 / 127 for the others)
template <int NT>
__device__ void wgrad_q8(float* __restrict__ G, int ldw, int col0,
                         const float* dout, int n_out, const float* in,
                         int n_in, int P, int LDP, float s, bool emb,
                         bool add) {
  for (int idx = threadIdx.x; idx < n_out * n_in; idx += NT) {
    const int i = idx / n_in, k = idx % n_in;
    const float* d = dout + i * LDP;
    const float* x = in + k * LDP;
    float acc = 0.f;
    for (int p = 0; p < P; ++p) acc = fmaf(d[p], x[p], acc);
    float g = __fmul_rn(acc, s);
    if (emb) g = __fmul_rn(g, k < 3 ? INV_XS : INV_127);
    float* gp = G + (size_t)i * ldw + col0 + k;
    *gp = add ? *gp + g : g;
  }
}

// The quantised backward (bwd_chunk_q8). Each output gradient's bias
// gradient is taken from its f32 values; the gradient is then quantised
// in place once (dalpha and dlogits with the head scale, the others with
// the hidden one) and read by both its weight- and its input-gradient
// product. The ReLU masks are the quantised activations' (q > 0); dproj
// and the dirs gradient stay f32.
template <int H, int NT>
__device__ __forceinline__ void backward_q8(
    const float* __restrict__ Wq, const float* __restrict__ wsc,
    const float* __restrict__ qs, const Q8Act& a, float* __restrict__ G,
    Offsets off, const TileBufs<H>& t, int P, int LDP, bool add) {
  float *emb = t.emb, *xs = t.xs, *red = t.red;
  const float* head = qs ? qs + 2 : nullptr;
  const float* hid = qs ? qs + 4 : nullptr;

  bgrad<NT>(G + off.b_col_out, t.dy, 3, P, LDP, add);
  bgrad<NT>(G + off.b_alpha, t.dal, 1, P, LDP, add);
  const float sdl = quant_rows<NT>(t.dy, 3, P, LDP, head, red, true).s;
  const float sda = quant_rows<NT>(t.dal, 1, P, LDP, head, red, true).s;
  wgrad_q8<NT>(G + off.w_col_out, H, 0, t.dy, 3, t.hc, H, P, LDP,
               __fmul_rn(sdl, a.sc), false, add);
  wgrad_q8<NT>(G + off.w_alpha, H, 0, t.dal, 1, t.h4, H, P, LDP,
               __fmul_rn(sda, a.s4), false, add);
  __syncthreads();
  const float s_out = __fmul_rn(wsc[QW_OUT], sdl);
  for (int idx = threadIdx.x; idx < H * P; idx += NT) {
    const int k = idx / P, p = idx % P;
    const float g = dot_col(Wq + off.w_col_out, H, k, t.dy, 3, p, LDP);
    t.hc[k * LDP + p] = t.hc[k * LDP + p] > 0.f ? __fmul_rn(g, s_out) : 0.f;
  }
  __syncthreads();
  bgrad<NT>(G + off.b_col, t.hc, H, P, LDP, add);
  const float sdc = quant_rows<NT>(t.hc, H, P, LDP, hid, red, true).s;
  wgrad_q8<NT>(G + off.w_col, H + EMB2, 0, t.hc, H, t.h4, H, P, LDP,
               __fmul_rn(sdc, a.s4), false, add);
  wgrad_q8<NT>(G + off.w_col, H + EMB2, H, t.hc, H, emb + EMB1 * LDP, EMB2,
               P, LDP, __fmul_rn(sdc, INV_127), false, add);
  __syncthreads();
  const float s_colh = __fmul_rn(wsc[QW_COL_H], sdc);
  const float s_alpha = __fmul_rn(wsc[QW_ALPHA], sda);
  const float s_colx = __fmul_rn(wsc[QW_COL_X], sdc);
  for (int idx = threadIdx.x; idx < (H + NDIR) * P; idx += NT) {
    const int k = idx / P, p = idx % P;
    if (k < H) {
      const float g = __fadd_rn(
          __fmul_rn(dot_col(Wq + off.w_col, H + EMB2, k, t.hc, H, p, LDP),
                    s_colh),
          __fmul_rn(Wq[off.w_alpha + k] * t.dal[p], s_alpha));
      t.h4[k * LDP + p] = t.h4[k * LDP + p] > 0.f ? g : 0.f;
    } else {
      const int j = k - H;
      float acc = 0.f;
      for (int b = 4; b < NBAND; ++b) {
        const int e = (b - 4) * NDIR + j;   // column within emb2
        const float g = __fmul_rn(
            __fmul_rn(dot_col(Wq + off.w_col, H + EMB2, H + e, t.hc, H, p,
                              LDP), s_colx), 127.f);
        acc += band_grad(g, t.proj[j * LDP + p], b);
      }
      t.dproj[j * LDP + p] = acc;
    }
  }
  __syncthreads();
  bgrad<NT>(G + off.b_mid2, t.h4, H, P, LDP, add);
  const float sdh4 = quant_rows<NT>(t.h4, H, P, LDP, hid, red, true).s;
  wgrad_q8<NT>(G + off.w_mid2, H, 0, t.h4, H, t.h3, H, P, LDP,
               __fmul_rn(sdh4, a.s3), false, add);
  __syncthreads();
  const float s_mid2 = __fmul_rn(wsc[QW_MID2], sdh4);
  for (int idx = threadIdx.x; idx < H * P; idx += NT) {
    const int k = idx / P, p = idx % P;
    const float g = dot_col(Wq + off.w_mid2, H, k, t.h4, H, p, LDP);
    t.h3[k * LDP + p] = t.h3[k * LDP + p] > 0.f ? __fmul_rn(g, s_mid2) : 0.f;
  }
  __syncthreads();
  bgrad<NT>(G + off.b_cat, t.h3, H, P, LDP, add);
  const float sdh3 = quant_rows<NT>(t.h3, H, P, LDP, hid, red, true).s;
  wgrad_q8<NT>(G + off.w_cat, H + EMB1, 0, t.h3, H, t.h2, H, P, LDP,
               __fmul_rn(sdh3, a.s2), false, add);
  wgrad_q8<NT>(G + off.w_cat, H + EMB1, H, t.h3, H, emb, EMB1, P, LDP, sdh3,
               true, add);
  __syncthreads();
  const float s_cath = __fmul_rn(wsc[QW_CAT_H], sdh3);
  const float s_catx = __fmul_rn(wsc[QW_CAT_X], sdh3);
  for (int idx = threadIdx.x; idx < (H + NDIR) * P; idx += NT) {
    const int k = idx / P, p = idx % P;
    if (k < H) {
      const float g = dot_col(Wq + off.w_cat, H + EMB1, k, t.h3, H, p, LDP);
      t.h2[k * LDP + p] = t.h2[k * LDP + p] > 0.f ? __fmul_rn(g, s_cath)
                                                  : 0.f;
    } else {
      const int j = k - H;
      float acc = t.dproj[j * LDP + p];
      for (int b = 0; b < 4; ++b) {
        const int e = 3 + b * NDIR + j;     // column within emb1
        const float g = __fmul_rn(
            __fmul_rn(dot_col(Wq + off.w_cat, H + EMB1, H + e, t.h3, H, p,
                              LDP), s_catx), 127.f);
        acc += band_grad(g, t.proj[j * LDP + p], b);
      }
      t.dproj[j * LDP + p] = acc;
    }
  }
  __syncthreads();
  bgrad<NT>(G + off.b_mid1, t.h2, H, P, LDP, add);
  const float sdh2 = quant_rows<NT>(t.h2, H, P, LDP, hid, red, true).s;
  wgrad_q8<NT>(G + off.w_mid1, H, 0, t.h2, H, t.h1, H, P, LDP,
               __fmul_rn(sdh2, a.s1), false, add);
  __syncthreads();
  const float s_mid1 = __fmul_rn(wsc[QW_MID1], sdh2);
  for (int idx = threadIdx.x; idx < H * P; idx += NT) {
    const int k = idx / P, p = idx % P;
    const float g = dot_col(Wq + off.w_mid1, H, k, t.h2, H, p, LDP);
    t.h1[k * LDP + p] = t.h1[k * LDP + p] > 0.f ? __fmul_rn(g, s_mid1) : 0.f;
  }
  __syncthreads();
  bgrad<NT>(G + off.b_in, t.h1, H, P, LDP, add);
  const float sdh1 = quant_rows<NT>(t.h1, H, P, LDP, hid, red, true).s;
  wgrad_q8<NT>(G + off.w_in, EMB1, 0, t.h1, H, emb, EMB1, P, LDP, sdh1, true,
               add);
  const float s_in = __fmul_rn(wsc[QW_IN], sdh1);
  for (int idx = threadIdx.x; idx < NDIR * P; idx += NT) {
    const int j = idx / P, p = idx % P;
    float acc = t.dproj[j * LDP + p];
    for (int b = 0; b < 4; ++b) {
      const int e = 3 + b * NDIR + j;
      const float g = __fmul_rn(
          __fmul_rn(dot_col(Wq + off.w_in, EMB1, e, t.h1, H, p, LDP), s_in),
          127.f);
      acc += band_grad(g, t.proj[j * LDP + p], b);
    }
    t.dproj[j * LDP + p] = acc;
  }
  __syncthreads();
  // d dirs[j][k] = sum_p dproj[j][p] xs[k][p], f32
  wgrad<NT>(G + off.dirs, 3, 0, t.dproj, NDIR, xs, 3, P, LDP, add);
  __syncthreads();
}

// The tile under an int8 policy, not inlined (as train_step.cu's
// grad_tile): Wq is the slot's quantised weights, wsc their scales.
template <int H, int NT, int POL>
__device__ __noinline__ void grad_tile_q8(const float* __restrict__ W,
                          const float* __restrict__ Wq,
                          const float* __restrict__ wsc,
                          const float* __restrict__ qs,
                          const float* __restrict__ od,
                          const float* __restrict__ zs,
                          const float* __restrict__ ray,
                          const float* __restrict__ wm, float sc,
                          float* __restrict__ G, float* __restrict__ loss,
                          Offsets off, size_t rbase, int ray0,
                          int n_per, int S, int RT, int LDP, float cs,
                          float osc, bool add, float* sm) {
  tile_body<H, NT, POL>(W, Wq, od, zs, ray, wm, sc, G, loss, off, rbase,
                        ray0, n_per, S, RT, LDP, cs, osc, add, sm, wsc, qs);
}

// train_grad_kernel under an int8 policy: the same grid of (partial row,
// slot) and tile order. sample_reuse is a runtime offset here (with n_eff
// == n_iter it is 0).
template <int H, int NT, int POL>
__global__ void __launch_bounds__(NT)
train_grad_q8_kernel(const float* __restrict__ params,   // [cap, NP]
                     const float* __restrict__ wq,       // [cap, NP]
                     const float* __restrict__ wscale,   // [cap, NQW]
                     const float* __restrict__ qs,       // [6] or null
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
  // pixel rows of block it mod n_eff; z advanced to this iteration's rows
  const size_t rbase = ((size_t)slot * n_eff + it % n_eff) * n_per;
  zs += ((size_t)slot * n_rays + (size_t)it * n_per - rbase) * S;
  const float* wm = wmul + ((size_t)slot * n_eff + it % n_eff) * 4;
  for (int tile = row; tile < n_tiles; tile += n_rows) {
    float* G = grad_part + ((size_t)slot * n_rows + row) * n_params;
    float* loss = loss_part + (size_t)slot * n_rows + row;
    grad_tile_q8<H, NT, POL>(params + (size_t)slot * n_params,
                             wq + (size_t)slot * n_params,
                             wscale + (size_t)slot * NQW, qs, od, zs, ray, wm,
                             scale[slot], G, loss, off, rbase, tile * RT,
                             n_per, S, RT, LDP, cs, osc, tile != row, sm);
  }
}

// Tensor t of a slot's quantised weights: offset, shape, row stride and
// which static row scale folds into it first (1: the trunk's embedding
// columns, 2: the colour head's, x 1/127)
struct QwDesc {
  int off, rows, cols, ld, fold;
};

__device__ QwDesc qw_desc(int t, const Offsets& o, int H) {
  switch (t) {
    case QW_IN: return {o.w_in, H, EMB1, EMB1, 1};
    case QW_MID1: return {o.w_mid1, H, H, H, 0};
    case QW_CAT_H: return {o.w_cat, H, H, H + EMB1, 0};
    case QW_CAT_X: return {o.w_cat + H, H, EMB1, H + EMB1, 1};
    case QW_MID2: return {o.w_mid2, H, H, H, 0};
    case QW_ALPHA: return {o.w_alpha, 1, H, H, 0};
    case QW_COL_H: return {o.w_col, H, H, H + EMB2, 0};
    case QW_COL_X: return {o.w_col + H, H, EMB2, H + EMB2, 2};
    default: return {o.w_col_out, 3, H, H, 0};
  }
}

__device__ __forceinline__ float fold_w(float w, int fold, int c) {
  if (fold == 1) return __fmul_rn(w, c < 3 ? INV_XS : INV_127);
  if (fold == 2) return __fmul_rn(w, INV_127);
  return w;
}

constexpr int QUANT_THREADS = 256;

// One block per (tensor, active slot): the tensor's dynamic scale (a block
// reduction of |w| after the fold), then its integer-valued copy in wq.
__global__ void __launch_bounds__(QUANT_THREADS)
quant_weights_kernel(const float* __restrict__ p, float* __restrict__ wq,
                     float* __restrict__ wscale,
                     const int* __restrict__ active, Offsets off,
                     int n_params, int H) {
  __shared__ float red[QUANT_THREADS / 32];
  const int t = blockIdx.x, slot = blockIdx.y;
  if (!active[slot]) return;
  const QwDesc d = qw_desc(t, off, H);
  const float* src = p + (size_t)slot * n_params + d.off;
  float* dst = wq + (size_t)slot * n_params + d.off;
  float m = 0.f;
  for (int idx = threadIdx.x; idx < d.rows * d.cols; idx += QUANT_THREADS) {
    const int r = idx / d.cols, c = idx % d.cols;
    m = fmaxf(m, fabsf(fold_w(src[r * d.ld + c], d.fold, c)));
  }
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = 0.f;
  for (int w = 0; w < QUANT_THREADS / 32; ++w) m = fmaxf(m, red[w]);
  const float s = __fadd_rn(__fmul_rn(m, INV_127), 1e-30f);
  const float inv = 1.f / s;
  for (int idx = threadIdx.x; idx < d.rows * d.cols; idx += QUANT_THREADS) {
    const int r = idx / d.cols, c = idx % d.cols;
    dst[r * d.ld + c] = rintf(__fmul_rn(fold_w(src[r * d.ld + c], d.fold, c),
                                        inv));
  }
  if (threadIdx.x == 0) wscale[(size_t)slot * NQW + t] = s;
}

// The operands and geometry of one int8 train_grad launch.
struct Q8Args {
  const float *params, *wq, *wscale, *qs, *od, *z, *ray, *wmul, *scale;
  const int* active;
  float *grad_part, *loss_part;
  Offsets off;
  int cap, n_params, n_per, n_iter, n_eff, it, S, RT, n_tiles, n_rows;
  float cs, osc;
};

template <int H, int NT, int POL>
int launch_q8(const Q8Args& a, cudaStream_t stream) {
  if (a.RT > NT) return (int)cudaErrorInvalidValue;
  const int P = a.RT * a.S;
  const int LDP = P | 1;
  // tile_body's buffers, then the f32 xs rows and the reduction scratch
  const size_t smem = grad_smem_bytes(H, LDP, a.RT)
                      + sizeof(float) * (3 * (size_t)LDP + 32);
  cudaError_t err = cudaFuncSetAttribute(
      train_grad_q8_kernel<H, NT, POL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.n_rows, a.cap);
  train_grad_q8_kernel<H, NT, POL><<<grid, NT, smem, stream>>>(
      a.params, a.wq, a.wscale, a.qs, a.od, a.z, a.ray, a.wmul, a.scale,
      a.active, a.grad_part, a.loss_part, a.off, a.n_params,
      a.n_iter * a.n_per, a.n_per, a.n_iter, a.it, a.S, a.RT, a.n_tiles, LDP,
      a.cs, a.osc, a.n_eff);
  return (int)cudaGetLastError();
}

template <int POL>
int launch_q8_width(int hidden, const Q8Args& a, cudaStream_t stream) {
  if (hidden == 32) return launch_q8<32, 256, POL>(a, stream);
  if (hidden == 128) return launch_q8<128, 256, POL>(a, stream);
  if (hidden == 256) return launch_q8<256, 512, POL>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// vmap_train_grad (train_step.cu) under an int8 policy: q8b 1 for int8 /
// int8_static (quantised backward), 0 for int8_fwd / int8_static_fwd. wq /
// wscale: the quantised weights and their [cap, 9] scales
// (vmap_train_quant_w); qs: the static policies' (scale, 127 / maximum)
// pairs for activations, head gradients and hidden gradients, or null for
// dynamic scales.
int vmap_train_grad_q8(int q8b, int hidden, const float* params,
                       const float* wq, const float* wscale, const float* qs,
                       const float* od, const float* z, const float* ray,
                       const float* wmul, const float* scale,
                       const int* active, float* grad_part, float* loss_part,
                       const int* offsets, int cap, int n_params, int n_per,
                       int n_iter, int n_eff, int it, int S, int RT,
                       int n_tiles, int n_rows, float cs, float osc,
                       void* stream) {
  if (!grad_args_ok(cap, n_per, n_iter, n_eff, it, S, RT, n_tiles, n_rows) ||
      wq == nullptr || wscale == nullptr)
    return (int)cudaErrorInvalidValue;
  const Q8Args a = {params, wq, wscale, qs, od, z, ray, wmul, scale, active,
                    grad_part, loss_part, offsets_from(offsets), cap,
                    n_params, n_per, n_iter, n_eff, it, S, RT, n_tiles,
                    n_rows, cs, osc};
  cudaStream_t st = (cudaStream_t)stream;
  return q8b ? launch_q8_width<INT8>(hidden, a, st)
             : launch_q8_width<INT8_FWD>(hidden, a, st);
}

// The quantised copy wq (integer-valued, the parameters' layout) of the
// nine MLP weight tensors of every active slot, and their scales wscale
// [cap, 9], from the parameters p.
int vmap_train_quant_w(const float* p, float* wq, float* wscale,
                       const int* active, const int* offsets, int cap,
                       int n_params, int hidden, void* stream) {
  if (cap < 1 || (hidden != 32 && hidden != 128 && hidden != 256))
    return (int)cudaErrorInvalidValue;
  dim3 grid(NQW, cap);
  quant_weights_kernel<<<grid, QUANT_THREADS, 0, (cudaStream_t)stream>>>(
      p, wq, wscale, active, offsets_from(offsets), n_params, hidden);
  return (int)cudaGetLastError();
}

}  // extern "C"
