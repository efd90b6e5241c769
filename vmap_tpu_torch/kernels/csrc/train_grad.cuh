// K1's float tile (train_step.cu's design comment): its shared memory,
// the forward products, the tile and train_grad_kernel, and the launch of
// one width's instances. train_step.cu instantiates it at h = 32, 128 and
// 256; train_step_h16.cu and train_step_h64.cu each at one narrow width,
// in translation units of their own so that the build's files compile
// side by side.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "train_step.cuh"

namespace {

// The float tile's shared memory (kernels/train_step.py float_smem_bytes):
// nbuf slab buffers, then FloatBufs' rows (EMB + 4 NDIR + 2 H + 8 of LDP)
// and the per-ray losses
template <int H, int POL>
size_t float_smem_bytes(int LDP, int RT, int nbuf) {
  return nbuf * slab_bytes<H, POL>() +
         sizeof(float) * ((size_t)LDP * float_rows(H) + RT);
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
  constexpr int NF = fwd_pieces<POL>();
  constexpr int FWM = T::FWM, FWN = T::FWN, FMU = T::FMU;
  const int P = RT * S;
  const FloatBufs<H> bufs(sm, LDP);
  float *emb = bufs.emb, *a = bufs.a, *b = bufs.b, *alp = bufs.alp;
  float* emb2 = emb + EMB1 * LDP;
  float *s1 = hs, *s2 = hs + H * LDP, *s3 = hs + 2 * H * LDP;
  K1_MARK_START();

  // 1. points xs = (o + z d) / scale, projection, sin bands
  tile_points<NT>(W, od, zs, sc, off, emb, bufs.proj, rbase, ray0, n_per, S,
                  P, LDP);
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
                                nullptr, 0, bufs.col, P, LDP, false, slab0,
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
  render_loss<NT>(zs, ray, wm, alp, bufs.col, bufs.dal, bufs.dy, bufs.rl,
                  loss, add, rbase, ray0, n_per, S, RT, LDP, cs, osc);
  K1_MARK(2);

  // 4. MLP backward
  float_backward<H, POL>(W, ws, NS, G, hs, off, bufs, P, LDP, add, slab0,
                         slab1);
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

template <int H, int POL>
int launch_reuse(const GradArgs& a, cudaStream_t stream) {
  return a.n_eff == a.n_iter ? launch_grad<H, POL, false>(a, stream)
                             : launch_grad<H, POL, true>(a, stream);
}

}  // namespace

// The arguments of vmap_train_grad (train_step.cu) past its policy and
// width, which each width's entry takes in the same order
#define VMAP_GRAD_PARAMS                                                    \
  const float *params, const void *ws, const float *od, const float *z,    \
      const float *ray, const float *wmul, const float *scale,              \
      const int *active, float *grad_part, float *loss_part,                \
      float *act_part, const int *offsets, int cap, int n_params,           \
      int n_per, int n_iter, int n_eff, int it, int S, int RT, int n_tiles, \
      int n_rows, float cs, float osc, void *stream
#define VMAP_GRAD_ARGS                                                      \
  params, ws, od, z, ray, wmul, scale, active, grad_part, loss_part,        \
      act_part, offsets, cap, n_params, n_per, n_iter, n_eff, it, S, RT,    \
      n_tiles, n_rows, cs, osc, stream

namespace {

// vmap_train_grad at width H: the arguments checked, then the instance of
// the policy (0 F32, 1 BWD_BF16, 2 BF16) and of sample_reuse
template <int H>
int train_grad_at(int policy, VMAP_GRAD_PARAMS) {
  const Offsets off = offsets_from(offsets);
  if (!grad_args_ok(cap, n_per, n_iter, n_eff, it, S, RT, n_tiles, n_rows) ||
      ws == nullptr || act_part == nullptr || !rest_fits(off, H))
    return (int)cudaErrorInvalidValue;
  const GradArgs a = {params, static_cast<const bf16*>(ws), od, z, ray, wmul,
                      scale, active, grad_part, loss_part, act_part,
                      off, cap, n_params, n_per, n_iter,
                      n_eff, it, S, RT, n_tiles, n_rows, cs, osc};
  cudaStream_t st = (cudaStream_t)stream;
  if (policy == F32) return launch_reuse<H, F32>(a, st);
  if (policy == BWD_BF16) return launch_reuse<H, BWD_BF16>(a, st);
  if (policy == BF16) return launch_reuse<H, BF16>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
