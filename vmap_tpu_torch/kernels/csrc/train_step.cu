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

#include <cuda_runtime.h>
#include <stdint.h>

#include "train_step.cuh"

namespace {

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
  if (!grad_args_ok(cap, n_per, n_iter, n_eff, it, S, RT, n_tiles, n_rows))
    return (int)cudaErrorInvalidValue;
  const GradArgs a = {params, wr, od, z, ray, wmul, scale, active,
                      grad_part, loss_part, offsets_from(offsets), cap,
                      n_params, n_per, n_iter, n_eff, it, S, RT, n_tiles,
                      n_rows, cs, osc};
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
