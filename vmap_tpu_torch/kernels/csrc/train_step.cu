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
//   adamw_kernel        one wave of blocks, each taking runs of 512 row
//       positions of active slots (update_plan.cuh: the runs, the ring,
//       the thread mapping and the summation order). Streams the run's
//       partial rows through a two-stage ring in shared memory by
//       TMA 1-D bulk copies on mbarriers, sums each position's rows in row
//       order (deterministic, no atomics), maps the position to its
//       parameter (kernels/train_step.py grad_row_param), applies masked
//       AdamW (torch semantics: p *= 1 - lr wd first, betas 0.9 / 0.999,
//       eps 1e-8, per-slot bias corrections 1 - b^t precomputed on the
//       host), and writes the staged copy of the updated product weights
//       as 8-byte vectors (where the policy reads it: not int8 /
//       int8_static). Inactive slots are not touched, so they stay
//       bit-identical.
//       Replaces the TPU kernel's adam_sub
//       (vmap_tpu/kernels/train_step.py:1144). Bound by bytes: it must
//       read the rows (100 x 20 x 13,040, 300 x 101,072 and 132 x 333,136
//       floats at the object, background and iMAP shapes of
//       chip_smoke.py phase 3) besides p, m, v; one thread's serial
//       4-byte loads over the rows kept too few bytes in flight, which
//       the ring of 32 KB a block, six blocks an SM, is for; a warp reads
//       and writes whole runs of p, m and v (its lanes on consecutive
//       positions), which at the object shape's 20-row items weigh as
//       much as the stream.
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

#include "train_grad.cuh"

namespace {

// The bf16 pieces of 4 positions' values in one plane: 8 bytes
// One staged plane of 4 positions' values r, as one 8-byte store of their
// bf16 roundings, which r then loses (mma.cuh split: the next plane holds
// what is left)
__device__ __forceinline__ void store_piece4(bf16* w, float (&r)[ADAM_V]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(r[0], r[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(r[2], r[3]);
  *reinterpret_cast<uint2*>(w) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                 *reinterpret_cast<const uint32_t*>(&hi));
  r[0] -= __low2float(lo);
  r[1] -= __high2float(lo);
  r[2] -= __low2float(hi);
  r[3] -= __high2float(hi);
}

// The partial rows (grad_row; rparam[q] the parameter at row position q,
// -1 on padding: kernels/train_step.py grad_row_param) summed in row
// order, then AdamW, and the updated product weights' staged copy written
// to ws ([cap, STAGED_PIECES, staged_size(hidden)] bf16, zeros on its
// padding), which the next iteration's train_grad reads (under int8_fwd /
// int8_static_fwd its f32 backward; int8 / int8_static read none and pass
// a null ws); losses[slot, it] by update_plan.cuh's fixed-order warp sum.
// The grid, runs, ring, thread mapping and summation order are
// update_plan.cuh's.
__global__ void __launch_bounds__(ADAM_NT, ADAM_BPS)
adamw_kernel(float* __restrict__ p, bf16* __restrict__ ws,
             const int* __restrict__ rparam, float* __restrict__ m,
             float* __restrict__ v, const float* __restrict__ grad_part,
             const float* __restrict__ loss_part, float* __restrict__ losses,
             const int* __restrict__ active, const float* __restrict__ bc1,
             const float* __restrict__ bc2, int hidden, int cap, int n_params,
             int n_rows, int n_iter, int it, float lr, float decay, int L) {
  constexpr int NT = ADAM_NT, RUN = ADAM_RUN, RS = ADAM_RS;
  const int tid = threadIdx.x;
  if (blockIdx.x < L) {
    // the losses: warp w of block b slot b NT / 32 + w; lane l sums rows
    // l, l + 32, ... in order, then the butterfly (every lane ends with
    // lane 0's sum)
    const int s = blockIdx.x * (NT / 32) + (tid >> 5), lane = tid & 31;
    if (s >= cap) return;
    float acc = 0.f;
    if (active[s]) {
      const float* lp = loss_part + (size_t)s * n_rows;
#pragma unroll 4
      for (int t = lane; t < n_rows; t += 32) acc += lp[t];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) losses[(size_t)s * n_iter + it] = acc;
    return;
  }
  // the ring [ADAM_STAGES][RS][RUN] and its stages' mbarriers
  extern __shared__ __align__(128) unsigned char adam_smem_dyn[];
  auto ring = reinterpret_cast<float (*)[RS][RUN]>(adam_smem_dyn);
  uint64_t* full = reinterpret_cast<uint64_t*>(adam_smem_dyn +
                                               ADAM_STAGES * ADAM_STAGE_BYTES);
  __shared__ __align__(16) float pbuf[RUN];   // the pieces' exchange
  const int ng = grad_row(hidden), NS = staged_size(hidden);
  const int runs = adam_runs_of(ng), items = cap * runs;
  const int chunks = adam_chunks(n_rows);
  const int b = blockIdx.x - L, G = gridDim.x - L;   // the streaming blocks

  // the block's items b, b + G, ... of active slots; the stream of their
  // stages (item, chunk of RS rows), thread 0 ADAM_STAGES ahead
  auto next_item = [&](int i) {
    while (i < items && !active[i / runs]) i += G;
    return i;
  };
  int p_item = next_item(b), p_chunk = 0;   // thread 0's next issue
  auto issue = [&](int s) {
    const int slot = p_item / runs, run = p_item - slot * runs;
    const uint32_t bytes = 4u * adam_run_len_of(ng, run);
    const int r0 = p_chunk * RS;
    const int nr = n_rows - r0 < RS ? n_rows - r0 : RS;
    const float* src =
        grad_part + ((size_t)slot * n_rows + r0) * ng + run * RUN;
    mbarrier_expect(&full[s], nr * bytes);
    for (int r = 0; r < nr; ++r)
      bulk_copy_g2s(ring[s][r], src + (size_t)r * ng, bytes, &full[s]);
    if (++p_chunk == chunks) {
      p_chunk = 0;
      p_item = next_item(p_item + G);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < ADAM_STAGES; ++s) mbarrier_init(&full[s], 1);
    fence_proxy_async_smem();
    for (int s = 0; s < ADAM_STAGES && p_item < items; ++s) issue(s);
  }
  __syncthreads();

  // betas as the f32 roundings of 0.9, 1 - 0.9, 0.999, 1 - 0.999 (the
  // constants the plain PyTorch and JAX updates multiply by)
  const float b1 = 0.9f, omb1 = (float)(1.0 - 0.9);
  const float b2 = 0.999f, omb2 = (float)(1.0 - 0.999);
  // thread tid's positions tid + i NT of the run: their sums, parameters
  // (-1: none), and the parameters' values and moments
  float g[ADAM_V], pv[ADAM_V], mv[ADAM_V], vv[ADAM_V];
  int j[ADAM_V];
  float c1 = 1.f, c2 = 1.f;
  int k = 0;   // the stage consumed
  for (int item = next_item(b), chunk = 0; item < items; ++k) {
    const int slot = item / runs, run = item - slot * runs;
    const int len = adam_run_len_of(ng, run), q0 = run * RUN;
    const size_t base = (size_t)slot * n_params;
    if (chunk == 0) {
      // the item's parameters and moments, read while its rows stream in:
      // the four indices first, then their values (the loads of an index
      // and of its values interleaved, one index at a time, made each
      // item wait for eight dependent reads)
#pragma unroll
      for (int i = 0; i < ADAM_V; ++i) {
        g[i] = 0.f;
        j[i] = tid + i * NT < len ? rparam[q0 + tid + i * NT] : -1;
      }
#pragma unroll
      for (int i = 0; i < ADAM_V; ++i)
        if (j[i] >= 0) {
          pv[i] = p[base + j[i]];
          mv[i] = m[base + j[i]];
          vv[i] = v[base + j[i]];
        }
      c1 = bc1[(size_t)slot * n_iter + it];
      c2 = bc2[(size_t)slot * n_iter + it];
    }
    const int s = k % ADAM_STAGES;
    mbarrier_wait(&full[s], (uint32_t)(k / ADAM_STAGES) & 1u);
    const int r0 = chunk * RS;
    const int nr = n_rows - r0 < RS ? n_rows - r0 : RS;
    for (int r = 0; r < nr; ++r) {   // rows in order: the stated sum
#pragma unroll
      for (int i = 0; i < ADAM_V; ++i) g[i] += ring[s][r][tid + i * NT];
    }
    __syncthreads();   // stage s read by every thread: refill it
    if (tid == 0 && p_item < items) {
      fence_proxy_async_smem();
      issue(s);
    }
    if (++chunk < chunks) continue;
    chunk = 0;
#pragma unroll
    for (int i = 0; i < ADAM_V; ++i) {
      float pn = 0.f;   // the staged layout's padding
      if (j[i] >= 0) {
        const float mn = b1 * mv[i] + omb1 * g[i];
        const float vn = b2 * vv[i] + omb2 * g[i] * g[i];
        const float mhat = mn / c1;
        const float vhat = vn / c2;
        pn = pv[i] * decay - lr * mhat / (sqrtf(vhat) + 1e-8f);
        p[base + j[i]] = pn;
        m[base + j[i]] = mn;
        v[base + j[i]] = vn;
      }
      pbuf[tid + i * NT] = pn;
    }
    __syncthreads();   // pbuf written (the next item's first stage
                       // barrier comes before it is written again)
    const int qv = q0 + ADAM_V * tid;   // this thread's 4 staged positions
    if (ws != nullptr && qv < NS && ADAM_V * tid < len) {
      float r4[ADAM_V];
      const float4 x = *reinterpret_cast<const float4*>(&pbuf[ADAM_V * tid]);
      r4[0] = x.x;
      r4[1] = x.y;
      r4[2] = x.z;
      r4[3] = x.w;
      bf16* w = ws + (size_t)slot * STAGED_PIECES * NS + qv;
#pragma unroll
      for (int pc = 0; pc < STAGED_PIECES; ++pc)   // mma.cuh split
        store_piece4(w + (size_t)pc * NS, r4);
    }
    item = next_item(item + G);
  }
}

}  // namespace

extern "C" {

// the float instances at the narrow widths (train_step_h16.cu,
// train_step_h64.cu): vmap_train_grad at h=16 and h=64
int vmap_train_grad_h16(int policy, VMAP_GRAD_PARAMS);
int vmap_train_grad_h64(int policy, VMAP_GRAD_PARAMS);

// The staged weights' elements per plane at a kernel width (0 for any
// other): kernels/train_step.py holds its staged_layout to it (and its
// grad_row_size and q8_layout to vmap_update_plan's).
int vmap_staged_size(int hidden) {
  return kernel_width(hidden) ? staged_size(hidden) : 0;
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
int vmap_train_grad(int policy, int hidden, VMAP_GRAD_PARAMS) {
  switch (hidden) {
    case 16: return vmap_train_grad_h16(policy, VMAP_GRAD_ARGS);
    case 32: return train_grad_at<32>(policy, VMAP_GRAD_ARGS);
    case 64: return vmap_train_grad_h64(policy, VMAP_GRAD_ARGS);
    case 128: return train_grad_at<128>(policy, VMAP_GRAD_ARGS);
    case 256: return train_grad_at<256>(policy, VMAP_GRAD_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

// Row-partial reduction + masked AdamW of one bank for iteration `it`;
// also writes losses[slot, it]. The rows are grad_row(hidden) floats
// (every policy's; rparam [grad_row] the parameter at each position, -1
// on padding), and the updated product weights' staged bf16 copy goes to
// ws [cap, 3, staged_size(hidden)] (the float policies' train_grad
// operand, and the int8_fwd halves' f32 backward's), or nowhere if ws is
// null (int8 / int8_static). grad_part, rparam and ws 16-byte aligned.
// The grid is update_plan.cuh's adam_loss_blocks + adam_blocks on the
// card's SM count.
int vmap_train_adamw(float* p, void* ws, const int* rparam, float* m,
                     float* v, const float* grad_part,
                     const float* loss_part, float* losses,
                     const int* active, const float* bc1, const float* bc2,
                     int hidden, int cap, int n_params, int n_rows,
                     int n_iter, int it, float lr, float decay,
                     void* stream) {
  if (cap < 1 || n_params < 1 || n_rows < 1 || it < 0 || it >= n_iter ||
      rparam == nullptr || vmap_staged_size(hidden) == 0 ||
      (reinterpret_cast<uintptr_t>(grad_part) |
       reinterpret_cast<uintptr_t>(rparam) |
       reinterpret_cast<uintptr_t>(ws)) % 16)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = (cudaError_t)sm_count(&sms);
  if (err == cudaSuccess)   // all of L1 as shared memory: ADAM_BPS blocks
    err = cudaFuncSetAttribute(adamw_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int L = adam_loss_blocks(cap);
  adamw_kernel<<<L + adam_blocks(sms, cap, hidden), ADAM_NT,
                 ADAM_STAGES * ADAM_STAGE_BYTES + 8 * ADAM_STAGES,
                 (cudaStream_t)stream>>>(
      p, static_cast<bf16*>(ws), rparam, m, v, grad_part, loss_part, losses,
      active, bc1, bc2, hidden, cap, n_params, n_rows, n_iter, it, lr, decay,
      L);
  return (int)cudaGetLastError();
}

// K1's update-step plan (update_plan.cuh update_plan) of a bank of cap
// slots at `hidden` with n_rows partial rows a slot, on the current
// card's SM count, into out[UP_N] (kernels/train_step.py UPDATE_PLAN).
// Returns a CUDA error code.
int vmap_update_plan(int hidden, int cap, int n_rows, int* out) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  return update_plan(hidden, sms, cap, n_rows, out);
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
