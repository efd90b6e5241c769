// The train-frame kernel under the int8 matmul policies (sm_90a, plain C
// interface, loaded with ctypes): every int8 MLP product on s8 tensor
// cores, mma.sync m16n8k32 with exact s32 sums.
//
// Replaces the int8 paths of the TPU kernel
// vmap_tpu/kernels/train_step.py::_make_kernel: quant_dyn / quant_static /
// quant_relu / quant_emb / quant_weights (:520-590), the quantised forward
// of fwd_mlp (:812, its q8f branch) and the quantised backward
// bwd_chunk_q8 (:1050). The plain version, and the statement of the scale
// granularity this kernel computes, is vmap_tpu_torch/ops/quant.py.
//
// One iteration of one bank is train_grad_q8_kernel, grid (partial row,
// slot), the float tile's grid, tile order and partial rows (train_step.cu;
// kernels/train_step.py frame_geometry): a block takes the ray tiles row,
// row + n_rows, ... of tile_rays(h, S) whole rays (kernels.MAX_POINTS: the
// int8 scale granularity, one scale per tile and tensor) and adds each
// tile's gradients to its row, the weights in the staged layout
// (grad_row), then the dirs and biases. train_adamw sums the rows in a
// fixed order (writing no staged bf16 pieces: under int8 / int8_static no
// kernel reads them); quant_weights_kernel then writes the s8 copy this
// kernel reads.
//
// The products (mma.cuh mma_s8; A row-major, k contiguous; B "col", k
// contiguous per column, so every fragment register is one 32-bit
// shared-memory load):
//   forward         out[i][p] = sum_k Wq[i][k] xq[k][p]: A the weights
//                   [i][k], B the activations point-major [p][k];
//   input grads     dx[k][p] = sum_i Wq[i][k] dq[i][p]: A the weights'
//                   transpose [k][i], B the gradient point-major [p][i];
//   weight grads    dW[i][k] = sum_p dq[i][p] xq[k][p] over the tile's
//                   points: A the gradient feature-major [i][p], B the
//                   activations feature-major [k][p].
// ldmatrix .trans moves 16-bit elements only, so an s8 operand cannot be
// transposed as it is loaded: each pass that quantises a tensor writes its
// s8 copies in the layouts its products read (the point-major copy for the
// next product, the feature-major one for the backward), and
// quant_weights_kernel writes each weight's transpose beside it. The
// contraction depths are padded with s8 zeros to whole k32 steps, which
// add exactly nothing: the embedding's 87 / 42 rows to 96 / 64, the tile's
// points to up32(P), and h=16's hidden depth of 16 to 32 (half of one k32
// step: its other half multiplies zero bytes of the weights' padded copies
// and of the point-major copies' unwritten columns, in shared memory; no
// m16n8k16 s8 path). An s8 x s8 -> s32 sum is an exact integer; it is
// converted to f32 (exactly: every sum here stays under 2^24, ops/quant.py)
// and scaled as the plain version scales it, acc * (s_a * s_b), with
// __fmul_rn / __fadd_rn so that no multiply-add is contracted.
//
// A hidden layer's epilogue (fwd_layer, bwd_layer) keeps its f32 values in
// the accumulator registers: each warp takes the abs-max of its fragments,
// one block reduction combines the warps (max is order-free, so the scale
// does not depend on the order), then each warp quantises its own values
// into the s8 copies. A hidden gradient's f32 bias gradient is summed per
// row in the same registers (quad shuffles, then one partial per row and
// column unit, added in a fixed order). Static scales skip the reduction.
// The ReLU masks are the quantised activations' (q > 0): each gradient is
// quantised in place over its activation's feature-major copy.
//
// The weights: quant_weights_kernel writes the nine QW tensors' s8
// copies, each padded to whole 16 x 32 tiles, and their transposes
// (q8_layout), with the [cap, 9] scales, after each train_adamw but the
// frame's last and once before the first iteration: each weight matrix of
// an active slot in 32-row bands, one block a band, a matrix's bands one
// thread-block cluster that takes its scales through distributed shared
// memory (update_plan.cuh). Replaces the TPU kernel's quant_weights
// (vmap_tpu/kernels/train_step.py:576-590). Its bound is bytes (the
// weights read once, the s8 copy written once: 0.0017 ms for the object
// bank), far under its chain of dependent steps a unit takes (the band's
// read, the block reduction, the cluster's exchange, the quantisation and
// the stores) and the launch.
// The tile: a block streams each product's s8 weights through a ring of
// two slabs in shared memory (16-byte cp.async copies, L2 evict_last; the
// next slab in flight while one computes), slabs of Q8Tile<H>::KS columns
// across all rows: at h=16, 32, 64 and 128 every weight of a product is
// one slab, at h=256 slabs of 64 columns (the nine tensors and their
// transposes are 690 KB a slot).
//
// Policies: INT8 (int8, int8_static) runs the backward above. INT8_FWD
// (int8_fwd, int8_static_fwd) runs the same s8 forward, keeping each
// layer's f32 ReLU output (h1..h3 in the block's activation scratch, h4 and
// hc in shared memory), then the float tile's f32 backward
// (train_step.cuh float_backward<H, F32>: three bf16 tensor-core passes
// from the staged bf16 pieces), never TF32. Static or dynamic scales are a
// runtime choice: qs points to the static (scale, 127 / maximum) pairs of
// the activations, head gradients and hidden gradients, or is null.
//
// The checked build (-DVMAP_SMEM_CHECK, mma.cuh; never shipped): each tile
// states its plan (q8_plan: the two slabs, the f32 rows, every s8 copy,
// each within the launch's dynamic shared memory, whose size is
// vmap_q8_smem's), and every shared-memory address the int8 products and
// passes form is held to the region of the buffer it was formed from:
// the slab ring's cp.async destinations (sites 1, 2), the s8 fragment
// loads (mma.cuh, 3-6), the s8 copies' writes (7-12), the masks' reads
// (13) and the bias partials (14, 15).
//
// What bounds it on the card (chip_smoke.py --sections; PERF.md §6): at
// h=256 the weight gradients, 60% of an int8 tile: the
// read-modify-write of the block's 1.33 MB partial row for every tile of
// 28 points (the scale tile; twice the float tile's tiles), about 2 TB/s;
// at h=32 / 128 the chain of block barriers: the quantisation passes and
// scale reductions 26-31% of a tile, then the products' slab steps. The
// products' own bound is far below: 3 x 11,200 s8 multiply-adds a point
// at h=32, at 1979 TOP/s.

#include "train_step_q8.cuh"

extern "C" {

// the int8 instances at the narrow widths (train_step_q8_narrow.cu): the
// entries below at h=16 and h=64
int vmap_train_grad_q8_narrow(int q8b, int hidden, VMAP_Q8_PARAMS);
int vmap_train_quant_w_narrow(const float* p, void* wq, float* wscale,
                              const int* active, const int* offsets, int cap,
                              int n_params, int hidden, void* stream);
int vmap_q8_smem_narrow(int hidden, int q8b, int S, int RT);

// The dynamic shared memory of one int8 train_grad block (q8b 1: int8 /
// int8_static, 0: the _fwd policies) at S samples and RT rays a tile, 0 at
// a width without a kernel: kernels/train_step.py q8_smem_bytes is held to
// it.
int vmap_q8_smem(int hidden, int q8b, int S, int RT) {
  switch (hidden) {
    case 32: return q8_smem_at<32>(q8b, S, RT);
    case 128: return q8_smem_at<128>(q8b, S, RT);
    case 256: return q8_smem_at<256>(q8b, S, RT);
  }
  return vmap_q8_smem_narrow(hidden, q8b, S, RT);
}

// vmap_train_grad (train_step.cu) under an int8 policy: q8b 1 for int8 /
// int8_static (the s8 backward), 0 for int8_fwd / int8_static_fwd (the
// float tile's f32 backward on ws, with the activation scratch act_part
// [cap, n_rows, 3, hidden, (RT S) | 1]). ws: the staged bf16 pieces
// [cap, 3, staged_size] (vmap_train_adamw), null under q8b; wq / wscale:
// the s8 weights [cap, q8_size] and their [cap, 9] scales
// (vmap_train_quant_w); qs: the static policies' (scale, 127 / maximum)
// pairs for activations, head gradients and hidden gradients, or null for
// dynamic scales. The partial
// rows are grad_row(hidden) floats, as the float policies'.
int vmap_train_grad_q8(int q8b, int hidden, VMAP_Q8_PARAMS) {
  switch (hidden) {
    case 32: return train_grad_q8_at<32>(q8b, VMAP_Q8_ARGS);
    case 128: return train_grad_q8_at<128>(q8b, VMAP_Q8_ARGS);
    case 256: return train_grad_q8_at<256>(q8b, VMAP_Q8_ARGS);
  }
  return vmap_train_grad_q8_narrow(q8b, hidden, VMAP_Q8_ARGS);
}

// The s8 copy wq [cap, q8_size(hidden)] (q8_layout: each QW tensor and its
// transpose, zero-padded) of the nine MLP weight tensors of every active
// slot, and their scales wscale [cap, 9], from the parameters p (p and wq
// 16-byte aligned). The grid is update_plan.cuh's q_clusters on the
// card's SM count.
int vmap_train_quant_w(const float* p, void* wq, float* wscale,
                       const int* active, const int* offsets, int cap,
                       int n_params, int hidden, void* stream) {
  if (cap < 1 || n_params < 1 || !kernel_width(hidden) ||
      (reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(wq)) %
          16)
    return (int)cudaErrorInvalidValue;
  switch (hidden) {
    case 32:
      return quant_w_at<32>(p, wq, wscale, active, offsets, cap, n_params,
                            stream);
    case 128:
      return quant_w_at<128>(p, wq, wscale, active, offsets, cap, n_params,
                             stream);
    case 256:
      return quant_w_at<256>(p, wq, wscale, active, offsets, cap, n_params,
                             stream);
  }
  return vmap_train_quant_w_narrow(p, wq, wscale, active, offsets, cap,
                                   n_params, hidden, stream);
}

#ifdef K1_PROFILE
// the int8 tile's section clocks of the measuring build (this file's
// k1_prof) into host[8], then zeroed
int vmap_k1_profile_q8(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, k1_prof, sizeof(k1_prof));
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(k1_prof, zero, sizeof(k1_prof));
}
#endif

}  // extern "C"
