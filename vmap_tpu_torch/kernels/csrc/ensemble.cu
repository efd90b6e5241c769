// Hand-written CUDA field kernels: the forward field query of a bank of
// occupancy MLPs at arbitrary points (meshing, vertex colours, the field
// training path) and its hand-derived backward (sm_90a, plain C interface,
// loaded with ctypes).
//
// Replaces the TPU kernels of vmap_tpu/kernels/ensemble.py:
//   field_fwd_kernel   <- _make_fwd_kernel, launched by _run_fwd       (K2)
//   field_bwd_kernel + field_wgrad_kernel
//                      <- _make_bwd_kernel, launched by _fused_train_bwd (K3)
// and field_stage_kernel writes the bf16 pieces both read.
//
// The function, per object and point (the prepared parameters of
// kernels/ensemble.py prepare_params, packed one row an object):
//   xs = pts / scale, proj = dirs xs, emb = [xs; sin(pi 2^b proj), b < 6]
//   h1 = relu(W_in emb_a + b), h2 = relu(W_mid1 h1 + b),
//   h3 = relu(W_cat_h h2 + W_cat_x emb_a + b), h4 = relu(W_mid2 h3 + b),
//   alpha = 10 (W_alpha h4 + b), c = relu(W_col_h h4 + W_col_x emb_b + b),
//   colour = sigmoid(W_out c + b).
//
// The products run on tensor cores: mma.sync m16n8k16, bf16 operands, f32
// accumulation (mma.cuh), never TF32. float32 is split into bf16 pieces
// (x = p0 + p1 (+ p2), mma_pieces): K2's products and K3's input and
// weight gradients three passes of two pieces, each within (3 2^-16 + K
// 2^-24) sum_k |a_k b_k| of the exact product; K3's recomputed forward six
// passes of three, within (4 + K) 2^-24, as K1 bwd_bf16's forward, each 16
// columns' six passes summed in a fresh accumulator and added to the
// layer's sum in f32 (round to nearest, outside the tensor cores, whose
// own accumulation truncates): K3's ReLU masks must fall where the f32
// plain version's do, and a pre-activation put on the other side of 0
// moves a gradient by a whole point's share, beyond phase 6's K3 bar
// (tests/test_torch_field_design.py: a three-pass forward misses it).
// The weights are the seven product matrices in train_step.cuh's staged
// layout (each [up16(n_out)][up16(n_in)], the concat layers whole), three
// bf16 pieces an element, written by field_stage_kernel from the packed
// f32 row (the wrapper keeps them while the weights do not change).
// Activations live
// in shared memory as bf16 pieces, feature by feature ([piece][row]
// [P + 8], points fastest), so every fragment is one ldmatrix; a layer's
// sums stay in the accumulators until its last product step, then
// overwrite the layer's input: one H-row activation buffer and a 96-row
// embedding region per tile. The embedding region holds emb_a (87 rows,
// 9 zero) for the first three layers, then emb_b (42 rows, 6 zero). The
// PE's projection and sines stay f32 on the FMA pipe: K2 the double-angle
// ladder from sincospif (it holds phase 6's tiers and ran no slower than
// sinpif at any width, PERF.md), K3 sinpif each band (its ReLU masks want
// the most accurate embedding); the build uses no fast math.
//
// The tiles, shared-memory plans and grids are field_plan.cuh's; the
// launchers size each grid from the card's SM count.
//
// K2 field_fwd_kernel: a 1-D grid of blocks (at most SMs x MINB), block b
// taking the items [b N / G, (b + 1) N / G) of the N = O n_tiles (object,
// point tile) pairs in order, so the card is filled whatever the objects
// and points. At h=32 a block (two an SM, 64-point tiles: one's barriers
// hide in the other's work) holds the object's whole weights in shared
// memory (57 KB as pieces), staged once per object it meets; at h=128 and
// h=256 (0.4 / 1.3 MB) each product streams its pieces through a ring of
// two slabs of KF columns (cp.async, L2 evict_last), the next in flight
// while one computes.
//
// K3 in two kernels:
//   field_bwd_kernel, grid (block, object), 512 threads, a block taking a
//     run of an object's point tiles: the forward as K2 (each activation
//     also saved as pieces to the scratch, point-contiguous rows, and
//     h1..h4's ReLU masks kept as bits in shared memory), the cotangents
//     (d alpha-layer = 10 g_alpha, d logits = g_c s (1 - s), 0 past M),
//     and the input gradients dx = W^T d (A = W^T by ldmatrix .trans), the
//     ReLU masks applied in the epilogue from those bits (c's from its
//     activation), each pre-activation gradient saved too; the band
//     gradients (W_cat_x's and W_in's added first) folded through
//     pi 2^b cospif(2^b proj) into the projection's, the bias and dirs
//     gradients summed in shared memory over the block's tiles and written
//     once, to rest_part[object, block];
//   field_wgrad_kernel, grid (output tile x split, object): each block one
//     128-column (32 / 128-row) tile of one weight's gradient, sum_p d[i][p]
//     x[k][p] over a split's points (whole units of tile_m, or of its
//     halves where that fills the card), three passes from the scratch's
//     pieces through a 4-stage cp.async ring of 32-point steps, written
//     once to part[object, split]. The wrapper sums the splits and the
//     blocks' rest rows in a fixed order: no atomics, two launches
//     bit-equal.
// The weight gradients cannot stay on chip over a block's points at
// h=128 / 256 (0.4 / 1.3 MB a row), so they are one product over the
// points after the tiles, not a partial row read and written per tile.
//
// What bounds them on the card (chip_smoke.py phases 6 and 8; PERF.md):
// the products are 3 x 11,200 / 100,000 / 331,000 multiply-adds a point at
// h = 32 / 128 / 256 (bf16 at 989 TFLOP/s) and, at h=32, the PE's 126
// sines a point on the FMA / SFU pipes about as much; mma.sync issue, the
// fragment loads and the slab steps' barriers set the time, 4-8 x the
// bound. K3 runs 12 passes to K2's 3, its forward-and-input-gradient pass
// most of its time, and moves its scratch, (176 + 10 h) rows x 4 bytes a
// point, written once and read once.

#include "ensemble.cuh"

namespace {

// the staged pieces [O][WP][NS] of the packed prepared rows
__global__ void __launch_bounds__(256)
field_stage_kernel(const float* __restrict__ params, int n_params, Prep off,
                   int H, bf16* __restrict__ ws) {
  const int o = blockIdx.y, NS = staged_size(H);
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx >= NS) return;
  int m = 0;
  while (idx >= mat_off(H, m + 1)) ++m;
  const int C = mat_cols(H, m), r = (idx - mat_off(H, m)) / C;
  const int c = (idx - mat_off(H, m)) % C;
  const float* W = params + (size_t)o * n_params;
  float v = 0.f;
  switch (m) {
    case M_IN:
      if (c < EMB1) v = W[off.w_in + r * EMB_PAD + c];
      break;
    case M_MID1: v = W[off.w_mid1 + r * H + c]; break;
    case M_CAT:
      if (c < H)
        v = W[off.w_cat_h + r * H + c];
      else if (c < H + EMB1)
        v = W[off.w_cat_x + r * EMB_PAD + c - H];
      break;
    case M_MID2: v = W[off.w_mid2 + r * H + c]; break;
    case M_ALPHA:
      if (r < 1) v = W[off.w_alpha + c];
      break;
    case M_COL:
      if (c < H)
        v = W[off.w_col_h + r * H + c];
      else if (c < H + EMB2)
        v = W[off.w_col_x + r * EMB_PAD + c - H];
      break;
    default:
      if (r < 3) v = W[off.w_out + r * H + c];
  }
  store_one<WP>(ws + (size_t)o * WP * NS, NS, idx, v);
}

static_assert(PLAN_INVALID == (int)cudaErrorInvalidValue,
              "field_plan.cuh's refusal is cudaErrorInvalidValue");

}  // namespace

extern "C" {

// the field kernels at the narrow widths (ensemble_narrow.cu): the entries
// below at h=16 and h=64, their arguments checked and the SM count read
int vmap_field_fwd_narrow(int hidden, const float* params,
                          const int* offsets, int n_params, const void* ws,
                          const float* scale, const float* pts, int O, int M,
                          int sms, float* alpha, float* color, void* stream);
int vmap_field_bwd_narrow(int hidden, const float* params,
                          const int* offsets, int n_params, const void* ws,
                          const float* scale, const float* pts,
                          const float* g_alpha, const float* g_color, int O,
                          int M, int tile_m, int sms, void* scratch,
                          float* rest_part, void* stream);
int vmap_field_wgrad_narrow(int hidden, const void* scratch, int O, int M,
                            int tile_m, int sms, float* part, void* stream);

// The bf16 pieces ws [O, 3, staged_size(hidden)] (the staged layout of
// common.cuh; plane i piece i of mma.cuh split) of the packed prepared rows
// params [O, n_params] (offsets[17] into a row), which field_fwd and
// field_bwd read. Returns a cudaError_t code (0 on success).
int vmap_field_stage(int hidden, const float* params, const int* offsets,
                     int n_params, int O, void* ws, void* stream) {
  if (bad_shape(hidden, offsets, n_params, O, 1) || !kernel_width(hidden))
    return (int)cudaErrorInvalidValue;
  const int NS = staged_size(hidden);
  field_stage_kernel<<<dim3((NS + 255) / 256, O), 256, 0,
                       (cudaStream_t)stream>>>(
      params, n_params, make_prep(offsets), hidden, static_cast<bf16*>(ws));
  return (int)cudaGetLastError();
}

// The plan of a launch on O objects x M points with K3's weight gradients
// summed in units of tile_m points, on the current device's SMs, into
// out[PL_N] (field_plan.cuh PlanField): the grids the entries below
// launch and the sizes of the buffers they write. Returns a cudaError_t
// code (0 on success).
int vmap_field_plan(int hidden, int O, int M, int tile_m, int* out) {
  int sms = 0;
  const int err = sm_count(&sms);
  return err ? err : field_plan(hidden, sms, O, M, tile_m, out);
}

// K2: alpha [O, M] (x10 applied) and colour [O, M, 3] (sigmoid applied) of
// every object's field at its points pts [O, M, 3], on the plan's blocks;
// params [O, n_params] packed prepared rows (the biases and dirs read), ws
// their pieces (vmap_field_stage), scale [O]. Returns a cudaError_t code
// (0 on success).
int vmap_field_fwd(int hidden, const float* params, const int* offsets,
                   int n_params, const void* ws, const float* scale,
                   const float* pts, int O, int M, float* alpha,
                   float* color, void* stream) {
  int sms = 0;
  if (const int err = sm_count(&sms)) return err;
  // (K2 sums no weight gradients: any valid tile_m)
  if (bad_shape(hidden, offsets, n_params, O, M) ||
      !plan_args_ok(sms, O, M, WG_KP))
    return (int)cudaErrorInvalidValue;
  const Prep off = make_prep(offsets);
  const bf16* w = static_cast<const bf16*>(ws);
  cudaStream_t st = (cudaStream_t)stream;
#define VMAP_FWD(HH)                                                      \
  launch_fwd<HH>(params, n_params, off, w, scale, pts, O, M, sms, alpha, \
                 color, st)
  if (hidden == 32) return VMAP_FWD(32);
  if (hidden == 128) return VMAP_FWD(128);
  if (hidden == 256) return VMAP_FWD(256);
#undef VMAP_FWD
  return vmap_field_fwd_narrow(hidden, params, offsets, n_params, ws, scale,
                               pts, O, M, sms, alpha, color, stream);
}

// K3, first kernel: the forward and input gradients of every object's Mp
// points (the plan's), writing the activations and pre-activation
// gradients as two pieces to scratch [O, 2, scratch rows, Mp] and each
// block's bias and dirs gradients to rest_part [O, blocks an object, rest
// floats] (the plan's sizes for the same O, M, tile_m).
int vmap_field_bwd(int hidden, const float* params, const int* offsets,
                   int n_params, const void* ws, const float* scale,
                   const float* pts, const float* g_alpha,
                   const float* g_color, int O, int M, int tile_m,
                   void* scratch, float* rest_part, void* stream) {
  int sms = 0;
  if (const int err = sm_count(&sms)) return err;
  if (bad_shape(hidden, offsets, n_params, O, M) ||
      !plan_args_ok(sms, O, M, tile_m))
    return (int)cudaErrorInvalidValue;
  const Prep off = make_prep(offsets);
  const bf16* w = static_cast<const bf16*>(ws);
  bf16* scr = static_cast<bf16*>(scratch);
  cudaStream_t st = (cudaStream_t)stream;
#define VMAP_BWD(HH)                                                         \
  launch_bwd<HH>(params, n_params, off, w, scale, pts, g_alpha, g_color, O,  \
                 M, tile_m, sms, scr, rest_part, st)
  if (hidden == 32) return VMAP_BWD(32);
  if (hidden == 128) return VMAP_BWD(128);
  if (hidden == 256) return VMAP_BWD(256);
#undef VMAP_BWD
  return vmap_field_bwd_narrow(hidden, params, offsets, n_params, ws, scale,
                               pts, g_alpha, g_color, O, M, tile_m, sms,
                               scratch, rest_part, stream);
}

// K3, second kernel: every weight's gradient from the scratch, split over
// the plan's runs of whole units of points, into part [O, splits,
// staged_size(hidden)] (the staged layout, padding 0).
int vmap_field_wgrad(int hidden, const void* scratch, int O, int M,
                     int tile_m, float* part, void* stream) {
  int sms = 0;
  if (const int err = sm_count(&sms)) return err;
  if (!plan_args_ok(sms, O, M, tile_m)) return (int)cudaErrorInvalidValue;
  const bf16* scr = static_cast<const bf16*>(scratch);
  cudaStream_t st = (cudaStream_t)stream;
  if (hidden == 32)
    return launch_wgrad<32>(scr, O, M, tile_m, sms, part, st);
  if (hidden == 128)
    return launch_wgrad<128>(scr, O, M, tile_m, sms, part, st);
  if (hidden == 256)
    return launch_wgrad<256>(scr, O, M, tile_m, sms, part, st);
  return vmap_field_wgrad_narrow(hidden, scratch, O, M, tile_m, sms, part,
                                 stream);
}

}  // extern "C"
