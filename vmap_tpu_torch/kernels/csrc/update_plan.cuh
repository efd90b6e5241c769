// K1's update step's plan: train_adamw (train_step.cu adamw_kernel) and
// train_quant_w (train_step_q8.cu quant_weights_kernel). The one statement
// of the partial-gradient row, the s8 weights' layout, both kernels' runs,
// bands, clusters, ring, shared memory and grids, and train_adamw's
// summation order: the launchers size their grids from it and
// vmap_update_plan gives the wrapper (kernels/train_step.py update_plan)
// its values. It compiles on a host compiler alone too
// (tests/test_torch_update_design.py builds it with g++ and holds the
// bands, runs, alignment and grids at the H100's 132 SMs).

#pragma once

#include "common.cuh"

namespace {

// ---- the partial-gradient row (every policy): the product weights'
// gradients in the staged layout (the 16-byte writes of wgrad_mma /
// wgrad_s8), then the other parameters, the dirs and biases, which lead the
// parameter layout (BankSpec: the PE's dirs, then the MLP's names sorted,
// b_* before w_*): parameter j < rest_size(H) at staged_size(H) + j.
// grad_row floats, a multiple of 16, so every row starts 64-byte aligned.
// kernels/train_step.py grad_row_index gives each parameter's place and
// grad_row_param its inverse (the parameter at each place, -1 on the
// staged layout's zero padding and the row's tail).
__host__ __device__ constexpr int rest_size(int H) {
  return 3 * NDIR + 5 * H + 4;   // dirs, five [H] biases, b_alpha, b_col_out
}
__host__ __device__ constexpr int grad_row(int H) {
  return staged_size(H) + up16(rest_size(H));
}

// ---- the staged s8 weights (kernels/train_step.py q8_layout): the nine
// quantised tensors of a slot (ops/quant.py QW_NAMES); per slot, for each
// tensor [n_out][n_in] in order, its copy [up16(n_out)][up32(n_in)]
// row-major, then its transpose [up16(n_in)][up32(n_out)], zero-padded
// (every block a multiple of 512 bytes, so 16-byte aligned)
enum QW : int {
  QW_IN, QW_MID1, QW_CAT_H, QW_CAT_X, QW_MID2, QW_ALPHA, QW_COL_H, QW_COL_X,
  QW_OUT, NQW
};
__host__ __device__ constexpr int up32(int x) { return (x + 31) / 32 * 32; }
__host__ __device__ constexpr int qw_out(int H, int t) {
  return t == QW_ALPHA ? 1 : t == QW_OUT ? 3 : H;
}
__host__ __device__ constexpr int qw_in(int H, int t) {
  return t == QW_IN || t == QW_CAT_X ? EMB1 : t == QW_COL_X ? EMB2 : H;
}
__host__ __device__ constexpr int qw_off(int H, int t) {
  int s = 0;
  for (int i = 0; i < t; ++i)
    s += up16(qw_out(H, i)) * up32(qw_in(H, i)) +
         up16(qw_in(H, i)) * up32(qw_out(H, i));
  return s;
}
__host__ __device__ constexpr int qwt_off(int H, int t) {
  return qw_off(H, t) + up16(qw_out(H, t)) * up32(qw_in(H, t));
}
__host__ __device__ constexpr int q8_size(int H) { return qw_off(H, NQW); }

// ---- train_adamw (adamw_kernel). The row positions of a slot are cut
// into runs of ADAM_RUN (the last one shorter, a multiple of 16 floats),
// an item (slot, run) numbered slot * adam_runs + run. A block of ADAM_NT
// threads takes the items b, b + G, ... (G blocks), skipping inactive
// slots, so no block works for one. The block streams its items' rows
// through a ring of ADAM_STAGES stages in shared memory, each stage
// ADAM_RS rows of one run (fewer for an item's last), each row one TMA
// 1-D bulk copy of the run (2 KB, 64-byte aligned: rows and runs are
// multiples of 16 floats) completing on the stage's mbarrier: thread 0
// issues, every thread consumes, and the stage is refilled with the
// stream's stage ADAM_STAGES ahead (the next item's rows once an item's
// are all issued) after a block barrier. Thread i sums positions i, i +
// ADAM_NT, i + 2 ADAM_NT, i + 3 ADAM_NT of the run, so that a warp's reads
// and writes of p, m and v are whole runs of the parameters; the staged
// pieces go through shared memory to thread i's positions 4i .. 4i + 3,
// one 8-byte store a plane. The sizes are the card's best of the variants
// tried (PERF.md §6 PR 12): two stages of 8 rows beat four of 4 (and four
// of 8 rows of 1 KB runs), which paid a barrier and a wait for every 8 KB.
// Its summation order: position q's gradient is
//   g = (((0 + row_0[q]) + row_1[q]) + ...) + row_{n_rows-1}[q],
// each + one f32 add, rows in row order (kernels/train_step.py row_sum is
// the plain version). The loss: adam_loss_blocks blocks before the G that
// stream, one warp a slot (a block of the stream that waited on a slot's
// loss held its ring up; dispatched first, they hold back only the last
// streaming blocks, those with the fewest items, for their one read), lane
// l summing loss_part[s, l], [s, l + 32], ... in order, then the 32 lane
// sums by a shuffle butterfly of offsets 16, 8, 4, 2, 1
// (kernels/train_step.py loss_sum).
constexpr int ADAM_NT = 128, ADAM_V = 4, ADAM_RUN = ADAM_V * ADAM_NT;
constexpr int ADAM_RS = 8, ADAM_STAGES = 2;
constexpr int ADAM_BPS = 6;   // blocks an SM (the launch bound asks for it)
constexpr size_t ADAM_STAGE_BYTES = (size_t)4 * ADAM_RS * ADAM_RUN;
// the ring and the stages' mbarriers (dynamic), the pieces' exchange
// (static)
constexpr size_t ADAM_SMEM =
    ADAM_STAGES * ADAM_STAGE_BYTES + 8 * ADAM_STAGES + 4 * ADAM_RUN;

__host__ __device__ constexpr int adam_runs_of(int ng) {
  return (ng + ADAM_RUN - 1) / ADAM_RUN;
}
__host__ __device__ constexpr int adam_runs(int H) {
  return adam_runs_of(grad_row(H));
}
// positions [run ADAM_RUN, run ADAM_RUN + adam_run_len) of a slot's rows
// of ng = grad_row(H) floats (the kernel passes ng, which it takes once:
// at a width known only at run time grad_row is a loop over the matrices)
__host__ __device__ constexpr int adam_run_len_of(int ng, int run) {
  return ng - run * ADAM_RUN < ADAM_RUN ? ng - run * ADAM_RUN : ADAM_RUN;
}
__host__ __device__ constexpr int adam_run_len(int H, int run) {
  return adam_run_len_of(grad_row(H), run);
}
__host__ __device__ constexpr int adam_chunks(int n_rows) {
  return (n_rows + ADAM_RS - 1) / ADAM_RS;
}
// the blocks that sum the losses, a warp a slot
__host__ __device__ constexpr int adam_loss_blocks(int cap) {
  return (cap + ADAM_NT / 32 - 1) / (ADAM_NT / 32);
}
// the streaming blocks: one wave of sms x ADAM_BPS, fewer where the bank
// has fewer items
inline int adam_blocks(int sms, int cap, int H) {
  const long long items = (long long)cap * adam_runs(H);
  const long long wave = (long long)sms * ADAM_BPS;
  return (int)(items < wave ? items : wave);
}

// ---- train_quant_w (quant_weights_kernel). A slot's weights are NQM
// source matrices of the parameter layout, each one or two QW tensors
// (w_cat and w_col: the hidden columns, then the embedding's), and a
// matrix is cut into bands of QBAND rows: band k holds its rows 32k ..
// 32k + 31 (the 1-row w_alpha and 3-row w_col_out one band, at k = 0). A
// matrix's bands form one thread-block cluster of q_cluster(H) blocks,
// block k of the cluster band k: at h=32 a block alone (the matrix is one
// band; launched as no cluster: a launch of the object bank's 728 blocks
// as clusters of one took longer on the card), at h=128 a cluster of 4
// and at h=256 of 8 (portable sizes), so every width runs the same 32-row
// band, the background's one slot at h=128 gets 28 blocks, not 7, and
// h=256's w_cat band (32 x 343 floats) is 44 KB of a block's shared
// memory. A cluster takes the units (slot,
// matrix) u = c, c + G, ... (G clusters), skipping inactive slots. Per unit
// a block:
//   1. copies its band's rows, one contiguous span of the slot's
//      parameters (band rows are whole rows of the matrix), into shared
//      memory with 16-byte cp.async from the 16-byte boundary at or before
//      the span (element by element past the last whole 16 bytes of the
//      parameters), each weight read once;
//   2. takes each of its tensors' abs-max after the fold (fold_w: the
//      fold of each column class's raw maximum, the same bits, since the
//      fold is a positive constant a class and rounding is monotonic), one
//      block reduction for both; the cluster's blocks exchange theirs
//      through distributed shared memory (a cluster barrier, then lane r
//      of warp 0 reads block r's by map_shared_rank, then the barrier's
//      arrive, its wait at the unit's end, so that no block overwrites its
//      maxima while another reads them) and each takes the max of all:
//      max is order-free, so every block and the plain version have the
//      same scale, bit for bit; block 0 writes it;
//   3. quantises its band of each tensor into an s8 copy band
//      [32][up32(n_in)] and a transpose band [up16(n_in)][32] (rows QTRS
//      bytes apart) in shared memory (zero where the tensor has no
//      element), then, after one barrier, writes them all as 16-byte
//      stores: a copy band's rows are one contiguous range of the copy, a
//      transpose band 32 bytes of each transpose row.
// A warp takes 4 band rows and 32 columns at a time (lane = column): 4
// bytes of each copy row, one 4-byte word of each transpose row, on 32
// distinct banks (QTRS / 4 = 9 is odd). No integer division per element.
// Threads (q_threads): h=32's 700 blocks of the object bank in one wave
// of 128-thread blocks; the few blocks of h=128 and h=256 (28 and 56 for
// one slot) 256 and 512 (128 was slower on the card, and 1024 too: the
// band's steps are latency, not work).
constexpr int QBAND = 32, NQM = 7;
constexpr int QTRS = 36;   // the transpose band's row stride in shared memory
enum QMat : int { QM_IN, QM_MID1, QM_CAT, QM_MID2, QM_ALPHA, QM_COL, QM_OUT };

__host__ __device__ constexpr int q_cluster(int H) { return H / QBAND; }
__host__ __device__ constexpr int q_threads(int H) {
  return H == 32 ? 128 : H == 128 ? 256 : 512;
}
__host__ __device__ constexpr int qm_rows(int H, int m) {
  return m == QM_ALPHA ? 1 : m == QM_OUT ? 3 : H;
}
// the matrix's row stride in the parameters (floats)
__host__ __device__ constexpr int qm_ld(int H, int m) {
  return m == QM_IN    ? EMB1
         : m == QM_CAT ? H + EMB1
         : m == QM_COL ? H + EMB2
                       : H;
}
// its first QW tensor and their count
__host__ __device__ constexpr int qm_first(int m) {
  return m == QM_IN     ? QW_IN
         : m == QM_MID1 ? QW_MID1
         : m == QM_CAT  ? QW_CAT_H
         : m == QM_MID2 ? QW_MID2
         : m == QM_ALPHA ? QW_ALPHA
         : m == QM_COL  ? QW_COL_H
                        : QW_OUT;
}
__host__ __device__ constexpr int qm_count(int m) {
  return m == QM_CAT || m == QM_COL ? 2 : 1;
}
// QW tensor t's first column in its matrix, and which static row scale
// folds into it (1: the trunk's embedding columns, 2: the colour head's)
__host__ __device__ constexpr int qw_col0(int H, int t) {
  return t == QW_CAT_X || t == QW_COL_X ? H : 0;
}
__host__ __device__ constexpr int qw_fold(int t) {
  return t == QW_IN || t == QW_CAT_X ? 1 : t == QW_COL_X ? 2 : 0;
}
__host__ __device__ constexpr int clip_band(int n) {
  return n < 0 ? 0 : n > QBAND ? QBAND : n;
}
// band k of matrix m: its source rows, its copy rows (padding rows
// included) and whether it writes a transpose slice (columns 32k .. 32k +
// 31 of the transposes' up32(n_out))
__host__ __device__ constexpr int q_src_rows(int H, int m, int k) {
  return clip_band(qm_rows(H, m) - QBAND * k);
}
__host__ __device__ constexpr int q_copy_rows(int H, int m, int k) {
  return clip_band(up16(qm_rows(H, m)) - QBAND * k);
}
__host__ __device__ constexpr bool q_has_tr(int H, int m, int k) {
  return QBAND * k < up32(qm_rows(H, m));
}

// a block's shared memory: the band's f32 span (its rows from a 16-byte
// boundary: at most 3 floats before it and 3 after it), the s8 copy and
// transpose bands of the matrix's tensors, then the block's maxima [2]
// (which the cluster reads) and its warps' [2][q_threads / 32]
__host__ __device__ constexpr int q_max_ld(int H) {
  int l = 0;
  for (int m = 0; m < NQM; ++m) l = qm_ld(H, m) > l ? qm_ld(H, m) : l;
  return l;
}
__host__ __device__ constexpr size_t q_stage_bytes(int H) {
  return ((size_t)4 * (QBAND * q_max_ld(H) + 8) + 15) / 16 * 16;
}
// one tensor's s8 bands (the copy band, then the transpose band), to 16
// bytes; a matrix's tensors' bands one after the other
__host__ __device__ constexpr int q_s8_band(int H, int t) {
  return (QBAND * up32(qw_in(H, t)) + up16(qw_in(H, t)) * QTRS + 15) / 16 *
         16;
}
__host__ __device__ constexpr size_t q_s8_bytes(int H) {
  size_t b = 0;
  for (int m = 0; m < NQM; ++m) {
    size_t n = 0;
    for (int i = 0; i < qm_count(m); ++i) n += q_s8_band(H, qm_first(m) + i);
    b = n > b ? n : b;
  }
  return b;
}
// the maxima [2] and the warps' [2][q_threads / 32] after the bands
__host__ __device__ constexpr size_t q_smem(int H) {
  return q_stage_bytes(H) + q_s8_bytes(H) + 4 * (2 + 2 * (q_threads(H) / 32));
}
// blocks an SM: by shared memory and by registers, 64 a thread (the
// launch bound asks for them: h=32's 700 blocks of the object bank one
// wave of 8 an SM)
__host__ __device__ constexpr int q_bps(int H) {
  return (int)(SM_SMEM / (q_smem(H) + BLOCK_RESERVED)) <
                 65536 / (64 * q_threads(H))
             ? (int)(SM_SMEM / (q_smem(H) + BLOCK_RESERVED))
             : 65536 / (64 * q_threads(H));
}
// clusters of a launch: one wave of sms x q_bps blocks, fewer where the
// bank has fewer units, at least one
inline int q_clusters(int sms, int cap, int H) {
  const long long units = (long long)cap * NQM;
  long long wave = (long long)sms * q_bps(H) / q_cluster(H);
  if (wave < 1) wave = 1;
  return (int)(units < wave ? units : wave);
}

template <int H>
constexpr bool update_plans_fit() {
  return ADAM_SMEM <= 48 * 1024 &&
         ADAM_BPS * (ADAM_SMEM + BLOCK_RESERVED) <= SM_SMEM &&
         ADAM_RUN % 16 == 0 && grad_row(H) % 16 == 0 &&
         staged_size(H) % ADAM_V == 0 && q_smem(H) <= SMEM_MAX &&
         q_bps(H) >= 1 && q_cluster(H) >= 1 && q_cluster(H) <= 8 &&
         H % QBAND == 0 && q8_size(H) % 16 == 0;
}
static_assert(update_plans_fit<32>() && update_plans_fit<128>() &&
                  update_plans_fit<256>(),
              "an update kernel's plan exceeds what it counts on");

// ---- vmap_update_plan's output, in this order (kernels/train_step.py
// UPDATE_PLAN names it)
enum UpdateField : int {
  UP_ADAM_THREADS, UP_ADAM_RUN, UP_ADAM_ROWS_A_STAGE, UP_ADAM_STAGES,
  UP_ADAM_SMEM, UP_ADAM_BLOCKS_PER_SM, UP_ADAM_RUNS, UP_ADAM_CHUNKS,
  UP_ADAM_BLOCKS, UP_ADAM_LOSS_BLOCKS, UP_Q_THREADS, UP_Q_BAND_ROWS,
  UP_Q_CLUSTER, UP_Q_SMEM, UP_Q_BLOCKS_PER_SM, UP_Q_CLUSTERS, UP_GRAD_ROW,
  UP_Q8_SIZE, UP_N
};
constexpr int UPDATE_INVALID = 1;   // cudaErrorInvalidValue

// The plan of a bank of cap slots at width H with n_rows partial rows a
// slot on `sms` SMs into out[UP_N]; UPDATE_INVALID for a width without
// kernels or arguments the kernels refuse
inline int update_plan(int H, int sms, int cap, int n_rows, int* out) {
  if ((H != 32 && H != 128 && H != 256) || sms < 1 || cap < 1 ||
      n_rows < 1)
    return UPDATE_INVALID;
  out[UP_ADAM_THREADS] = ADAM_NT;
  out[UP_ADAM_RUN] = ADAM_RUN;
  out[UP_ADAM_ROWS_A_STAGE] = ADAM_RS;
  out[UP_ADAM_STAGES] = ADAM_STAGES;
  out[UP_ADAM_SMEM] = (int)ADAM_SMEM;
  out[UP_ADAM_BLOCKS_PER_SM] = ADAM_BPS;
  out[UP_ADAM_RUNS] = adam_runs(H);
  out[UP_ADAM_CHUNKS] = adam_chunks(n_rows);
  out[UP_ADAM_BLOCKS] = adam_blocks(sms, cap, H);
  out[UP_ADAM_LOSS_BLOCKS] = adam_loss_blocks(cap);
  out[UP_Q_THREADS] = q_threads(H);
  out[UP_Q_BAND_ROWS] = QBAND;
  out[UP_Q_CLUSTER] = q_cluster(H);
  out[UP_Q_SMEM] = (int)q_smem(H);
  out[UP_Q_BLOCKS_PER_SM] = q_bps(H);
  out[UP_Q_CLUSTERS] = q_clusters(sms, cap, H);
  out[UP_GRAD_ROW] = grad_row(H);
  out[UP_Q8_SIZE] = q8_size(H);
  return 0;
}

// ---- a band's writes, for the CPU test: band k of matrix m at width H
// into out[QB_N] per tensor of the matrix (out[i * QB_N + ...], i <
// qm_count): the QW tensor, its first column in the matrix, its columns,
// fold, source rows and first row, copy rows, its copy band's byte offset
// in the slot (qw_off + 32k up32(n_in)) and bytes, and its transpose
// slice's (qwt_off + 32k, then every up32(n_out) bytes, up16(n_in) rows
// of 32 bytes; -1 if the band writes none). Returns the tensor count, 0
// for arguments outside the plan.
enum BandField : int {
  QB_T, QB_COL0, QB_COLS, QB_FOLD, QB_ROW0, QB_SRC_ROWS, QB_COPY_ROWS,
  QB_COPY_OFF, QB_COPY_BYTES, QB_TR_OFF, QB_TR_STRIDE, QB_TR_ROWS, QB_N
};
inline int quant_band(int H, int m, int k, int* out) {
  if ((H != 32 && H != 128 && H != 256) || m < 0 || m >= NQM || k < 0 ||
      k >= q_cluster(H))
    return 0;
  for (int i = 0; i < qm_count(m); ++i) {
    const int t = qm_first(m) + i;
    int* o = out + i * QB_N;
    o[QB_T] = t;
    o[QB_COL0] = qw_col0(H, t);
    o[QB_COLS] = qw_in(H, t);
    o[QB_FOLD] = qw_fold(t);
    o[QB_ROW0] = QBAND * k;
    o[QB_SRC_ROWS] = q_src_rows(H, m, k);
    o[QB_COPY_ROWS] = q_copy_rows(H, m, k);
    o[QB_COPY_OFF] = qw_off(H, t) + QBAND * k * up32(qw_in(H, t));
    o[QB_COPY_BYTES] = q_copy_rows(H, m, k) * up32(qw_in(H, t));
    o[QB_TR_OFF] = q_has_tr(H, m, k) ? qwt_off(H, t) + QBAND * k : -1;
    o[QB_TR_STRIDE] = up32(qw_out(H, t));
    o[QB_TR_ROWS] = q_has_tr(H, m, k) ? up16(qw_in(H, t)) : 0;
  }
  return qm_count(m);
}

}  // namespace
