// Constants and helpers shared by the field kernels of this directory
// (train_step.cu, ensemble.cu): the positional-encoding widths of
// n_unidir_funcs 5, the staged layout of the product weights, the shared
// memory a block and an SM may use and the IEEE sigmoid. It compiles on a
// host compiler alone too, as the plan headers that include it do
// (field_plan.cuh, update_plan.cuh).

#pragma once

#ifndef __CUDACC__
#include <math.h>
#define __host__
#define __device__
#define __forceinline__ inline
#endif
#include <stddef.h>

namespace {

constexpr int NDIR = 21;
constexpr int NBAND = 6;
constexpr int EMB = 3 + NDIR * NBAND;   // 129
constexpr int EMB1 = 3 + NDIR * 4;      // 87: xs + bands 0..3 (trunk)
constexpr int EMB2 = EMB - EMB1;        // 42: bands 4..5 (colour head)
constexpr float PI_F = 3.14159265358979323846f;

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

constexpr size_t SMEM_MAX = 232448;   // the most a block may use
// The shared memory of one SM, and what each resident block takes of it
// beyond its dynamic shared memory
constexpr size_t SM_SMEM = 233472, BLOCK_RESERVED = 1024;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

}  // namespace
