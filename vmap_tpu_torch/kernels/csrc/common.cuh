// Constants and helpers shared by the field kernels of this directory
// (train_step.cu, ensemble.cu): the positional-encoding widths of
// n_unidir_funcs 5 and the IEEE sigmoid.

#pragma once

namespace {

constexpr int NDIR = 21;
constexpr int NBAND = 6;
constexpr int EMB = 3 + NDIR * NBAND;   // 129
constexpr int EMB1 = 3 + NDIR * 4;      // 87: xs + bands 0..3 (trunk)
constexpr int EMB2 = EMB - EMB1;        // 42: bands 4..5 (colour head)
constexpr float PI_F = 3.14159265358979323846f;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

}  // namespace
