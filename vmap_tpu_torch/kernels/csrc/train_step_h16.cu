// K1's float tile at h=16 (train_grad.cuh), under the three float policies
// with and without sample_reuse: vmap_train_grad's instances at this width,
// in a translation unit of its own (the build compiles each source
// beside the others).

#include "train_grad.cuh"

extern "C" int vmap_train_grad_h16(int policy, VMAP_GRAD_PARAMS) {
  return train_grad_at<16>(policy, VMAP_GRAD_ARGS);
}
