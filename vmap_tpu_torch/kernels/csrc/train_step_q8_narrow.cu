// K1's int8 tile and train_quant_w at h=16 and h=64 (train_step_q8.cuh):
// the int8 entries' instances at these widths, in a translation unit of
// their own (the build compiles each source beside the others).

#include "train_step_q8.cuh"

extern "C" {

int vmap_q8_smem_narrow(int hidden, int q8b, int S, int RT) {
  if (hidden == 16) return q8_smem_at<16>(q8b, S, RT);
  if (hidden == 64) return q8_smem_at<64>(q8b, S, RT);
  return 0;
}

int vmap_train_grad_q8_narrow(int q8b, int hidden, VMAP_Q8_PARAMS) {
  if (hidden == 16) return train_grad_q8_at<16>(q8b, VMAP_Q8_ARGS);
  if (hidden == 64) return train_grad_q8_at<64>(q8b, VMAP_Q8_ARGS);
  return (int)cudaErrorInvalidValue;
}

int vmap_train_quant_w_narrow(const float* p, void* wq, float* wscale,
                              const int* active, const int* offsets, int cap,
                              int n_params, int hidden, void* stream) {
  if (hidden == 16)
    return quant_w_at<16>(p, wq, wscale, active, offsets, cap, n_params,
                          stream);
  if (hidden == 64)
    return quant_w_at<64>(p, wq, wscale, active, offsets, cap, n_params,
                          stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
