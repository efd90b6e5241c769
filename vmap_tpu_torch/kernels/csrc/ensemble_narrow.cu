// The field kernels K2 and K3 at h=16 and h=64 (ensemble.cuh): the
// instances of ensemble.cu's entries at these widths, in a translation
// unit of their own (the build compiles each source beside the others).
// The entries have checked the arguments and read the SM count.

#include "ensemble.cuh"

extern "C" {

int vmap_field_fwd_narrow(int hidden, const float* params,
                          const int* offsets, int n_params, const void* ws,
                          const float* scale, const float* pts, int O, int M,
                          int sms, float* alpha, float* color, void* stream) {
  const Prep off = make_prep(offsets);
  const bf16* w = static_cast<const bf16*>(ws);
  cudaStream_t st = (cudaStream_t)stream;
  if (hidden == 16)
    return launch_fwd<16>(params, n_params, off, w, scale, pts, O, M, sms,
                          alpha, color, st);
  if (hidden == 64)
    return launch_fwd<64>(params, n_params, off, w, scale, pts, O, M, sms,
                          alpha, color, st);
  return (int)cudaErrorInvalidValue;
}

int vmap_field_bwd_narrow(int hidden, const float* params,
                          const int* offsets, int n_params, const void* ws,
                          const float* scale, const float* pts,
                          const float* g_alpha, const float* g_color, int O,
                          int M, int tile_m, int sms, void* scratch,
                          float* rest_part, void* stream) {
  const Prep off = make_prep(offsets);
  const bf16* w = static_cast<const bf16*>(ws);
  bf16* scr = static_cast<bf16*>(scratch);
  cudaStream_t st = (cudaStream_t)stream;
  if (hidden == 16)
    return launch_bwd<16>(params, n_params, off, w, scale, pts, g_alpha,
                          g_color, O, M, tile_m, sms, scr, rest_part, st);
  if (hidden == 64)
    return launch_bwd<64>(params, n_params, off, w, scale, pts, g_alpha,
                          g_color, O, M, tile_m, sms, scr, rest_part, st);
  return (int)cudaErrorInvalidValue;
}

int vmap_field_wgrad_narrow(int hidden, const void* scratch, int O, int M,
                            int tile_m, int sms, float* part, void* stream) {
  const bf16* scr = static_cast<const bf16*>(scratch);
  cudaStream_t st = (cudaStream_t)stream;
  if (hidden == 16)
    return launch_wgrad<16>(scr, O, M, tile_m, sms, part, st);
  if (hidden == 64)
    return launch_wgrad<64>(scr, O, M, tile_m, sms, part, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
