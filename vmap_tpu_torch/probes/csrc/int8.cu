// K10: chained s8 x s8 -> s32 products (vmap_tpu_torch/probes/int8.py;
// replaces scripts/microbench_int8.py::_chain, the Pallas kernel at
// :50-77). The f32 mode of the script is mm.cu's FMA chain (scale 1e-3).
//
// Modes (wq = round(127 W) [m][k] s8):
//   1  i8: the carry is s8 (c0 = s8(clip(100 c, +-127)), truncating, laid
//      out by int8.py); a step is y = wq @ c in s32, c <- s8(clip(f32(
//      fold(y)) 1e-3, +-127));
//   2  i8_quant: the carry is f32; a step takes the per-tensor scale
//      s = max|c| / 127 + 1e-30 over the WHOLE carry (K1's shapes: over its
//      chain's), cq = rint(c (1/s)), y = wq @ cq in s32, c <- f32(fold(y))
//      s 1e-3 (the script's op order).
//
// int8_chain_kernel<V, N, REG> is chain.cuh's wgmma_chain on m64nNk32 s8
// products with s32 accumulation (the sums exact, so i8 is bit-equal to
// its plain version), on the plan probes/mm.py takes from the card. In the
// grid regime i8_quant's scale comes in the same exchange as the fold:
// each block's epilogue takes the abs-max of the values it writes, one
// atomicMax a block folds it into the step's slot in global memory, and
// the grid barrier that publishes the carry publishes the slot; the next
// step quantises each staged f32 chunk of the carry into wgmma's s8 layout
// as it arrives. So the chain spreads over the whole card, not over one
// cluster of 16 blocks. In the block regime (K1's shapes, a scale a
// chain) the block reduces its own carry.
//
// Bound on this card: 2 m k n operations a step at 1979 TOP/s (s8), plus
// i8_quant's 5 FP32 operations a carry element.

#include "chain.cuh"

namespace {

using chain::Plan;

template <int V, int N, int REG>
__global__ void __launch_bounds__(512, 1)
int8_chain_kernel(Plan p, const unsigned char* __restrict__ wq, unsigned char* __restrict__ cb0,
                  unsigned char* __restrict__ cb1, float* __restrict__ out,
                  unsigned* __restrict__ ws) {
  chain::wgmma_chain<V, N, REG>(p, wq, cb0, cb1, out, ws, 1.f);
}

// The (regime, warpgroup width) pairs built (probes/mm.py BUILT): the
// block plan's 16-column slabs and K1's chains, the grid plans of
// i8_quant (and i8 on them), the cluster plan of i8 at [512, 512].
template <int V>
int launch(const Plan& p, const unsigned char* w, unsigned char* c0, unsigned char* c1,
           float* out, unsigned* ws, cudaStream_t s) {
#define I8_K(reg, n)                                                                        \
  if (p.grid == reg && p.N == n)                                                            \
    return chain::launch_plan(int8_chain_kernel<V, n, reg>, p, V, s, p, w, c0, c1, out, ws);
  I8_K(chain::BLOCK, 16) I8_K(chain::BLOCK, 48) I8_K(chain::BLOCK, 64)
  I8_K(chain::GRID, 32) I8_K(chain::GRID, 80)
  if constexpr (V == chain::I8) {
    I8_K(chain::CLUSTER, 80)
  }
#undef I8_K
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// mode 1 i8 / 2 i8_quant; `plan` the 15 ints of chain::Plan (probes/mm.py
// PLAN_FIELDS); wq: the s8 weights laid out for the plan; cb0: c0 laid out
// as the plan's carry (i8: its s8 pieces; i8_quant: f32), overwritten in
// the grid regime; cb1: the grid's second buffer; out [k][n] f32 (i8: the
// s8 carry's values); ws: zeroed, 4 bytes x (reps + 2). Returns a CUDA
// error code, as vmap_probe_mm.
extern "C" int vmap_probe_int8(int mode, const void* wq, void* cb0, void* cb1, void* out,
                               void* ws, const int* plan, void* stream) {
  const Plan p = chain::read_plan(plan);
  const int v = mode == 1 ? chain::I8 : chain::I8Q;
  if (mode < 1 || mode > 2 || !chain::plan_ok(p, v, 16)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const unsigned char*>(wq);
  auto c0 = static_cast<unsigned char*>(cb0);
  auto c1 = static_cast<unsigned char*>(cb1);
  auto o = static_cast<float*>(out);
  auto u = static_cast<unsigned*>(ws);
  if (mode == 1) return launch<chain::I8>(p, w, c0, c1, o, u, s);
  return launch<chain::I8Q>(p, w, c0, c1, o, u, s);
}
