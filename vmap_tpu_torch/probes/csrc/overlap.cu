// K8: FMA-pipe work against tensor-core work inside one kernel
// (vmap_tpu_torch/probes/overlap.py; replaces
// scripts/microbench_overlap.py::_run, the Pallas kernel at :61-96).
//
// Two independent chains, a block owning 16 columns of both (80 blocks at
// T = 1280, 128 threads = 4 warps, one block an SM):
//   vpu: v [8, T], a thread one element in a register, 24 dependent ops a
//        step (4 rounds of vpu_round), each rounded as the script's
//        (__fmul_rn / __fadd_rn: no contraction into FFMA);
//   mxu: c [128, T] in shared memory, two dependent products a step,
//        c <- (W @ c) 1e-2, on bf16 tensor cores (mma.sync m16n8k16) with
//        the 3xbf16 split of both operands (the f32 product); a warp four
//        16 x 8 tiles of a product. W1's and W2's hi / lo copies sit in
//        shared memory (136 KB, rows padded to 136), as the script keeps
//        its weights in VMEM: read from L2 instead, the fragment loads'
//        latency, not the tensor cores, would set the product's time.
// MODE 0 vpu, 1 mxu, 2 both. In both, a step is emitted as the script's
// kernel emits it: 3 vpu ops, product 1, the other 21 vpu ops, product 2;
// the 21 ops sit between product 1's mma instructions and the stores of
// its results, so the FMA pipe can run while the tensor cores do, within
// a warp and across the warps of the SM.
// MODE 3 vpu_bal, 4 both_bal: the balanced case, not in the script. The
// script's vpu chain (4 rounds) takes about 1/27 of the mxu chain's step
// on the H100, so its overlap fraction divides the slopes' noise by a
// small time; here the vpu chain runs BAL_ROUNDS = 108 rounds a step
// (27x), about the mxu chain's time, and both_bal places half of them
// between each product's mma instructions and its stores.
//
// Bound on this card (a step): the vpu chain's 8 T x 14 FP32 operations a
// round at 33.5 Tops/s (67 TFLOP/s counts an FMA as two; these are single
// multiplies, adds, max and abs), the mxu chain's 2 x 3 x 2 x 128^2 x T
// bf16 operations at 989 TFLOP/s; both, the larger of the two.

#include "probe_common.cuh"

namespace {

constexpr int M = 128, NB = 16, THREADS = 128, LD = M + 8;
constexpr int ROUNDS = 4, BAL_ROUNDS = 108;
constexpr int WARPS = THREADS / 32, NTILE = NB / 8;
constexpr int TILES_PER_WARP = (M / 16) * NTILE / WARPS;
// dynamic shared memory: W1 hi, W1 lo, W2 hi, W2 lo [M][LD] bf16, the
// carry cF [M][NB] f32 and its column-major bf16 hi / lo copies [NB][LD]
constexpr size_t SMEM = 4 * M * LD * 2 + M * NB * 4 + 2 * NB * LD * 2;

__device__ __forceinline__ float sgn(float x) {
  return (float)((x > 0.f) - (x < 0.f));
}

// the script's vpu_step, split where its `both` kernel places product 1
__device__ __forceinline__ float vpu_first3(float v, float a, float b) {
  v = __fadd_rn(__fmul_rn(v, a), b);
  v = __fadd_rn(fabsf(v), 1e-3f);
  return fmaxf(__fmul_rn(v, 0.99f), __fmul_rn(b, 0.5f));
}
__device__ __forceinline__ float vpu_last3(float v, float a) {
  v = __fsub_rn(v, __fmul_rn(sgn(v), 1e-4f));
  v = __fmul_rn(v, __fsub_rn(1.f, __fmul_rn(v, 1e-3f)));
  return __fadd_rn(v, __fmul_rn(a, 1e-3f));
}
template <int N>
__device__ __forceinline__ float vpu_rounds(float v, float a, float b) {
#pragma unroll
  for (int rd = 0; rd < N; ++rd) v = vpu_last3(vpu_first3(v, a, b), a);
  return v;
}

// c <- (W @ c) 1e-2 for this block's columns; `between` runs after the
// products' mma instructions and before their results are stored.
template <typename F>
__device__ __forceinline__ void product(float* cF, bf16* cB, bf16* cL,
                                        const bf16* wh, const bf16* wl,
                                        F between) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  probe::carry_to_bf16<true>(cF, NB, cB, cL, LD, M, NB);
  __syncthreads();
  float acc[TILES_PER_WARP][4] = {};
#pragma unroll
  for (int i = 0; i < TILES_PER_WARP; ++i) {
    const int tile = warp + i * WARPS;
    probe::mma_tile_bf16<true>(acc[i], wh, wl, LD, cB, cL, LD,
                               tile / NTILE * 16, tile % NTILE * 8, M, lane);
  }
  between();
#pragma unroll
  for (int i = 0; i < TILES_PER_WARP; ++i) {
    const int tile = warp + i * WARPS;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = tile / NTILE * 16 + probe::acc_row(e, lane);
      const int c = tile % NTILE * 8 + probe::acc_col(e, lane);
      cF[r * NB + c] = acc[i][e] * 1e-2f;
    }
  }
  __syncthreads();
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
overlap_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const bf16* __restrict__ w1h, const bf16* __restrict__ w1l,
               const bf16* __restrict__ w2h, const bf16* __restrict__ w2l,
               const float* __restrict__ c0, float* __restrict__ vout,
               float* __restrict__ cout, int T, int reps) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16 *s1h = ws, *s1l = ws + M * LD, *s2h = ws + 2 * M * LD, *s2l = ws + 3 * M * LD;
  float* cF = reinterpret_cast<float*>(ws + 4 * M * LD);
  bf16* cB = reinterpret_cast<bf16*>(cF + M * NB);
  bf16* cL = cB + NB * LD;
  probe::stage_rows(s1h, LD, w1h, M, M);
  probe::stage_rows(s1l, LD, w1l, M, M);
  probe::stage_rows(s2h, LD, w2h, M, M);
  probe::stage_rows(s2l, LD, w2l, M, M);
  const int col0 = blockIdx.x * NB, tid = threadIdx.x;
  const size_t vi = (size_t)(tid / NB) * T + col0 + tid % NB;
  const float av = a[vi], bv = b[vi];
  float v = av * 1.0001f;
  for (int idx = tid; idx < M * NB; idx += THREADS)
    cF[idx] = c0[(size_t)(idx / NB) * T + col0 + idx % NB] * 1.0001f;
  __syncthreads();

  for (int step = 0; step < reps; ++step) {
    if constexpr (MODE == 0) {
      v = vpu_rounds<ROUNDS>(v, av, bv);
    } else if constexpr (MODE == 1) {
      product(cF, cB, cL, s1h, s1l, [] {});
      product(cF, cB, cL, s2h, s2l, [] {});
    } else if constexpr (MODE == 2) {
      v = vpu_first3(v, av, bv);
      product(cF, cB, cL, s1h, s1l, [&] {
        v = vpu_last3(v, av);
        v = vpu_rounds<ROUNDS - 1>(v, av, bv);
      });
      product(cF, cB, cL, s2h, s2l, [] {});
    } else if constexpr (MODE == 3) {
      v = vpu_rounds<BAL_ROUNDS>(v, av, bv);
    } else {
      product(cF, cB, cL, s1h, s1l,
              [&] { v = vpu_rounds<BAL_ROUNDS / 2>(v, av, bv); });
      product(cF, cB, cL, s2h, s2l,
              [&] { v = vpu_rounds<BAL_ROUNDS / 2>(v, av, bv); });
    }
  }
  vout[vi] = v;
  for (int idx = tid; idx < M * NB; idx += THREADS)
    cout[(size_t)(idx / NB) * T + col0 + idx % NB] = cF[idx];
}

template <int MODE>
int launch(const void* a, const void* b, const void* w1h, const void* w1l,
           const void* w2h, const void* w2l, const void* c0, void* vout,
           void* cout, int T, int reps, cudaStream_t s) {
  const cudaError_t err = probe::allow_smem(overlap_kernel<MODE>, SMEM);
  if (err != cudaSuccess) return (int)err;
  overlap_kernel<MODE><<<T / NB, THREADS, SMEM, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const bf16*>(w1h), static_cast<const bf16*>(w1l),
      static_cast<const bf16*>(w2h), static_cast<const bf16*>(w2l),
      static_cast<const float*>(c0), static_cast<float*>(vout),
      static_cast<float*>(cout), T, reps);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0 vpu / 1 mxu / 2 both / 3 vpu_bal / 4 both_bal; a, b, vout [8][T];
// w*h / w*l [128][128]
// bf16 (W1, W2 hi / lo); c0, cout [128][T] f32; T a multiple of 16.
extern "C" int vmap_probe_overlap(int mode, const void* a, const void* b,
                                  const void* w1h, const void* w1l,
                                  const void* w2h, const void* w2l,
                                  const void* c0, void* vout, void* cout, int T,
                                  int reps, void* stream) {
  if (T % NB || reps < 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<0>(a, b, w1h, w1l, w2h, w2l, c0, vout, cout, T, reps, s);
    case 1: return launch<1>(a, b, w1h, w1l, w2h, w2l, c0, vout, cout, T, reps, s);
    case 2: return launch<2>(a, b, w1h, w1l, w2h, w2l, c0, vout, cout, T, reps, s);
    case 3: return launch<3>(a, b, w1h, w1l, w2h, w2l, c0, vout, cout, T, reps, s);
    case 4: return launch<4>(a, b, w1h, w1l, w2h, w2l, c0, vout, cout, T, reps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
