// K8: FMA-pipe work against tensor-core work inside one kernel
// (vmap_tpu_torch/probes/overlap.py; replaces
// scripts/microbench_overlap.py::_run, the Pallas kernel at :61-96).
//
// Two independent chains, a block owning NB = 16 columns of both (the
// slab overlap.py `plan` cuts from the card: 80 blocks at T = 1280, one an
// SM), 128 threads = one warpgroup:
//   vpu: v [8, T], a thread one element in a register, 24 dependent ops a
//        step (4 rounds of vpu_round), each rounded as the script's
//        (__fmul_rn / __fadd_rn: no contraction into FFMA);
//   mxu: two dependent products a step, c <- (W @ c) 1e-2, [128, 128] x
//        [128, T], on wgmma m64n16k16 bf16 with f32 accumulation and the
//        3xbf16 split of both operands (W lo c hi, W hi c lo, W hi c hi into
//        one accumulator, the small terms first: the f32 product). W1's and
//        W2's hi / lo pieces stay in shared memory for the whole chain in
//        wgmma's no-swizzle K-major layout (chain.cuh tc_off; overlap.py
//        w_layout), as the script keeps its weights in VMEM; the carry's hi
//        / lo pieces (the B operand, two buffers) are written by each
//        product's fold straight into that layout from the accumulators, so
//        no conversion pass and one barrier a product.
// MODE 0 vpu, 1 mxu, 2 both. A product's 48 wgmma are issued and committed
// as one group, then the vpu ops placed "inside" it run, then
// wgmma.wait_group: the ops run on the FMA pipe in the same warps while the
// tensor cores work (they touch no accumulator register, so ptxas keeps
// the products asynchronous, with no serialisation warning; in the SASS it
// interleaves the vpu chain with the 48 HGMMA's issue, whatever their
// order in the source). In both, a step is emitted as the script's kernel
// emits it: 3 vpu ops, product 1 with the other 21 ops inside it, product
// 2.
// MODE 3 vpu_bal, 4 both_bal: the balanced case, not in the script. The
// script's vpu chain (4 rounds) takes about 1/27 of the mxu chain's step
// on the H100, so its overlap fraction divides the slopes' noise by a
// small time; here the vpu chain runs BAL_ROUNDS = 108 rounds a step
// (27x), about the mxu chain's time, and both_bal places half of them
// inside each product.
//
// Bound on this card (a step): the vpu chain's 8 T x 14 FP32 operations a
// round at 33.5 Tops/s (67 TFLOP/s counts an FMA as two; these are single
// multiplies, adds, max and abs), the mxu chain's 2 x 3 x 2 x 128^2 x T
// bf16 operations at 989 TFLOP/s; both, the larger of the two. A step of
// mxu is two dependent products of 48 small wgmma each, so its latency
// (issue, the tensor cores' pipeline, the fold and its barrier), not the
// tensor cores' rate, sets it.

#include "chain.cuh"

namespace {

constexpr int M = 128, NB = 16, THREADS = 128;
constexpr int ROUNDS = 4, BAL_ROUNDS = 108;
// shared memory: W1 hi, W1 lo, W2 hi, W2 lo (M x M bf16 pieces), then two
// carry buffers of hi, lo (NB x M bf16 pieces), then the W barrier
constexpr uint32_t W_PIECE = M * M * 2, C_PIECE = NB * M * 2;
constexpr uint32_t W_BYTES = 4 * W_PIECE, C_BUF = 2 * C_PIECE;
constexpr size_t SMEM = W_BYTES + 2 * C_BUF + 16;
constexpr uint32_t SBO = 8 * M * 2;  // between 8-row groups of a depth-M piece

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

// c <- (W @ c) 1e-2 for this block's columns: `w` the descriptor of W's hi
// piece (lo W_PIECE past it), `cur` the carry's (lo C_PIECE past it); the
// products
// are committed as one group, v <- inside(v) runs while they are in flight,
// then the fold writes the new carry's hi / lo into the buffer `nxt`
// (LAST: the f32 carry to cout).
template <bool LAST, typename F>
__device__ __forceinline__ void product(uint64_t w, uint64_t cur, bf16* nxt, float& v, F inside,
                                        float* __restrict__ cout, int T, int col0) {
  float acc[2][8];  // two m-tiles of 64 rows; written by the first product (scale_d 0)
  chain::fence_acc(acc[0]);
  chain::fence_acc(acc[1]);
  chain::wgmma_fence();
  // descriptors: the start address (16-byte units) in the low bits, so an
  // offset of `off` bytes adds off / 16
#pragma unroll
  for (int ks = 0; ks < M / 16; ++ks)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const uint64_t a = w + (mt * 64 * M * 2 + ks * 256) / 16, b = cur + ks * 256 / 16;
      chain::Wgmma<16>::bf16(acc[mt], a + W_PIECE / 16, b, ks > 0);
      chain::Wgmma<16>::bf16(acc[mt], a, b + C_PIECE / 16, 1);
      chain::Wgmma<16>::bf16(acc[mt], a, b, 1);
    }
  chain::wgmma_commit();
  v = inside(v);
  chain::wgmma_wait_all();
  chain::fence_acc(acc[0]);
  chain::fence_acc(acc[1]);
  // accumulator element 4 j + e: row 16 warp + lane / 4 + 8 (e / 2) of the
  // m-tile, column 8 j + 2 (lane % 4) + e % 2 (chain.cuh Wgmma)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mt * 64 + 16 * warp + (lane >> 2) + 8 * (e >> 1);
        const int c = 8 * j + 2 * (lane & 3) + (e & 1);
        const float y = acc[mt][4 * j + e] * 1e-2f;
        if constexpr (LAST) {
          cout[(size_t)r * T + col0 + c] = y;
        } else {
          const bf16 hi = __float2bfloat16_rn(y);
          const int at = chain::tc_off(c, r, M, 8);
          nxt[at] = hi;
          nxt[C_PIECE / 2 + at] = __float2bfloat16_rn(y - __bfloat162float(hi));
        }
      }
  if constexpr (!LAST) {  // the carry's generic writes, read by the next wgmma
    probe::fence_proxy_async();
    __syncthreads();
  }
}

// a, b, vout: [8][T]; w: W1 hi, W1 lo, W2 hi, W2 lo pieces (overlap.py
// w_layout); cl: the initial carry's hi / lo pieces a slab (overlap.py
// carry_layout); c0, cout: [M][T] f32 (c0 read by the vpu modes, whose c
// is 1.0001 c0).
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
overlap_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const bf16* __restrict__ w, const bf16* __restrict__ cl,
               const float* __restrict__ c0, float* __restrict__ vout,
               float* __restrict__ cout, int T, int reps) {
  constexpr bool MXU = MODE == 1 || MODE == 2 || MODE == 4;
  const int col0 = blockIdx.x * NB, tid = threadIdx.x;
  const size_t vi = (size_t)(tid / NB) * T + col0 + tid % NB;
  const float av = a[vi], bv = b[vi];
  float v = av * 1.0001f;
  if constexpr (!MXU) {
    for (int step = 0; step < reps; ++step)
      v = vpu_rounds<MODE == 0 ? ROUNDS : BAL_ROUNDS>(v, av, bv);
    for (int idx = tid; idx < M * NB; idx += THREADS) {
      const size_t at = (size_t)(idx / NB) * T + col0 + idx % NB;
      cout[at] = c0[at] * 1.0001f;
    }
  } else {
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + W_BYTES + 2 * C_BUF);
    if (tid == 0) {
      probe::mbar_init(bar, 1);
      probe::fence_proxy_async();
    }
    __syncthreads();
    if (tid == 0) {
      probe::mbar_arrive_expect_tx(bar, W_BYTES + C_BUF);
      probe::bulk_g2s(smem, w, W_BYTES, bar);
      probe::bulk_g2s(smem + W_BYTES, cl + (size_t)blockIdx.x * (C_BUF / 2), C_BUF, bar);
    }
    chain::mbar_wait(bar, 0);
    const uint32_t base = probe::smem_u32(smem);
    const uint64_t w1 = chain::desc(base, SBO), w2 = chain::desc(base + 2 * W_PIECE, SBO);
    const uint64_t c1 = chain::desc(base + W_BYTES, SBO), c2 = chain::desc(base + W_BYTES + C_BUF, SBO);
    bf16* cs = reinterpret_cast<bf16*>(smem + W_BYTES);
    for (int step = 0; step < reps; ++step) {
      // product 1 reads buffer 0 and writes buffer 1, product 2 the reverse
      if constexpr (MODE == 2) v = vpu_first3(v, av, bv);
      product<false>(w1, c1, cs + C_BUF / 2, v, [&](float x) {
        if constexpr (MODE == 2) x = vpu_rounds<ROUNDS - 1>(vpu_last3(x, av), av, bv);
        if constexpr (MODE == 4) x = vpu_rounds<BAL_ROUNDS / 2>(x, av, bv);
        return x;
      }, cout, T, col0);
      const auto inside2 = [&](float x) {
        if constexpr (MODE == 4) x = vpu_rounds<BAL_ROUNDS / 2>(x, av, bv);
        return x;
      };
      if (step == reps - 1)
        product<true>(w2, c2, cs, v, inside2, cout, T, col0);
      else
        product<false>(w2, c2, cs, v, inside2, cout, T, col0);
    }
  }
  vout[vi] = v;
}

template <int MODE>
int launch(const void* a, const void* b, const void* w, const void* cl, const void* c0,
           void* vout, void* cout, int T, int reps, cudaStream_t s) {
  constexpr bool MXU = MODE == 1 || MODE == 2 || MODE == 4;
  const size_t smem = MXU ? SMEM : 0;
  const cudaError_t err = probe::allow_smem(overlap_kernel<MODE>, smem);
  if (err != cudaSuccess) return (int)err;
  overlap_kernel<MODE><<<T / NB, THREADS, smem, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const bf16*>(w),
      static_cast<const bf16*>(cl), static_cast<const float*>(c0), static_cast<float*>(vout),
      static_cast<float*>(cout), T, reps);
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0 vpu / 1 mxu / 2 both / 3 vpu_bal / 4 both_bal; a, b, vout [8][T]
// f32; w the 4 pieces of W1 / W2 hi / lo (overlap.py w_layout); cl the
// initial carry's pieces, [T / nb][hi, lo][nb x 128] bf16 (overlap.py
// carry_layout); c0, cout [128][T] f32; nb the plan's slab, which must be
// the 16 columns this kernel is built for (one element a thread); reps >= 1
// for the products.
extern "C" int vmap_probe_overlap(int mode, const void* a, const void* b, const void* w,
                                  const void* cl, const void* c0, void* vout, void* cout,
                                  int T, int nb, int reps, void* stream) {
  if (nb != NB || T % NB || reps < 1) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<0>(a, b, w, cl, c0, vout, cout, T, reps, s);
    case 1: return launch<1>(a, b, w, cl, c0, vout, cout, T, reps, s);
    case 2: return launch<2>(a, b, w, cl, c0, vout, cout, T, reps, s);
    case 3: return launch<3>(a, b, w, cl, c0, vout, cout, T, reps, s);
    case 4: return launch<4>(a, b, w, cl, c0, vout, cout, T, reps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
