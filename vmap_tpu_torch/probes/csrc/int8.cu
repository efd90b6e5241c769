// K10: chained s8 x s8 -> s32 products (vmap_tpu_torch/probes/int8.py;
// replaces scripts/microbench_int8.py::_chain, the Pallas kernel at
// :50-77). The f32 mode of the script is mm.cu's FMA chain (scale 1e-3).
//
// Modes (template MODE), wq = round(127 W) [m][k] s8:
//   1  i8: the carry is s8 (c0 = s8(clip(100 c, +-127)), truncating);
//      a step is y = wq @ c in s32, c <- s8(clip(f32(fold(y)) 1e-3, +-127));
//   2  i8_quant: the carry is f32; a step takes the per-tensor scale
//      s = max|c| / 127 + 1e-30 over the WHOLE carry, cq = rint(c (1/s)),
//      y = wq @ cq in s32, c <- f32(fold(y)) s 1e-3 (the script's op order).
//
// A block owns nb columns of the carry, as in mm.cu, and runs the products
// on mma.sync m16n8k32 (a warp one 16 x 8 tile of y at a time, the s8
// operand column-major in shared memory; wq in shared memory where it
// fits beside the carry, STAGE_W, rows padded to k + 16, else read from
// global memory).
//
// The reduction of i8_quant. On one TPU core the abs-max of the whole
// carry [k, 1280] is free; here the carry (up to 2.6 MB of f32 at k = 512)
// spans blocks, and one launch per step would time launch latency (a step
// is about 85 ns of s8 work at [128,128] x [128,1280]). The choice made:
// a thread-block CLUSTER. The blocks of one carry form one cluster (16
// blocks of 80 columns at n = 1280, cudaLaunchKernelEx with cluster dims
// and cudaFuncAttributeNonPortableClusterSizeAllowed; K1's shapes run one
// chain per block, a cluster of 1). Each step a block reduces its columns
// (warp shuffles, then one warp over the warps' maxima), writes the result
// to its shared slot (two slots, by step parity, so the slot a block
// writes is never one another block still reads), waits at one cluster
// barrier (barrier.cluster arrive / wait), and reads the 16 slots through
// distributed shared memory. Cost per step: one block barrier, one cluster
// barrier and 16 remote shared-memory loads, plus the abs-max and the
// quantisation of the block's columns; i8_quant's slope less i8's at the
// same 16-block layout is 5.78 / 12.01 / 21.97 us a step at k = 128 / 384
// / 512 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 12). A
// cooperative grid (grid.sync()) would spread the carry over all 132 SMs
// but pays a barrier through global memory per step.
//
// Bound on this card: 2 m k n operations a step at 1979 TOP/s (s8).

#include <cooperative_groups.h>

#include <algorithm>

#include "probe_common.cuh"

namespace cg = cooperative_groups;

namespace {

template <int MODE, bool STAGE_W>
__global__ void __launch_bounds__(256)
int8_chain_kernel(const int8_t* __restrict__ wq_g, const float* __restrict__ c0,
                  float* __restrict__ out, int m, int k, int n, int nb, int reps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[8];
  __shared__ float slot[2];
  const int nbp = (nb + 7) / 8 * 8;
  const int col0 = blockIdx.x * nb;
  const int ldq = probe::ldb_s8(k);
  // wq's copy (STAGE_W); then i8: two s8 carries [nbp][ldq], alternating by
  // step; i8_quant: the f32 carry cF [k][nbp] and its quantised copy cq
  const int8_t* wq = wq_g;
  int lda = k;
  size_t wbytes = 0;
  if constexpr (STAGE_W) {
    lda = probe::ldb_s8(k);
    int8_t* ws = reinterpret_cast<int8_t*>(smem);
    probe::stage_rows(ws, lda, wq_g, m, k);
    wq = ws;
    wbytes = (size_t)m * lda;
  }
  float* cF = reinterpret_cast<float*>(smem + wbytes);
  int8_t* q0 = MODE == 1 ? reinterpret_cast<int8_t*>(smem + wbytes)
                         : reinterpret_cast<int8_t*>(cF + k * nbp);
  int8_t* q1 = q0 + nbp * ldq;

  for (int idx = threadIdx.x; idx < k * nbp; idx += blockDim.x) {
    const int r = idx / nbp, c = idx - r * nbp;
    const float x = c < nb ? c0[(size_t)r * n + col0 + c] : 0.f;
    if (MODE == 1)
      q0[c * ldq + r] = (int8_t)(int)fminf(fmaxf(x * 100.f, -127.f), 127.f);
    else
      cF[idx] = x;
  }
  __syncthreads();

  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int ntile = nbp / 8, tiles = (m / 16) * ntile;
  for (int step = 0; step < reps; ++step) {
    const int8_t* cur = (MODE == 1 && (step & 1)) ? q1 : q0;
    int8_t* nxt = (MODE == 1 && (step & 1)) ? q0 : q1;
    float s = 0.f;
    if constexpr (MODE == 2) {
      float mx = 0.f;
      for (int idx = threadIdx.x; idx < k * nbp; idx += blockDim.x)
        mx = fmaxf(mx, fabsf(cF[idx]));
      for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, off));
      if (lane == 0) red[warp] = mx;
      __syncthreads();
      if (warp == 0) {
        mx = lane < nwarps ? red[lane] : 0.f;
        for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, off));
        if (lane == 0) slot[step & 1] = mx;
      }
      cluster.sync();
      mx = 0.f;
      for (unsigned r = 0; r < cluster.num_blocks(); ++r)
        mx = fmaxf(mx, cluster.map_shared_rank(slot, r)[step & 1]);
      s = mx * (float)(1.0 / 127.0) + 1e-30f;
      const float inv = 1.0f / s;
      for (int idx = threadIdx.x; idx < k * nbp; idx += blockDim.x) {
        const int r = idx / nbp, c = idx - r * nbp;
        q0[c * ldq + r] = (int8_t)(int)rintf(cF[idx] * inv);
      }
      __syncthreads();
    }
    for (int tile = warp; tile < tiles; tile += nwarps) {
      const int row0 = tile / ntile * 16, cb = tile % ntile * 8;
      int acc[4] = {0, 0, 0, 0};
      for (int k0 = 0; k0 < k; k0 += 32) {
        uint32_t a[4], b[2];
        probe::load_a_s8(a, wq, lda, row0, k0, lane);
        probe::load_b_s8(b, cur, ldq, cb, k0, lane);
        probe::mma_s8(acc, a, b);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = cb + probe::acc_col(i, lane);
        if constexpr (MODE == 1) {
          const float v = fminf(fmaxf((float)acc[i] * 1e-3f, -127.f), 127.f);
          const int8_t q = (int8_t)(int)v;
          for (int r = row0 + probe::acc_row(i, lane); r < k; r += m) nxt[c * ldq + r] = q;
        } else {
          const float v = (float)acc[i] * s * 1e-3f;
          for (int r = row0 + probe::acc_row(i, lane); r < k; r += m) cF[r * nbp + c] = v;
        }
      }
    }
    __syncthreads();
  }
  const int8_t* last = (MODE == 1 && (reps & 1)) ? q1 : q0;
  for (int idx = threadIdx.x; idx < k * nbp; idx += blockDim.x) {
    const int r = idx / nbp, c = idx - r * nbp;
    if (c < nb) out[(size_t)r * n + col0 + c] = MODE == 1 ? (float)last[c * ldq + r] : cF[idx];
  }
  // no block may leave while another still reads its slot
  cluster.sync();
}

// Shared memory of one block (probes/int8.py smem_bytes computes the same).
size_t smem_bytes(int mode, int m, int k, int nbp, bool stage_w) {
  const size_t q = (size_t)nbp * probe::ldb_s8(k);
  return (mode == 1 ? 2 * q : (size_t)k * nbp * 4 + q) +
         (stage_w ? (size_t)m * probe::ldb_s8(k) : 0);
}

template <int MODE, bool STAGE_W>
int launch_as(const int8_t* wq, const float* c0, float* out, int m, int k, int n,
              int nb, int cl, int reps, cudaStream_t stream) {
  const int nbp = probe::round_up(nb, 8);
  const size_t smem = smem_bytes(MODE, m, k, nbp, STAGE_W);
  auto kernel = int8_chain_kernel<MODE, STAGE_W>;
  cudaError_t err = probe::allow_smem(kernel, smem);
  if (err == cudaSuccess && cl > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n / nb);
  cfg.blockDim = dim3(32 * std::min(8, (m / 16) * (nbp / 8)));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, wq, c0, out, m, k, n, nb, reps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int MODE>
int launch(bool stage_w, const int8_t* wq, const float* c0, float* out, int m,
           int k, int n, int nb, int cl, int reps, cudaStream_t s) {
  return stage_w ? launch_as<MODE, true>(wq, c0, out, m, k, n, nb, cl, reps, s)
                 : launch_as<MODE, false>(wq, c0, out, m, k, n, nb, cl, reps, s);
}

}  // namespace

// mode 1 i8 / 2 i8_quant; wq [m][k] s8, c0 / out [k][n] f32 (i8: the s8
// carry's values). m a multiple of 16, k of 32; nb <= 128 dividing n; the
// n / nb blocks form clusters of cl (1..16) blocks, whose columns share
// i8_quant's scale; stage_w: wq in shared memory (refused if it does not
// fit). Returns a CUDA error code.
extern "C" int vmap_probe_int8(int mode, const void* wq, const void* c0,
                               void* out, int m, int k, int n, int nb, int cl,
                               int reps, int stage_w, void* stream) {
  if (m % 16 || k % 32 || nb < 1 || nb > 128 || n % nb || cl < 1 || cl > 16 ||
      (n / nb) % cl || reps < 0 || mode < 1 || mode > 2 ||
      smem_bytes(mode, m, k, probe::round_up(nb, 8), stage_w) > probe::SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const int8_t*>(wq);
  auto c = static_cast<const float*>(c0);
  auto o = static_cast<float*>(out);
  if (mode == 1) return launch<1>(stage_w, w, c, o, m, k, n, nb, cl, reps, s);
  return launch<2>(stage_w, w, c, o, m, k, n, nb, cl, reps, s);
}
