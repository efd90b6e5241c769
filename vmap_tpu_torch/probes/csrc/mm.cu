// K4: chained matrix products, y = sum_j W_j @ c, c <- fold(y) * scale
// (vmap_tpu_torch/probes/mm.py; replaces scripts/microbench_mm.py::_one,
// the Pallas kernel at :27-48). Also the f32 mode of K10
// (scripts/microbench_int8.py, scale 1e-3, one product a step).
//
// A block owns nb columns of the carry c [k, n] (W @ c is separable by
// column): it holds them in shared memory (cF [k][nbp], nbp = nb rounded up
// to the mma tile's 8, the padding zero) for the whole chain, so steps
// need nothing from other blocks. W sits in shared memory where it fits
// beside the carry (STAGE_W: the script's W is in VMEM, and K1 keeps its
// weights in shared memory; bf16 rows padded to k + 8), else it is read
// from global memory each step (L2 resident: up to 6.5 MB f32 at 1280^2).
// The wrapper decides (probes/mm.py smem_bytes) and the launcher refuses
// a staging that does not fit.
//
// Variants (template V):
//   0  f32: FP32 FMA, a thread 4 rows x 4 columns of y (W^T read as float4
//      over rows, c as float4 broadcasts from shared memory); y goes to a
//      shared buffer, then the fold writes the carry;
//   1  bf16: the carry rounded to bf16 each step (column-major copy in
//      shared memory), mma.sync m16n8k16 with f32 accumulation, a warp one
//      16 x 8 tile of y at a time;
//   2  3xbf16: as 1 with hi / lo copies of both operands, three products.
// The ind products of a step are summed in order (y = y_0 + y_1 + ...),
// then scaled, as the script's kernel does.
//
// Bound on this card: 2 m k n ind operations a step at 67 TFLOP/s (f32)
// or 989 (bf16; 3xbf16 does three times the bf16 work); at K1's sizes a
// step is well under a microsecond of work, so a chain of dependent steps
// is latency-bound (block barriers, shared-memory round trips), which is
// what the probe measures.

#include <algorithm>

#include "probe_common.cuh"

namespace {

template <int V, bool STAGE_W>
__global__ void __launch_bounds__(256)
mm_chain_kernel(const float* __restrict__ wt_g, const bf16* __restrict__ whi_g,
                const bf16* __restrict__ wlo_g, const float* __restrict__ c0,
                float* __restrict__ out, int m, int k, int n, int nb, int ind,
                int reps, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nbp = (nb + 7) / 8 * 8;
  const int col0 = blockIdx.x * nb;
  // W's copy (STAGE_W), then the carry and its buffers
  const float* wt = wt_g;
  const bf16* whi = whi_g;
  const bf16* wlo = wlo_g;
  int lda = k;                                                // W's bf16 rows
  size_t wbytes = 0;
  if constexpr (STAGE_W) {
    if constexpr (V == 0) {
      float* ws = reinterpret_cast<float*>(smem);             // [ind][k][m]
      probe::stage_rows(ws, m, wt_g, ind * k, m);
      wt = ws;
      wbytes = (size_t)ind * k * m * 4;
    } else {
      lda = probe::ldb_bf16(k);
      bf16* hs = reinterpret_cast<bf16*>(smem);               // [ind][m][lda]
      probe::stage_rows(hs, lda, whi_g, ind * m, k);
      whi = hs;
      wbytes = (size_t)ind * m * lda * 2;
      if constexpr (V == 2) {
        bf16* ls = hs + (size_t)ind * m * lda;
        probe::stage_rows(ls, lda, wlo_g, ind * m, k);
        wlo = ls;
        wbytes *= 2;
      }
    }
  }
  float* cF = reinterpret_cast<float*>(smem + wbytes);       // [k][nbp]
  float* yS = cF + k * nbp;                                   // [m][nbp] (V 0)
  const int ldb = probe::ldb_bf16(k);
  bf16* cB = reinterpret_cast<bf16*>(cF + k * nbp);           // [nbp][ldb]
  bf16* cL = cB + nbp * ldb;                                  // (V 2)

  for (int idx = threadIdx.x; idx < k * nbp; idx += blockDim.x) {
    const int r = idx / nbp, c = idx - r * nbp;
    cF[idx] = c < nb ? c0[(size_t)r * n + col0 + c] : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int step = 0; step < reps; ++step) {
    if constexpr (V == 0) {
      const int cgroups = nbp / 4, items = (m / 4) * cgroups;
      for (int it = threadIdx.x; it < items; it += blockDim.x) {
        const int r0 = it / cgroups * 4, cc = it % cgroups * 4;
        float acc[4][4];
        for (int j = 0; j < ind; ++j) {
          float a[4][4] = {};
          const float* wp = wt + (size_t)j * k * m + r0;
#pragma unroll 4
          for (int kk = 0; kk < k; ++kk) {
            const float4 w4 = *reinterpret_cast<const float4*>(wp + (size_t)kk * m);
            const float4 c4 = *reinterpret_cast<const float4*>(cF + kk * nbp + cc);
            const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
            const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int q = 0; q < 4; ++q) a[i][q] = fmaf(wv[i], cv[q], a[i][q]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][q] = j == 0 ? a[i][q] : acc[i][q] + a[i][q];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) yS[(r0 + i) * nbp + cc + q] = acc[i][q] * scale;
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < k * nbp; idx += blockDim.x) {
        const int r = idx / nbp, c = idx - r * nbp;
        cF[idx] = yS[(r % m) * nbp + c];
      }
      __syncthreads();
    } else {
      probe::carry_to_bf16<V == 2>(cF, nbp, cB, cL, ldb, k, nbp);
      __syncthreads();
      const int ntile = nbp / 8, tiles = (m / 16) * ntile;
      for (int tile = warp; tile < tiles; tile += nwarps) {
        const int row0 = tile / ntile * 16, cb = tile % ntile * 8;
        float acc[4];
        for (int j = 0; j < ind; ++j) {
          float a[4] = {0.f, 0.f, 0.f, 0.f};
          probe::mma_tile_bf16<V == 2>(a, whi + (size_t)j * m * lda,
                                       wlo + (size_t)j * m * lda, lda, cB, cL,
                                       ldb, row0, cb, k, lane);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i] = j == 0 ? a[i] : acc[i] + a[i];
        }
        // the carry is not read until the next step's conversion: write
        // the fold of this tile straight into it
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = acc[i] * scale;
          const int c = cb + probe::acc_col(i, lane);
          for (int r = row0 + probe::acc_row(i, lane); r < k; r += m) cF[r * nbp + c] = v;
        }
      }
      __syncthreads();
    }
  }
  for (int idx = threadIdx.x; idx < k * nbp; idx += blockDim.x) {
    const int r = idx / nbp, c = idx - r * nbp;
    if (c < nb) out[(size_t)r * n + col0 + c] = cF[idx];
  }
}

// Shared memory of one block: W's copy (if staged), the carry and its
// buffers (probes/mm.py smem_bytes computes the same).
size_t smem_bytes(int V, int m, int k, int nbp, int ind, bool stage_w) {
  const int split = V == 2 ? 2 : 1;
  size_t bytes = (size_t)k * nbp * 4;
  bytes += V == 0 ? (size_t)m * nbp * 4 : (size_t)nbp * probe::ldb_bf16(k) * 2 * split;
  if (stage_w)
    bytes += V == 0 ? (size_t)ind * k * m * 4 : (size_t)ind * m * probe::ldb_bf16(k) * 2 * split;
  return bytes;
}

template <int V, bool STAGE_W>
int launch_as(const float* wt, const bf16* whi, const bf16* wlo, const float* c0,
           float* out, int m, int k, int n, int nb, int ind, int reps,
           float scale, cudaStream_t stream) {
  const int nbp = probe::round_up(nb, 8);
  const size_t smem = smem_bytes(V, m, k, nbp, ind, STAGE_W);
  const int threads = V == 0 ? std::min(256, probe::round_up((m / 4) * (nbp / 4), 32))
                             : 32 * std::min(8, (m / 16) * (nbp / 8));
  cudaError_t err = probe::allow_smem(mm_chain_kernel<V, STAGE_W>, smem);
  if (err != cudaSuccess) return (int)err;
  mm_chain_kernel<V, STAGE_W><<<n / nb, threads, smem, stream>>>(
      wt, whi, wlo, c0, out, m, k, n, nb, ind, reps, scale);
  return (int)cudaGetLastError();
}

template <int V>
int launch(bool stage_w, const float* wt, const bf16* whi, const bf16* wlo,
           const float* c0, float* out, int m, int k, int n, int nb, int ind,
           int reps, float scale, cudaStream_t s) {
  return stage_w ? launch_as<V, true>(wt, whi, wlo, c0, out, m, k, n, nb, ind, reps, scale, s)
                 : launch_as<V, false>(wt, whi, wlo, c0, out, m, k, n, nb, ind, reps, scale, s);
}

}  // namespace

// variant 0 f32 / 1 bf16 / 2 3xbf16; wt [ind][k][m] f32 (variant 0), whi /
// wlo [ind][m][k] bf16 (1: whi; 2: both); c0 / out [k][n] f32. m, k
// multiples of 16, nb <= 64 dividing n, ind 1..4; stage_w: W in shared
// memory (refused if it does not fit). Returns a CUDA error code.
extern "C" int vmap_probe_mm(int variant, const void* wt, const void* whi,
                             const void* wlo, const void* c0, void* out, int m,
                             int k, int n, int nb, int ind, int reps,
                             float scale, int stage_w, void* stream) {
  if (m % 16 || k % 16 || nb < 1 || nb > 64 || n % nb || ind < 1 || ind > 4 ||
      reps < 0 || variant < 0 || variant > 2 ||
      smem_bytes(variant, m, k, probe::round_up(nb, 8), ind, stage_w) > probe::SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const float*>(wt);
  auto hi = static_cast<const bf16*>(whi);
  auto lo = static_cast<const bf16*>(wlo);
  auto c = static_cast<const float*>(c0);
  auto o = static_cast<float*>(out);
  switch (variant) {
    case 0: return launch<0>(stage_w, w, hi, lo, c, o, m, k, n, nb, ind, reps, scale, s);
    case 1: return launch<1>(stage_w, w, hi, lo, c, o, m, k, n, nb, ind, reps, scale, s);
    default: return launch<2>(stage_w, w, hi, lo, c, o, m, k, n, nb, ind, reps, scale, s);
  }
}
