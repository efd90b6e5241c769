// K4: chained matrix products, y = sum_j W_j @ c, c <- fold(y) * scale
// (vmap_tpu_torch/probes/mm.py; replaces scripts/microbench_mm.py::_one,
// the Pallas kernel at :27-48). Also the f32 mode of K10
// (scripts/microbench_int8.py, scale 1e-3, one product a step) and K5's
// fwd_mm / fwd_mm_bf16 (scripts/microbench_ops.py:149-157).
//
// The plan (chain.cuh: the block, grid and cluster regimes, the ring, the
// layouts) is taken from the card by probes/mm.py `plan`; this file holds
// the two product engines and the launcher.
//
//   mm_chain_kernel<V, NW, REG> (V 1 bf16, 2 3xbf16; REG the regime):
//     chain.cuh's wgmma_chain, a warpgroup 64 rows of W by NW columns,
//     m64nNk16 bf16 products with f32 accumulation, A (W) and B (the
//     carry's bf16 copies, which the fold writes straight into wgmma's
//     layout) from shared memory; 3xbf16 takes three products a k step (W
//     lo carry hi, W hi carry lo, W hi carry hi: the small terms first)
//     into one accumulator;
//   mm_fma_kernel<ITEMS, IND> (f32): FP32 FMA, IEEE, never TF32. Up to
//     512 threads (the plan's: enough for one or ITEMS 4 x 4 tiles a
//     thread); a thread owns 4 rows x 4 ITEMS columns of y (one row group,
//     ITEMS column groups), the threads of a warp walking the panel's rows
//     first (W^T's float4 reads of a k row conflict-free, read once for the
//     thread's ITEMS groups; the carry's float4 broadcast); W^T and the
//     carry's chunk [kc][N] in shared memory. The ind products of a step
//     (W_j = W (1 + 0.001 j)) are accumulated apart and summed in order j,
//     then scaled, as the script's kernel does.
//
// Bound on this card: 2 m k n ind operations a step at 67 TFLOP/s (f32),
// 989 (bf16; 3xbf16 three times the bf16 work). What the plans do about it:
// every SM has work each step (the slabs and panels are cut from the SM
// count), W stays in shared memory for the whole chain wherever it fits
// (read from L2 once, not once a step), and a step's exchange is none
// (block regime), shared-to-shared copies in a cluster (cluster regime) or
// one grid barrier (grid regime).

#include <algorithm>

#include "chain.cuh"

namespace {

using chain::Plan;

template <int V, int NW, int REG>
__global__ void __launch_bounds__(NW >= 128 ? 256 : 512, 1)
mm_chain_kernel(Plan p, const unsigned char* __restrict__ w, unsigned char* __restrict__ cb0,
                unsigned char* __restrict__ cb1, float* __restrict__ out,
                unsigned* __restrict__ ws, float scale) {
  chain::wgmma_chain<V, NW, REG>(p, w, cb0, cb1, out, ws, scale);
}

template <int ITEMS, int IND>
__global__ void __launch_bounds__(512, 1)
mm_fma_kernel(Plan p, const float* __restrict__ w, float* __restrict__ cb0,
              float* __restrict__ cb1, float* __restrict__ out, unsigned* __restrict__ ws,
              float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const chain::Regions R = chain::regions(smem, p, chain::F32);
  const int tid = threadIdx.x;
  const int panel = p.grid ? blockIdx.x / p.slabs : 0;
  const int slab = p.grid ? blockIdx.x % p.slabs : blockIdx.x;
  const int m = p.m, k = p.k, kc = p.kc, N = p.N, rows = p.rows, ind = p.ind;
  const int nq = (p.grid || !p.w_resident) ? k / kc : 0;
  const long total = (long)p.reps * nq;
  const auto* wb = reinterpret_cast<const unsigned char*>(w);
  auto* c0b = reinterpret_cast<unsigned char*>(cb0);
  auto* c1b = reinterpret_cast<unsigned char*>(cb1);
  chain::load_resident(p, chain::F32, R, wb, c0b, panel, slab, (size_t)k * N * 4);
  if (!p.grid && tid == 0)
    for (long gi = 0; gi < p.stages && gi < total; ++gi)
      chain::issue_chunk(p, chain::F32, R, gi, nq, wb, c0b, c1b, panel, slab);

  // this thread's tiles: one row group (4 rows of y) and ITEMS column
  // groups (4 columns each, tpr apart): W^T's float4 of a k row is read
  // once for all of them
  const int rgroups = rows / 4, tpr = blockDim.x / rgroups, cgroups = N / 4;
  const int r0 = 4 * (tid % rgroups), cg0 = tid / rgroups;
  const bool active = tid < rgroups * tpr;
  int cc[ITEMS], cr[ITEMS];  // a column group, and where it is read (a group
  bool on[ITEMS];            // past the slab reads the thread's first, unused)
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    cc[i] = 4 * (cg0 + i * tpr);
    on[i] = active && cg0 + i * tpr < cgroups;
    cr[i] = on[i] ? cc[i] : 4 * cg0;
  }
  const size_t wj = (size_t)k * rows;  // W_j's stride (resident)
  long g = 0;
  unsigned nbar = 0;
  for (int step = 0; step < p.reps; ++step) {
    const bool last = step == p.reps - 1;
    if (p.grid && tid == 0)
      for (int q = 0; q < p.stages && q < nq; ++q)
        chain::issue_chunk(p, chain::F32, R, g + q, nq, wb, c0b, c1b, panel, slab);
    float acc[IND][ITEMS][16];
#pragma unroll
    for (int j = 0; j < IND; ++j)
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[j][i][e] = 0.f;
    const int chunks = nq ? nq : 1;
    for (int q = 0; q < chunks; ++q) {
      if (nq) chain::mbar_wait(R.bars + 2 + g % p.stages, (uint32_t)((g / p.stages) & 1));
      const unsigned char* slot = R.ring + (g % p.stages) * R.slot;
      const float* W = p.w_resident ? reinterpret_cast<const float*>(R.w) + (size_t)q * kc * rows
                                    : reinterpret_cast<const float*>(slot);
      const float* C = p.grid ? reinterpret_cast<const float*>(
                                    slot + chain::w_piece_bytes(p, chain::F32))
                              : reinterpret_cast<const float*>(R.c) + (size_t)q * kc * N;
      const int len = nq ? kc : k;
      if (on[0]) {  // whole warps without a tile skip the loop
        const float* wp = W + r0;
#pragma unroll 4
        for (int kk = 0; kk < len; ++kk) {
          float wv[IND][4];
#pragma unroll
          for (int j = 0; j < IND; ++j) {
            const float4 w4 = *reinterpret_cast<const float4*>(wp + (j < ind ? j : 0) * wj +
                                                               kk * rows);
            wv[j][0] = w4.x, wv[j][1] = w4.y, wv[j][2] = w4.z, wv[j][3] = w4.w;
          }
#pragma unroll
          for (int i = 0; i < ITEMS; ++i) {
            const float4 c4 = *reinterpret_cast<const float4*>(C + kk * N + cr[i]);
            const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
            for (int j = 0; j < IND; ++j)
#pragma unroll
              for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int b = 0; b < 4; ++b)
                  acc[j][i][4 * a + b] = fmaf(wv[j][a], cv[b], acc[j][i][4 * a + b]);
          }
        }
      }
      if (nq) {
        __syncthreads();  // every thread is done with the slot
        const long limit = p.grid ? (long)(step + 1) * nq : total;
        if (tid == 0 && g + p.stages < limit)
          chain::issue_chunk(p, chain::F32, R, g + p.stages, nq, wb, c0b, c1b, panel, slab);
        ++g;
      }
    }

    // the fold: y's row i to the carry's rows i, i + m, ... < k (block
    // plan: in shared memory; grid plan: the panel's rows staged in slot 0
    // as [rows][N], then bulk-copied to each copy's place in L2)
    __syncthreads();  // every thread is done with the carry (block) / slot 0 (grid)
    float* cF = reinterpret_cast<float*>(R.c);
    float* stage = reinterpret_cast<float*>(R.ring);
    // y's element (row r0 + a, column cc[i] + b), the sum of the ind
    // products in order j, scaled; the output (last step) skips what is
    // not y's, the carry takes every element of the thread's tiles (a
    // padding column's product is 0) but those past the slab, which go to
    // a scratch word: no branches in the unrolled loop
    float* dummy = R.red + 16;
#define FMA_Y(i, a, b)                                                                    \
  float y = acc[0][i][4 * a + b];                                                         \
  _Pragma("unroll") for (int j = 1; j < IND; ++j) if (j < ind) y = y + acc[j][i][4 * a + b]; \
  const float v = y * scale;
    if (last) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int row = (p.grid ? panel * rows : 0) + r0 + a, c = cc[i] + b;
            if (!on[i] || row >= m || c >= p.ncols) continue;
            FMA_Y(i, a, b)
            for (int r = row; r < k; r += m) out[(size_t)r * p.n + slab * p.ncols + c] = v;
          }
    } else {
      for (int rc = 0; rc < (p.grid ? 1 : k); rc += m) {  // the copies, the same for all
#pragma unroll
        for (int i = 0; i < ITEMS; ++i)
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int c = cc[i] + b, r = rc + r0 + a;
              FMA_Y(i, a, b)
              float* d = p.grid ? stage + (r0 + a) * N + c : cF + r * N + c;
              *(on[i] && r < k ? d : dummy) = v;
            }
      }
    }
#undef FMA_Y
    if (p.grid && !last) {
      probe::fence_proxy_async();
      __syncthreads();
      if (tid == 0) {
        float* dst = (step & 1) ? cb0 : cb1;
        for (int r0g = panel * rows; r0g < k; r0g += m)
          chain::bulk_s2g(dst + (((size_t)(r0g / 64) * p.slabs + slab) * 64 + r0g % 64) * N,
                          stage, (uint32_t)(rows * N * 4));
        chain::bulk_s2g_wait();
      }
    }
    if (p.grid) {
      if (!last) chain::grid_sync(ws, ++nbar);
    } else {
      __syncthreads();
    }
  }
}

// The (regime, warpgroup width) pairs built, the ones probes/mm.py plan
// gives (mm.py BUILT): the block plan's 16-column slabs and K1's chains,
// the grid plan's and the cluster plan's slabs.
template <int V>
int launch_wgmma(const Plan& p, const unsigned char* w, unsigned char* c0, unsigned char* c1,
                 float* out, unsigned* ws, float scale, cudaStream_t s) {
  const int nw = p.N > 128 ? 128 : p.N;  // a warpgroup's width
#define MM_K(reg, n)                                                                       \
  if (p.grid == reg && nw == n)                                                            \
    return chain::launch_plan(mm_chain_kernel<V, n, reg>, p, V, s, p, w, c0, c1, out, ws, \
                              scale);
  MM_K(chain::BLOCK, 16) MM_K(chain::BLOCK, 48) MM_K(chain::BLOCK, 64)
  MM_K(chain::GRID, 32) MM_K(chain::GRID, 80) MM_K(chain::GRID, 128)
  MM_K(chain::CLUSTER, 16) MM_K(chain::CLUSTER, 32) MM_K(chain::CLUSTER, 40)
  MM_K(chain::CLUSTER, 64) MM_K(chain::CLUSTER, 80)
#undef MM_K
  return (int)cudaErrorInvalidValue;
}

template <int ITEMS, int IND>
int launch_fma_as(const Plan& p, const float* w, float* c0, float* c1, float* out, unsigned* ws,
                  float scale, cudaStream_t s) {
  return chain::launch_plan(mm_fma_kernel<ITEMS, IND>, p, chain::F32, s, p, w, c0, c1, out, ws,
                            scale);
}

int launch_fma(const Plan& p, const float* w, float* c0, float* c1, float* out, unsigned* ws,
               float scale, cudaStream_t s) {
  const int tpr = p.threads / (p.rows / 4), per = (p.N / 4 + tpr - 1) / tpr;  // column groups a thread
  if (tpr < 1) return (int)cudaErrorInvalidValue;
  if (p.ind > 1) {
    if (per != 1) return (int)cudaErrorInvalidValue;
    return launch_fma_as<1, 4>(p, w, c0, c1, out, ws, scale, s);
  }
  switch (per) {
    case 1: return launch_fma_as<1, 1>(p, w, c0, c1, out, ws, scale, s);
    case 2: return launch_fma_as<2, 1>(p, w, c0, c1, out, ws, scale, s);
    case 3: return launch_fma_as<3, 1>(p, w, c0, c1, out, ws, scale, s);
    case 4: return launch_fma_as<4, 1>(p, w, c0, c1, out, ws, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One m64n16 product D = A B^T (A [64][K], B [16][K] row-major, K a
// multiple of 32 up to 256) on wgmma from chain.cuh's layout, and on
// mma.sync from row-major copies: the check that the descriptors and the
// accumulator layout are right.
template <bool S8>
__global__ void __launch_bounds__(128)
wgmma_tile_kernel(const void* a, const void* b, float* d_wg, float* d_mma, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int E = S8 ? 1 : 2, CK = 16 / E, KSTEP = 2 * CK, PAD = S8 ? 16 : 8;
  using T = typename std::conditional<S8, int8_t, bf16>::type;
  T* ap = reinterpret_cast<T*>(smem);      // [64 x K] piece
  T* bp = ap + 64 * K;                     // [16 x K] piece
  T* ar = bp + 16 * K;                     // [64][K + PAD] row-major
  T* br = ar + 64 * (K + PAD);             // [16][K + PAD]
  const T* ag = static_cast<const T*>(a);
  const T* bg = static_cast<const T*>(b);
  for (int i = threadIdx.x; i < 64 * K; i += blockDim.x) {
    const int r = i / K, d = i % K;
    ap[chain::tc_off(r, d, K, CK)] = ag[i];
    ar[r * (K + PAD) + d] = ag[i];
  }
  for (int i = threadIdx.x; i < 16 * K; i += blockDim.x) {
    const int r = i / K, d = i % K;
    bp[chain::tc_off(r, d, K, CK)] = bg[i];
    br[r * (K + PAD) + d] = bg[i];
  }
  probe::fence_proxy_async();
  __syncthreads();
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  using Acc = typename std::conditional<S8, int, float>::type;
  Acc acc[8];  // written by the first product (scale_d 0)
  chain::fence_acc(acc);
  chain::wgmma_fence();
  const uint32_t a0 = probe::smem_u32(ap), b0 = probe::smem_u32(bp), sbo = 8 * K * E;
  for (int ks = 0; ks < K / KSTEP; ++ks) {
    if constexpr (S8)
      chain::Wgmma<16>::s8(acc, chain::desc(a0 + ks * 256, sbo), chain::desc(b0 + ks * 256, sbo),
                           ks > 0);
    else
      chain::Wgmma<16>::bf16(acc, chain::desc(a0 + ks * 256, sbo),
                             chain::desc(b0 + ks * 256, sbo), ks > 0);
  }
  chain::wgmma_commit();
  chain::wgmma_wait_all();
  chain::fence_acc(acc);
  for (int j = 0; j < 2; ++j)
    for (int e = 0; e < 4; ++e) {
      const int r = warp * 16 + (lane >> 2) + (e >> 1) * 8, c = 8 * j + 2 * (lane & 3) + (e & 1);
      d_wg[r * 16 + c] = (float)acc[4 * j + e];
    }
  for (int j = 0; j < 2; ++j) {
    Acc d4[4] = {};
    if constexpr (S8) {
      for (int k0 = 0; k0 < K; k0 += 32) {
        uint32_t af[4], bf[2];
        probe::load_a_s8(af, ar, K + PAD, warp * 16, k0, lane);
        probe::load_b_s8(bf, br, K + PAD, 8 * j, k0, lane);
        probe::mma_s8(d4, af, bf);
      }
    } else {
      probe::mma_tile_bf16(d4, ar, K + PAD, br, K + PAD, warp * 16, 8 * j, K, lane);
    }
    for (int e = 0; e < 4; ++e)
      d_mma[(warp * 16 + probe::acc_row(e, lane)) * 16 + 8 * j + probe::acc_col(e, lane)] =
          (float)d4[e];
  }
}

}  // namespace

// variant 0 f32 / 1 bf16 / 2 3xbf16; `plan` the 15 ints of chain::Plan
// (probes/mm.py PLAN_FIELDS). w: W laid out for the plan (mm.py
// w_layout); cb0: c0 laid out as the plan's carry, overwritten in the
// grid regime; cb1: the grid's second carry buffer (same size); out [k][n]
// f32, the last carry; ws: zeroed, 4 bytes x (reps + 2). Returns a CUDA
// error code (cudaErrorInvalidValue for a plan outside chain::plan_ok,
// cudaErrorCooperativeLaunchTooLarge for a grid plan not all resident).
extern "C" int vmap_probe_mm(int variant, const void* w, void* cb0, void* cb1, void* out,
                             void* ws, const int* plan, float scale, void* stream) {
  const Plan p = chain::read_plan(plan);
  if (variant < 0 || variant > 2 || !chain::plan_ok(p, variant, variant ? 8 : 2))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<float*>(out);
  auto u = static_cast<unsigned*>(ws);
  if (variant == 0)
    return launch_fma(p, static_cast<const float*>(w), static_cast<float*>(cb0),
                      static_cast<float*>(cb1), o, u, scale, s);
  auto wb = static_cast<const unsigned char*>(w);
  auto c0 = static_cast<unsigned char*>(cb0);
  auto c1 = static_cast<unsigned char*>(cb1);
  if (variant == 1) return launch_wgmma<1>(p, wb, c0, c1, o, u, scale, s);
  return launch_wgmma<2>(p, wb, c0, c1, o, u, scale, s);
}

// The tile check: s8 (0 bf16, 1 s8) A [64][K], B [16][K] -> d_wg, d_mma
// [64][16] f32. Returns a CUDA error code.
extern "C" int vmap_probe_wgmma_tile(int s8, const void* a, const void* b, void* d_wg,
                                     void* d_mma, int K, void* stream) {
  if (K < 32 || K > 256 || K % 32) return (int)cudaErrorInvalidValue;
  const int E = s8 ? 1 : 2, pad = s8 ? 16 : 8;
  const size_t smem = (size_t)E * (80 * K + 80 * (K + pad));
  auto s = static_cast<cudaStream_t>(stream);
  auto kernel = s8 ? wgmma_tile_kernel<true> : wgmma_tile_kernel<false>;
  cudaError_t err = probe::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, 128, smem, s>>>(a, b, static_cast<float*>(d_wg), static_cast<float*>(d_mma), K);
  return (int)cudaGetLastError();
}
