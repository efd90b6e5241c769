// The plan, the memory layouts and the pipeline that K4's and K10's chain
// kernels share (mm.cu mm_chain_kernel / mm_fma_kernel, int8.cu
// int8_chain_kernel), with the warpgroup products (wgmma) they run on.
//
// A chain runs `reps` dependent steps of y = W c, c <- fold(y) (y's rows
// repeated until there are k of them) in one launch. The plan is taken
// from the card (probes/mm.py `plan` computes it from the SM count and
// passes it in; the launchers here check it): a block computes `rows` rows
// of y (a panel of W) for one slab of `ncols` columns of the carry (padded
// to N), in one of three regimes:
//
//   * block (grid = 0): a block owns its slab and every row of W (`rows`
//     = m, or m padded to warpgroups of 64), so its chain needs nothing
//     from other blocks; the carry stays in its shared memory. K1's
//     products (one chain of P columns a block) and the script's shapes
//     whose whole W fits beside a 16-column slab run so.
//   * grid (grid = 1): W is cut into `panels` of `rows` rows; a block owns
//     (panel, slab) and keeps its W panel in shared memory for the whole
//     chain where it fits (w_resident), else streams it from L2 every step.
//     Each step's fold is staged in shared memory and bulk-copied to global
//     memory (L2) in the layout the next step's operand copies read, and
//     one grid-wide barrier a step makes it visible; the launch is
//     cooperative and the launcher refuses a plan whose blocks are not all
//     resident (occupancy API).
//   * cluster (grid = 2): as grid, but the `panels` blocks of a slab are
//     one thread-block cluster that keeps the slab's whole carry in each
//     block's shared memory (two buffers): a block's fold goes into its own
//     next buffer and, as bulk copies between shared memories, into every
//     peer's, completing on the peer's barrier of that buffer; no grid
//     barrier and no L2 round trip (W resident, 64- or 128-row panels).
//
// Streamed operands (the carry's k-chunks in the grid regime, W's where it
// does not stay resident) come through a ring of `stages` slots, each
// filled by TMA 1-D bulk copies (cp.async.bulk) of one k-chunk of `kc`
// rows, completing on the slot's mbarrier; every operand is laid out in
// global memory (probes/mm.py lays out W and c0; the epilogue lays out each
// step's fold) so that a chunk is one contiguous copy.
//
// Tensor-core operands (bf16, 3xbf16's hi / lo pieces, s8) sit in shared
// memory in wgmma's no-swizzle K-major layout: core matrices of 8 rows x
// 16 bytes (8 bf16 or 16 s8 values of k), 128 contiguous bytes each. A
// piece of R rows and depth D keeps element (r, d) at
//     (r / 8) * 8D + (d / CK) * 8 CK + (r % 8) * CK + d % CK    (CK = 16 / E)
// elements: the descriptor's leading byte offset (between core matrices
// along k) is 128, its stride byte offset (between 8-row groups) 8 D E,
// and one k step of a product (k16 bf16, k32 s8: two core matrices) moves
// the start address by 256 bytes. W is the A operand (rows of y), the
// carry the B operand (its columns are B's rows); f32 accumulators.
//
// Proxies: the fold's stores are generic-proxy writes that the next step's
// bulk copies (grid, cluster) or wgmma (block) read through the async
// proxy, so the writers fence (fence.proxy.async) before the barrier that
// publishes them.

#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "probe_common.cuh"

namespace chain {

// Variants: operand bytes an element of W (every copy), of the carry held
// in shared memory (block regime), of a streamed carry chunk (grid).
enum { F32 = 0, BF16 = 1, SPLIT3 = 2, I8 = 3, I8Q = 4 };
__host__ __device__ constexpr int w_bytes_el(int v) {
  return v == F32 ? 4 : v == BF16 ? 2 : v == SPLIT3 ? 4 : 1;
}
__host__ __device__ constexpr int c_block_el(int v) {
  return v == F32 ? 4 : v == BF16 ? 2 : v == SPLIT3 ? 4 : v == I8 ? 1 : 5;
}
__host__ __device__ constexpr int c_grid_el(int v) {
  return v == F32 ? 4 : v == BF16 ? 2 : v == SPLIT3 ? 4 : v == I8 ? 1 : 4;
}

// The plan (probes/mm.py PLAN_FIELDS, in that order); `grid` names the
// regime.
enum { BLOCK = 0, GRID = 1, CLUSTER = 2 };
struct Plan {
  int grid, rows, panels, slabs, N, ncols, kc, stages, w_resident, threads;
  int m, k, n, ind, reps;
};
constexpr int PLAN_INTS = 15;

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Shared memory of one block, region by region (probes/mm.py smem_bytes
// computes the same): W resident, the carry (block regime; i8_quant's f32
// carry and its s8 copy), the ring's slots, i8_quant's s8 chunk (grid),
// then the mbarriers and a reduction scratch.
struct Smem {
  size_t w, c, slot, ring, q, bars, total;
};
__host__ __device__ inline size_t w_piece_bytes(const Plan& p, int v) {
  return p.w_resident ? 0 : (size_t)p.ind * p.rows * p.kc * w_bytes_el(v);
}
__host__ __device__ inline size_t c_piece_bytes(const Plan& p, int v) {
  return p.grid == GRID ? (size_t)p.kc * p.N * c_grid_el(v) : 0;
}
__host__ __device__ inline Smem smem_layout(const Plan& p, int v) {
  Smem s;
  const size_t wb = p.w_resident ? (size_t)p.ind * p.rows * p.k * w_bytes_el(v) : 0;
  const size_t cb = p.grid == GRID ? 0
                    : (size_t)(p.grid == CLUSTER ? 2 : 1) * p.k * p.N * c_block_el(v);
  const size_t qb = (p.grid == GRID && v == I8Q) ? (size_t)p.kc * p.N : 0;
  s.w = 0;
  s.c = s.w + align128(wb);
  s.ring = s.c + align128(cb);
  s.slot = align128(w_piece_bytes(p, v) + c_piece_bytes(p, v));
  s.q = s.ring + (size_t)p.stages * s.slot;
  s.bars = s.q + align128(qb);
  s.total = s.bars + 256;
  return s;
}

// The limits a plan must meet (the launchers return cudaErrorInvalidValue
// otherwise; probes/mm.py plan_checks states the same on the CPU).
__host__ inline bool plan_ok(const Plan& p, int v, int ck) {
  const int kstep = 2 * ck;  // one product's k depth
  const bool tc = v != F32;
  if (p.grid < BLOCK || p.grid > CLUSTER || (p.grid == CLUSTER && (!tc || v == I8Q)))
    return false;
  if (p.m < 1 || p.k < 1 || p.reps < 1 || p.ind < 1 || p.ind > 4) return false;
  if (p.ncols > p.N || p.slabs * p.ncols != p.n) return false;
  if (p.grid ? (p.panels * p.rows != p.m) : (p.panels != 1 || p.rows < p.m)) return false;
  // tensor cores: a warpgroup a 64-row panel (block), or a column group of
  // up to 128 (grid, cluster)
  const int col_wgs = p.N > 128 ? p.N / 128 : 1;
  if (tc && (p.ind != 1 || p.rows % 64 || p.N % 8 || (p.N > 128 && p.N % 128) ||
             p.threads != 2 * p.rows * col_wgs))
    return false;
  if (!tc && (p.rows % 4 || p.N % 8 || p.threads % 32 || p.threads > 512 ||
              p.threads < p.rows / 4))
    return false;
  const bool ring = p.grid == GRID || !p.w_resident;
  if (ring && (p.kc < kstep || p.kc % kstep || p.k % p.kc || p.stages < 1 || p.stages > 8))
    return false;
  if (!ring && (p.stages != 0 || p.k % kstep)) return false;
  if (p.ind > 1 && !p.w_resident) return false;
  // grid and cluster: a block's panel lies within one 64-deep chunk of the
  // carry, the fold's copies are whole panels (bulk copies), W resident
  // where the carry is exchanged in shared memory or i8_quant's scale is
  // taken
  if (p.grid && (p.kc != 64 || p.k % p.m || p.ncols != p.N)) return false;
  if (p.grid == GRID && (p.rows > 64 || 64 % p.rows)) return false;
  if (p.grid == CLUSTER && p.rows != 64 && p.rows != 128) return false;
  if (p.grid == CLUSTER && (!p.w_resident || p.panels > 16)) return false;
  if (p.grid == GRID && v == I8Q && !p.w_resident) return false;
  return smem_layout(p, v).total <= probe::SMEM_MAX;
}

// ---- barriers, with a spin bound: a wait that never completes traps (a
// launch error) instead of hanging the card

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  long spins = 0;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(probe::smem_u32(bar)), "r"(parity) : "memory");
    if (++spins > (1L << 28)) __trap();
  } while (!done);
}

__device__ __forceinline__ void fence_proxy_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// Grid-wide barrier number `n` (1, 2, ...) on the zeroed counter *count:
// every block's writes before it (generic and async proxy) are visible to
// every block after it. Needs every block resident (cooperative launch).
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned n) {
  fence_proxy_async_all();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned target = n * gridDim.x;
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" :: "l"(count) : "memory");
    unsigned v;
    long spins = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(count) : "memory");
      if (++spins > (1L << 28)) __trap();
    } while (v < target);
    fence_proxy_async_all();
  }
  __syncthreads();
}

// Thread 0: `bytes` (a multiple of 16) from this block's shared memory to
// global memory as a TMA bulk copy, waited for (the source is free and the
// writes performed) before it returns.
__device__ __forceinline__ void bulk_s2g(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(probe::smem_u32(src)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_s2g_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The largest of every thread's `x` in the block (x >= 0); `red` holds one
// float a warp. Ends with every thread holding the maximum.
__device__ __forceinline__ float block_max(float x, float* red) {
  for (int off = 16; off; off >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) x = fmaxf(x, red[w]);
  __syncthreads();
  return x;
}

// Element offset of (r, d) in a tensor-core piece of depth D (the layout
// above); ck = 16 / element bytes.
__host__ __device__ __forceinline__ int tc_off(int r, int d, int D, int ck) {
  return (r >> 3) * 8 * D + (d / ck) * 8 * ck + (r & 7) * ck + d % ck;
}

// wgmma shared-memory descriptor: no swizzle, leading byte offset 128,
// stride byte offset `sbo` (PTX ISA, "Matrix Descriptor Format").
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
template <typename T, int R>
__device__ __forceinline__ void fence_acc(T (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if constexpr (std::is_same<T, float>::value)
      asm volatile("" : "+f"(d[i]) :: "memory");
    else
      asm volatile("" : "+r"(d[i]) :: "memory");
  }
}

// m64nNk16 bf16 -> f32 and m64nNk32 s8 -> s32, both operands from shared
// memory (descriptors), D = A B + (scale_d ? D : 0) (PTX ISA
// "wgmma.mma_async"; a step's first product takes scale_d 0 rather than
// accumulators zeroed by other instructions, which would serialize the
// products). Accumulator
// element 4 j + e of thread t of the warpgroup: row 16 (t / 32) + (t % 32) /
// 4 + 8 (e / 2), column 8 j + 2 (t % 4) + e % 2.
template <int N> struct Wgmma;

template <> struct Wgmma<16> {
  __device__ __forceinline__ static void bf16(float (&d)[8], uint64_t a,
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ __forceinline__ static void s8(int (&d)[8], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<32> {
  __device__ __forceinline__ static void bf16(float (&d)[16], uint64_t a,
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ __forceinline__ static void s8(int (&d)[16], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<40> {  // bf16 only (s8 takes no n40)
  __device__ __forceinline__ static void bf16(float (&d)[20], uint64_t a,
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19"
        "}, %20, %21, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<48> {
  __device__ __forceinline__ static void bf16(float (&d)[24], uint64_t a,
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ __forceinline__ static void s8(int (&d)[24], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<64> {
  __device__ __forceinline__ static void bf16(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ __forceinline__ static void s8(int (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<80> {
  __device__ __forceinline__ static void bf16(float (&d)[40], uint64_t a,
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ __forceinline__ static void s8(int (&d)[40], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, %40, %41, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Wgmma<128> {
  __device__ __forceinline__ static void bf16(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  __device__ __forceinline__ static void s8(int (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// ---- the pipeline

// Shared-memory regions of the running block.
struct Regions {
  unsigned char *w, *c, *ring;
  int8_t* q;
  uint64_t* bars;  // [0] W resident, [1] the carry's load, [2 + s] slot s
  float* red;      // block_max's scratch (16 floats)
  size_t slot;
};
__device__ __forceinline__ Regions regions(unsigned char* smem, const Plan& p, int v) {
  const Smem L = smem_layout(p, v);
  Regions r;
  r.w = smem + L.w;
  r.c = smem + L.c;
  r.ring = smem + L.ring;
  r.q = reinterpret_cast<int8_t*>(smem + L.q);
  r.bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  r.red = reinterpret_cast<float*>(r.bars + 2 + 8);
  r.slot = L.slot;
  return r;
}

// Thread 0, once: the barriers, W's resident copy (its panel) and, in the
// block regime, the slab's initial carry (`cbytes` bytes of c0's slab).
__device__ __forceinline__ void load_resident(const Plan& p, int v, const Regions& R,
                                              const unsigned char* w, const unsigned char* c0,
                                              int panel, int slab, size_t cbytes) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 + (p.stages > 2 ? p.stages : 2); ++i) probe::mbar_init(R.bars + i, 1);
    probe::fence_proxy_async();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (p.w_resident) {
      const size_t bytes = (size_t)p.ind * p.rows * p.k * w_bytes_el(v);
      probe::mbar_arrive_expect_tx(R.bars, (uint32_t)bytes);
      probe::bulk_g2s(R.w, w + panel * bytes, (uint32_t)bytes, R.bars);
    }
    if (p.grid != GRID) {
      probe::mbar_arrive_expect_tx(R.bars + 1, (uint32_t)cbytes);
      probe::bulk_g2s(R.c, c0 + slab * cbytes, (uint32_t)cbytes, R.bars + 1);
    }
  }
  if (p.w_resident) mbar_wait(R.bars, 0);
  if (p.grid != GRID) mbar_wait(R.bars + 1, 0);
}

// ---- the cluster regime's exchange: the blocks of a slab (one cluster,
// rank = panel) send each step's fold to every peer's next carry buffer
// as bulk copies between shared memories, completing on the peer's
// barrier of that buffer

__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void bulk_s2peer(uint32_t dst, uint32_t src, uint32_t bytes,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// Stores from registers into a peer's shared memory (addresses from
// mapa), each completing its bytes on the peer's mbarrier `bar` (release
// at cluster scope; the peer waits with mbar_wait_cluster).
__device__ __forceinline__ void st_async(uint32_t dst, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               :: "r"(dst), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async(uint32_t dst, float4 v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
               "[%0], {%1, %2, %3, %4}, [%5];\n"
               :: "r"(dst), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
                  "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
               : "memory");
}
// mbar_wait with acquire at cluster scope: what peers' st_async wrote
// before completing the phase is visible after it.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  long spins = 0;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(probe::smem_u32(bar)), "r"(parity) : "memory");
    if (++spins > (1L << 28)) __trap();
  } while (!done);
}

// Thread 0: chunk gi of the chain (step gi / nq, k-chunk gi % nq) into its
// slot: W's piece of the chunk where W is streamed, the carry's where the
// carry comes from L2 (grid: step s reads buffer s & 1).
__device__ __forceinline__ void issue_chunk(const Plan& p, int v, const Regions& R, long gi,
                                            int nq, const unsigned char* w,
                                            const unsigned char* cb0, const unsigned char* cb1,
                                            int panel, int slab) {
  const int step = (int)(gi / nq), q = (int)(gi % nq), s = (int)(gi % p.stages);
  const size_t wp = w_piece_bytes(p, v), cp = c_piece_bytes(p, v);
  unsigned char* dst = R.ring + s * R.slot;
  uint64_t* bar = R.bars + 2 + s;
  probe::mbar_arrive_expect_tx(bar, (uint32_t)(wp + cp));
  if (wp) probe::bulk_g2s(dst, w + ((size_t)panel * nq + q) * wp, (uint32_t)wp, bar);
  if (cp) {
    const unsigned char* src = (step & 1) ? cb1 : cb0;
    probe::bulk_g2s(dst + wp, src + ((size_t)q * p.slabs + slab) * cp, (uint32_t)cp, bar);
  }
}

// `steps` k steps of products into acc from A (W's rows, descriptor
// stride sa) and B (the carry's columns of this warpgroup, stride sb);
// 3xbf16's lo copies at alo / blo bytes past the hi ones.
template <int V, int NW, typename Acc>
__device__ __forceinline__ void products(Acc (&acc)[NW / 2], uint32_t a, uint32_t sa,
                                         uint32_t alo, uint32_t b, uint32_t sb, uint32_t blo,
                                         int steps, bool first) {
  for (int ks = 0; ks < steps; ++ks) {
    const uint32_t off = ks * 256;
    const int keep = first && ks == 0 ? 0 : 1;  // the step's first product overwrites
    if constexpr (V == I8 || V == I8Q) {
      Wgmma<NW>::s8(acc, desc(a + off, sa), desc(b + off, sb), keep);
    } else if constexpr (V == SPLIT3) {
      Wgmma<NW>::bf16(acc, desc(a + alo + off, sa), desc(b + off, sb), keep);
      Wgmma<NW>::bf16(acc, desc(a + off, sa), desc(b + blo + off, sb), 1);
      Wgmma<NW>::bf16(acc, desc(a + off, sa), desc(b + off, sb), 1);
    } else {
      Wgmma<NW>::bf16(acc, desc(a + off, sa), desc(b + off, sb), keep);
    }
  }
}

// ---- the fold of a tensor-core step: y's row i to the carry's rows i,
// i + m, ... < k, from this thread's accumulators. One loop a regime and
// (LAST) for the output, each with no regime branches: the code stays
// small (a fully unrolled epilogue with every branch ran out of the
// instruction cache). Block: into the carry in shared memory; grid: the
// panel's 64 rows into a staged piece (its copies are bulk copies); cluster:
// into this block's next carry buffer (then sent to the peers).
template <int V, int NW, int REG, bool LAST, typename Acc>
__device__ __forceinline__ float fold(const Acc (&acc)[NW / 2], const Plan& p, int row0,
                                      int col0, int slab, float scale, float s,
                                      unsigned char* dst, unsigned char* dummy,
                                      float* __restrict__ out) {
  constexpr bool S8 = V == I8 || V == I8Q, SPLIT = V == SPLIT3, QUANT = V == I8Q;
  constexpr int CK = S8 ? 16 : 8, COPIES = SPLIT ? 2 : 1;
  const int m = p.m, k = p.k, N = p.N, lane = threadIdx.x & 31;
  // the copies (r0 = 0, m, 2m, ...) outermost, the same for every thread;
  // the grid regime stages one piece for all of them
  const int r_end = REG == GRID && !LAST ? 1 : k;
  float mx = 0.f;
  for (int r0 = 0; r0 < r_end; r0 += m) {
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row0 + (e >> 1) * 8, c = col0 + 8 * j + 2 * (lane & 3) + (e & 1);
        const int r = i + r0;
        // grid and cluster tiles are whole (plan_ok); a block's padding rows
        // and columns are not written: their stores go to `dummy` (no
        // branches in the unrolled loop) and LAST skips them
        const bool ok = REG != BLOCK || (i < m && c < p.ncols && r < k);
        if constexpr (LAST) {
          if (!ok) continue;
          float v;
          if constexpr (QUANT)
            v = (float)acc[4 * j + e] * s * 1e-3f;
          else if constexpr (S8)
            v = (float)(int8_t)(int)fminf(fmaxf((float)acc[4 * j + e] * 1e-3f, -127.f), 127.f);
          else
            v = acc[4 * j + e] * scale;
          out[(size_t)r * p.n + slab * p.ncols + c] = v;
        } else if constexpr (QUANT) {
          const float v = (float)acc[4 * j + e] * s * 1e-3f;
          mx = fmaxf(mx, ok ? fabsf(v) : 0.f);
          const int at = REG == GRID ? (i & 63) * N + c : r * N + c;
          *reinterpret_cast<float*>(ok ? dst + 4 * at : dummy) = v;
        } else if constexpr (S8) {
          const float v = fminf(fmaxf((float)acc[4 * j + e] * 1e-3f, -127.f), 127.f);
          const int at = REG == BLOCK ? tc_off(c, r, k, CK)
                         : REG == GRID ? tc_off(c, i & 63, 64, CK)
                                       : (r >> 6) * 64 * N + tc_off(c, r & 63, 64, CK);
          *reinterpret_cast<int8_t*>(ok ? dst + at : dummy) = (int8_t)(int)v;
        } else {
          const float v = acc[4 * j + e] * scale;
          const bf16 hi = __float2bfloat16_rn(v);
          const int at = REG == BLOCK ? tc_off(c, r, k, CK)
                         : REG == GRID ? tc_off(c, i & 63, 64, CK)
                                       : (r >> 6) * 64 * N * COPIES + tc_off(c, r & 63, 64, CK);
          bf16* d = reinterpret_cast<bf16*>(ok ? dst + 2 * at : dummy);
          d[0] = hi;
          if constexpr (SPLIT) {
            const int lo_at = REG == BLOCK ? k * N : 64 * N;
            *(ok ? d + lo_at : d) = __float2bfloat16_rn(v - __bfloat162float(hi));
          }
        }
      }
    }
  }
  return mx;
}

// ---- the tensor-core chain (mm.cu variants bf16 / 3xbf16, int8.cu i8 /
// i8_quant) in regime REG, on products NW wide a warpgroup: a warpgroup a
// 64-row panel (block regime) or a column group of NW (grid, cluster: N =
// NW or 2 x 128). `cb0` holds c0 laid out as the plan's carry (and is
// overwritten in the grid regime), `cb1` the grid's second carry buffer,
// `ws` the zeroed barrier counter then i8_quant's per-step abs-max slots.
template <int V, int NW, int REG>
__device__ __forceinline__ void wgmma_chain(const Plan& p, const unsigned char* __restrict__ w,
                                            unsigned char* __restrict__ cb0,
                                            unsigned char* __restrict__ cb1,
                                            float* __restrict__ out, unsigned* __restrict__ ws,
                                            float scale) {
  constexpr bool S8 = V == I8 || V == I8Q, SPLIT = V == SPLIT3, QUANT = V == I8Q;
  constexpr int E = S8 ? 1 : 2, CK = 16 / E, KSTEP = 2 * CK, NACC = NW / 2;
  constexpr int COPIES = SPLIT ? 2 : 1;
  constexpr bool block = REG == BLOCK, grid = REG == GRID, clus = REG == CLUSTER;
  using Acc = typename std::conditional<S8, int, float>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const Regions R = regions(smem, p, V);
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127, rw = p.rows / 64;
  const int wgr = wg % rw, wgc = wg / rw;  // this warpgroup's 64 rows / NW columns
  const int panel = block ? 0 : grid ? blockIdx.x / p.slabs : blockIdx.x % p.panels;
  const int slab = block ? blockIdx.x : grid ? blockIdx.x % p.slabs : blockIdx.x / p.panels;
  const int m = p.m, k = p.k, kc = p.kc, N = p.N;
  const int nq = (grid || !p.w_resident) ? k / kc : 0;  // ring chunks a step
  const long total = (long)p.reps * nq;
  // a 64-deep piece of the slab's carry, every copy (grid, cluster)
  const uint32_t piece = 64 * N * E * COPIES;
  const uint32_t cbuf = (uint32_t)k * N * c_block_el(V);  // the carry a block keeps
  float* amax = reinterpret_cast<float*>(ws + 1);
  unsigned nbar = 0;

  load_resident(p, V, R, w, cb0, panel, slab, QUANT ? (size_t)k * N * 4 : cbuf);
  if (clus) cluster_sync();  // every peer's barriers are set up before a copy names them
  if constexpr (QUANT && grid) {  // step 0's scale: max |c0| over the whole carry
    const float* c = reinterpret_cast<const float*>(cb0);
    const size_t all = (size_t)k * p.n, share = (all + gridDim.x - 1) / gridDim.x;
    const size_t end = (blockIdx.x + 1) * share < all ? (blockIdx.x + 1) * share : all;
    float mx = 0.f;
    for (size_t i = blockIdx.x * share + tid; i < end; i += blockDim.x) mx = fmaxf(mx, fabsf(c[i]));
    mx = block_max(mx, R.red);
    if (tid == 0) atomicMax(reinterpret_cast<int*>(amax), __float_as_int(mx));
    grid_sync(ws, ++nbar);
  }
  if (block && tid == 0)
    for (long gi = 0; gi < p.stages && gi < total; ++gi)
      issue_chunk(p, V, R, gi, nq, w, cb0, cb1, panel, slab);

  const uint32_t wres = probe::smem_u32(R.w) + wgr * 64 * k * E;  // W resident
  const uint32_t wlo = (uint32_t)p.rows * k * 2, s64 = 8 * 64 * E;
  const uint32_t bcol = wgc * (NW / 8) * s64;  // this column group's B rows
  const int warp = t >> 5, lane = t & 31;
  const int row0 = panel * p.rows + wgr * 64 + warp * 16 + (lane >> 2), col0 = wgc * NW;
  long g = 0;
  for (int step = 0; step < p.reps; ++step) {
    const bool last = step == p.reps - 1;
    unsigned char* cur = R.c + (clus ? (step & 1) * cbuf : 0);
    unsigned char* nxt = R.c + (clus ? ((step + 1) & 1) * cbuf : 0);
    if (clus) {
      if (step > 0) mbar_wait(R.bars + 2 + (step & 1), (uint32_t)(((step - 1) >> 1) & 1));
      if (tid == 0 && !last)
        probe::mbar_arrive_expect_tx(R.bars + 2 + ((step + 1) & 1),
                                     (p.panels - 1) * (k / m) * rw * piece);
    }
    float s = 0.f, inv = 0.f;
    if constexpr (QUANT) {
      float mx;
      if constexpr (grid) {
        mx = __ldcg(amax + step);
      } else {
        const float* cF = reinterpret_cast<const float*>(R.c);
        mx = 0.f;
        for (int i = tid; i < k * N; i += blockDim.x) mx = fmaxf(mx, fabsf(cF[i]));
        mx = block_max(mx, R.red);
      }
      s = mx * (float)(1.0 / 127.0) + 1e-30f;
      inv = 1.0f / s;
      if constexpr (block) {  // the step's s8 copy of the whole carry
        const float* cF = reinterpret_cast<const float*>(R.c);
        int8_t* cq = reinterpret_cast<int8_t*>(R.c + (size_t)k * N * 4);
        for (int i = tid; i < k * N; i += blockDim.x) {
          const int r = i / N, c = i - r * N;
          cq[tc_off(c, r, k, 16)] = (int8_t)(int)rintf(cF[i] * inv);
        }
        probe::fence_proxy_async();
        __syncthreads();
      }
    }
    if (grid && tid == 0)
      for (int q = 0; q < p.stages && q < nq; ++q)
        issue_chunk(p, V, R, g + q, nq, w, cb0, cb1, panel, slab);

    Acc acc[NACC];  // written by the step's first product (scale_d 0)
    if (!nq) {
      fence_acc(acc);
      wgmma_fence();
      if constexpr (block) {
        const uint32_t b = probe::smem_u32(QUANT ? R.c + (size_t)k * N * 4 : R.c);
        products<V, NW>(acc, wres, 8 * k * E, wlo, b, 8 * k * E, (uint32_t)N * k * 2, k / KSTEP,
                        true);
      } else {  // cluster: the carry in 64-deep pieces
        for (int q = 0; q < k / 64; ++q)
          products<V, NW>(acc, wres + (q * 64 / CK) * 128, 8 * k * E, wlo,
                          probe::smem_u32(cur) + q * piece + bcol, s64, (uint32_t)N * 64 * 2,
                          64 / KSTEP, q == 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
    }
    for (int q = 0; q < nq; ++q) {
      mbar_wait(R.bars + 2 + g % p.stages, (uint32_t)((g / p.stages) & 1));
      unsigned char* slot = R.ring + (g % p.stages) * R.slot;
      uint32_t a, sa, alo;
      if (p.w_resident) {
        a = wres + (q * kc / CK) * 128, sa = 8 * k * E, alo = wlo;
      } else {
        a = probe::smem_u32(slot) + wgr * 64 * kc * E, sa = 8 * kc * E;
        alo = (uint32_t)p.rows * kc * 2;
      }
      uint32_t b, sb, blo;
      if constexpr (grid) {
        unsigned char* cpiece = slot + w_piece_bytes(p, V);
        if constexpr (QUANT) {  // quantise the staged f32 chunk [kc][N] with this step's scale
          const float* f = reinterpret_cast<const float*>(cpiece);
          for (int i = tid; i < kc * N; i += blockDim.x) {
            const int d = i / N, c = i - d * N;
            R.q[tc_off(c, d, kc, 16)] = (int8_t)(int)rintf(f[i] * inv);
          }
          probe::fence_proxy_async();
          __syncthreads();
          b = probe::smem_u32(R.q) + bcol;
        } else {
          b = probe::smem_u32(cpiece) + bcol;
        }
        sb = s64, blo = (uint32_t)N * 64 * 2;
      } else {
        b = probe::smem_u32(QUANT ? R.c + (size_t)k * N * 4 : R.c) + (q * kc / CK) * 128;
        sb = 8 * k * E, blo = (uint32_t)N * k * 2;
      }
      fence_acc(acc);
      wgmma_fence();
      products<V, NW>(acc, a, sa, alo, b, sb, blo, kc / KSTEP, q == 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);
      __syncthreads();  // every warpgroup is done with the slot
      const long limit = grid ? (long)(step + 1) * nq : total;
      if (tid == 0 && g + p.stages < limit)
        issue_chunk(p, V, R, g + p.stages, nq, w, cb0, cb1, panel, slab);
      ++g;
    }

    if (block) __syncthreads();  // every warpgroup has read the carry
    float mx;
    unsigned char* dummy = reinterpret_cast<unsigned char*>(R.red + 16);  // after block_max's
    if (last)
      mx = fold<V, NW, REG, true>(acc, p, row0, col0, slab, scale, s, nullptr, dummy, out);
    else
      mx = fold<V, NW, REG, false>(acc, p, row0, col0, slab, scale, s, grid ? R.ring : nxt,
                                   dummy, out);
    if (!block && !last) {
      probe::fence_proxy_async();
      __syncthreads();
      if constexpr (grid) {  // the staged piece to each copy's place in the next buffer
        if (tid == 0) {
          unsigned char* dst = (step & 1) ? cb0 : cb1;
          const uint32_t bytes = (uint32_t)(64 * N * c_grid_el(V));
          for (int r0 = panel * 64; r0 < k; r0 += m)
            bulk_s2g(dst + ((size_t)(r0 / 64) * p.slabs + slab) * bytes, R.ring, bytes);
          bulk_s2g_wait();
        }
      } else if (tid < 32) {  // this block's pieces to the same place in every peer's
        const uint32_t bar = probe::smem_u32(R.bars + 2 + ((step + 1) & 1));
        const int peers = p.panels - 1, sends = (k / m) * peers;
        for (int x = tid; x < sends; x += 32) {  // a send a lane: the block's rw pieces
          const int r0 = panel * p.rows + (x / peers) * m;
          const uint32_t peer = (panel + 1 + x % peers) % p.panels;
          const uint32_t src = probe::smem_u32(nxt) + (r0 / 64) * piece;
          bulk_s2peer(mapa(src, peer), src, rw * piece, mapa(bar, peer));
        }
      }
    }
    if constexpr (grid) {
      if constexpr (QUANT) {
        mx = block_max(mx, R.red);
        if (tid == 0) atomicMax(reinterpret_cast<int*>(amax + step + 1), __float_as_int(mx));
      }
      if (!last) grid_sync(ws, ++nbar);
    } else if constexpr (block) {
      probe::fence_proxy_async();
      __syncthreads();
    }
  }
  if (clus) cluster_sync();  // no block leaves while a peer may still copy to it
}

// ---- launching

// Launch `kernel` on the plan: dynamic shared memory allowed; in the grid
// regime a cooperative launch, refused unless every block is resident on
// the card (occupancy API); in the cluster regime clusters of `panels`.
template <typename K, typename... Args>
__host__ inline int launch_plan(K kernel, const Plan& p, int v, cudaStream_t stream,
                                Args... args) {
  const size_t smem = smem_layout(p, v).total;
  cudaError_t err = probe::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = p.panels * p.slabs;
  if (p.grid == GRID) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, p.threads, smem)) !=
        cudaSuccess)
      return (int)err;
    if (per_sm * sms < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (p.grid == CLUSTER) {
    if (p.panels > 8 &&
        (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
            cudaSuccess)
      return (int)err;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.panels;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  } else {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = p.grid ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

__host__ inline Plan read_plan(const int* v) {
  Plan p;
  int* f = &p.grid;
  for (int i = 0; i < PLAN_INTS; ++i) f[i] = v[i];
  return p;
}

}  // namespace chain
