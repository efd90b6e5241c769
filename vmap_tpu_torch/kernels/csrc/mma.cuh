// Warp-level tensor-core helpers of the train-frame tiles and the field
// kernels: mma.sync m16n8k16 bf16 -> f32 (train_step.cu's float tile,
// ensemble.cu), its fragment loads (32-bit shared-memory loads, ldmatrix
// and ldmatrix .trans), the split of an f32
// operand into bf16 pieces and the products of the pieces; mma.sync
// m16n8k32 s8 -> s32 and its fragment loads (train_step_q8.cu's int8
// tile); 16-byte cp.async copies into shared memory; and TMA 1-D bulk
// copies completing on mbarriers (train_step.cu's train_adamw). The probe
// kernels (probes/csrc/probe_common.cuh) include it for the same products.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16" and
// "mma.m16n8k32"), with g = lane / 4 and t = lane % 4; each bf16 register
// holds two bf16, the lower column (A) or row (B) in its low half, each s8
// register four s8, the lowest column (A) or row (B) in its low byte:
//   A 16 x 16 bf16, row-major:  a0 (g, 2t..2t+1)  a1 (g+8, 2t..)
//                               a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   B 16 x 8 bf16, "col":       b0 (2t..2t+1, g)  b1 (2t+8.., g)
//   A 16 x 32 s8, row-major:    a0 (g, 4t..4t+3)  a1 (g+8, 4t..)
//                               a2 (g, 4t+16..)  a3 (g+8, 4t+16..)
//   B 32 x 8 s8, "col":         b0 (4t..4t+3, g)  b1 (4t+16.., g)
//   C / D 16 x 8 f32 or s32:    d0 (g, 2t)  d1 (g, 2t+1)  d2 (g+8, 2t)
//                               d3 (g+8, 2t+1)
//
// The checked build (-DVMAP_SMEM_CHECK, off in every shipped build;
// kernels/q8_profile_fault.py builds it): a kernel states its
// shared-memory plan as regions (smem_plan_add, the block's thread 0,
// then a block barrier), and SMEM_CHECK(base, p, n, site) traps, printing
// the site number, where the n bytes at p do not lie within the plan's
// region that holds base (the buffer the address was formed from), or no
// region holds base. In the shipped build SMEM_CHECK is nothing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#ifdef VMAP_SMEM_CHECK
#include <cstdio>
#endif

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

#ifdef VMAP_SMEM_CHECK
constexpr int SMEM_REGIONS = 24;
__shared__ uint32_t smem_plan[SMEM_REGIONS][2];   // [lo, hi) shared bytes
__shared__ int smem_plan_n;

__device__ __noinline__ void smem_trap(int site, uint32_t a, int n,
                                       uint32_t lo, uint32_t hi) {
  printf("smem check: site %d block (%d, %d) thread %d: bytes [%u, %u) "
         "outside the plan's region [%u, %u)\n", site, blockIdx.x,
         blockIdx.y, threadIdx.x, a, a + n, lo, hi);
  __trap();
}

// the dynamic shared memory's first address and its bytes at this launch
__device__ __forceinline__ uint32_t dyn_smem_lo() {
  extern __shared__ __align__(16) unsigned char vmap_dyn_smem[];
  return smem_u32(vmap_dyn_smem);
}
__device__ __forceinline__ uint32_t dyn_smem_bytes() {
  uint32_t n;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(n));
  return n;
}

// thread 0 only: a plan of no regions
__device__ __forceinline__ void smem_plan_reset() { smem_plan_n = 0; }

// thread 0 only: region [lo, lo + bytes), itself within the launch's
// dynamic shared memory (site 0 if not)
__device__ __forceinline__ void smem_plan_add(const void* lo, size_t bytes) {
  const uint32_t a = smem_u32(lo), d0 = dyn_smem_lo();
  if (smem_plan_n >= SMEM_REGIONS || a < d0 ||
      a + bytes > d0 + dyn_smem_bytes())
    smem_trap(0, a, (int)bytes, d0, d0 + dyn_smem_bytes());
  smem_plan[smem_plan_n][0] = a;
  smem_plan[smem_plan_n][1] = a + (uint32_t)bytes;
  ++smem_plan_n;
}

__device__ __forceinline__ void smem_check(const void* base, const void* p,
                                           int n, int site) {
  const uint32_t b = smem_u32(base), a = smem_u32(p);
  for (int r = 0; r < smem_plan_n; ++r)
    if (smem_plan[r][0] <= b && b < smem_plan[r][1]) {
      if (a < smem_plan[r][0] || a + n > smem_plan[r][1])
        smem_trap(site, a, n, smem_plan[r][0], smem_plan[r][1]);
      return;
    }
  smem_trap(site, a, n, 0, 0);
}
#define SMEM_CHECK(base, p, n, site) smem_check((base), (p), (n), (site))
#else
#define SMEM_CHECK(base, p, n, site) ((void)0)
#endif

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A B with both operands given as NP bf16 pieces (split below):
// the pieces' products down to 2^-8 (NP - 1) of the whole, the small terms
// first. NP = 1 the one product a0 b0; 2 the three a1 b0 + a0 b1 + a0 b0;
// 3 the six a2 b0 + a1 b1 + a0 b2 + a1 b0 + a0 b1 + a0 b0
template <int NP>
__device__ __forceinline__ void mma_pieces(float (&d)[4],
                                           const uint32_t (&a)[NP][4],
                                           const uint32_t (&b)[NP][2]) {
  if constexpr (NP == 3) {
    mma_bf16(d, a[2], b[0]);
    mma_bf16(d, a[1], b[1]);
    mma_bf16(d, a[0], b[2]);
  }
  if constexpr (NP >= 2) {
    mma_bf16(d, a[1], b[0]);
    mma_bf16(d, a[0], b[1]);
  }
  mma_bf16(d, a[0], b[0]);
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += A B, s8 operands, exact s32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of rows row0.., columns k0.. of a row-major s8 array in
// shared memory (row stride lda bytes, a multiple of 4; lda / 4 = 4 mod 8
// puts the 8 rows of a fragment on distinct banks)
__device__ __forceinline__ void load_a_s8(uint32_t (&a)[4], const int8_t* A,
                                          int lda, int row0, int k0,
                                          int lane) {
  const int8_t* p = A + (row0 + (lane >> 2)) * lda + k0 + 4 * (lane & 3);
  SMEM_CHECK(A, p, 4, 3);
  SMEM_CHECK(A, p + 8 * lda + 16, 4, 4);
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * lda);
  a[2] = lds32(p + 16);
  a[3] = lds32(p + 8 * lda + 16);
}

// B fragment of columns col0.., k0.. of an s8 array in shared memory held
// column by column ([col][ldb], one column's k values contiguous)
__device__ __forceinline__ void load_b_s8(uint32_t (&b)[2], const int8_t* B,
                                          int ldb, int col0, int k0,
                                          int lane) {
  const int8_t* p = B + (col0 + (lane >> 2)) * ldb + k0 + 4 * (lane & 3);
  SMEM_CHECK(B, p, 4, 5);
  SMEM_CHECK(B, p + 16, 4, 6);
  b[0] = lds32(p);
  b[1] = lds32(p + 16);
}

// A fragment of rows row0.., columns k0.. of a row-major bf16 array in
// shared memory (row stride ld elements, even)
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[4], const bf16* A,
                                            int ld, int row0, int k0,
                                            int lane) {
  const bf16* p = A + (row0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * ld);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * ld + 8);
}

// ldmatrix .x4: four 8 x 8 b16 matrices, lane l naming row (l & 7) of
// matrix l / 8 (16 bytes, 16-byte aligned); r[j] matrix j. .trans gives
// each matrix transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// A fragment of rows row0.., columns k0.. of a row-major bf16 array in
// shared memory (row stride ld a multiple of 8, k0 of 8): one ldmatrix
// .x4 (matrices a0..a3: rows +0 / +8, columns +0 / +8)
__device__ __forceinline__ void load_a_ldsm(uint32_t (&a)[4], const bf16* A,
                                            int ld, int row0, int k0,
                                            int lane) {
  const int q = lane >> 3;
  ldsm_x4(a, A + (row0 + (lane & 7) + (q & 1) * 8) * ld + k0 + (q >> 1) * 8);
}

// B fragments of the n tiles n0 and n0 + 8, depth k0.. 16, from a bf16
// array in shared memory held k by k (x[k][n], row stride ld a multiple of
// 8, n0 of 8): one ldmatrix .x4 .trans; b[t] the tile n0 + 8 t
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[2][2], const bf16* x,
                                          int ld, int k0, int n0, int lane) {
  const int q = lane >> 3;
  uint32_t r[4];
  ldsm_x4_t(r, x + (k0 + (lane & 7) + (q & 1) * 8) * ld + n0 + (q >> 1) * 8);
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// the same from an array held n by n (x[n][k]: each column's depth
// contiguous): one ldmatrix .x4
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[2][2], const bf16* x,
                                          int ld, int n0, int k0, int lane) {
  const int q = lane >> 3;
  uint32_t r[4];
  ldsm_x4(r, x + (n0 + (lane & 7) + (q >> 1) * 8) * ld + k0 + (q & 1) * 8);
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// A fragment of A = S^T, rows m0.., columns k0.., where S is a row-major
// bf16 array in shared memory (A[m][k] = S[k][m]; row stride ld a multiple
// of 8, m0 a multiple of 8): one ldmatrix .x4 .trans. Lane l names row
// (l & 7) of 8 x 8 matrix l / 8: matrices 0..3 are a0..a3.
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4], const bf16* S,
                                             int ld, int m0, int k0,
                                             int lane) {
  const int q = lane >> 3, r = lane & 7;
  const bf16* p = S + (k0 + r + ((q >> 1) << 3)) * ld + m0 + ((q & 1) << 3);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p))
      : "memory");
}

// (x0, x1) -> NP bf16x2 pieces, x0 in the low halves: p[0] = bf16(x),
// p[1] = bf16(x - p[0]), p[2] = bf16(x - p[0] - p[1]) (each difference
// exact in f32): x = p[0] + p[1] to within 2^-16 |x|, x = p[0] + p[1] +
// p[2] to within 2^-24 |x|
template <int NP>
__device__ __forceinline__ void split(float x0, float x1, uint32_t (&p)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    p[i] = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= __uint_as_float(p[i] << 16);
    x1 -= __uint_as_float(p[i] & 0xffff0000u);
  }
}

// An L2 policy that keeps what it names resident (evict_last): the staged
// weights, re-read by every tile, against the partial-gradient rows
// streamed past them
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(pol));
  return pol;
}

// 16 bytes global -> shared through L2 (cp.async.cg) under the L2 policy
// pol, grouped by commit_group; wait_group<N> returns once at most N of
// this thread's groups are in flight
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint64_t pol) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
      :: "r"(smem_u32(dst)), "l"(src), "l"(pol) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// 16 bytes global -> shared through L2, no cache hint (data read once)
__device__ __forceinline__ void cp_async16_once(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// ---- TMA 1-D bulk copies completing on an mbarrier (a 64-bit word in
// shared memory; PTX ISA "mbarrier", "cp.async.bulk")
// init: `count` arrivals a phase
__device__ __forceinline__ void mbarrier_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
// orders this thread's generic-proxy shared-memory accesses (a barrier's
// initialisation, reads of a buffer) before later async-proxy ones (the
// TMA unit's writes into it)
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// arrive once, expecting `bytes` of transactions in the current phase
__device__ __forceinline__ void mbarrier_expect(uint64_t* bar,
                                                uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbarrier_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  do {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16; both addresses 16-byte aligned) global ->
// this block's shared memory, completing as transactions on `bar`
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace
