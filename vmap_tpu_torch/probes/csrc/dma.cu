// K6: small asynchronous copies into shared memory, `live` in flight
// (vmap_tpu_torch/probes/dma.py; replaces scripts/microbench_dma.py::build,
// the Pallas kernel at :28-52; `live` is its n_live, 1 to 8, 8 by
// default).
//
// Block b issues n copies of one [8, 128] u32 row block (4 KB) of src
// [rows, 128] u32, rows row_b(i) .. row_b(i) + 7 with
//   row_b(i) = g (((b n + i) 37) mod ((rows - 8) / g))
// (grain g = 1 or 8; b = 0 and g = 1: the script's (i 37) mod (rows - 8);
// g = 8 on a source of 8 blocks n + 8 rows reads every byte once), into
// `live` rotating slots of shared memory, copy i into slot i mod live, so
// `live` copies are in flight. Each copy is waited on before word 0 of
// its slot is added to a u32 checksum, and only then is copy i + live
// issued into that slot. The script's kernel issues copy i + live before
// it reads the slot, so its checksum is a race (on the TPU undefined; in
// interpret mode, where a copy completes when it starts, word 0 of copy
// i + live); this one is defined: sum_i src[row_b(i)][0] mod 2^32. After
// the last copy the `live` slots go to a side output, so a copy that moved
// only word 0 would show.
//
// Each slot has warps of its own (slot s: copies s, s + live, s + 2 live,
// ...): they wait on their copy, read word 0 into the slot's partial
// checksum, and issue its next copy; the partials are added in slot order
// at the end (u32: the same sum in any order). So the slots' chains of
// wait, read and issue run side by side, and a copy's time is its round
// trip over `live` where the copy unit overlaps them. One thread issuing every copy
// in turn (the script's loop as written) took 126 ns a copy with 8 in
// flight against a 282 ns round trip with one (bulk, L2, on an H100 80GB
// HBM3 at 700 W): the chain of that thread's wait, read, proxy fence,
// barrier arrival and issue, about 250 clocks, set the pace, not the
// copies. Routes:
//   0 bulk: a warp a slot; its lane 0 issues each copy as one TMA bulk
//     copy (cp.async.bulk, the counterpart of make_async_copy) completing
//     on the slot's mbarrier (the counterpart of the DMA semaphore), waits
//     on the barrier's phase, and a proxy fence orders its read of word 0
//     before its next copy into the slot;
//   1 cp_async: W = group_warps(live) warps a slot (a warp a slot where
//     2 or more are in flight, the block's 8 at one) copy each copy with
//     16-byte cp.async, one commit group a copy, wait for it with
//     wait_group 0 and meet (a warp: __syncwarp; the block:
//     __syncthreads), so the slot's wait is the whole copy's; its thread 0
//     reads word 0, which it copied itself.
// Every shared-memory address the loops use is taken once, before them
// (mbarriers, slots, word 0), so no loop trip recomputes the shared
// window's base. One block (the script's) or 132 (one an SM: the
// aggregate rate K1's grid would see fetching its own pixels). The source
// of a warp's next copy is a pointer stepped by 37 live grains and wrapped
// (Copies), taken at the end of the trip before.
//
// A source of 2 MiB lives in the 50 MB L2, so the cases on it time L2, not
// HBM (dma.py's bound says what each case must move).

#include "probe_common.cuh"

namespace {

constexpr int MAX_LIVE = 8, SLOT_ROWS = 8, COLS = 128;
constexpr uint32_t COPY_BYTES = SLOT_ROWS * COLS * 4;
constexpr uint32_t ROW_BYTES = COLS * 4;

// The sources of a warp's copies, row_b(i) of src for i = first, first +
// stride, ..., kept as a pointer stepped by 37 stride grains and wrapped
// (no 64-bit product or division between copies, and nothing ptxas would
// recompute from an index after a wait).
struct Copies {
  const uint32_t *at, *end;
  size_t step, span;  // words
  __device__ Copies(const uint32_t* src, long long first, int rows, int g, int stride) {
    const int grains = (rows - SLOT_ROWS) / g;
    span = (size_t)grains * g * COLS;
    end = src + span;
    at = src + (size_t)((first * 37) % grains) * g * COLS;
    step = (size_t)(37LL * stride % grains) * g * COLS;
  }
  __device__ const uint32_t* next() {
    const uint32_t* r = at;
    at += step;
    if (at >= end) at -= span;
    return r;
  }
};

// The end of a launch: the warps' partial checksums added in slot order,
// and the `live` slots to this block's [live][8][128] of out.
__device__ void finish(const uint32_t* part, const uint32_t (*slot)[SLOT_ROWS][COLS],
                       int live, uint32_t* sums, uint32_t* out) {
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t acc = 0;
    for (int s = 0; s < live; ++s) acc += part[s];
    sums[blockIdx.x] = acc;
  }
  const uint32_t* w = &slot[0][0][0];
  const int words = live * SLOT_ROWS * COLS;
  for (int k = threadIdx.x; k < words; k += blockDim.x)
    out[(size_t)blockIdx.x * words + k] = w[k];
}

// 32 live threads: warp s < live owns slot s.
__global__ void __launch_bounds__(32 * MAX_LIVE)
dma_bulk_kernel(const uint32_t* __restrict__ src, int rows, int n, int live,
                int grain, uint32_t* __restrict__ sums,
                uint32_t* __restrict__ slots) {
  __shared__ __align__(128) uint32_t slot[MAX_LIVE][SLOT_ROWS][COLS];
  __shared__ __align__(8) uint64_t bars[MAX_LIVE];
  __shared__ uint32_t part[MAX_LIVE];
  const int s = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    probe::mbar_init(&bars[s], 1);
    probe::fence_proxy_async();
    const uint32_t bar = probe::smem_u32(&bars[s]), dst = probe::smem_u32(slot[s]);
    Copies copies(src, (long long)blockIdx.x * n + s, rows, grain, live);
    probe::mbar_arrive_expect_tx(bar, COPY_BYTES);
    probe::bulk_g2s(dst, copies.next(), COPY_BYTES, bar);
    // the next copy's source, taken at the end of the trip before
    const uint32_t* from = copies.next();
    uint32_t acc = 0, parity = 0;
    for (int i = s; i < n; i += live) {
      probe::mbar_wait(bar, parity);
      acc += probe::ld_shared_volatile(dst);
      if (i + live < n) {
        probe::fence_proxy_async();
        probe::mbar_arrive_expect_tx(bar, COPY_BYTES);
        probe::bulk_g2s(dst, from, COPY_BYTES, bar);
      }
      from = copies.next();
      parity ^= 1u;
    }
    part[s] = acc;
  }
  finish(part, slot, live, sums, slots);
}

// The warps copying one slot's copies on the cp_async route: the block's
// 8 at one in flight, else one, so a launch has at most 8 warps and a
// warp's lanes 8 / W chunks of a copy.
__host__ __device__ constexpr int group_warps(int live) { return live == 1 ? 8 : 1; }

// 32 W live threads: warps W s .. W s + W - 1 own slot s; thread t of the
// group copies the 16-byte chunks t + 32 W j of a copy (j < 8 / W: words
// 4 (c % 32) .. + 3 of row c / 32 of chunk c).
template <int W>
__global__ void __launch_bounds__(32 * MAX_LIVE)
dma_cp_async_kernel(const uint32_t* __restrict__ src, int rows, int n, int live,
                    int grain, uint32_t* __restrict__ sums,
                    uint32_t* __restrict__ slots) {
  constexpr int CHUNKS = SLOT_ROWS / W;
  __shared__ __align__(128) uint32_t slot[MAX_LIVE][SLOT_ROWS][COLS];
  __shared__ uint32_t part[MAX_LIVE];
  const int s = threadIdx.x / (32 * W), t = threadIdx.x % (32 * W);
  // this thread's first chunk (row r0, words w0 ..) in the slot
  const int r0 = t / 32, w0 = 4 * (t % 32);
  const uint32_t dst = probe::smem_u32(&slot[s][r0][w0]), word0 = probe::smem_u32(slot[s]);
  Copies copies(src, (long long)blockIdx.x * n + s, rows, grain, live);
  // this thread's first chunk of the next copy
  auto chunk = [&]() { return copies.next() + r0 * COLS + w0; };
  auto issue = [&](const uint32_t* from) {
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j)
      probe::cp_async16(dst + j * W * ROW_BYTES, from + j * W * COLS);
  };
  issue(chunk());
  probe::cp_async_commit();
  // the next copy's chunk, taken at the end of the trip before (ptxas
  // would sink it past the barrier, onto the copy's round trip)
  const uint32_t* from = chunk();
  uint32_t acc = 0;
  for (int i = s; i < n; i += live) {
    probe::cp_async_wait<0>();
    if constexpr (W == 1)
      __syncwarp();
    else
      __syncthreads();
    if (t == 0) acc += probe::ld_shared_volatile(word0);
    if (i + live < n) issue(from);
    probe::cp_async_commit();  // an empty group after the last copy
    from = chunk();
  }
  if (t == 0) part[s] = acc;
  finish(part, slot, live, sums, slots);
}

}  // namespace

// route 0 bulk / 1 cp_async; src [rows][128] u32 (rows > 8, 16-byte
// aligned); live 1..8 copies in flight; n >= live copies a block; blocks
// 1..1024; grain 1 or 8 rows; sums [blocks] u32, slots
// [blocks][live][8][128] u32. Returns a CUDA error code.
extern "C" int vmap_probe_dma(int route, const void* src, int rows, int n,
                              int live, int blocks, int grain, void* sums,
                              void* slots, void* stream) {
  if (route < 0 || route > 1 || rows <= SLOT_ROWS || live < 1 ||
      live > MAX_LIVE || n < live || blocks < 1 ||
      blocks > 1024 || (grain != 1 && grain != SLOT_ROWS) ||
      (rows - SLOT_ROWS) / grain < 1 ||
      reinterpret_cast<uintptr_t>(src) % 16)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto in = static_cast<const uint32_t*>(src);
  auto sm = static_cast<uint32_t*>(sums);
  auto sl = static_cast<uint32_t*>(slots);
  const int threads = 32 * live * (route == 0 ? 1 : group_warps(live));
  switch (route == 0 ? 0 : group_warps(live)) {
    case 0: dma_bulk_kernel<<<blocks, threads, 0, s>>>(in, rows, n, live, grain, sm, sl); break;
    case 1: dma_cp_async_kernel<1><<<blocks, threads, 0, s>>>(in, rows, n, live, grain, sm, sl); break;
    default: dma_cp_async_kernel<8><<<blocks, threads, 0, s>>>(in, rows, n, live, grain, sm, sl); break;
  }
  return (int)cudaGetLastError();
}
