// K6: small asynchronous copies into shared memory, 8 in flight
// (vmap_tpu_torch/probes/dma.py; replaces scripts/microbench_dma.py::build,
// the Pallas kernel at :28-52).
//
// Block b issues n copies of one [8, 128] u32 row block (4 KB) of src
// [rows, 128] u32, rows row_b(i) .. row_b(i) + 7 with
//   row_b(i) = g (((b n + i) 37) mod ((rows - 8) / g))
// (grain g = 1 or 8; b = 0 and g = 1: the script's (i 37) mod (rows - 8);
// g = 8 on a source of 8 blocks n + 8 rows reads every byte once), into 8
// rotating slots of
// shared memory, 8 copies in flight. For each i in order it waits for copy
// i, adds word 0 of its slot to a u32 checksum, and only then issues copy
// i + 8 into that slot. The script's kernel issues copy i + 8 before it
// reads the slot, so its checksum is a race (on the TPU undefined; in
// interpret mode, where a copy completes when it starts, word 0 of copy
// i + 8); this one is defined: sum_i src[row_b(i)][0] mod 2^32. After the
// last copy the 8 slots go to a side output, so a copy that moved only
// word 0 would show. Routes:
//   0 bulk: thread 0 of the block issues each copy as one TMA bulk copy
//     (cp.async.bulk, the counterpart of make_async_copy) completing on
//     the slot's mbarrier (the counterpart of the DMA semaphore) and waits
//     on the barrier's phase; a proxy fence orders its read of the slot
//     before the next copy into it;
//   1 cp_async: 256 threads, each copies 16 B of every copy with cp.async
//     (one commit group a copy), waits with wait_group<7> (the copy 8
//     groups back), and the block meets at one barrier a copy before
//     thread 0 reads the slot.
// One block (the script's) or 132 (one an SM: the aggregate rate K1's
// grid would see fetching its own pixels). The row of the next copy is
// kept incrementally (+37 grains, wrapped), so no 64-bit division sits
// between copies.
//
// A source of 2 MiB lives in the 50 MB L2, so the cases on it time L2, not
// HBM (dma.py's bound says what each case must move).

#include "probe_common.cuh"

namespace {

constexpr int LIVE = 8, SLOT_ROWS = 8, COLS = 128;
constexpr uint32_t COPY_BYTES = SLOT_ROWS * COLS * 4;
constexpr int CP_THREADS = COPY_BYTES / 16;          // 256: 16 B each

struct Rows {  // row_b(i) in grains of g rows
  int grain, span, at;
  __device__ Rows(long long first, int rows, int g)
      : grain(g), span((rows - SLOT_ROWS) / g),
        at((int)((first * 37) % ((rows - SLOT_ROWS) / g))) {}
  __device__ size_t next() {
    const int r = at;
    at += 37;
    if (at >= span) at -= span;
    return (size_t)r * grain;
  }
};

__device__ void write_slots(const uint32_t (*slot)[SLOT_ROWS][COLS],
                            uint32_t* out) {
  const uint32_t* s = &slot[0][0][0];
  for (int k = threadIdx.x; k < LIVE * SLOT_ROWS * COLS; k += blockDim.x)
    out[(size_t)blockIdx.x * LIVE * SLOT_ROWS * COLS + k] = s[k];
}

__global__ void __launch_bounds__(128)
dma_bulk_kernel(const uint32_t* __restrict__ src, int rows, int n, int grain,
                uint32_t* __restrict__ sums, uint32_t* __restrict__ slots) {
  __shared__ __align__(128) uint32_t slot[LIVE][SLOT_ROWS][COLS];
  __shared__ __align__(8) uint64_t bar[LIVE];
  if (threadIdx.x == 0) {
    for (int s = 0; s < LIVE; ++s) probe::mbar_init(&bar[s], 1);
    probe::fence_proxy_async();
    Rows next((long long)blockIdx.x * n, rows, grain);
    for (int s = 0; s < LIVE && s < n; ++s) {
      probe::mbar_arrive_expect_tx(&bar[s], COPY_BYTES);
      probe::bulk_g2s(slot[s], src + next.next() * COLS, COPY_BYTES,
                      &bar[s]);
    }
    uint32_t acc = 0;
    for (int i = 0; i < n; ++i) {
      const int s = i % LIVE;
      probe::mbar_wait(&bar[s], (uint32_t)(i / LIVE) & 1u);
      acc += *reinterpret_cast<volatile uint32_t*>(&slot[s][0][0]);
      if (i + LIVE < n) {
        probe::fence_proxy_async();
        probe::mbar_arrive_expect_tx(&bar[s], COPY_BYTES);
        probe::bulk_g2s(slot[s], src + next.next() * COLS, COPY_BYTES,
                        &bar[s]);
      }
    }
    sums[blockIdx.x] = acc;
  }
  __syncthreads();
  write_slots(slot, slots);
}

__global__ void __launch_bounds__(CP_THREADS)
dma_cp_async_kernel(const uint32_t* __restrict__ src, int rows, int n,
                    int grain, uint32_t* __restrict__ sums,
                    uint32_t* __restrict__ slots) {
  __shared__ __align__(128) uint32_t slot[LIVE][SLOT_ROWS][COLS];
  // thread t copies words 4 (t % 32) .. + 3 of row t / 32 of every copy
  const int t = threadIdx.x, r = t / 32, w = (t % 32) * 4;
  Rows next((long long)blockIdx.x * n, rows, grain);
  for (int s = 0; s < LIVE; ++s) {
    const size_t row = next.next();
    if (s < n) probe::cp_async16(&slot[s][r][w], src + (row + r) * COLS + w);
    probe::cp_async_commit();
  }
  uint32_t acc = 0;
  for (int i = 0; i < n; ++i) {
    const int s = i % LIVE;
    probe::cp_async_wait<LIVE - 1>();
    __syncthreads();
    if (t == 0) acc += slot[s][0][0];
    const size_t row = next.next();
    if (i + LIVE < n)
      probe::cp_async16(&slot[s][r][w], src + (row + r) * COLS + w);
    probe::cp_async_commit();
  }
  probe::cp_async_wait<0>();
  __syncthreads();
  if (t == 0) sums[blockIdx.x] = acc;
  write_slots(slot, slots);
}

}  // namespace

// route 0 bulk / 1 cp_async; src [rows][128] u32 (rows > 8, 16-byte
// aligned); n >= 8 copies a block; blocks 1..1024; grain 1 or 8 rows;
// sums [blocks] u32, slots [blocks][8][8][128] u32. Returns a CUDA error
// code.
extern "C" int vmap_probe_dma(int route, const void* src, int rows, int n,
                              int blocks, int grain, void* sums, void* slots,
                              void* stream) {
  if (route < 0 || route > 1 || rows <= SLOT_ROWS || n < LIVE || blocks < 1 ||
      blocks > 1024 || (grain != 1 && grain != SLOT_ROWS) ||
      (rows - SLOT_ROWS) / grain < 1 ||
      reinterpret_cast<uintptr_t>(src) % 16)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto in = static_cast<const uint32_t*>(src);
  auto sm = static_cast<uint32_t*>(sums);
  auto sl = static_cast<uint32_t*>(slots);
  if (route == 0)
    dma_bulk_kernel<<<blocks, 128, 0, s>>>(in, rows, n, grain, sm, sl);
  else
    dma_cp_async_kernel<<<blocks, CP_THREADS, 0, s>>>(in, rows, n, grain, sm,
                                                      sl);
  return (int)cudaGetLastError();
}
