"""K6: the cost of small copies into shared memory, 8 in flight.

Counterpart of ``scripts/microbench_dma.py::build``, the probe that asked
whether K1 should fetch its sampled pixels itself instead of the
sampler's gather. A launch runs ``n`` copies of one [8, 128] u32 row block
(4 KB) of src [rows, 128] a block, rows row_b(i) .. row_b(i) + 7 with

    row_b(i) = g (((b n + i) 37) mod ((rows - 8) / g))

(block b, grain g = 1 or 8; b = 0 and g = 1: the script's (i 37) mod
(rows - 8)) into 8 rotating shared-memory slots, waiting on copy i
before it issues copy i + 8 into the same slot, and returns a checksum of
word 0 of every copy and the 8 slots after the last copy (csrc/dma.cu).

**The script's checksum is a race.** Its loop (``microbench_dma.py:41-46``)
waits on copy i, starts copy i + 8 into the same slot, and only then
reads the slot. On a TPU the value is undefined; in interpret mode, where
a copy completes when it starts, it is word 0 of copy i + 8 for i < n - 8
and of copy i for the last 8. This port reads the slot before it issues
the next copy into it, so its checksum is defined:
sum_i src[row(i), 0] mod 2^32. The words are kept as int32 (as
``core/pool.py`` keeps the pool's) and summed as int64.

Cases (``CASES``), each timed by the script's slope, n = 4000 and 16000
copies a block, in ns a copy:

  * ``bulk``: TMA bulk copies issued by one thread, the script's 2 MiB
    source, one block. The source lives in the 50 MB L2: this times L2,
    not device memory as on the TPU;
  * ``cp_async``: the same copies as 16 B ``cp.async`` by 256 threads, a
    commit group and a block barrier a copy (L2, one block);
  * ``bulk_hbm``: a 256 MiB source (524,288 rows: the row formula spans
    it), one block; its 16000 copies read distinct rows;
  * ``bulk_hbm_132``: 132 blocks (one an SM), each its own stretch of the
    row sequence, on a source that holds every copy of a launch apart:
    g = 8 and 132 x 16000 windows of 8 rows (8.65 GB), so a launch reads
    each byte of what it copies once, from device memory (37 is prime to
    the window count). This is the aggregate rate K1's grid would see
    fetching its own pixels (ns a copy of one block; the aggregate is that
    over 132).

``bound`` counts the bytes a launch must move as the contract of the
kernels line counts them, each input byte read once: the distinct rows a
launch reads (``unique_bytes``) over the HBM rate. The script's 2 MiB
source is read whole by 4000 copies already, so for bulk and cp_async that
slope is 0; there, and for one block, the bound is the 4 KB each copy
writes into one SM's shared memory (``probes.SMEM_BYTES_PER_SM``).

    python -m vmap_tpu_torch.probes.dma [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from vmap_tpu_torch import probes
from vmap_tpu_torch.probes import _timing

LIVE, SLOT_ROWS, COLS = 8, 8, 128
COPY_BYTES = SLOT_ROWS * COLS * 4
CASES = ("bulk", "cp_async", "bulk_hbm", "bulk_hbm_132")
ROUTE = {"bulk": 0, "cp_async": 1, "bulk_hbm": 0, "bulk_hbm_132": 0}
N1, N2 = 4000, 16000                   # the script's n and 4 n
BLOCKS = {"bulk_hbm_132": 132}
GRAIN = {"bulk_hbm_132": SLOT_ROWS}
SRC_ROWS = {"bulk": 4096, "cp_async": 4096, "bulk_hbm": 524_288,
            "bulk_hbm_132": SLOT_ROWS * 132 * N2 + SLOT_ROWS}
MASK = 0xFFFFFFFF


def make_source(rows: int, dev) -> torch.Tensor:
    """src [rows, 128]: u32 words below 2^31 held as int32. The script's
    4096 rows are its own draw (default_rng(0).integers(0, 2^31)); a
    larger source is drawn on the device from a generator seeded 0."""
    if rows == 4096:
        words = np.random.default_rng(0).integers(0, 2 ** 31, (rows, COLS))
        return torch.tensor(words.astype(np.int32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    return torch.randint(0, 2 ** 31, (rows, COLS), generator=gen,
                         dtype=torch.int32, device=dev)


def copy_rows(src_rows: int, n: int, blocks: int = 1, grain: int = 1,
              device=None) -> torch.Tensor:
    """row_b(i) [blocks, n], int64."""
    i = (torch.arange(blocks, dtype=torch.int64, device=device)[:, None] * n
         + torch.arange(n, dtype=torch.int64, device=device))
    return i * 37 % ((src_rows - SLOT_ROWS) // grain) * grain


def unique_bytes(case: str, n: int) -> int:
    """Bytes of the source that a launch of ``n`` copies a block reads,
    each distinct row counted once."""
    rows = copy_rows(SRC_ROWS[case], n, BLOCKS.get(case, 1),
                     GRAIN.get(case, 1))
    touched = torch.zeros(SRC_ROWS[case], dtype=torch.bool)
    touched[(rows[..., None] + torch.arange(SLOT_ROWS)).reshape(-1)] = True
    return int(touched.sum()) * COLS * 4


def chain_reference(src: torch.Tensor, n: int, blocks: int = 1,
                    grain: int = 1) -> dict:
    """Plain version: {"sums": the defined checksum of each block [blocks]
    (int64 in [0, 2^32)), "slots": [blocks, 8, 8, 128] int32, slot s
    holding the last copy i with i mod 8 = s, "rows": row_b(i)}."""
    rows = copy_rows(src.shape[0], n, blocks, grain, src.device)
    sums = (src[rows, 0].long() & MASK).sum(1) & MASK
    last = rows[:, n - LIVE:]                         # copies n-8 .. n-1
    block = src[last[..., None] + torch.arange(SLOT_ROWS, device=src.device)]
    # copy n - 8 + k sits in slot (n + k) mod 8
    return {"sums": sums, "slots": torch.roll(block, n % LIVE, 1),
            "rows": rows}


def launch(src: torch.Tensor, n: int, route: int, blocks: int = 1,
           grain: int = 1) -> dict:
    """The copy kernel (csrc/dma.cu) on a CUDA source: {"sums", "slots"}
    as ``chain_reference``."""
    if (src.dim() != 2 or src.shape[1] != COLS or src.dtype != torch.int32
            or src.shape[0] <= SLOT_ROWS or n < LIVE
            or not 1 <= blocks <= 1024 or grain not in (1, SLOT_ROWS)):
        raise ValueError(f"dma probe takes an int32 [rows > 8, {COLS}] "
                         f"source, n >= 8, 1..1024 blocks and grain 1 or "
                         f"8; got {tuple(src.shape)} {src.dtype} n={n} "
                         f"blocks={blocks} grain={grain}")
    dev = probes.check_cuda(src)
    sums = torch.empty(blocks, dtype=torch.int32, device=dev)
    slots = torch.empty((blocks, LIVE, SLOT_ROWS, COLS), dtype=torch.int32,
                        device=dev)
    code = probes.LIBRARY.load().vmap_probe_dma(
        route, probes.ptr(src), src.shape[0], n, blocks, grain,
        probes.ptr(sums),
        probes.ptr(slots), probes.stream(dev))
    probes.LIBRARY.check(code, f"dma probe (route {route}) launch")
    probes.LAUNCHES["dma"] += 1
    return {"sums": sums.long() & MASK, "slots": slots}


def run_case(case: str, src: torch.Tensor, n: int) -> dict:
    """A case's copies: the plain version on a CPU source, the kernel on
    CUDA."""
    blocks, grain = BLOCKS.get(case, 1), GRAIN.get(case, 1)
    if src.device.type == "cpu":
        return chain_reference(src, n, blocks, grain)
    return launch(src, n, ROUTE[case], blocks, grain)


def source(case: str, dev, cache: dict) -> torch.Tensor:
    """The case's source, made once per size into ``cache``."""
    rows = SRC_ROWS[case]
    if rows not in cache:
        cache[rows] = make_source(rows, dev)
    return cache[rows]


def compare(dev: torch.device, reps: int = N1) -> list:
    """Every case's kernel against its plain version at ``reps`` copies a
    block (by default the script's n): the checksums and the 8 final
    slots bit-equal. Raises if one differs."""
    res, sources = [], {}
    for case in CASES:
        src = source(case, dev, sources)
        blocks, grain = BLOCKS.get(case, 1), GRAIN.get(case, 1)
        got = launch(src, reps, ROUTE[case], blocks, grain)
        want = chain_reference(src, reps, blocks, grain)
        res.append(probes.held(f"{case} checksum", got["sums"],
                               want["sums"], 0.0))
        res.append(probes.held(f"{case} slots", got["slots"], want["slots"],
                               0.0))
    return res


def measure(case: str, src: torch.Tensor, dev: torch.device) -> dict:
    blocks = BLOCKS.get(case, 1)
    sl = _timing.slope(lambda n: run_case(case, src, n)["sums"], N1, N2,
                       dev)
    return {"case": case, "blocks": blocks, "src_rows": src.shape[0],
            "reps": (N1, N2), **sl, "ns_per_copy": sl["step_ns"],
            "aggregate_ns_per_copy": sl["step_ns"] / blocks,
            "gb_per_s": blocks * COPY_BYTES / sl["step_ns"]}


def bound(case: dict) -> dict:
    """A copy's bound (ns a copy of each block, as ``measure``): the larger
    of the distinct source bytes a copy adds to a launch (the slope of
    ``unique_bytes`` between N1 and N2, all blocks) over the HBM rate, and
    its 4 KB into one SM's shared memory."""
    name = case["case"]
    new = (unique_bytes(name, N2) - unique_bytes(name, N1)) / (N2 - N1)
    return probes.bound(bytes_s=max(new / probes.PEAK_BYTES,
                                    COPY_BYTES / probes.SMEM_BYTES_PER_SM))


def plain_ms(case: dict, dev: torch.device) -> float:
    """The plain version (the checksums' gather and sum) a copy."""
    src = make_source(SRC_ROWS[case["case"]], dev)
    blocks, grain = BLOCKS.get(case["case"], 1), GRAIN.get(case["case"], 1)
    return _timing.graph_step_ms(
        lambda n: chain_reference(src, n, blocks, grain)["sums"], dev,
        (N1, N2))


def library_ms(case: dict, dev: torch.device) -> float:
    """``torch.index_select`` of the copies' rows (all blocks), a copy."""
    name = case["case"]
    src = make_source(SRC_ROWS[name], dev)
    idx = {n: (copy_rows(src.shape[0], n, BLOCKS.get(name, 1),
                         GRAIN.get(name, 1), dev)[..., None]
               + torch.arange(SLOT_ROWS, device=dev)).reshape(-1)
           for n in (N1, N2)}
    return _timing.graph_step_ms(
        lambda n: torch.index_select(src, 0, idx[n]), dev, (N1, N2))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = probes.device_from_arg(args.device)
    print(f"device: {_timing.device_label(dev)}", flush=True)
    out, sources = [], {}
    for case in CASES:
        src = source(case, dev, sources)
        rows = src.shape[0]
        r = measure(case, src, dev)
        where = "L2-resident" if rows * COLS * 4 < 50e6 else "device memory"
        print(f"{case} ({r['blocks']} block(s), {rows} x {COLS} u32 source, "
              f"{where}): {r['ns_per_copy']:.1f} ns a copy of {COPY_BYTES} "
              f"B, aggregate {r['aggregate_ns_per_copy']:.2f} ns a copy, "
              f"{r['gb_per_s']:.1f} GB/s", flush=True)
        out.append(r)
    return out


if __name__ == "__main__":
    main()
