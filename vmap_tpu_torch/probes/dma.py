"""K6: the cost of small copies into shared memory, 8 (or ``live``) in flight.

Counterpart of ``scripts/microbench_dma.py::build``, the probe that asked
whether K1 should fetch its sampled pixels itself instead of the
sampler's gather. A launch runs ``n`` copies of one [8, 128] u32 row block
(4 KB) of src [rows, 128] a block, rows row_b(i) .. row_b(i) + 7 with

    row_b(i) = g (((b n + i) 37) mod ((rows - 8) / g))

(block b, grain g = 1 or 8; b = 0 and g = 1: the script's (i 37) mod
(rows - 8)) into ``live`` rotating shared-memory slots (the script's
``n_live``, 1 to 8, 8 by default), waiting on copy i before it issues copy
i + live into the same slot, and returns a checksum of word 0 of every
copy and the ``live`` slots after the last copy (csrc/dma.cu).

**The script's checksum is a race.** Its loop (``microbench_dma.py:41-46``)
waits on copy i, starts copy i + live into the same slot, and only then
reads the slot. On a TPU the value is undefined; in interpret mode, where
a copy completes when it starts, it is word 0 of copy i + live for i < n -
live and of copy i for the last ``live``. This port reads the slot before
it issues the next copy into it, so its checksum is defined:
sum_i src[row(i), 0] mod 2^32. The words are kept as int32 (as
``core/pool.py`` keeps the pool's) and summed as int64.

**A warp a slot.** Warp s of a block owns slot s and makes copies s, s +
live, ... (``slot_copies``): it waits on its copy, adds word 0 to its own
partial checksum and issues its next copy, so the slots' chains run side
by side; the partials are added in slot order (u32: the same sum). One
thread issuing every copy in turn, the script's loop as written, was held
to about 250 clocks a copy by its own chain of wait, read, fence and
issue, whatever the copies' round trip.

Cases (``CASES``), each timed by the script's slope, n = 4000 and 16000
copies a block, in ns a copy:

  * ``bulk``: TMA bulk copies, each issued by lane 0 of its slot's warp,
    the script's 2 MiB source, one block. The source lives in the 50 MB
    L2: this times L2, not device memory as on the TPU;
  * ``cp_async``: the same copies as 16 B ``cp.async`` by the slot's
    warps (``group_warps``: one where 2 or more are in flight, the
    block's 8 at one), a
    commit group a copy (``chunk_writes``), the slot's warps meeting after
    their wait (L2, one block);
  * ``bulk_hbm``: a 256 MiB source (524,288 rows: the row formula spans
    it), one block; its 16000 copies read distinct rows;
  * ``bulk_hbm_132``: 132 blocks (one an SM), each its own stretch of the
    row sequence, on a source that holds every copy of a launch apart:
    g = 8 and 132 x 16000 windows of 8 rows (8.65 GB), so a launch reads
    each byte of what it copies once, from device memory (37 is prime to
    the window count). This is the aggregate rate K1's grid would see
    fetching its own pixels (ns a copy of one block; the aggregate is that
    over 132);
  * ``bulk_live1``, ``cp_async_live1``, ``bulk_hbm_live1``: bulk, cp_async
    and bulk_hbm with one copy in flight, so a copy's time is its round
    trip. Over 8 it is the floor an 8-deep ring reaches if the copy unit
    overlaps one SM's copies.

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

# LIVE: the script's n_live default, and the most copies the kernels keep
# in flight
LIVE, SLOT_ROWS, COLS = 8, 8, 128
COPY_BYTES = SLOT_ROWS * COLS * 4
CASES = ("bulk", "cp_async", "bulk_hbm", "bulk_hbm_132", "bulk_live1",
         "cp_async_live1", "bulk_hbm_live1")
ROUTE = {"bulk": 0, "cp_async": 1, "bulk_hbm": 0, "bulk_hbm_132": 0,
         "bulk_live1": 0, "cp_async_live1": 1, "bulk_hbm_live1": 0}
N1, N2 = 4000, 16000                   # the script's n and 4 n
BLOCKS = {"bulk_hbm_132": 132}
GRAIN = {"bulk_hbm_132": SLOT_ROWS}
LIVE_OF = {"bulk_live1": 1, "cp_async_live1": 1, "bulk_hbm_live1": 1}
SRC_ROWS = {"bulk": 4096, "cp_async": 4096, "bulk_hbm": 524_288,
            "bulk_hbm_132": SLOT_ROWS * 132 * N2 + SLOT_ROWS,
            "bulk_live1": 4096, "cp_async_live1": 4096,
            "bulk_hbm_live1": 524_288}
MASK = 0xFFFFFFFF


def slot_copies(n: int, live: int = LIVE) -> list:
    """The copies each slot's warp makes, in its order (csrc/dma.cu: warp
    s copies s, s + live, ...; copy i lands in slot i mod live)."""
    return [list(range(s, n, live)) for s in range(live)]


def group_warps(live: int) -> int:
    """The warps copying one slot's copies on the cp_async route
    (csrc/dma.cu group_warps): the block's 8 at one in flight, else one."""
    return 8 if live == 1 else 1


def chunk_writes(live: int = LIVE) -> list:
    """The cp_async route's 16-byte chunks of one 4 KB copy (csrc/dma.cu):
    [(thread of the slot's group, first byte)], thread t of W =
    ``group_warps(live)`` warps the chunks t + 32 W j, j < 8 / W."""
    w = group_warps(live)
    return [(t, 16 * (t + 32 * w * j)) for t in range(32 * w)
            for j in range(SLOT_ROWS // w)]


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
                    grain: int = 1, live: int = LIVE) -> dict:
    """Plain version: {"sums": the defined checksum of each block [blocks]
    (int64 in [0, 2^32)), "slots": [blocks, live, 8, 128] int32, slot s
    holding the last copy i with i mod live = s, "rows": row_b(i)}."""
    rows = copy_rows(src.shape[0], n, blocks, grain, src.device)
    sums = (src[rows, 0].long() & MASK).sum(1) & MASK
    last = rows[:, n - live:]                   # copies n - live .. n - 1
    block = src[last[..., None] + torch.arange(SLOT_ROWS, device=src.device)]
    # copy n - live + k sits in slot (n + k) mod live
    return {"sums": sums, "slots": torch.roll(block, n % live, 1),
            "rows": rows}


def launch(src: torch.Tensor, n: int, route: int, blocks: int = 1,
           grain: int = 1, live: int = LIVE) -> dict:
    """The copy kernel (csrc/dma.cu) on a CUDA source: {"sums", "slots"}
    as ``chain_reference``."""
    if (src.dim() != 2 or src.shape[1] != COLS or src.dtype != torch.int32
            or src.shape[0] <= SLOT_ROWS or not 1 <= live <= LIVE
            or n < live or not 1 <= blocks <= 1024
            or grain not in (1, SLOT_ROWS)):
        raise ValueError(f"dma probe takes an int32 [rows > 8, {COLS}] "
                         f"source, 1..{LIVE} copies in flight, n >= "
                         f"live, 1..1024 blocks and grain 1 or 8; got "
                         f"{tuple(src.shape)} {src.dtype} n={n} live={live} "
                         f"blocks={blocks} grain={grain}")
    dev = probes.check_cuda(src)
    sums = torch.empty(blocks, dtype=torch.int32, device=dev)
    slots = torch.empty((blocks, live, SLOT_ROWS, COLS), dtype=torch.int32,
                        device=dev)
    code = probes.LIBRARY.load().vmap_probe_dma(
        route, probes.ptr(src), src.shape[0], n, live, blocks, grain,
        probes.ptr(sums), probes.ptr(slots), probes.stream(dev))
    probes.LIBRARY.check(code, f"dma probe (route {route}) launch")
    probes.LAUNCHES["dma"] += 1
    return {"sums": sums.long() & MASK, "slots": slots}


def run_case(case: str, src: torch.Tensor, n: int) -> dict:
    """A case's copies: the plain version on a CPU source, the kernel on
    CUDA."""
    blocks, grain = BLOCKS.get(case, 1), GRAIN.get(case, 1)
    live = LIVE_OF.get(case, LIVE)
    if src.device.type == "cpu":
        return chain_reference(src, n, blocks, grain, live)
    return launch(src, n, ROUTE[case], blocks, grain, live)


def source(case: str, dev, cache: dict) -> torch.Tensor:
    """The case's source, made once per size into ``cache``."""
    rows = SRC_ROWS[case]
    if rows not in cache:
        cache[rows] = make_source(rows, dev)
    return cache[rows]


def compare(dev: torch.device, reps: int = N1) -> list:
    """Every case's kernel against its plain version at ``reps`` copies a
    block (by default the script's n), 8 copies in flight or one as the
    case says: the checksums and the final slots bit-equal. Raises if one
    differs."""
    res, sources = [], {}
    for case in CASES:
        src = source(case, dev, sources)
        blocks, grain = BLOCKS.get(case, 1), GRAIN.get(case, 1)
        live = LIVE_OF.get(case, LIVE)
        got = launch(src, reps, ROUTE[case], blocks, grain, live)
        want = chain_reference(src, reps, blocks, grain, live)
        res.append(probes.held(f"{case} checksum", got["sums"],
                               want["sums"], 0.0))
        res.append(probes.held(f"{case} slots", got["slots"],
                               want["slots"], 0.0))
    return res


def measure(case: str, src: torch.Tensor, dev: torch.device) -> dict:
    blocks = BLOCKS.get(case, 1)
    sl = _timing.slope(lambda n: run_case(case, src, n)["sums"], N1, N2,
                       dev)
    return {"case": case, "blocks": blocks, "live": LIVE_OF.get(case, LIVE),
            "src_rows": src.shape[0],
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
    name = case["case"]
    src = make_source(SRC_ROWS[name], dev)
    blocks, grain = BLOCKS.get(name, 1), GRAIN.get(name, 1)
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
        print(f"{case} ({r['blocks']} block(s), {r['live']} in flight, "
              f"{rows} x {COLS} u32 source, "
              f"{where}): {r['ns_per_copy']:.1f} ns a copy of {COPY_BYTES} "
              f"B, aggregate {r['aggregate_ns_per_copy']:.2f} ns a copy, "
              f"{r['gb_per_s']:.1f} GB/s", flush=True)
        out.append(r)
    return out


if __name__ == "__main__":
    main()
