"""K4: the rate of chained matrix products at K1's shapes on the card.

Counterpart of ``scripts/microbench_mm.py::_one``. One launch runs
``reps`` dependent steps of

    y = sum_j W_j @ c,  W_j = W (1 + 0.001 j), j < ind      [m, n]
    c <- fold(y) / (1 + ind)                                 [k, n]

(``fold`` repeats y's rows until there are k of them, as the script's
concat does), from c = c0, and returns the last carry. Variants:

  * ``f32``: FP32 FMA, IEEE (never TF32);
  * ``bf16``: W and each step's carry rounded to bf16, products on
    ``wgmma`` bf16 tensor cores with f32 accumulation, as the script's
    ``dt = bf16`` kernel computes (W_j = bf16(W) bf16(1 + 0.001 j), which
    is bf16(W) for j < 4);
  * ``f32_3xbf16``: the f32 product on bf16 tensor cores, each operand
    split as hi = bf16(x), lo = bf16(x - hi) and a @ b taken as
    ah bh + ah bl + al bh: the accurate tensor-core route for K1's f32
    policy, held to the f32 plain version.

W @ c is separable by column, and the step's work (m k n) is cut from the
card (``plan``, mirrored by ``csrc/chain.cuh``, which says more): a
*block* plan gives each block a slab of columns and every row of W, so
its chain needs nothing from another block (K1's own products, one chain
of [h, h] x [h, P] a block on all 132 SMs, n = 132 P; the script's shapes
whose W fits beside a 16-column slab); a *grid* plan cuts W into panels
(64 rows for the tensor cores, 32 or 64 for FMA) and n into slabs so
that every SM has a (panel, slab) each step, keeps each block's W panel
in shared memory for the whole chain where it fits, and exchanges the
fold through L2 with one grid barrier a step; a *cluster* plan (tensor
cores, a slab's panels within one thread-block cluster) exchanges it
through the cluster's shared memory instead. The loop-invariant operand
copies (bf16 / hi / lo, the scaled W_j) are made in ``operands`` and laid
out for the plan in ``launch``; the tensor-core variants take ind = 1.

Values leave the f32 range within tens of steps (the carry grows about
k 0.05 / (1 + ind) a step), so the kernel is held against its plain version
at a few steps and timed at the script's (200, or 40 above 400 M
multiply-adds, and 4x that).

    python -m vmap_tpu_torch.probes.mm [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from vmap_tpu_torch import probes
from vmap_tpu_torch.kernels import MAX_POINTS
from vmap_tpu_torch.probes import _timing

VARIANTS = ("f32", "bf16", "f32_3xbf16")
VARIANT_CODE = {v: i for i, v in enumerate(VARIANTS)}
# scripts/microbench_mm.py:88-95: (m, k, n) per dtype, then f32 ind4
SCRIPT_SHAPES = ((128, 128, 1280), (128, 384, 1280), (256, 256, 1280),
                 (512, 512, 1280), (512, 512, 512), (1280, 1280, 1280))
IND4_SHAPES = ((128, 384, 1280), (128, 128, 1280))
N_SMS = 132
# the most dynamic shared memory one block may take (chain.cuh
# probe::SMEM_MAX), and one SM's (228 KB, 1 KB of it reserved per block)
BLOCK_SMEM, SM_SMEM, BLOCK_RESERVED = 227 * 1024, 228 * 1024, 1024
# the script's shapes: no columns a block of their own (the plan's)
SCRIPT_NB = 8
TOL = {"f32": 1e-5, "f32_3xbf16": 1e-5, "bf16": 2e-3}   # rtol, see tol()


# the widths of K1's per-block products the probe times: the main path's
# (the vMAP objects and background, the iMAP field)
K1_WIDTHS = (32, 128, 256)


def k1_shapes() -> tuple:
    """K1's per-block products: (h, h, 132 P, P) for h = 32 / 128 / 256."""
    return tuple((h, h, N_SMS * MAX_POINTS[h], MAX_POINTS[h])
                 for h in K1_WIDTHS)


def base_reps(m: int, k: int, n: int) -> int:
    return 200 if m * k * n < 400 * 1 << 20 else 40


def tol(variant: str, reps: int) -> float:
    """rtol of the kernel's last carry against the plain version's: 1e-5
    per step for the f32 products (FMA, and 3xbf16 against plain f32),
    2e-3 for bf16 (the plain version rounds where the kernel rounds; a
    carry element within f32 noise of a bf16 boundary may round the other
    way)."""
    return TOL[variant] * (reps if variant != "bf16" else 1)


# chain.cuh's Plan, in the order the launchers read it
PLAN_FIELDS = ("grid", "rows", "panels", "slabs", "N", "ncols", "kc", "stages",
               "w_resident", "threads", "m", "k", "n", "ind", "reps")
# wgmma widths a plan may take (within BUILT), the block plan's slab at
# the script's shapes, the most ring slots
TC_WIDTHS = (16, 32, 40, 48, 64, 80, 256)   # 256: two warpgroups of 128
BLOCK_SLAB = 16
MAX_STAGES = 8
# the (regime: 0 block, 1 grid, 2 cluster) -> warpgroup widths the
# tensor-core kernels are built for (csrc/mm.cu launch_wgmma, csrc/int8.cu
# launch): the ones the plans of the cases take
_TC_BUILT = {0: (16, 48, 64), 1: (32, 80, 128), 2: (16, 32, 40, 64, 80)}
BUILT = {"bf16": _TC_BUILT, "f32_3xbf16": _TC_BUILT,
         "i8": {0: (16, 48, 64), 1: (32, 80), 2: (80,)},
         "i8_quant": {0: (16, 48, 64), 1: (32, 80)}}
# bytes an element: of W (every copy), of the carry a block keeps
# (i8_quant: f32 and its s8 copy), of a streamed carry chunk
W_EL = {"f32": 4, "bf16": 2, "f32_3xbf16": 4, "i8": 1, "i8_quant": 1}
C_BLOCK_EL = {"f32": 4, "bf16": 2, "f32_3xbf16": 4, "i8": 1, "i8_quant": 5}
C_GRID_EL = {"f32": 4, "bf16": 2, "f32_3xbf16": 4, "i8": 1, "i8_quant": 4}


def fma_items(rows: int, N: int) -> int:
    """FMA: the 4 x 4 tiles a thread owns (its column groups), the fewest
    that keep a block within 512 threads (csrc/mm.cu launch_fma)."""
    return -(-(rows // 4) * (N // 4) // 512)


def fma_threads(rows: int, N: int) -> int:
    """FMA: a block's threads, each row group's column groups split over
    them (warps walk the row groups first), rounded to whole warps."""
    tpr = -(-(N // 4) // fma_items(rows, N))
    return -(-(rows // 4) * tpr // 32) * 32


def _a128(x: int) -> int:
    return -(-x // 128) * 128


def kstep(variant: str) -> int:
    """k depth of one product (wgmma k16 bf16, k32 s8; FMA: any 4)."""
    return {"f32": 4, "i8": 32, "i8_quant": 32}.get(variant, 16)


def smem_bytes(p: dict, variant: str) -> int:
    """One block's dynamic shared memory (``csrc/chain.cuh``
    smem_layout): W resident, the carry (block plan; the cluster plan's two
    buffers), the ring's slots, i8_quant's s8 chunk (grid plan), 256 bytes
    of barriers and scratch."""
    w = p["ind"] * p["rows"] * p["k"] * W_EL[variant] if p["w_resident"] else 0
    # the carry a block keeps: one (block plan), none (grid), two (cluster)
    c = (1, 0, 2)[p["grid"]] * p["k"] * p["N"] * C_BLOCK_EL[variant]
    slot = ((0 if p["w_resident"]
             else p["ind"] * p["rows"] * p["kc"] * W_EL[variant])
            + (p["kc"] * p["N"] * C_GRID_EL[variant] if p["grid"] == 1 else 0))
    q = p["kc"] * p["N"] if p["grid"] == 1 and variant == "i8_quant" else 0
    return _a128(w) + _a128(c) + p["stages"] * _a128(slot) + _a128(q) + 256


def _fit(base: dict, variant: str) -> dict:
    """The plan ``base`` with W resident where it fits (the carry's ring
    beside it in the grid plan), else streamed through the ring: the
    deepest k-chunk and the most slots (at least 2) that fit."""
    k = base["k"]
    ring_w = (True, False) if base["grid"] else (True,)
    # grid, tensor cores: W stays resident only beside a ring of at least 4
    # slots (the carry's chunks in flight set the step's time), else it is
    # streamed beside a deeper ring (i8_quant and ind > 1 keep W resident)
    min_resident = (min(4, k // 64) if base["grid"] and base["ind"] == 1
                    and variant in ("bf16", "f32_3xbf16", "i8") else 1)
    if not base["grid"]:
        p = {**base, "w_resident": 1, "kc": 0, "stages": 0}
        if smem_bytes(p, variant) <= BLOCK_SMEM:
            return p
        ring_w = (False,)
    for w_res in ring_w:
        # grid: a panel's rows lie within one 64-deep chunk (chain.cuh)
        for kc in ((64,) if base["grid"] else (64, 32, 16, 8)):
            if kc % kstep(variant) or k % kc:
                continue
            for stages in range(min(MAX_STAGES, k // kc), 0, -1):
                if stages < min(2, k // kc):
                    break
                p = {**base, "w_resident": int(w_res), "kc": kc,
                     "stages": stages}
                if (smem_bytes(p, variant) <= BLOCK_SMEM
                        and (not w_res or stages >= min_resident)):
                    return p
    raise ValueError(f"no plan fits a block's shared memory: {variant} "
                     f"{base}")


@functools.lru_cache(maxsize=256)
def plan(variant: str, m: int, k: int, n: int, nb: int = SCRIPT_NB,
         ind: int = 1, sms: int = N_SMS, exchange: bool = False,
         reps: int = 1) -> dict:
    """The chain kernels' plan (``csrc/chain.cuh`` Plan) for ``sms`` SMs
    (cached: treat it as read-only): K1's shapes (nb != SCRIPT_NB) a block
    a chain of nb columns; the script's a block plan where W fits beside a
    16-column slab (not i8_quant, whose scale spans the carry, nor
    ``exchange``); else the (panel, slab) blocks, the most that stay
    within one block an SM (FMA: 32- or 64-row panels, whichever gives
    more), as a cluster plan where the tensor cores' slab fits one cluster
    (not i8_quant nor ``exchange``), else a grid plan. The tensor cores
    take only the widths ``BUILT`` names for the regime. Raises where
    none fits."""
    tc = variant != "f32"
    if variant not in W_EL:
        raise ValueError(f"no chain plan for {variant!r}")

    def widths(regime):
        if not tc:
            return range(8, n + 1, 8)
        return [w for w in TC_WIDTHS
                if min(w, 128) in BUILT[variant].get(regime, ())]

    def base(grid, rows, N, ncols):
        # tensor cores: a warpgroup a 64-row panel (block plan) or a
        # column group of at most 128 (grid plan); FMA: fma_threads
        threads = (fma_threads(rows, N) if not tc
                   else 2 * rows * (max(1, N // 128) if grid else 1))
        return {"grid": int(grid), "rows": rows,
                "panels": m // rows if grid else 1, "slabs": n // ncols,
                "N": N, "ncols": ncols, "threads": threads,
                "m": m, "k": k, "n": n, "ind": ind, "reps": reps}

    rows_all = -(-m // 64) * 64 if tc else m
    if nb != SCRIPT_NB:
        N = (next((w for w in widths(0) if w >= nb), None) if tc
             else -(-nb // 8) * 8)
        if N is None or n % nb:
            raise ValueError(f"K1's layout needs nb <= {widths(0)[-1]} "
                             f"dividing n")
        return _fit(base(False, rows_all, N, nb), variant)
    if not exchange and variant != "i8_quant" and n % BLOCK_SLAB == 0:
        try:
            p = _fit(base(False, rows_all, BLOCK_SLAB, BLOCK_SLAB), variant)
            if p["w_resident"]:
                return p
        except ValueError:
            pass
    if k % m:
        raise ValueError(f"a grid plan folds whole panels: k={k} is not a "
                         f"multiple of m={m}")
    best = None
    for rows in ((64,) if tc else (32, 64)):
        if m % rows:
            continue
        for N in widths(1):
            blocks = (m // rows) * (n // N)
            items = 0 if tc else fma_items(rows, N)
            if n % N or blocks > sms or items > (1 if ind > 1 else 4):
                continue
            if best is None or blocks > best[0]:
                best = (blocks, rows, N)
            break
    if best is None:
        raise ValueError(f"no grid plan: {variant} m={m} k={k} n={n}")
    _, rows, N = best
    if tc and variant != "i8_quant" and not exchange:
        # the fold exchanged through the slab's cluster's shared memory: 64-
        # or 128-row panels (two warpgroups), the one with the most blocks,
        # then the fewest bytes a block sends a step
        options = []
        for crows in (64, 128):
            if m % crows or not 2 <= m // crows <= 8:
                continue
            for cN in widths(2):
                blocks = (m // crows) * (n // cN)
                if n % cN or cN > 128 or blocks > sms:
                    continue
                p = {**base(True, crows, cN, cN), "grid": 2, "w_resident": 1,
                     "kc": 64, "stages": 0}
                if smem_bytes(p, variant) <= BLOCK_SMEM:
                    options.append((-blocks, (m // crows - 1) * crows * cN, p))
                break
        if options:
            return min(options, key=lambda o: o[:2])[2]
    return _fit(base(True, rows, N, N), variant)


def plan_checks(p: dict, variant: str, sms: int = N_SMS) -> dict:
    """The limits a plan must meet (``csrc/chain.cuh`` plan_ok and the
    launchers' residency check): the block's shared memory, every block of
    a grid plan resident (one an SM), a kernel built for it (``BUILT``),
    W's panels covering each of its rows once, the slabs covering the n
    columns once."""
    row_cover = [0] * (p["rows"] * p["panels"])
    for panel in range(p["panels"]):
        for r in range(p["rows"]):
            row_cover[panel * p["rows"] + r] += 1
    col_cover = [0] * p["n"]
    for s in range(p["slabs"]):
        for c in range(p["ncols"]):
            col_cover[s * p["ncols"] + c] += 1
    per_sm = SM_SMEM // (smem_bytes(p, variant) + BLOCK_RESERVED)
    return {"fits": smem_bytes(p, variant) <= BLOCK_SMEM,
            # the grid plan's barrier needs every block resident; a cluster
            # needs only its own (at most 16, co-scheduled)
            "resident": (per_sm * sms >= p["panels"] * p["slabs"])
            if p["grid"] == 1 else p["grid"] == 0 or p["panels"] <= 16,
            "built": variant == "f32"
            or min(p["N"], 128) in BUILT[variant].get(p["grid"], ()),
            "rows_once": row_cover[:p["m"]] == [1] * p["m"]
            and (not p["grid"] or len(row_cover) == p["m"]),
            "cols_once": col_cover == [1] * p["n"]
            and p["ncols"] <= p["N"]}


def describe(p: dict) -> str:
    """A plan in a few words, for the probe's printout."""
    w = "W resident" if p["w_resident"] else f"W streamed (kc {p['kc']})"
    if p["grid"] == 2:
        return (f"cluster {p['slabs']} clusters of {p['panels']} blocks of "
                f"{p['rows']} rows x {p['N']} cols, {w}")
    if p["grid"]:
        return (f"grid {p['panels']}x{p['slabs']} blocks of {p['rows']} rows"
                f" x {p['N']} cols, {w}, ring {p['stages']}x{p['kc']}")
    return f"block {p['slabs']} x {p['ncols']} cols (N {p['N']}), {w}"


def _tc_pieces(x: torch.Tensor, depth: int) -> torch.Tensor:
    """[R, K] (R a multiple of 8) -> [K // depth, R * depth]: each k-chunk
    of ``depth`` as a piece in wgmma's no-swizzle K-major layout
    (``csrc/chain.cuh`` tc_off)."""
    r, kk = x.shape
    ck = 16 // x.element_size()
    return (x.reshape(r // 8, 8, kk // depth, depth // ck, ck)
            .permute(2, 0, 3, 1, 4).reshape(kk // depth, r * depth))


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[-2] == rows:
        return x
    pad = x.new_zeros(*x.shape[:-2], rows - x.shape[-2], x.shape[-1])
    return torch.cat([x, pad], -2)


def w_layout(copies: list, p: dict) -> torch.Tensor:
    """W's operand for the plan: tensor-core copies ([m, k] each: hi, and lo
    for 3xbf16; s8) as [panel][k-chunk][copy][rows x kc piece] (kc = k
    where W stays resident); the f32 stack [ind, m, k] as W_j^T,
    [panel][j][k][rows]."""
    rows, panels, k = p["rows"], p["panels"], p["k"]
    if copies[0].dtype == torch.float32:
        ws = _pad_rows(copies[0], rows * panels)
        return (ws.reshape(ws.shape[0], panels, rows, k).permute(1, 0, 3, 2)
                .contiguous())
    depth = k if p["w_resident"] else p["kc"]
    out = [torch.stack([_tc_pieces(_pad_rows(x, rows * panels)
                                   [q * rows:(q + 1) * rows], depth)
                        for q in range(panels)]) for x in copies]
    return torch.stack(out, 2).contiguous()


def carry_layout(c: torch.Tensor, p: dict, variant: str) -> torch.Tensor:
    """c0 [k, n] as the plan's carry: [k-chunk][slab][copy][N x kc piece]
    for the tensor cores (bf16 hi, and lo for 3xbf16; i8 the s8 carry,
    clip(100 c) truncated; the cluster plan [slab][k-chunk]...),
    [k-chunk][slab][kc][N] f32 for FMA and i8_quant (kc = k in the block
    plan); padding columns 0."""
    k, n = c.shape
    S, ncols, N = p["slabs"], p["ncols"], p["N"]
    depth = p["kc"] if p["grid"] else k
    if variant in ("f32", "i8_quant"):
        x = c.reshape(k, S, ncols)
        if N > ncols:
            x = torch.cat([x, x.new_zeros(k, S, N - ncols)], 2)
        return (x.reshape(k // depth, depth, S, N).permute(0, 2, 1, 3)
                .contiguous())
    x = _pad_rows(c.t().reshape(S, ncols, k), N)          # [S, N, k]
    if variant == "i8":
        copies = [torch.clamp(x * 100.0, -127, 127).to(torch.int8)]
    else:
        hi = x.to(torch.bfloat16)
        copies = [hi] + ([(x - hi.float()).to(torch.bfloat16)]
                         if variant == "f32_3xbf16" else [])
    out = [torch.stack([_tc_pieces(xc[s], depth) for s in range(S)], 1)
           for xc in copies]                             # [q, S, piece]
    out = torch.stack(out, 2)
    if p["grid"] == 2:       # a slab's pieces together: one block's load
        out = out.transpose(0, 1)
    return out.contiguous()


def sm_count(dev: torch.device) -> int:
    """The card's SMs (the CPU: the H100's 132, for the printout)."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).multi_processor_count
    return N_SMS


_LAYOUTS: dict = {}


def cached(kind: str, tensors: list, p: dict, make):
    """``make()``, a copy or layout of ``tensors`` for ``p`` (a plan, or any
    dict of what else it depends on), made once while the tensors are
    alive and unmodified (the cache keeps them, so their memory stays
    theirs): the loop-invariant copies are made outside the timed chain,
    as the script's are."""
    key = (kind, tuple((t.data_ptr(), tuple(t.shape), t.dtype, t._version)
                       for t in tensors), tuple(sorted(p.items())))
    if key not in _LAYOUTS:
        if len(_LAYOUTS) >= 16:
            _LAYOUTS.clear()
        _LAYOUTS[key] = (tensors, make())
    return _LAYOUTS[key][1]


def launch_chain(variant: str, copies: list, c0: torch.Tensor, reps: int,
                 scale: float, nb: int, ind: int, counter: str,
                 exchange: bool = False) -> torch.Tensor:
    """The chain kernel of ``variant`` (csrc/mm.cu f32 / bf16 / 3xbf16,
    csrc/int8.cu i8 / i8_quant) on CUDA tensors, on the plan for this
    card: returns the last carry [k, n] f32. ``copies``: W's loop-invariant
    copies (``w_layout``); ``counter``: the probe whose launch count it
    adds to; ``exchange``: the grid plan even where another fits."""
    import ctypes
    dev = probes.check_cuda(c0, *copies)
    if reps < 1:
        raise ValueError("a chain takes at least one step")
    m, k = copies[0].shape[-2:]
    n = c0.shape[1]
    p = plan(variant, m, k, n, nb, ind, sm_count(dev), exchange, reps)
    w = cached("w", copies, p, lambda: w_layout(copies, p))
    cb0 = cached("c", [c0], p, lambda: carry_layout(c0, p, variant))
    if p["grid"]:   # overwritten by the chain
        cb0 = cb0.clone()
    cb1 = torch.empty_like(cb0) if p["grid"] else cb0.new_empty(16)
    out = torch.empty_like(c0)
    ws = torch.zeros(reps + 2, dtype=torch.int32, device=dev)
    ints = (ctypes.c_int * len(PLAN_FIELDS))(*(p[f] for f in PLAN_FIELDS))
    lib = probes.LIBRARY.load()
    ptrs = [probes.ptr(t) for t in (w, cb0, cb1, out, ws)]
    if variant in VARIANT_CODE:
        code = lib.vmap_probe_mm(VARIANT_CODE[variant], *ptrs,
                                 ctypes.cast(ints, ctypes.c_void_p), scale,
                                 probes.stream(dev))
    else:
        code = lib.vmap_probe_int8(1 if variant == "i8" else 2, *ptrs,
                                   ctypes.cast(ints, ctypes.c_void_p),
                                   probes.stream(dev))
    probes.LIBRARY.check(code, f"{counter} chain ({variant}, {describe(p)})"
                         " launch")
    probes.LAUNCHES[counter] += 1
    return out


def make_inputs(m: int, k: int, n: int, dev) -> tuple:
    """The script's draws: W [m, k] and c [k, n], uniform [0, 0.1), f32."""
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.random((m, k)) * 0.1, dtype=torch.float32)
    c = torch.tensor(rng.random((k, n)) * 0.1, dtype=torch.float32)
    return w.to(dev), c.to(dev)


def fold_scale(ind: int) -> float:
    return float(np.float32(1.0 / (1.0 + ind)))


def operands(w: torch.Tensor, variant: str, ind: int) -> dict:
    """The loop-invariant copies of W the chain reads: ``w`` [ind, m, k]
    f32 (for bf16 its bf16 values), which the plain version and the f32
    kernel read, and the tensor-core kernel's ``hi`` [ind, m, k] bf16
    (bf16, 3xbf16) and ``lo`` (3xbf16)."""
    if variant == "bf16":
        # the script's bf16 w * (1 + 0.001 j): the factor takes w's type
        # first (bf16(1.001) = 1), the product is rounded to bf16
        wb = w.to(torch.bfloat16)
        hi = torch.stack([wb] + [
            (wb.float() * float(torch.tensor(1.0 + 0.001 * j,
                                             dtype=torch.bfloat16)))
            .to(torch.bfloat16) for j in range(1, ind)])
        return {"w": hi.float(), "hi": hi}
    ws = torch.stack([w] + [w * np.float32(1.0 + 0.001 * j)
                            for j in range(1, ind)])
    if variant == "f32":
        return {"w": ws}
    hi = ws.to(torch.bfloat16)
    return {"w": ws, "hi": hi, "lo": (ws - hi.float()).to(torch.bfloat16)}


def fold(y: torch.Tensor, k: int, scale: float) -> torch.Tensor:
    """The script's fold: y's rows repeated to k rows, times ``scale``."""
    m = y.shape[0]
    if m != k:
        y = y.repeat(-(-k // m), 1)[:k]
    return y * scale


def chain_reference(ops: dict, c0: torch.Tensor, variant: str, reps: int,
                    scale: float) -> torch.Tensor:
    """Plain version: the chain with ``torch.matmul`` (bf16: operands
    rounded to bf16, products summed in f32; 3xbf16: the f32 product)."""
    w = ops["w"]
    c = c0.clone()
    for _ in range(reps):
        cc = c.to(torch.bfloat16).float() if variant == "bf16" else c
        y = w[0] @ cc
        for j in range(1, w.shape[0]):
            y = y + w[j] @ cc
        c = fold(y, c.shape[0], scale)
    return c


def launch(ops: dict, c0: torch.Tensor, variant: str, reps: int,
           scale: float, nb: int, counter: str = "mm") -> torch.Tensor:
    """The chain kernel (csrc/mm.cu) on CUDA tensors: returns the last
    carry [k, n]. ``counter``: the probe whose launch count it adds to."""
    w = ops["w"]
    ind, m, k = w.shape
    if c0.shape[0] != k or c0.dtype != torch.float32:
        raise ValueError(f"carry {tuple(c0.shape)} {c0.dtype}: expected "
                         f"f32 [{k}, n]")
    if m % 16 or k % 16 or not 1 <= ind <= (4 if variant == "f32" else 1):
        raise ValueError(f"mm probe takes m, k multiples of 16 and ind 1..4 "
                         f"(f32) or 1 (tensor cores); got m={m} k={k} "
                         f"ind={ind} ({variant})")
    copies = ([w] if variant == "f32"
              else [ops["hi"][0]] + ([ops["lo"][0]] if "lo" in ops else []))
    return launch_chain(variant, copies, c0, reps, scale, nb, ind, counter)


def chain(ops: dict, c0: torch.Tensor, variant: str, reps: int,
          scale: float, nb: int = SCRIPT_NB) -> torch.Tensor:
    """The chain: the plain version on a CPU tensor, the kernel on a CUDA
    tensor."""
    if c0.device.type == "cpu":
        return chain_reference(ops, c0, variant, reps, scale)
    return launch(ops, c0, variant, reps, scale, nb)


def cases() -> list:
    """(m, k, n, nb, variant, ind) of the script's shapes (every variant,
    ind 1; f32 ind 4 at IND4_SHAPES) and of K1's (every variant)."""
    return ([(m, k, n, SCRIPT_NB, v, 1) for v in VARIANTS
             for (m, k, n) in SCRIPT_SHAPES]
            + [(m, k, n, SCRIPT_NB, "f32", 4) for (m, k, n) in IND4_SHAPES]
            + [(m, k, n, nb, v, 1) for v in VARIANTS
               for (m, k, n, nb) in k1_shapes()])


def label(m, k, n, nb, variant, ind) -> str:
    tag = f" ind{ind}" if ind > 1 else ""
    blocks = f" ({n // nb} chains of {nb} cols)" if nb != SCRIPT_NB else ""
    return f"[{m},{k}]x[{k},{n}] {variant}{tag}{blocks}"


def measure(case: tuple, dev: torch.device) -> dict:
    """Time one case by the slope; returns its numbers."""
    m, k, n, nb, variant, ind = case
    w, c0 = make_inputs(m, k, n, dev)
    ops = operands(w, variant, ind)
    scale = fold_scale(ind)
    base = base_reps(m, k, n)
    sl = _timing.slope(lambda r: chain(ops, c0, variant, r, scale, nb),
                       base, 4 * base, dev)
    ns = sl["step_ns"] / ind
    return {"case": label(*case), "m": m, "k": k, "n": n, "nb": nb,
            "variant": variant, "ind": ind, "reps": (base, 4 * base),
            "plan": describe(plan(variant, m, k, n, nb, ind, sm_count(dev))),
            **sl,
            "ns_per_product": ns, "tflops": 2.0 * m * k * n / ns / 1e3}


def bound(case: dict) -> dict:
    """A step's bound: its products over the peak of their type (the carry
    stays on chip; the chain's inputs and output, read and written once a
    launch, amortise to under 0.1% of a step at these reps)."""
    ops = 2.0 * case["m"] * case["k"] * case["n"] * case["ind"]
    return probes.bound({"f32": ops / probes.PEAK_F32,
                         "bf16": ops / probes.PEAK_BF16,
                         "f32_3xbf16": 3 * ops / probes.PEAK_BF16}[
                             case["variant"]])


def plain_ms(case: dict, dev: torch.device) -> float:
    w, c0 = make_inputs(case["m"], case["k"], case["n"], dev)
    ops = operands(w, case["variant"], case["ind"])
    scale = fold_scale(case["ind"])
    return _timing.graph_step_ms(
        lambda r: chain_reference(ops, c0, case["variant"], r, scale), dev)


def matmul_chain(case: dict, dev: torch.device, dt: torch.dtype,
                 scale: float):
    """The chain as ``torch.matmul`` calls on ``dt`` operands, a function
    of the steps: the library call's chain (TF32 off for f32)."""
    w, c0 = make_inputs(case["m"], case["k"], case["n"], dev)
    ws = operands(w, "f32", case.get("ind", 1))["w"].to(dt)

    def run(reps):
        c = c0.to(dt)
        for _ in range(reps):
            y = torch.matmul(ws[0], c)
            for j in range(1, ws.shape[0]):
                y = y + torch.matmul(ws[j], c)
            c = fold(y, case["k"], scale)
        return c
    return run


def library_ms(case: dict, dev: torch.device) -> float:
    """``torch.matmul`` a product: f32 (f32 and 3xbf16) or bf16 operands."""
    dt = torch.bfloat16 if case["variant"] == "bf16" else torch.float32
    return _timing.graph_step_ms(
        matmul_chain(case, dev, dt, fold_scale(case["ind"])), dev)


def tile_check(dev: torch.device, K: int = 64) -> list:
    """One m64n16 product, A [64, K] B^T [16, K], on ``wgmma`` from the
    chain kernels' shared-memory layout and on ``mma.sync`` from row-major
    copies (csrc/mm.cu ``vmap_probe_wgmma_tile``), bf16 and s8, each held
    to the exact product (f64; every sum exact in f32 / s32 here): the
    check of the descriptors and the accumulator layout. Raises if one is
    off; returns the errors."""
    res = []
    gen = torch.Generator().manual_seed(7)
    for s8, dt in ((0, torch.bfloat16), (1, torch.int8)):
        if s8:
            a = torch.randint(-8, 8, (64, K), generator=gen, dtype=torch.int8)
            b = torch.randint(-8, 8, (16, K), generator=gen, dtype=torch.int8)
        else:   # small integers: exact in bf16 and in any f32 order
            a = torch.randint(-8, 8, (64, K), generator=gen).to(dt)
            b = torch.randint(-8, 8, (16, K), generator=gen).to(dt)
        want = a.double() @ b.double().t()
        a, b = a.to(dev), b.to(dev)
        d_wg = torch.empty(64, 16, device=dev)
        d_mma = torch.empty(64, 16, device=dev)
        code = probes.LIBRARY.load().vmap_probe_wgmma_tile(
            s8, probes.ptr(a), probes.ptr(b), probes.ptr(d_wg),
            probes.ptr(d_mma), K, probes.stream(dev))
        probes.LIBRARY.check(code, "wgmma tile check launch")
        name = f"m64n16k{K} {'s8' if s8 else 'bf16'}"
        res.append(probes.held(f"{name} mma.sync", d_mma.cpu(), want, 0.0))
        res.append(probes.held(f"{name} wgmma", d_wg.cpu(), want, 0.0))
    return res


def compare(dev: torch.device, reps: int = 3) -> list:
    """Every case's kernel against its plain version on ``dev`` (CUDA) at
    ``reps`` steps; raises if one is outside ``tol``. Returns the errors."""
    res = []
    for case in cases():
        m, k, n, nb, variant, ind = case
        w, c0 = make_inputs(m, k, n, dev)
        ops = operands(w, variant, ind)
        scale = fold_scale(ind)
        got = launch(ops, c0, variant, reps, scale, nb)
        want = chain_reference(ops, c0, variant, reps, scale)
        res.append(probes.held(label(*case), got, want, tol(variant, reps)))
    return res


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = probes.device_from_arg(args.device)
    print(f"device: {_timing.device_label(dev)}", flush=True)
    out = []
    for case in cases():
        r = measure(case, dev)
        print(f"{r['case']}: {r['ns_per_product']:.0f} ns/op  "
              f"{r['tflops']:.1f} TF/s  ({r['plan']})", flush=True)
        out.append(r)
    return out


if __name__ == "__main__":
    main()
