"""Hopper probes: the port's counterparts of ``scripts/microbench_*.py``.

Each probe chains one small computation inside one kernel launch, so its
time per step (the two-point repetition slope of ``_timing``) is the cost
of that computation at K1's shapes on the card, launch latency cancelled:

  * ``mm`` (K4, ``scripts/microbench_mm.py``): chained ``W @ c`` on FP32
    FMA, bf16 ``wgmma`` and 3xbf16 ``wgmma``, on a plan cut from the card
    (``mm.plan``, ``csrc/chain.cuh``);
  * ``int8`` (K10, ``scripts/microbench_int8.py``): chained s8 ``wgmma``
    with and without in-loop per-tensor quantisation, on the same plans;
  * ``sections`` (K7, ``scripts/microbench_sections.py``): K1's render,
    embedding products and sin/cos ladder, each alone;
  * ``overlap`` (K8, ``scripts/microbench_overlap.py``): whether FMA work
    hides tensor-core work inside one kernel;
  * ``vpu`` (K9, ``scripts/microbench_vpu.py``): elementwise chains in f32
    against packed bf16;
  * ``ops`` (K5, ``scripts/microbench_ops.py``): the per-op cost model,
    dependent against independent FMA chains, sigmoid, sin / cos, a lane
    sum as a product against a strided sum, the forward product, a serial
    tile chain;
  * ``dma`` (K6, ``scripts/microbench_dma.py``): 4 KB row copies into
    shared memory, 8 in flight or, as the script's ``n_live`` allows, 1
    (TMA bulk copies and ``cp.async``).

Run one as ``python -m vmap_tpu_torch.probes.<name>`` (the card;
``--device cpu`` times the plain PyTorch version). The kernels live in
``probes/csrc/*.cu`` and build into their own library (``LIBRARY``,
``probes/_build/<hash>/libvmap_probes.so``), apart from K1-K3's. On a CPU
tensor a probe runs its plain version; on a CUDA tensor it launches its
kernel or raises. ``LAUNCHES`` counts successful launches per probe; only
the launchers change it.

Beside a probe's own time, phase 12 of ``chip_smoke.py`` reads each
module's ``bound(case)`` (the least time a step could take on the card,
from the peaks below), ``plain_ms(case, dev)`` (the plain version's time
a step) and ``library_ms(case, dev)`` (one PyTorch call computing the
same step, or None where there is none), ``case`` being one of the
dicts its ``main`` returns.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from vmap_tpu_torch.kernels._build import Library

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_HERE = Path(__file__).resolve().parent

# C signatures of probes/csrc/*.cu
SIGNATURES = {
    "vmap_probe_mm": ((I,) + (P,) * 6 + (F, P), I),
    "vmap_probe_int8": ((I,) + (P,) * 7, I),
    "vmap_probe_wgmma_tile": ((I, P, P, P, P, I, P), I),
    "vmap_probe_render": ((P, P, P, P, P, P, I, P), I),
    "vmap_probe_fast_check": ((I, P, I, P), I),
    "vmap_probe_emb": ((I, P, P, P, P, P, I, I, P), I),
    "vmap_probe_ladder": ((I, P, P, P, I, I, P), I),
    "vmap_probe_overlap": ((I, P, P, P, P, P, P, P, I, I, I, P), I),
    "vmap_probe_vpu": ((I, I, P, P, P, I, I, P), I),
    "vmap_probe_ew": ((I, P, P, P, I, I, P), I),
    "vmap_probe_ops": ((I, P, P, P, I, I, P), I),
    "vmap_probe_lanesum": ((P,) * 5 + (I, P), I),
    "vmap_probe_dma": ((I, P, I, I, I, I, I, P, P, P), I),
}
# probe_common.cuh includes the kernel library's mma.cuh
LIBRARY = Library(_HERE / "csrc", _HERE / "_build", "libvmap_probes.so",
                  SIGNATURES,
                  headers=(_HERE.parent / "kernels" / "csrc" / "mma.cuh",))

LAUNCHES = {"mm": 0, "int8": 0, "sections": 0, "overlap": 0, "vpu": 0,
            "ops": 0, "dma": 0}

# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): FP32 outside the
# tensor cores, bf16 and int8 in them, HBM3
PEAK_F32, PEAK_BF16, PEAK_INT8, PEAK_BYTES = 67e12, 989e12, 1979e12, 3.35e12
# per SM a clock at compute capability 9.0, x 132 SMs x the 1.98 GHz boost
# clock (CUDA C++ Programming Guide): elementwise FP32 instructions (128;
# an FMA is one, where 67 TFLOP/s counts it as two); the special-function
# unit (16 results of reciprocal, exp2, sin, cos); packed 16-bit (bf16x2)
# add, multiply and multiply-add (256 results, twice FP32's)
SMS, CLOCK = 132, 1.98e9
PEAK_F32_OPS = PEAK_F32 / 2
PEAK_SFU = SMS * 16 * CLOCK
PEAK_BF16X2_OPS = 2 * PEAK_F32_OPS
# one SM's shared memory: 32 banks of 32 bits a clock (the Guide's shared
# memory section), so 128 B a clock into one block's buffers
SMEM_BYTES_PER_SM = 32 * 4 * CLOCK


def bound(ops_s: float = 0.0, bytes_s: float = 0.0) -> dict:
    """``bound_ms`` / ``bound_by`` of the phase-12 kernels line: the larger
    of a step's operations and its bytes, each over its peak (seconds)."""
    return {"bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


# the elementwise chains' spread (csrc/probe_common.cuh Spread, in the
# order the launchers read it) and its largest block (SPREAD_MAX_THREADS,
# the kernels' __launch_bounds__)
SPREAD_FIELDS = ("blocks", "threads", "items")
SPREAD_MAX_WARPS = 16


def spread_plan(n: int, items: int, sms: int) -> dict:
    """How an elementwise chain's ``n`` elements go over a card of ``sms``
    SMs (csrc/probe_common.cuh Spread, checked there by spread_ok): in
    units of one warp's 32 x ``items`` elements, unit u on warp u //
    blocks of block u % blocks, so the units go round the blocks and the
    blocks differ by one unit at most; one block an SM where
    SPREAD_MAX_WARPS warps a block hold the units, else the fewest blocks
    an SM that do (every SM the same number). Raises where ``n`` is not a
    whole number of units."""
    unit = 32 * items
    if n <= 0 or n % unit:
        raise ValueError(f"{n} elements are not whole units of {unit}")
    units = n // unit
    blocks = min(units, sms * -(-units // (SPREAD_MAX_WARPS * sms)))
    return {"blocks": blocks, "threads": 32 * -(-units // blocks),
            "items": items}


def spread_elements(p: dict, n: int) -> list:
    """Each block's elements under plan ``p`` (csrc/probe_common.cuh
    spread_first: lane l of warp w of block b, unit u = w blocks + b,
    holds u 32 items + 32 k + l for k < items, where u 32 items < n)."""
    unit = 32 * p["items"]
    out = []
    for b in range(p["blocks"]):
        got = []
        for w in range(p["threads"] // 32):
            u = w * p["blocks"] + b
            if u * unit < n:
                got.extend(u * unit + 32 * k + lane
                           for k in range(p["items"]) for lane in range(32))
        out.append(got)
    return out


def spread_plan_checks(p: dict, n: int, sms: int) -> dict:
    """The limits a spread must meet: whole units (a warp holds all its
    32 x items elements or none, so a vote over its lanes is valid), every
    element once, a block within the kernels' SPREAD_MAX_WARPS warps, the
    blocks' units within one of each other and the blocks as many on each
    SM of a card of ``sms`` SMs (or one a unit)."""
    unit = 32 * p["items"]
    per = spread_elements(p, n)
    units = [len(e) // unit for e in per]
    seen = sorted(i for e in per for i in e)
    return {"whole_units": n % unit == 0
            and all(len(e) % unit == 0 for e in per),
            "once": seen == list(range(n)),
            "threads": p["threads"] % 32 == 0
            and 32 <= p["threads"] <= 32 * SPREAD_MAX_WARPS,
            "even": max(units) - min(units) <= 1
            and (p["blocks"] % sms == 0 or p["blocks"] == n // unit)}


def device_from_arg(name: str) -> torch.device:
    """A probe CLI's ``--device``: "cuda" (the default) needs CUDA and
    raises without it; "cpu" times the plain version."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probes run on an NVIDIA GPU and "
                           "torch.cuda.is_available() is False; pass "
                           "--device cpu to time the plain PyTorch version")
    return dev


def plan_ints(p: dict, fields: tuple) -> ctypes.c_void_p:
    """A plan's ``fields`` as the C int array its launcher reads (the
    pointer keeps the array alive)."""
    return ctypes.cast((ctypes.c_int * len(fields))(*(p[f] for f in fields)),
                       ctypes.c_void_p)


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """A tensor's device pointer for ctypes (None: NULL)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def check_cuda(*tensors: torch.Tensor) -> torch.device:
    """The tensors' common CUDA device; raise if any is elsewhere or not
    contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"probe kernels need CUDA tensors on one device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("probe kernel operands must be contiguous")
    return dev


def held(case: str, got: torch.Tensor, want: torch.Tensor, rtol: float,
         atol: torch.Tensor | float = 0.0) -> dict:
    """A kernel's output against its plain version's: every element finite
    and within ``atol + rtol |want|`` of the plain value (both 0:
    bit-equal; ``atol`` may be elementwise). Raises AssertionError
    otherwise; returns the case's largest errors and ``used``, the largest
    share of an element's bound its error takes (at most 1)."""
    got, want = got.double(), want.double()
    diff = (got - want).abs()
    rel = diff / want.abs().clamp_min(1e-300)
    bound = atol + rtol * want.abs()
    used = torch.where(diff > 0, diff / bound, 0.0)
    res = {"case": case, "max_abs_err": float(diff.max()),
           "max_rel_err": float(torch.where(diff > 0, rel, 0.0).max()),
           "rtol": rtol, "used": float(used.max())}
    finite = bool(torch.isfinite(got).all() & torch.isfinite(want).all())
    if not (finite and bool((diff <= bound).all())):
        raise AssertionError(f"{case}: kernel against plain {res}")
    return res


def ulp(x: torch.Tensor, bits: int = 24) -> torch.Tensor:
    """The spacing at |x| of a float with ``bits`` significant bits (24:
    f32, 8: bf16), as f64 (normal numbers; 0 maps to the smallest normal's
    spacing)."""
    a = x.double().abs().clamp_min(2.0 ** -126)
    _, e = torch.frexp(a)
    return torch.ldexp(torch.ones_like(a), e - bits)


def increment(keep: float, scale: float, c: torch.Tensor,
              out: torch.Tensor) -> tuple:
    """A step's work as one step c -> out = KEEP c + SCALE work shows it:
    ((out - KEEP c) / SCALE in f64, with KEEP and SCALE the f32 constants
    the step uses, and the bound of its error from the step's f32
    roundings, (ulp(out) + ulp(KEEP c)) / SCALE, elementwise)."""
    keep = float(np.float32(keep))
    scale = float(np.float32(scale))
    kc = c.double() * keep
    inc = (out.double() - kc) / scale
    return inc, (ulp(out) + ulp(kc)) / scale
