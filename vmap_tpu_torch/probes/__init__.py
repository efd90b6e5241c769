"""Hopper probes: the port's counterparts of ``scripts/microbench_*.py``.

Each probe chains one small computation inside one kernel launch, so its
time per step (the two-point repetition slope of ``_timing``) is the cost
of that computation at K1's shapes on the card, launch latency cancelled:

  * ``mm`` (K4, ``scripts/microbench_mm.py``): chained ``W @ c`` on FP32
    FMA, bf16 ``mma.sync`` and 3xbf16 ``mma.sync``;
  * ``int8`` (K10, ``scripts/microbench_int8.py``): chained s8 ``mma.sync``
    with and without in-loop per-tensor quantisation;
  * ``sections`` (K7, ``scripts/microbench_sections.py``): K1's render,
    embedding products and sin/cos ladder, each alone;
  * ``overlap`` (K8, ``scripts/microbench_overlap.py``): whether FMA work
    hides tensor-core work inside one kernel.

Run one as ``python -m vmap_tpu_torch.probes.<name>`` (the card;
``--device cpu`` times the plain PyTorch version). The kernels live in
``probes/csrc/*.cu`` and build into their own library (``LIBRARY``,
``probes/_build/<hash>/libvmap_probes.so``), apart from K1-K3's. On a CPU
tensor a probe runs its plain version; on a CUDA tensor it launches its
kernel or raises. ``LAUNCHES`` counts successful launches per probe; only
the launchers change it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from vmap_tpu_torch.kernels._build import Library

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_HERE = Path(__file__).resolve().parent

# C signatures of probes/csrc/*.cu
SIGNATURES = {
    "vmap_probe_mm": ((I,) + (P,) * 5 + (I,) * 6 + (F, I, P), I),
    "vmap_probe_int8": ((I, P, P, P) + (I,) * 7 + (P,), I),
    "vmap_probe_render": ((P, P, P, P, P, P, I, P), I),
    "vmap_probe_emb": ((I, P, P, P, P, I, I, I, P), I),
    "vmap_probe_ladder": ((I, P, P, I, I, P), I),
    "vmap_probe_overlap": ((I, P, P, P, P, P, P, P, P, P, I, I, P), I),
}
LIBRARY = Library(_HERE / "csrc", _HERE / "_build", "libvmap_probes.so",
                  SIGNATURES)

LAUNCHES = {"mm": 0, "int8": 0, "sections": 0, "overlap": 0}


def device_from_arg(name: str) -> torch.device:
    """A probe CLI's ``--device``: "cuda" (the default) needs CUDA and
    raises without it; "cpu" times the plain version."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probes run on an NVIDIA GPU and "
                           "torch.cuda.is_available() is False; pass "
                           "--device cpu to time the plain PyTorch version")
    return dev


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
