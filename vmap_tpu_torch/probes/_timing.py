"""The scripts' two-point repetition slope.

``slope(run, r1, r2)`` = (t(r2) - t(r1)) / (r2 - r1): the time of one step
of a chain of ``r`` steps launched as ``run(r)``, with launch latency and
the chain's set-up cancelled. ``scripts/microbench_{mm,int8,sections}.py``
take r2 = 4 r1, so (t(4 r) - t(r)) / 3 / r; ``microbench_overlap.py`` 200
and 600. t(r) is the best of 3 runs of 10 launches, each run ended by a
data-dependent readback of the last output: CUDA events on the card, the
wall clock on the CPU.
"""

from __future__ import annotations

import time

import torch


def _readback(out) -> float:
    first = out[0] if isinstance(out, (tuple, list)) else out
    return float(first.reshape(-1)[0])


def launch_ms(run, reps: int, dev: torch.device, tries: int = 3,
              launches: int = 10) -> float:
    """Best over ``tries`` of the mean milliseconds of ``run(reps)`` over
    ``launches`` back-to-back launches (one warm-up first)."""
    _readback(run(reps))
    best = float("inf")
    for _ in range(tries):
        if dev.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(launches):
                out = run(reps)
            t1.record()
            _readback(out)
            ms = t0.elapsed_time(t1)
        else:
            w0 = time.perf_counter()
            for _ in range(launches):
                out = run(reps)
            _readback(out)
            ms = (time.perf_counter() - w0) * 1e3
        best = min(best, ms / launches)
    return best


def slope(run, r1: int, r2: int, dev: torch.device, **kw) -> dict:
    """{"t1_ms", "t2_ms", "step_ns"}: launch times at r1 and r2 steps and
    the slope per step in nanoseconds (``kw``: ``launch_ms``'s tries and
    launches)."""
    t1 = launch_ms(run, r1, dev, **kw)
    t2 = launch_ms(run, r2, dev, **kw)
    return {"t1_ms": t1, "t2_ms": t2, "step_ns": (t2 - t1) / (r2 - r1) * 1e6}


def device_label(dev: torch.device) -> str:
    """What a probe's output names as the device it timed."""
    if dev.type == "cuda":
        return f"{torch.cuda.get_device_name(dev)} (CUDA kernel)"
    return "cpu (plain PyTorch version, not a device time)"
