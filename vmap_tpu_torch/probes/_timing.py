"""The scripts' two-point repetition slope.

``slope(run, r1, r2)`` = (t(r2) - t(r1)) / (r2 - r1): the time of one step
of a chain of ``r`` steps launched as ``run(r)``, with launch latency and
the chain's set-up cancelled. ``scripts/microbench_{mm,int8,sections}.py``
take r2 = 4 r1, so (t(4 r) - t(r)) / 3 / r; ``microbench_overlap.py`` 200
and 600. t(r) is the best of 3 runs of 10 launches, each run ended by a
data-dependent readback of the last output: CUDA events on the card, the
wall clock on the CPU. On the card a run's launches queue behind a
device-side sleep (``HOLD_CYCLES``) recorded before its first event, so
they run back to back: a launch shorter than the host's time to issue the
next one (a Python wrapper's tens of microseconds) is timed as the
device's, not the host's.
"""

from __future__ import annotations

import time

import torch

# about 5 ms at the card's clock: longer than the host takes to queue a
# run's launches
HOLD_CYCLES = 10_000_000
# the plain versions' and the library calls' slope: 10 and 40 steps, each
# chain of torch calls captured once in a CUDA graph and replayed (device
# time, no host dispatch between the calls), best of 3 x 5 replays
PLAIN_REPS, PLAIN_TIMING = (10, 40), {"tries": 3, "launches": 5}


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
            torch.cuda._sleep(HOLD_CYCLES)
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


def graphed(run):
    """``run(reps)`` (a chain of torch calls) as a CUDA graph replay: the
    graph of each reps is captured once, after one run outside capture on a
    side stream, so a replay times the device's work alone."""
    graphs = {}

    def replay(reps):
        if reps not in graphs:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                run(reps)
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = run(reps)
            graphs[reps] = (g, out)
        g, out = graphs[reps]
        g.replay()
        return out
    return replay


def graph_step_ms(run, dev: torch.device, reps: tuple = PLAIN_REPS) -> float:
    """The slope of ``run`` between ``reps`` steps, each replayed as a CUDA
    graph (``graphed``), in ms a step: the plain versions' and the library
    calls' device time."""
    return slope(graphed(run), *reps, dev, **PLAIN_TIMING)["step_ns"] * 1e-6


def device_label(dev: torch.device) -> str:
    """What a probe's output names as the device it timed."""
    if dev.type == "cuda":
        return f"{torch.cuda.get_device_name(dev)} (CUDA kernel)"
    return "cpu (plain PyTorch version, not a device time)"
