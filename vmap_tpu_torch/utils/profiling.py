"""Per-stage wall-clock timing and the PyTorch profiler (counterpart of
``vmap_tpu/utils/profiling.py``).

``StageTimer`` and ``performance_measure`` are the reference's
``performance_measure`` context manager (vmap.py:17-29) with aggregation;
``device_trace`` captures a ``torch.profiler`` trace of CPU and, where
CUDA is present, CUDA activity, written as a Chrome trace
(``chrome://tracing`` / Perfetto); ``trace_summary`` reads one back as
device time by kernel name and the device's idle share.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Callable

TRACE_FILE = "trace.json"


class StageTimer:
    """Accumulates per-stage wall time; ``report()`` prints and resets.

    ``sync``, where given, is called before the clock is read at the start
    and the end of every stage. CUDA launches return before the card has
    run them, so without a sync a stage's time is the host's time to queue
    its work; the trainer passes ``torch.cuda.synchronize`` on the card, so
    that each stage's time is the card's (the sync itself serialises host
    and card, so a timed run is slower than an untimed one).
    """

    def __init__(self, enabled: bool = True,
                 sync: Callable[[], None] | None = None):
        self.enabled = enabled
        self.sync = sync
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    def _now(self) -> float:
        if self.sync is not None:
            self.sync()
        return time.perf_counter()

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = self._now()
        try:
            yield
        finally:
            dt = self._now() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self, reset: bool = True) -> dict[str, float]:
        """Mean ms per call of each stage since the last reset, printed one
        line a stage."""
        if not self.enabled:
            return {}
        out = {}
        for name, total in sorted(self.totals.items()):
            ms = 1000.0 * total / max(self.counts[name], 1)
            out[name] = ms
            print(f"{name}: {ms:.2f} ms")
        if reset:
            self.totals.clear()
            self.counts.clear()
        return out


@contextlib.contextmanager
def performance_measure(name: str):
    """Drop-in analogue of the reference's context manager."""
    t0 = time.perf_counter_ns()
    yield
    dt = (time.perf_counter_ns() - t0) / 1e6
    print(f"{name} execution time: {dt:.2f} ms")


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    where it is available) and write ``<logdir>/trace.json``. Yields the
    profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _union_ms(spans: list) -> float:
    """Length of the union of (start, end) intervals (µs) in ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1000.0


def trace_summary(path: str, window: str | None = None) -> dict:
    """A Chrome trace of ``device_trace`` -> {"kernels": {name: device
    ms}, "launches": {name: n}, "device_ms": union of the kernels' time,
    "window_ms", "idle_share"}. The window runs from the start of the
    first host range named ``window`` (a ``record_function`` range, e.g.
    the trainer's ``frame``) to the end of the last such range or of the
    last kernel, whichever is later, and only kernels that start in it
    count; with no such range it is the span of the kernels. The idle
    share is the share of the window in which no kernel runs."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if window is not None and e.get("ph") == "X"
              and e.get("name") == window
              and e.get("cat") == "user_annotation"]
    if ranges:
        start, end = min(s for s, _ in ranges), max(e for _, e in ranges)
        kernels = [k for k in kernels if k[0] >= start]
    elif kernels:
        start, end = min(k[0] for k in kernels), max(k[1] for k in kernels)
    else:
        start = end = 0.0
    end = max([end] + [k[1] for k in kernels])
    by_name: dict = defaultdict(float)
    count: dict = defaultdict(int)
    for s, e, name in kernels:
        by_name[name] += (e - s) / 1000.0
        count[name] += 1
    device_ms = _union_ms([(s, e) for s, e, _ in kernels])
    window_ms = (end - start) / 1000.0
    return {"kernels": dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
            "launches": dict(count), "device_ms": device_ms,
            "window_ms": window_ms,
            "idle_share": (1.0 - device_ms / window_ms) if window_ms else None}
