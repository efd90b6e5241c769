"""Online / continual mapping mode (counterpart of
``vmap_tpu/core/live.py``).

The reference ships this as dormant scaffolding (a commented-out
torch.multiprocessing tracking node, train.py:78-88; queue polling helpers
``next_live_data`` dataset.py:14-37 and ``get_latest_queue`` utils.py:86-98;
``live`` / ``keep_alive`` config keys cfg.py:17-18). Here it is a working
subsystem:

  * ``FrameQueue``: a thread-safe latest-wins frame handoff from a
    producer (tracker / sensor bridge) to the mapper;
  * ``run_live``: the continual loop with the reference's semantics: a new
    frame is ingested when available, but **optimisation runs every tick
    regardless**, refining the map from the keyframe buffers (in the
    reference the training block sits outside the new-frame branch,
    train.py:105 vs 186); meshing runs once the stream has been idle
    longer than ``keep_alive`` (train.py:343-344), once per idle period.

On the card each training tick is one K1 frame per bank and each idle
export queries the fields through K2, as ``Mapper.train_frame`` /
``Mapper.export_meshes`` do.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

from vmap_tpu_torch.core.mapper import FrameSample, Mapper
from vmap_tpu_torch.parallel.distributed import is_multiprocess


class FrameQueue:
    """Latest-wins handoff: ``push`` never blocks (a full queue drops its
    oldest frame); ``poll`` drains the queue and returns the newest sample
    (utils.py:86-98 semantics)."""

    def __init__(self, maxsize: int = 5):
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._closed = threading.Event()

    def push(self, sample: FrameSample) -> None:
        while True:
            try:
                self._q.put_nowait(sample)
                return
            except queue.Full:  # drop the oldest
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    pass

    def close(self) -> None:
        self._closed.set()

    @property
    def closed(self) -> bool:
        return self._closed.is_set() and self._q.empty()

    def poll(self) -> FrameSample | None:
        latest = None
        while True:
            try:
                latest = self._q.get_nowait()
            except queue.Empty:
                return latest


@dataclass
class LiveStats:
    frames_ingested: int = 0
    ticks: int = 0
    idle_ticks: int = 0
    meshes_exported: int = 0
    losses: list = field(default_factory=list)


def run_live(
    mapper: Mapper,
    source: FrameQueue,
    keep_alive: float = 20.0,
    mesh_dir: str | None = None,
    max_ticks: int | None = None,
    min_tick_s: float = 0.0,
    on_tick=None,
) -> LiveStats:
    """Continual mapping until the source closes (or ``max_ticks``).
    Returns run statistics; ``losses`` holds each training tick's loss as
    a float."""
    if is_multiprocess():
        # the loop's wall-clock cadence (idle detection, poll timing)
        # would diverge across processes, and with it any collective
        raise RuntimeError(
            "live mode is single-process only (its wall-clock cadence "
            "cannot be kept collective across processes); run the batch "
            "CLI for multi-process training")
    stats = LiveStats()
    last_frame_time = time.time()
    meshed_since_idle = False

    while True:
        if max_ticks is not None and stats.ticks >= max_ticks:
            break
        sample = source.poll()
        if sample is not None:
            mapper.ingest_frame(sample)
            stats.frames_ingested += 1
            last_frame_time = time.time()
            meshed_since_idle = False
        else:
            if source.closed:
                break
            stats.idle_ticks += 1
            if not mapper.registry:
                # nothing to refine yet: don't busy-spin waiting for the
                # first frame
                stats.ticks += 1
                time.sleep(0.002)
                continue

        if mapper.registry:
            metrics = mapper.train_frame()
            if metrics:
                stats.losses.append(float(metrics["loss"]))
        stats.ticks += 1

        idle_for = time.time() - last_frame_time
        if (mesh_dir is not None and idle_for > keep_alive
                and not meshed_since_idle and mapper.registry):
            mapper.export_meshes(mesh_dir, frame_id=stats.frames_ingested)
            stats.meshes_exported += 1
            meshed_since_idle = True
        if on_tick is not None:
            on_tick(stats)
        if min_tick_s:
            time.sleep(min_tick_s)
    return stats
