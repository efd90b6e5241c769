"""Per-object keyframe bookkeeping (host side).

Replicates the reference keyframe-buffer state machine (vmap.py:208-268)
with pool-slot indirection instead of per-object frame copies:

  * the first sighting occupies local slot 0;
  * every append where ``frame_cnt % keyframe_step != 0`` overwrites the
    current *rolling* slot (the latest frame is always available);
  * every ``keyframe_step``-th append "cements" the rolling slot by opening
    a new one (so the frame immediately preceding the kf tick is frozen);
  * once the keyframe counter reaches ``buffer_size - 1`` it freezes there;
    the last physical slot becomes the rolling slot, and each subsequent kf
    tick prunes a random keyframe — never one of the two most recently
    (re)assigned — whose slot becomes the new rolling slot
    (vmap.py:224-241, 265-268);
  * sampling draws uniformly over local slots [0, n_keyframes) and always
    includes the two most recent keyframes (vmap.py:319-341).

All state here is tiny host integers; the actual pixels live once in the
global FramePool. ``KeyframeTable`` batches every object's table into dense
arrays for the jitted sampler.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

import numpy as np


@dataclass
class ObjectKF:
    """One object's keyframe table (mirror of sceneObject buffer state)."""
    buffer_size: int
    keyframe_step: int
    pool_slot: list[int] = field(default_factory=list)    # physical local slot -> pool slot
    bbox: list[np.ndarray] = field(default_factory=list)  # physical local slot -> [4]
    order: list[int] = field(default_factory=list)  # local slots by assignment recency
    latest_q: list[int] = field(default_factory=list)
    n_kf: int = 0          # the reference's n_keyframes counter (freezes at size-1)
    frame_cnt: int = 0
    kf_pointer: int | None = None
    buffer_full: bool = False
    rng: random.Random = field(default_factory=lambda: random.Random(0))

    @property
    def n_keyframes(self) -> int:
        return self.n_kf

    @property
    def n_physical(self) -> int:
        return len(self.pool_slot)

    def _assign(self, local: int, pool_slot: int, bbox: np.ndarray) -> int | None:
        """Point ``local`` at ``pool_slot``; returns the evicted pool slot."""
        evicted = None
        if local < len(self.pool_slot):
            evicted = self.pool_slot[local]
            self.pool_slot[local] = pool_slot
            self.bbox[local] = np.asarray(bbox, np.float32)
            if local in self.order:
                self.order.remove(local)
        else:
            assert local == len(self.pool_slot)
            self.pool_slot.append(pool_slot)
            self.bbox.append(np.asarray(bbox, np.float32))
        self.order.append(local)
        return evicted

    def first_frame(self, pool_slot: int, bbox: np.ndarray) -> None:
        assert self.n_kf == 0
        self._assign(0, pool_slot, bbox)
        self.n_kf = 1

    def append(self, pool_slot: int, bbox: np.ndarray) -> tuple[int, int | None]:
        """Append a frame sighting; returns (local slot written, evicted
        pool slot or None). Mirrors sceneObject.append_keyframe."""
        is_kf = (self.frame_cnt % self.keyframe_step == 0) or self.n_kf == 1
        if self.n_kf == self.buffer_size - 1:  # full: rolling-pointer mode
            self.buffer_full = True
            if self.kf_pointer is None:
                self.kf_pointer = self.n_kf  # the extra physical slot
            local = self.kf_pointer
            evicted = self._assign(local, pool_slot, bbox)
            if is_kf:
                self.latest_q.append(local)
                self.kf_pointer = self._prune_choice()
        else:
            if not is_kf:  # overwrite the rolling slot
                local = self.n_kf - 1
                evicted = self._assign(local, pool_slot, bbox)
            else:          # cement: open a new slot
                local = self.n_kf
                evicted = self._assign(local, pool_slot, bbox)
                self.latest_q.append(local)
                self.n_kf += 1
        self.frame_cnt += 1
        if len(self.latest_q) > 2:
            self.latest_q = self.latest_q[-2:]
        return local, evicted

    def _prune_choice(self) -> int:
        """Random keyframe excluding the two most recently assigned
        (vmap.py:265-268)."""
        candidates = self.order[:-2] if len(self.order) > 2 else self.order[:1]
        return self.rng.choice(candidates)

    def latest2(self) -> list[int]:
        q = self.latest_q[-2:]
        while len(q) < 2:
            q = [0] + q
        return q

    def replace_ref(self, local: int, new_pool_slot: int) -> int:
        """Re-point one local keyframe at a different pool frame (forced
        release under pool pressure). Returns the evicted pool slot."""
        old = self.pool_slot[local]
        self.pool_slot[local] = new_pool_slot
        return old

    def newest_pool_slot(self) -> int:
        return self.pool_slot[self.order[-1]]

    def all_slots(self) -> list[tuple[int, int]]:
        """(local, pool) for every physical slot (used for bounds/meshing)."""
        return list(enumerate(self.pool_slot))


class KeyframeTable:
    """Dense, device-uploadable view over all objects' keyframe tables."""

    def __init__(self, capacity: int, buffer_size: int):
        self.capacity = capacity
        # +1 physical slot for the full-buffer rolling pointer
        self.buffer_size = buffer_size
        self.objects: dict[int, ObjectKF] = {}  # bank slot -> table
        self._dirty = True
        self._arrays: tuple | None = None

    def get_or_create(self, slot: int, keyframe_step: int, seed: int = 0) -> ObjectKF:
        if slot not in self.objects:
            self.objects[slot] = ObjectKF(
                buffer_size=self.buffer_size, keyframe_step=keyframe_step,
                rng=random.Random(seed * 7919 + slot))
        self._dirty = True
        return self.objects[slot]

    def mark_dirty(self) -> None:
        self._dirty = True
        self._arrays = None

    def as_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(kf_pool_slot [cap, KF] i32, bbox [cap, KF, 4] f32,
        n_kf [cap] i32, latest2 [cap, 2] i32)."""
        if not self._dirty and self._arrays is not None:
            return self._arrays
        cap, kf = self.capacity, self.buffer_size
        pool_slot = np.zeros((cap, kf), np.int32)
        bbox = np.zeros((cap, kf, 4), np.float32)
        bbox[:, :, 1] = 1.0  # degenerate-but-safe default
        bbox[:, :, 3] = 1.0
        n_kf = np.zeros(cap, np.int32)
        latest2 = np.zeros((cap, 2), np.int32)
        for slot, t in self.objects.items():
            n_phys = min(t.n_physical, kf)
            n_kf[slot] = t.n_kf
            pool_slot[slot, :n_phys] = t.pool_slot[:n_phys]
            if n_phys:
                bbox[slot, :n_phys] = np.stack(t.bbox[:n_phys])
            latest2[slot] = t.latest2()
        self._arrays = (pool_slot, bbox, n_kf, latest2)
        self._dirty = False
        return self._arrays
