"""Deduplicated device-resident frame pool, word-packed (counterpart of
``vmap_tpu/core/pool.py``).

Every distinct frame is stored once; objects reference pool slots through
their keyframe tables. Storage is two 32-bit words per pixel,
[capacity, W, H, 2]:

    word0 = r | g<<8 | b<<16
    word1 = depth_mm | (instance_id + 1) << 16     (so -1 "unknown" -> 0)

The words are the JAX package's bits, held as int32: torch has no uint32
``>>`` on the CPU, so readers shift arithmetically and mask
(``(w1 >> 16) & 0xFFFF``). Slot allocation and refcounts are host-side.
"""

from __future__ import annotations

import numpy as np
import torch

INST_BIAS = 1   # stored instance = id + 1; 0 means "unknown" (-1)


def pack_frame(rgb: torch.Tensor, depth_mm: torch.Tensor,
               inst: torch.Tensor) -> torch.Tensor:
    """rgb [W, H, 3] (0..255), depth_mm [W, H] (0..65535), inst [W, H]
    (int, -1 unknown) -> [W, H, 2] int32 words."""
    rgb = rgb.to(torch.int32)
    w0 = rgb[..., 0] | (rgb[..., 1] << 8) | (rgb[..., 2] << 16)
    inst_b = (inst.to(torch.int32) + INST_BIAS) & 0xFFFF
    w1 = depth_mm.to(torch.int32) | (inst_b << 16)   # may wrap negative
    return torch.stack([w0, w1], dim=-1)


def unpack_words(w0: torch.Tensor, w1: torch.Tensor):
    """Words -> (r, g, b, depth_mm, biased instance), all int32."""
    return (w0 & 255, (w0 >> 8) & 255, (w0 >> 16) & 255,
            w1 & 0xFFFF, (w1 >> 16) & 0xFFFF)


def unpack_slot(frame: torch.Tensor):
    """[W, H, 2] words -> (rgb uint8 [W, H, 3], depth_mm int32, inst int32)."""
    r, g, b, depth, inst_b = unpack_words(frame[..., 0], frame[..., 1])
    rgb = torch.stack([r, g, b], dim=-1).to(torch.uint8)
    return rgb, depth, inst_b - INST_BIAS


class FramePool:
    """Fixed-capacity global frame store with host-side refcounts."""

    def __init__(self, capacity: int, width: int, height: int,
                 device: torch.device | str = "cpu"):
        self.capacity = capacity
        self.width = width
        self.height = height
        self.device = torch.device(device)
        self.packed = torch.zeros((capacity, width, height, 2),
                                  dtype=torch.int32, device=self.device)
        self.twc = torch.eye(4, dtype=torch.float32,
                             device=self.device).repeat(capacity, 1, 1)
        self.refcount = np.zeros(capacity, np.int64)
        self.frame_id = np.full(capacity, -1, np.int64)
        self.write_seq = np.zeros(capacity, np.int64)
        self._seq = 0

    # ---- host-side slot accounting -------------------------------------
    def allocate(self, frame_id: int) -> int:
        """Slot for ``frame_id`` (existing or a free one). Raises if full."""
        hit = np.nonzero(self.frame_id == frame_id)[0]
        if hit.size:
            return int(hit[0])
        free = np.nonzero(self.refcount == 0)[0]
        if free.size == 0:
            raise RuntimeError(
                f"frame pool exhausted ({self.capacity} slots all "
                "referenced); raise tpu.frame_pool_size in the config")
        slot = int(free[np.argmin(self.write_seq[free])])
        self.frame_id[slot] = frame_id
        self._seq += 1
        self.write_seq[slot] = self._seq
        return slot

    def incref(self, slot: int) -> None:
        self.refcount[slot] += 1

    def decref(self, slot: int) -> None:
        if self.refcount[slot] <= 0:
            raise RuntimeError(f"decref on free slot {slot}")
        self.refcount[slot] -= 1
        if self.refcount[slot] == 0:
            self.frame_id[slot] = -1

    @property
    def n_used(self) -> int:
        return int((self.refcount > 0).sum())

    # ---- device write ---------------------------------------------------
    def write(self, slot: int, rgb_u8: np.ndarray, depth_u16: np.ndarray,
              inst: np.ndarray, twc: np.ndarray) -> None:
        """Store a frame (host arrays, (W, H) layout) at ``slot``."""
        dev = self.device
        self.packed[slot] = pack_frame(
            torch.from_numpy(np.ascontiguousarray(rgb_u8)).to(dev),
            torch.from_numpy(np.asarray(depth_u16, np.int32)).to(dev),
            torch.from_numpy(np.asarray(inst, np.int32)).to(dev))
        self.twc[slot] = torch.as_tensor(np.asarray(twc, np.float32),
                                         device=dev)

    def arrays(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.packed, self.twc

    # ---- unpacked host views (meshing) ------------------------------------
    def unpack_depth_inst(self, slots) -> tuple[np.ndarray, np.ndarray]:
        """Slots -> (depth in metres f32 [n, W, H], instance id i32
        [n, W, H]) in one transfer: the JAX pool's unpack, the f32 depth
        ``depth_mm * 1e-3`` taken in numpy as the JAX package takes it."""
        idx = torch.as_tensor(list(slots), dtype=torch.long,
                              device=self.device)
        w1 = self.packed[idx, ..., 1].cpu().numpy()
        depth = (w1 & 0xFFFF).astype(np.float32) * 1e-3
        inst = ((w1 >> 16) & 0xFFFF).astype(np.int32) - INST_BIAS
        return depth, inst

    def slot_depth_m(self, slot: int) -> np.ndarray:
        return self.unpack_depth_inst([slot])[0][0]

    def slot_inst(self, slot: int) -> np.ndarray:
        return self.unpack_depth_inst([slot])[1][0]
