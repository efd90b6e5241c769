"""Replica (vMAP-rendered) sequence loader.

Behavioural parity with the reference loader (dataset.py:63-148):
  * files ``rgb/rgb_<i>.png``, ``depth/depth_<i>.png`` (uint16 mm),
    ``semantic_instance/semantic_instance_<i>.png``,
    ``semantic_class/semantic_class_<i>.png``; poses from ``traj_w_c.txt``;
  * everything transposed to the framework's (W, H) layout;
  * instances whose semantic class is in the background list fold into
    instance 0 (dataset.py:73-74, 107, 130);
  * instances smaller than 10 px on a side are dropped to background
    (dataset.py:119);
  * per-instance bboxes enlarged by 0.2 (dataset.py:76, 121);
  * depth scaled to metres and filtered beyond max_depth (dataset.py:69-71);
  * iMAP mode collapses the instance map to a single id 0 (dataset.py:95-96);
  * background bbox covers the full frame (dataset.py:133).
"""

from __future__ import annotations

import os

import numpy as np

from vmap_tpu_torch.data.transforms import (bbox_from_mask_batch, depth_filter,
                                      depth_scale, enlarge_bbox)

# Replica background semantic classes (dataset.py:74)
BACKGROUND_CLASSES = frozenset({5, 12, 30, 31, 40, 60, 92, 93, 95, 97, 98, 79})
MIN_INSTANCE_SIDE = 10
BBOX_SCALE = 0.2


def _imread(path: str, flags=None):
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED if flags is None else flags)
    if img is None:
        raise FileNotFoundError(path)
    return img


class ReplicaDataset:
    def __init__(self, cfg):
        self.root = cfg.dataset_dir
        self.imap_mode = cfg.imap_mode
        self.depth_scale_v = cfg.depth_scale
        self.max_depth = cfg.max_depth
        traj = os.path.join(self.root, "traj_w_c.txt")
        self.t_wc = np.loadtxt(traj, delimiter=" ").reshape(-1, 4, 4)
        self.n = len(os.listdir(os.path.join(self.root, "depth")))

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> dict:
        import cv2
        rgb = _imread(os.path.join(self.root, "rgb", f"rgb_{idx}.png"),
                      cv2.IMREAD_COLOR)
        rgb = cv2.cvtColor(rgb, cv2.COLOR_BGR2RGB).transpose(1, 0, 2)
        depth_raw = _imread(os.path.join(self.root, "depth", f"depth_{idx}.png"))
        depth = depth_raw.astype(np.float32).T
        inst = _imread(os.path.join(
            self.root, "semantic_instance", f"semantic_instance_{idx}.png")
        ).astype(np.int32).T
        sem = _imread(os.path.join(
            self.root, "semantic_class", f"semantic_class_{idx}.png")
        ).astype(np.int32).T

        depth = depth_filter(depth_scale(depth, self.depth_scale_v), self.max_depth)

        bbox_dict: dict[int, np.ndarray] = {}
        if self.imap_mode:
            inst_out = np.zeros_like(inst)
        else:
            inst_out, bbox_dict = self._build_instances(inst, sem)
        w, h = inst_out.shape
        bbox_dict[0] = np.array([0, w, 0, h], np.float32)

        return {
            "image": rgb.astype(np.uint8),
            "depth": depth,
            "obj": inst_out,
            "bbox_dict": bbox_dict,
            "T": self.t_wc[idx].astype(np.float32),
            "frame_id": idx,
        }

    def _build_instances(self, inst: np.ndarray, sem: np.ndarray):
        """Fold background classes, drop tiny instances, build enlarged
        bboxes. Vectorised where the reference loops (utils.py:75-84 was
        already batch-vectorised there too)."""
        w, h = inst.shape
        ids = np.unique(inst)
        keep_ids, masks = [], []
        for inst_id in ids:
            mask = inst == inst_id
            cls = sem[mask]
            # the reference takes unique(sem[mask]) and membership-checks it
            # (dataset.py:105-107); use the majority class for robustness
            cls_ids, counts = np.unique(cls, return_counts=True)
            if int(cls_ids[np.argmax(counts)]) in BACKGROUND_CLASSES:
                continue
            keep_ids.append(int(inst_id))
            masks.append(mask)

        inst_out = np.zeros_like(inst)
        bbox_dict: dict[int, np.ndarray] = {}
        if not masks:
            return inst_out, bbox_dict
        stack = np.stack(masks)
        u0, u1, v0, v1 = bbox_from_mask_batch(stack)
        for i, inst_id in enumerate(keep_ids):
            if (u1[i] - u0[i]) <= MIN_INSTANCE_SIDE or (v1[i] - v0[i]) <= MIN_INSTANCE_SIDE:
                continue  # tiny -> stays background
            bb = enlarge_bbox([int(u0[i]), int(u1[i]), int(v0[i]), int(v1[i])],
                              BBOX_SCALE, w, h)
            if bb is None:
                continue
            inst_out[stack[i]] = inst_id
            bbox_dict[inst_id] = np.asarray(bb, np.float32)
        return inst_out, bbox_dict
