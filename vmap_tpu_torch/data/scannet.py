"""ScanNet sequence loader with 3D instance association.

Behavioural parity with the reference loader (dataset.py:150-292):
  * ``color/*.jpg`` resized to the depth resolution, ``depth/*.png``
    (uint16 mm), ``instance-filt``/``label-filt`` pngs, per-frame pose txts
    under ``pose/``;
  * frames with non-finite poses are skipped (dataset.py:220-225);
  * a configurable edge crop removes the colour image's invalid border
    (dataset.py:229-232);
  * instance ids shifted +1 so 0 is free for background (dataset.py:247);
  * ScanNet background classes fold to 0 (dataset.py:186-187);
  * masks are validated against persistent 3D boxes; inconsistent pixels
    become -1 "unsure" (box_filter -> vmap_tpu_torch.data.association);
  * per-instance bboxes enlarged by 0.2, degenerate ones fold the mask to
    background (dataset.py:266-274).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from vmap_tpu_torch.data.association import AssociationState, associate_frame
from vmap_tpu_torch.data.transforms import (bbox_from_mask, depth_filter,
                                      depth_scale, enlarge_bbox)
from vmap_tpu_torch.utils.image import resize_linear, resize_nearest
from vmap_tpu_torch.utils.jpeg import read_jpeg
from vmap_tpu_torch.utils.png import read_png

# scannetv2-labels.combined.tsv background ids (dataset.py:187)
BACKGROUND_CLASSES = frozenset({-1, 0, 1, 3, 16, 41, 232, 21, 161, 128})
BBOX_SCALE = 0.2
MIN_PIXELS = 1500


def _sorted_by_stem(pattern: str) -> list[str]:
    return sorted(glob.glob(pattern),
                  key=lambda p: int(os.path.splitext(os.path.basename(p))[0]))


class ScanNetDataset:
    def __init__(self, cfg):
        self.root = cfg.dataset_dir
        self.imap_mode = cfg.imap_mode
        self.depth_scale_v = cfg.depth_scale
        self.max_depth = cfg.max_depth
        self.edge = cfg.mw
        self.fx, self.fy = cfg.fx, cfg.fy
        self.cx, self.cy = cfg.cx, cfg.cy
        self.color_paths = _sorted_by_stem(os.path.join(self.root, "color", "*.jpg"))
        self.depth_paths = _sorted_by_stem(os.path.join(self.root, "depth", "*.png"))
        self.inst_paths = _sorted_by_stem(os.path.join(self.root, "instance-filt", "*.png"))
        self.sem_paths = _sorted_by_stem(os.path.join(self.root, "label-filt", "*.png"))
        self.pose_paths = _sorted_by_stem(os.path.join(self.root, "pose", "*.txt"))
        self.assoc = AssociationState()

    def __len__(self) -> int:
        return len(self.color_paths)

    def __getitem__(self, idx: int) -> dict | None:
        T = np.loadtxt(self.pose_paths[idx]).reshape(4, 4)
        if not np.isfinite(T).all():
            # invalid-pose frames are skipped (dataset.py:220-225). Returning
            # None (train.py skips None samples) instead of recursing into
            # idx+1 keeps long invalid runs O(1) stack and never emits a
            # duplicate frame_id.
            return None

        depth = read_png(self.depth_paths[idx])
        depth = np.nan_to_num(depth.astype(np.float32), nan=0.0)
        H, W = depth.shape
        color = resize_linear(read_jpeg(self.color_paths[idx]), W, H)

        e = self.edge
        if e:
            color = color[e:-e, e:-e]
            depth = depth[e:-e, e:-e]
        depth = depth_filter(depth_scale(depth, self.depth_scale_v), self.max_depth)

        if self.imap_mode:
            inst = np.zeros_like(depth, np.int32)
            bbox_dict = {}
        else:
            inst_img = resize_nearest(read_png(self.inst_paths[idx]), W,
                                      H).astype(np.int32)
            sem_img = resize_nearest(read_png(self.sem_paths[idx]), W, H)
            if e:
                inst_img = inst_img[e:-e, e:-e]
                sem_img = sem_img[e:-e, e:-e]
            inst_img = inst_img + 1  # background reserve (dataset.py:247)

            masks, ids = [], []
            for oid in np.unique(inst_img):
                mask = inst_img == oid
                cls = np.unique(sem_img[mask])
                if any(int(c) in BACKGROUND_CLASSES for c in cls):
                    inst_img[mask] = 0
                    continue
                masks.append(mask)
                ids.append(int(oid))
            # association works in the (H, W) image layout; transpose after
            inst = associate_frame(
                [m.T for m in masks], ids, depth.T, self.assoc,
                self.fx, self.fy, self.cx, self.cy, T,
                min_pixels=MIN_PIXELS).T

            bbox_dict = {}
            for oid in np.unique(inst):
                if oid <= 0:
                    continue
                mask_t = (inst == oid).T
                bb = bbox_from_mask(mask_t)
                bb = None if bb is None else enlarge_bbox(
                    bb, BBOX_SCALE, mask_t.shape[0], mask_t.shape[1])
                if bb is None:
                    inst[inst == oid] = 0  # degenerate bbox -> background
                else:
                    bbox_dict[int(oid)] = np.asarray(bb, np.float32)

        w, h = depth.T.shape
        bbox_dict[0] = np.array([0, w, 0, h], np.float32)
        return {
            "image": color.transpose(1, 0, 2).astype(np.uint8),
            "depth": depth.T,
            "obj": inst.T if not self.imap_mode else inst.T,
            "bbox_dict": bbox_dict,
            "T": T.astype(np.float32),
            "frame_id": idx,
        }
