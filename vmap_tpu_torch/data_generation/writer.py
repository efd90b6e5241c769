"""Dataset writers: the exact on-disk layouts the loaders read.

Counterpart of the reference's save path (habitat_renderer.py:178-246,
which writes rgb/depth/semantic pngs + traj file from habitat
observations). Layouts are documented in docs/data_generation.md and
consumed by data/replica.py and data/scannet.py.

The Replica layout is all PNG and goes through the port's own codec
(``utils/png.py``), so it needs no OpenCV. The ScanNet layout's colour
images are JPEG, written through OpenCV; without ``cv2`` that writer
raises.
"""

from __future__ import annotations

import json
import os

import numpy as np

from vmap_tpu_torch.utils.png import write_png


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "the ScanNet layout writes its colour images as JPEG through "
            "OpenCV (cv2), which is not installed; the Replica layout "
            "needs no cv2") from e
    return cv2


def _imwrite(path: str, img: np.ndarray) -> None:
    ok = _cv2().imwrite(path, img)
    if not ok:
        raise IOError(f"failed to write {path}")


def write_replica_sequence(out_dir: str, frames, traj: np.ndarray,
                           depth_scale: float = 1000.0) -> None:
    """Write frames (dicts from MeshRenderer.render, (W, H) layout) as a
    Replica vMAP sequence:

        traj_w_c.txt, rgb/rgb_<i>.png, depth/depth_<i>.png (uint16 mm),
        semantic_class/semantic_class_<i>.png,
        semantic_instance/semantic_instance_<i>.png

    Colour is written as RGB, depth and masks as 16-bit greyscale.
    """
    for sub in ("rgb", "depth", "semantic_class", "semantic_instance"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    for i, f in enumerate(frames):
        rgb_hw = f["rgb"].transpose(1, 0, 2)  # (W,H) -> image (H,W)
        write_png(os.path.join(out_dir, "rgb", f"rgb_{i}.png"), rgb_hw)
        depth_u16 = np.clip(np.round(f["depth"].T * depth_scale),
                            0, 65535).astype(np.uint16)
        write_png(os.path.join(out_dir, "depth", f"depth_{i}.png"), depth_u16)
        write_png(os.path.join(out_dir, "semantic_class",
                               f"semantic_class_{i}.png"),
                  f["cls"].T.astype(np.uint16))
        write_png(os.path.join(out_dir, "semantic_instance",
                               f"semantic_instance_{i}.png"),
                  f["inst"].T.astype(np.uint16))
    np.savetxt(os.path.join(out_dir, "traj_w_c.txt"),
               np.asarray(traj).reshape(len(traj), 16), delimiter=" ")


def write_scannet_sequence(out_dir: str, frames, traj: np.ndarray,
                           depth_scale: float = 1000.0,
                           invalid_pose_frames: tuple = (),
                           intrinsics: tuple | None = None) -> None:
    """Write frames as a ScanNet-layout sequence:

        color/<i>.jpg, depth/<i>.png (uint16 mm), instance-filt/<i>.png,
        label-filt/<i>.png, pose/<i>.txt
        [+ intrinsic/intrinsic_depth.txt when ``intrinsics`` is given]

    ``invalid_pose_frames`` writes -inf poses for those indices (ScanNet
    sequences contain untracked frames; loaders must skip them).
    ``intrinsics`` = (fx, fy, cx, cy): ScanNet configs read the camera
    from the dataset's intrinsic txt (reference cfg.py:41-46), so the
    generator must ship one for the config to load stand-alone.
    """
    cv2 = _cv2()
    for sub in ("color", "depth", "instance-filt", "label-filt", "pose"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    if intrinsics is not None:
        fx, fy, cx, cy = intrinsics
        os.makedirs(os.path.join(out_dir, "intrinsic"), exist_ok=True)
        K = np.array([[fx, 0, cx, 0], [0, fy, cy, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)
        np.savetxt(os.path.join(out_dir, "intrinsic",
                                "intrinsic_depth.txt"), K)
    for i, f in enumerate(frames):
        rgb_hw = f["rgb"].transpose(1, 0, 2)
        _imwrite(os.path.join(out_dir, "color", f"{i}.jpg"),
                 cv2.cvtColor(rgb_hw, cv2.COLOR_RGB2BGR))
        depth_u16 = np.clip(np.round(f["depth"].T * depth_scale),
                            0, 65535).astype(np.uint16)
        _imwrite(os.path.join(out_dir, "depth", f"{i}.png"), depth_u16)
        # ScanNet instance ids are raw (the loader shifts +1 itself)
        _imwrite(os.path.join(out_dir, "instance-filt", f"{i}.png"),
                 f["inst"].T.astype(np.uint16))
        _imwrite(os.path.join(out_dir, "label-filt", f"{i}.png"),
                 f["cls"].T.astype(np.uint16))
        pose = np.asarray(traj[i], np.float64)
        if i in invalid_pose_frames:
            pose = np.full((4, 4), -np.inf)
        np.savetxt(os.path.join(out_dir, "pose", f"{i}.txt"), pose)


def write_gt_submeshes(gt_dir: str, objects) -> None:
    """GT evaluation artifacts: per-object ``mesh_semantic.ply_<id>.ply``
    submeshes + ``info_semantic.json`` (eval_3D_obj.py:43-55 inputs)."""
    os.makedirs(gt_dir, exist_ok=True)
    info = {"objects": []}
    for obj in objects:
        info["objects"].append({"id": int(obj.instance_id),
                                "class_id": int(obj.class_id)})
        obj.mesh.export(os.path.join(
            gt_dir, f"mesh_semantic.ply_{int(obj.instance_id)}.ply"))
    with open(os.path.join(gt_dir, "info_semantic.json"), "w") as f:
        json.dump(info, f)
