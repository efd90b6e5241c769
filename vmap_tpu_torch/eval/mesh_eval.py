"""Mesh-level evaluation protocols (scene and object).

Parity with the reference's offline scripts:
  * scene protocol (eval_3D_scene.py:36-82): compose per-object meshes into
    a scene mesh, sample 200k surface points on reconstruction and GT,
    report Acc / Comp / Comp-ratio@{1cm,5cm};
  * object protocol (eval_3D_obj.py:8-117): per object, crop the
    reconstruction to the GT oriented bbox enlarged by 1/0.9, sample 10k
    points (200k for the background), average metrics over objects.
"""

from __future__ import annotations

import os
import re

import numpy as np

from vmap_tpu_torch.eval.metrics import all_metrics
from vmap_tpu_torch.geometry.mesh import Mesh, load_mesh
from vmap_tpu_torch.geometry.obb import OrientedBox, oriented_bounds


def compose_scene_mesh(mesh_dir: str, frame_id: int | None = None) -> Mesh:
    """Concatenate frame_<f>_obj<i>.obj meshes into one scene mesh
    (eval_3D_scene.py:53-60). Uses the largest frame id when none given."""
    files = [f for f in os.listdir(mesh_dir) if f.endswith((".obj", ".ply"))]
    if frame_id is None:
        fids = [int(m.group(1)) for f in files
                if (m := re.match(r"frame_(\d+)_obj", f))]
        frame_id = max(fids)
    picked = [f for f in files if f.startswith(f"frame_{frame_id}_obj")]
    meshes = [load_mesh(os.path.join(mesh_dir, f)) for f in sorted(picked)]
    return Mesh.concatenate(meshes)


def eval_scene(rec_mesh: Mesh, gt_mesh: Mesh, n: int = 200000,
               seed: int = 0) -> dict:
    rec_pts = rec_mesh.sample_surface(n, seed=seed)
    gt_pts = gt_mesh.sample_surface(n, seed=seed + 1)
    return all_metrics(gt_pts, rec_pts)


def crop_to_gt_bound(rec_mesh: Mesh, gt_mesh: Mesh,
                     enlarge: float = 1.0 / 0.9,
                     min_extent: float = 0.1) -> Mesh:
    """Crop the reconstruction to the GT mesh's oriented bounds enlarged by
    ``enlarge`` (eval_3D_obj.py:13-16 divides extents by 0.9).

    ``min_extent`` floors each box side: a PLANAR GT (e.g. an analytic
    floor patch) has a near-zero-thickness OBB, and the multiplicative
    enlarge alone would crop away everything but an infinitesimally thin
    slab of the reconstruction. The reference never hits this because
    Replica GT submeshes are volumetric; the floor mirrors its 10 cm
    min-extent convention for degenerate bounds (vmap.py:297-300)."""
    to_origin, extents = oriented_bounds(gt_mesh.vertices)
    ext = np.maximum(np.asarray(extents) * enlarge, min_extent)
    box = OrientedBox.from_to_origin(to_origin, ext)
    return rec_mesh.slice_box(box)


def eval_object(rec_mesh: Mesh, gt_mesh: Mesh, n: int = 10000,
                seed: int = 0, gt_filter=None) -> dict | None:
    """``gt_filter``: optional boolean-mask function over GT sample points
    (e.g. :func:`observed_points_mask`). The reference evaluates against
    the FULL GT mesh (eval_3D_obj.py:68-117) because Replica trajectories
    cover the room; for partial-coverage sequences completion over
    never-observed GT regions is noise, so callers may restrict GT
    sampling to the observed surface (the iMAP/NICE-SLAM culled-mesh
    protocol)."""
    cropped = crop_to_gt_bound(rec_mesh, gt_mesh)
    if len(cropped.faces) == 0 or cropped.area <= 0:
        return None  # "no mesh found" (eval_3D_obj.py:17-19)
    rec_pts = cropped.sample_surface(n, seed=seed)
    gt_pts = gt_mesh.sample_surface(n, seed=seed + 1)
    if gt_filter is not None:
        keep = np.asarray(gt_filter(gt_pts), bool)
        if keep.sum() == 0:
            return None
        gt_pts = gt_pts[keep]
    return all_metrics(gt_pts, rec_pts)


def observed_points_mask(points: np.ndarray, poses: np.ndarray,
                         depths: np.ndarray, fx: float, fy: float,
                         cx: float, cy: float, tol: float = 0.05):
    """Boolean mask of 3D points observed by >= 1 RGB-D frame.

    A point counts as observed when it projects inside some frame, in
    front of the camera, and its camera z-depth matches the frame's depth
    map at that pixel within ``tol`` (occluded or out-of-frustum GT
    regions were never trained on). Depth maps follow the framework's
    (W, H) layout with 0 = invalid. Vectorised over frames x points.
    """
    points = np.asarray(points, np.float64)
    poses = np.asarray(poses, np.float64)        # [F, 4, 4] camera-to-world
    n = len(points)
    seen = np.zeros(n, bool)
    for T, dmap in zip(poses, depths):
        R, t = T[:3, :3], T[:3, 3]
        pc = (points - t) @ R                    # world -> camera
        z = pc[:, 2]
        ok = z > 1e-6
        zs = np.where(ok, z, 1.0)
        u = np.rint(pc[:, 0] / zs * fx + cx).astype(np.int64)
        v = np.rint(pc[:, 1] / zs * fy + cy).astype(np.int64)
        W, H = dmap.shape
        ok &= (u >= 0) & (u < W) & (v >= 0) & (v < H)
        d = dmap[np.clip(u, 0, W - 1), np.clip(v, 0, H - 1)]
        ok &= (d > 0) & (np.abs(z - d) < tol)
        seen |= ok
    return seen


def object_ids_in_dir(mesh_dir: str) -> list[int]:
    """Object ids present as frame_*_obj<id>.obj exports
    (eval_3D_obj.py:60-67)."""
    ids = set()
    for f in os.listdir(mesh_dir):
        m = re.match(r"frame_\d+_obj(\d+)\.(obj|ply)$", f)
        if m:
            ids.add(int(m.group(1)))
    return sorted(ids)
