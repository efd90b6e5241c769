"""Analytic synthetic RGB-D + instance sequence.

A small ray-traced scene (ground plane + sphere + box inside a bounding
room) with exact depth, instance masks and poses. Serves the role the
reference fills with pre-rendered Replica data: a deterministic,
dependency-free source for end-to-end convergence tests and demos (the
reference has no tests at all — SURVEY.md §4 motivates this fixture).

Conventions match the framework: images in (W, H) layout, depth in metres
with z-depth convention, camera-to-world poses with x right / y down /
z forward, instance id 0 = background.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from vmap_tpu_torch.data.transforms import bbox_from_mask, enlarge_bbox


@dataclass
class SyntheticScene:
    width: int = 80
    height: int = 60
    fx: float = 60.0
    fy: float = 60.0
    sphere_center: np.ndarray = None
    sphere_radius: float = 0.5
    box_min: np.ndarray = None
    box_max: np.ndarray = None
    floor_y: float = 1.0       # y points down; floor below the objects
    orbit_radius: float = 2.5
    orbit_height: float = -0.4
    # Depth sensor range: z beyond this reads 0 (invalid), like the
    # reference's DepthFilter transform (image_transforms.py:24-31) and
    # every real RGB-D sensor. Without it, near-horizon rays on the
    # infinite analytic floor return depths of tens of metres, which blow
    # the background's posed-depth OBB (and so its meshing voxel size) up
    # by an order of magnitude.
    max_depth: float = 8.0

    SPHERE_ID = 1
    BOX_ID = 2

    def __post_init__(self):
        if self.sphere_center is None:
            self.sphere_center = np.array([0.45, 0.55, 0.0])
        if self.box_min is None:
            self.box_min = np.array([-0.85, 0.30, -0.35])
        if self.box_max is None:
            self.box_max = np.array([-0.15, 1.00, 0.35])
        self.cx = (self.width - 1) / 2.0
        self.cy = (self.height - 1) / 2.0
        u = np.arange(self.width, dtype=np.float32)
        v = np.arange(self.height, dtype=np.float32)
        self._dirs = np.ones((self.width, self.height, 3), np.float32)
        self._dirs[:, :, 0] = ((u - self.cx) / self.fx)[:, None]
        self._dirs[:, :, 1] = ((v - self.cy) / self.fy)[None, :]

    # ---- camera ---------------------------------------------------------
    def pose(self, frame_id: int, n_frames: int = 64) -> np.ndarray:
        """Camera on a horizontal orbit, always looking at the origin."""
        th = 2 * np.pi * (frame_id % n_frames) / n_frames
        eye = np.array([self.orbit_radius * np.sin(th), self.orbit_height,
                        -self.orbit_radius * np.cos(th)])
        fwd = -eye
        fwd = fwd / np.linalg.norm(fwd)
        world_down = np.array([0.0, 1.0, 0.0])
        right = np.cross(world_down, fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        T = np.eye(4, dtype=np.float32)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, fwd, eye
        return T

    # ---- ray casting ----------------------------------------------------
    def _ray_sphere(self, o, d):
        # rays are unnormalised (z-depth parameterisation): solve
        # a t^2 + 2 b t + c = 0 with a = d.d
        oc = o - self.sphere_center
        a = (d * d).sum(-1)
        b = (d * oc).sum(-1)
        c = (oc * oc).sum(-1) - self.sphere_radius ** 2
        disc = b * b - a * c
        with np.errstate(invalid="ignore"):
            t = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
        return np.where((disc > 0) & (t > 0), t, np.inf)

    def _ray_box(self, o, d):
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / d
            t0 = (self.box_min - o) * inv
            t1 = (self.box_max - o) * inv
        tmin = np.minimum(t0, t1).max(-1)
        tmax = np.maximum(t0, t1).min(-1)
        hit = (tmax >= tmin) & (tmax > 0)
        t = np.where(tmin > 0, tmin, tmax)
        return np.where(hit & (t > 0), t, np.inf)

    def _ray_floor(self, o, d):
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (self.floor_y - o[..., 1]) / d[..., 1]
        return np.where(t > 0, t, np.inf)

    def render(self, frame_id: int, n_frames: int = 64):
        """Returns (rgb uint8 [W,H,3], depth f32 [W,H] z-convention,
        inst int32 [W,H], T_wc [4,4])."""
        T = self.pose(frame_id, n_frames)
        d_cam = self._dirs
        d_world = d_cam @ T[:3, :3].T
        o = np.broadcast_to(T[:3, 3], d_world.shape)

        t_sphere = self._ray_sphere(o, d_world)
        t_box = self._ray_box(o, d_world)
        t_floor = self._ray_floor(o, d_world)
        ts = np.stack([t_floor, t_sphere, t_box])          # [3, W, H] ray param
        winner = ts.argmin(0)
        t_hit = ts.min(0)
        hit = np.isfinite(t_hit)

        inst = np.zeros((self.width, self.height), np.int32)
        inst[hit & (winner == 1)] = self.SPHERE_ID
        inst[hit & (winner == 2)] = self.BOX_ID

        # z-depth (projection onto camera forward axis), not euclidean:
        # depth = t * (d_cam z component == 1) -> t IS the z depth already
        depth = np.where(hit & (t_hit <= self.max_depth),
                         t_hit, 0.0).astype(np.float32)

        # simple lambert shading with per-object albedo
        pt = o + d_world * np.where(hit, t_hit, 1.0)[..., None]
        normal = np.zeros_like(pt)
        normal[winner == 0] = [0.0, -1.0, 0.0]
        sn = pt - self.sphere_center
        sn /= np.maximum(np.linalg.norm(sn, axis=-1, keepdims=True), 1e-9)
        normal[winner == 1] = sn[winner == 1]
        bc = (self.box_min + self.box_max) / 2
        be = (self.box_max - self.box_min) / 2
        rel = (pt - bc) / be
        axis = np.abs(rel).argmax(-1)
        bn = np.zeros_like(pt)
        np.put_along_axis(bn, axis[..., None], np.sign(
            np.take_along_axis(rel, axis[..., None], -1)), -1)
        normal[winner == 2] = bn[winner == 2]

        light = np.array([0.4, -0.8, 0.45])
        light = light / np.linalg.norm(light)
        lam = np.clip((normal * light).sum(-1), 0.15, 1.0)
        albedo = np.zeros((self.width, self.height, 3), np.float32)
        albedo[winner == 0] = [0.55, 0.55, 0.5]
        albedo[winner == 1] = [0.85, 0.25, 0.2]
        albedo[winner == 2] = [0.2, 0.4, 0.85]
        rgb = np.clip(albedo * lam[..., None] * 255, 0, 255).astype(np.uint8)
        rgb[~hit] = 0
        return rgb, depth, inst, T

    def gt_meshes(self, floor_extent: float = 4.0) -> dict:
        """Analytic ground-truth meshes per instance id (0 = floor patch
        around the scene, limited to roughly the observed area)."""
        from vmap_tpu_torch.geometry.primitives import box, icosphere, plane_patch
        return {
            0: plane_patch([0.0, self.floor_y, 0.0], [0.0, -1.0, 0.0],
                           floor_extent, floor_extent),
            self.SPHERE_ID: icosphere(self.sphere_radius, self.sphere_center),
            self.BOX_ID: box(self.box_min, self.box_max),
        }

    def frame_sample(self, frame_id: int, n_frames: int = 64,
                     bbox_scale: float = 0.2):
        """Full ingest-ready sample with bbox_dict (background bbox covers
        the frame, like dataset.py:133)."""
        rgb, depth, inst, T = self.render(frame_id, n_frames)
        bbox_dict = {0: np.array([0, self.width, 0, self.height], np.float32)}
        for oid in (self.SPHERE_ID, self.BOX_ID):
            mask = inst == oid
            if mask.sum() < 10:
                continue
            bb = bbox_from_mask(mask)
            if bb is None:
                continue
            bb = enlarge_bbox(bb, bbox_scale, self.width, self.height)
            if bb is None:
                continue
            bbox_dict[oid] = np.asarray(bb, np.float32)
        return {"image": rgb, "depth": depth, "obj": inst,
                "bbox_dict": bbox_dict, "T": T, "frame_id": frame_id}
