"""RGB-D + semantic mesh renderer (dataset generation), in PyTorch.

Counterpart of the reference's Habitat-Sim renderer
(data_generation/habitat_renderer.py:27-246) and of the JAX package's ray
tracer: a [rays x triangles] two-sided Möller–Trumbore sweep in float32
that keeps each ray's (depth, winner) minimum. Rays stream in tiles of
``ray_chunk`` and triangles in chunks of ``tri_chunk``, so no tensor
larger than [ray_chunk, tri_chunk] is ever made: a full 1200 x 680 frame
(816,000 rays) never meets a triangle chunk at once. The last tile and
chunk are simply shorter, so no ray or triangle is padded.

Sensors produced per frame (the reference's color/depth/semantic trio):
  rgb    uint8  [W, H, 3]  lambertian shading, per-object albedo
  depth  f32    [W, H]     z-depth metres (habitat DEPTH convention)
  inst   int32  [W, H]     instance id (0 = miss/background)
  cls    int32  [W, H]     semantic class id

Rays use the pinhole parameterisation with d_cam.z = 1, so the ray
parameter t IS the z-depth — no per-ray normalisation anywhere.

Ties: within a chunk ``argmin`` keeps the first triangle at the minimum,
and across chunks a later chunk replaces the best only where it is
strictly nearer, so the earliest triangle wins a tie, as in the JAX
renderer. Every product is elementwise float32 (no matmul, so no TF32).
"""

from __future__ import annotations

import numpy as np
import torch

from vmap_tpu_torch.data_generation.settings import RenderSettings, SceneObject
from vmap_tpu_torch.device import resolve_device

DET_EPS = 1e-12      # |det| at or below: parallel to the triangle, no hit
T_MIN = 1e-4         # nearest accepted hit along the ray


def _cross(a, b):
    """a x b over a last axis of 3, by components (broadcasting)."""
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], -1)


def _dot(a, b):
    """sum_j a_j b_j over a last axis of 3, j in order (broadcasting)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def sweep(d, o, v0, e1, e2, tri_chunk: int, bary_eps: float = 0.0):
    """All triangles against one ray tile: ``d`` [R, 3] directions from
    the origin ``o`` [3]; triangles ``v0`` / ``e1`` / ``e2`` [T, 3]. ->
    (best_t [R], best_i [R]): the nearest hit's z-depth (inf on a miss)
    and triangle index (0 on a miss)."""
    n = d.shape[0]
    best_t = torch.full((n,), float("inf"), dtype=d.dtype, device=d.device)
    best_i = torch.zeros((n,), dtype=torch.int64, device=d.device)
    for s in range(0, v0.shape[0], tri_chunk):
        cv0, ce1, ce2 = (x[s:s + tri_chunk] for x in (v0, e1, e2))
        p = _cross(d[:, None, :], ce2[None, :, :])          # [R, C, 3]
        det = _dot(ce1[None], p)                            # [R, C]
        par = det.abs() <= DET_EPS
        inv = torch.where(par, torch.zeros_like(det), 1.0 / det)
        svec = o[None, :] - cv0                             # [C, 3]
        uu = _dot(svec[None], p) * inv
        del p
        q = _cross(svec, ce1)                               # [C, 3]
        vv = _dot(d[:, None, :], q[None]) * inv
        tt = _dot(ce2, q)[None, :] * inv
        ok = ((~par) & (uu >= -bary_eps) & (vv >= -bary_eps)
              & (uu + vv <= 1.0 + bary_eps) & (tt > T_MIN))
        del uu, vv
        tt = torch.where(ok, tt, torch.full_like(tt, float("inf")))
        ci = tt.argmin(dim=1)                               # first at min
        ct = tt.gather(1, ci[:, None])[:, 0]
        upd = ct < best_t
        best_t = torch.where(upd, ct, best_t)
        best_i = torch.where(upd, s + ci, best_i)
    return best_t, best_i


def pose_rays(t_wc: torch.Tensor, fx: float, fy: float, cx: float,
              cy: float, W: int, H: int) -> torch.Tensor:
    """World-frame ray directions [W * H, 3] of a pinhole camera at
    camera-to-world ``t_wc`` (d_cam.z = 1), pixel (u, v) at u * H + v."""
    dev, f32 = t_wc.device, torch.float32
    u = torch.arange(W, dtype=f32, device=dev)[:, None]
    v = torch.arange(H, dtype=f32, device=dev)[None, :]
    d_cam = torch.stack([((u - cx) / fx).expand(W, H),
                         ((v - cy) / fy).expand(W, H),
                         torch.ones((W, H), dtype=f32, device=dev)], -1)
    return _dot(d_cam.reshape(-1, 1, 3), t_wc[None, :3, :3])  # d_cam @ R.T


def trace_rays(tris: dict, d: torch.Tensor, o: torch.Tensor,
               light: torch.Tensor, ambient: float, tri_chunk: int,
               ray_chunk: int = 0, bary_eps: float = 0.0):
    """Rays ``d`` [N, 3] from ``o`` [3] against every triangle. ``tris``
    holds [T, ...] tensors ``v0``, ``e1``, ``e2``, ``inst``, ``cls``,
    ``albedo``, ``normals`` on ``d``'s device; ``ray_chunk`` 0 takes every
    ray in one tile. -> (rgb [N, 3] uint8, depth [N] f32, inst, cls [N]
    int32)."""
    n_rays = d.shape[0]
    step = ray_chunk if ray_chunk else n_rays
    hits = [sweep(d[r:r + step], o, tris["v0"], tris["e1"], tris["e2"],
                  tri_chunk, bary_eps) for r in range(0, n_rays, step)]
    best_t = torch.cat([h[0] for h in hits])
    best_i = torch.cat([h[1] for h in hits])

    hit = torch.isfinite(best_t)
    zero = torch.zeros((), dtype=torch.int32, device=d.device)
    depth = torch.where(hit, best_t, torch.zeros_like(best_t))
    inst = torch.where(hit, tris["inst"][best_i], zero)
    cls = torch.where(hit, tris["cls"][best_i], zero)

    n = tris["normals"][best_i]
    # two-sided shading: the normal flipped toward the camera (n.d = 0
    # gives sign 0: that pixel keeps only the ambient term); additive
    # ambient so walls facing away from the light keep usable range
    n = n * torch.sign(-_dot(n, d))[:, None]
    lam = ambient + (1.0 - ambient) * torch.clamp(_dot(n, light), min=0.0)
    rgb = torch.clamp(tris["albedo"][best_i] * lam[:, None] * 255.0, 0, 255)
    rgb = torch.where(hit[:, None], rgb, torch.zeros_like(rgb))
    return rgb.to(torch.uint8), depth, inst, cls


class MeshRenderer:
    """Render a list of SceneObjects along a trajectory, on ``device``:
    CUDA by default, which raises without CUDA (``device="cpu"`` asks for
    the CPU)."""

    def __init__(self, objects: list[SceneObject],
                 settings: RenderSettings | None = None,
                 device: str | torch.device = "cuda"):
        self.settings = settings or RenderSettings()
        self.device = resolve_device(device)
        tris, inst, cls, alb = [], [], [], []
        for obj in objects:
            t = np.asarray(obj.mesh.triangles, np.float32)
            tris.append(t)
            inst.append(np.full(len(t), obj.instance_id, np.int32))
            cls.append(np.full(len(t), obj.class_id, np.int32))
            alb.append(np.tile(np.asarray(obj.albedo, np.float32),
                               (len(t), 1)))
        tris = np.concatenate(tris)
        nrm = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
        light = np.asarray(self.settings.light_dir, np.float32)
        host = {"v0": tris[:, 0], "e1": tris[:, 1] - tris[:, 0],
                "e2": tris[:, 2] - tris[:, 0], "inst": np.concatenate(inst),
                "cls": np.concatenate(cls), "albedo": np.concatenate(alb),
                "normals": nrm.astype(np.float32)}
        self._tris = {k: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for k, a in host.items()}
        self._light = torch.from_numpy(light / np.linalg.norm(light)).to(
            self.device)

    @property
    def n_triangles(self) -> int:
        return int(self._tris["v0"].shape[0])

    def rays(self, t_wc: np.ndarray) -> tuple:
        """(directions [W * H, 3], origin [3]) of the frame at
        camera-to-world ``t_wc``, on the renderer's device."""
        st = self.settings
        pose = torch.as_tensor(np.asarray(t_wc, np.float32),
                               device=self.device)
        return (pose_rays(pose, *st.intrinsics(), st.width, st.height),
                pose[:3, 3])

    def trace(self, d: torch.Tensor, o: torch.Tensor) -> tuple:
        """Rays ``d`` from ``o`` (on the renderer's device) -> flat (rgb,
        depth, inst, cls) tensors."""
        st = self.settings
        with torch.no_grad():
            return trace_rays(self._tris, d, o, self._light, st.ambient,
                              st.tri_chunk, st.ray_chunk, st.bary_eps)

    def render_tensors(self, t_wc: np.ndarray) -> tuple:
        """One frame at camera-to-world ``t_wc`` -> (rgb, depth, inst,
        cls) tensors on the renderer's device, (W, H) layout."""
        st = self.settings
        W, H = st.width, st.height
        rgb, depth, inst, cls = self.trace(*self.rays(t_wc))
        return (rgb.reshape(W, H, 3), depth.reshape(W, H),
                inst.reshape(W, H), cls.reshape(W, H))

    def render(self, t_wc: np.ndarray) -> dict:
        """One frame at camera-to-world ``t_wc`` -> {rgb, depth, inst, cls}
        numpy arrays in the framework's (W, H) layout."""
        rgb, depth, inst, cls = self.render_tensors(t_wc)
        return {"rgb": rgb.cpu().numpy(), "depth": depth.cpu().numpy(),
                "inst": inst.cpu().numpy(), "cls": cls.cpu().numpy()}

    def render_trajectory(self, traj: np.ndarray):
        """Yield frames for every pose in ``traj`` [N, 4, 4]."""
        for i in range(len(traj)):
            yield self.render(traj[i])
