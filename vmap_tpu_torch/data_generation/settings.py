"""Render-job settings for dataset generation.

Counterpart of the reference's Habitat-Sim configuration
(data_generation/settings.py:8-233): where the reference assembles
habitat_sim sensor specs (colour/depth/semantic sensors at a shared
resolution, camera height, scene file), this declares the same knobs as a
plain dataclass consumed by ``MeshRenderer`` — the scene is a list of
meshes with instance/class ids instead of a Habitat .glb, and the
trajectory is an explicit [N, 4, 4] camera-to-world array (the reference
replays ``traj_w_c.txt`` the same way, habitat_renderer.py:150-176).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SceneObject:
    """One renderable object: a triangle mesh tagged with the ids the
    semantic sensors report (habitat_renderer.py:205-224 derives these from
    the scene's semantic annotations; here they are explicit)."""
    mesh: object                 # geometry.mesh.Mesh
    instance_id: int
    class_id: int
    albedo: tuple = (0.7, 0.7, 0.7)


@dataclass
class RenderSettings:
    """Camera + sensor settings (settings.py:8-60 equivalents)."""
    width: int = 1200
    height: int = 680
    fx: float = 600.0
    fy: float = 600.0
    cx: float | None = None      # default: (width - 1) / 2
    cy: float | None = None
    depth_scale: float = 1000.0  # stored depth units per metre (uint16 mm)
    max_depth_m: float = 65.0    # uint16 clip
    # sensor toggles (the reference enables each habitat sensor separately)
    color_sensor: bool = True
    depth_sensor: bool = True
    semantic_sensor: bool = True
    # lambertian shading light (unit-normalised at use)
    light_dir: tuple = (0.4, -0.8, 0.45)
    ambient: float = 0.15
    # triangles per intersection chunk (VMEM/latency tradeoff)
    tri_chunk: int = 512
    # rays per intersection tile (0 = whole frame at once); room-scale
    # frames (1200 x 680) must stream rays or the [rays, tri_chunk, 3]
    # Möller–Trumbore intermediates blow past HBM
    ray_chunk: int = 0
    # barycentric slack: rays crossing exactly on a shared triangle edge
    # can miss BOTH neighbours (speckle holes on large coplanar patches,
    # e.g. room shells); 0 keeps object silhouettes pixel-exact
    bary_eps: float = 0.0

    def intrinsics(self) -> tuple[float, float, float, float]:
        cx = (self.width - 1) / 2.0 if self.cx is None else self.cx
        cy = (self.height - 1) / 2.0 if self.cy is None else self.cy
        return self.fx, self.fy, cx, cy


def orbit_trajectory(n_frames: int, radius: float = 2.5, height: float = -0.4,
                     target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """[N, 4, 4] orbit poses looking at ``target`` (x right / y down /
    z forward camera, matching data/synthetic.py pose conventions)."""
    target = np.asarray(target, np.float64)
    poses = []
    for i in range(n_frames):
        th = 2 * np.pi * i / n_frames
        eye = target + np.array([radius * np.sin(th), height,
                                 -radius * np.cos(th)])
        fwd = target - eye
        fwd = fwd / np.linalg.norm(fwd)
        world_down = np.array([0.0, 1.0, 0.0])
        right = np.cross(world_down, fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        T = np.eye(4, dtype=np.float32)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, fwd, eye
        poses.append(T)
    return np.stack(poses)
