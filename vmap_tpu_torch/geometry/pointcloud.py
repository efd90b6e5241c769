"""Point-cloud utilities: depth-image unprojection and voxel downsampling.

Counterpart of the reference's Open3D calls: ``create_from_depth_image``
(utils.py:257-264, vmap.py:270-283) and ``voxel_down_sample``
(utils.py:164, 190). Unprojection is the three-line pinhole formula — no
native dependency needed.
"""

from __future__ import annotations

import numpy as np


def unproject_depth(depth: np.ndarray, fx: float, fy: float, cx: float,
                    cy: float, t_wc: np.ndarray | None = None,
                    mask: np.ndarray | None = None) -> np.ndarray:
    """Back-project a (W, H) z-depth image to 3D points [N, 3].

    Uses the framework's transposed (W, H) layout and z-depth convention
    (rays [(u-cx)/fx, (v-cy)/fy, 1] * depth). Invalid (<= 0) depths are
    skipped; ``mask`` further restricts pixels; ``t_wc`` maps the points
    from camera to world frame.
    """
    depth = np.asarray(depth)
    w, h = depth.shape
    valid = depth > 0
    if mask is not None:
        valid &= np.asarray(mask, bool)
    u, v = np.nonzero(valid)
    z = depth[u, v].astype(np.float64)
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    pts = np.stack([x, y, z], axis=1)
    if t_wc is not None:
        T = np.asarray(t_wc, np.float64)
        pts = pts @ T[:3, :3].T + T[:3, 3]
    return pts


def voxel_downsample(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Average points within each voxel (Open3D voxel_down_sample parity)."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    if len(pts) == 0:
        return pts
    keys = np.floor(pts / voxel_size).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    sums = np.zeros((len(counts), 3))
    np.add.at(sums, inv, pts)
    return sums / counts[:, None]
