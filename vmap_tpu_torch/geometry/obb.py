"""Minimal-volume oriented bounding boxes.

Counterpart of trimesh.bounds.oriented_bounds as used for per-object 3D
bounds (reference vmap.py:291-309) and eval-time GT cropping
(eval_3D_obj.py:13-16): convex hull, then for each hull facet orientation a
rotating-calipers minimum-area rectangle in the facet plane; the best
(volume-minimal) orientation wins. Same contract as trimesh:
``oriented_bounds(points) -> (to_origin 4x4, extents 3)`` with
``to_origin @ [p, 1]`` centring the box at the origin.
"""

from __future__ import annotations

import numpy as np

try:
    from scipy.spatial import ConvexHull, QhullError
except ImportError:  # pragma: no cover
    ConvexHull = None
    QhullError = Exception


class OrientedBox:
    """center [3], R [3,3] (columns = box axes in world), extent [3]."""

    def __init__(self, center, R, extent):
        self.center = np.asarray(center, np.float64)
        self.R = np.asarray(R, np.float64)
        self.extent = np.asarray(extent, np.float64)

    @classmethod
    def from_to_origin(cls, to_origin: np.ndarray, extents: np.ndarray) -> "OrientedBox":
        T = np.linalg.inv(to_origin)
        return cls(T[:3, 3], T[:3, :3], extents)

    def to_origin(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = self.R.T
        T[:3, 3] = -self.R.T @ self.center
        return T

    def transform(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = self.R
        T[:3, 3] = self.center
        return T

    def contains(self, points: np.ndarray, tol: float = 0.0) -> np.ndarray:
        local = (np.asarray(points) - self.center) @ self.R
        return (np.abs(local) <= self.extent / 2 + tol).all(axis=1)

    def face_planes(self):
        """(origin, inward normal) for the 6 faces."""
        planes = []
        for axis in range(3):
            for sign in (1.0, -1.0):
                n = -sign * self.R[:, axis]
                o = self.center + sign * self.R[:, axis] * (self.extent[axis] / 2)
                planes.append((o, n))
        return planes

    def corners(self) -> np.ndarray:
        signs = np.array([[sx, sy, sz] for sx in (-1, 1)
                          for sy in (-1, 1) for sz in (-1, 1)], np.float64)
        return self.center + (signs * (self.extent / 2)) @ self.R.T

    def scaled(self, factor: float) -> "OrientedBox":
        return OrientedBox(self.center, self.R, self.extent * factor)

    @property
    def volume(self) -> float:
        return float(np.prod(self.extent))


def _min_area_rect_2d(pts: np.ndarray):
    """Rotating calipers on a 2D point set -> (area, angle, (w, h), center)."""
    try:
        hull = ConvexHull(pts)
    except QhullError:
        hull = ConvexHull(pts, qhull_options="QJ")
    hp = pts[hull.vertices]
    edges = np.diff(np.vstack([hp, hp[:1]]), axis=0)
    angles = np.unique(np.mod(np.arctan2(edges[:, 1], edges[:, 0]), np.pi / 2))
    best = None
    for th in angles:
        c, s = np.cos(th), np.sin(th)
        R = np.array([[c, s], [-s, c]])
        proj = hp @ R.T
        mn, mx = proj.min(0), proj.max(0)
        wh = mx - mn
        area = wh[0] * wh[1]
        if best is None or area < best[0]:
            center2 = R.T @ ((mn + mx) / 2)
            best = (area, th, wh, center2)
    return best


def oriented_bounds(points: np.ndarray):
    """Minimal-volume OBB of a point set.

    Returns (to_origin [4,4], extents [3]). Raises QhullError for
    degenerate inputs (the caller skips such objects, like the reference's
    get_bound, vmap.py:291-296).
    """
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    if len(pts) < 4:
        raise QhullError("need at least 4 points for a 3D hull")
    try:
        hull3 = ConvexHull(pts)
    except QhullError:
        # degenerate (coplanar/colinear) input: joggle to make it full-rank
        # — produces a valid, hair-thin box instead of failing, which the
        # min-extent floors downstream inflate (the reference's Open3D path
        # hard-fails here and skips the object; robustness is preferable)
        hull3 = ConvexHull(pts, qhull_options="QJ")
    hp = pts[hull3.vertices]

    best = None
    # candidate orientations: each hull facet normal as the box z axis
    normals = hull3.equations[:, :3]
    # dedupe nearly-parallel normals to bound work on dense hulls
    keys = np.round(normals * 64).astype(np.int64)
    _, uniq = np.unique(keys, axis=0, return_index=True)
    for ni in uniq:
        n = normals[ni]
        n = n / np.linalg.norm(n)
        # build a frame with z = n
        a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        x = np.cross(a, n)
        x /= np.linalg.norm(x)
        y = np.cross(n, x)
        frame = np.stack([x, y, n], axis=1)  # world->frame via frame.T
        local = hp @ frame
        zmin, zmax = local[:, 2].min(), local[:, 2].max()
        area2, th, wh, c2 = _min_area_rect_2d(local[:, :2])
        vol = area2 * (zmax - zmin)
        if best is None or vol < best[0]:
            c, s = np.cos(th), np.sin(th)
            R2 = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            R = frame @ R2          # columns: box axes in world
            extent = np.array([wh[0], wh[1], zmax - zmin])
            center_local = np.array([c2[0], c2[1], (zmin + zmax) / 2])
            center = frame @ center_local
            best = (vol, R, extent, center)

    _, R, extent, center = best
    # canonicalise: sort axes by extent descending, keep right-handed
    order = np.argsort(-extent)
    R = R[:, order]
    extent = extent[order]
    if np.linalg.det(R) < 0:
        R[:, 2] = -R[:, 2]
    box = OrientedBox(center, R, extent)
    return box.to_origin(), extent


def obb_from_points(points: np.ndarray, min_extent: float = 0.0) -> OrientedBox | None:
    """Convenience: OBB or None on degenerate input; optional floor on the
    extents (the reference enforces 5-10 cm minima, vmap.py:298-307)."""
    try:
        to_origin, extents = oriented_bounds(points)
    except (QhullError, ValueError):
        return None
    extents = np.maximum(extents, min_extent)
    return OrientedBox.from_to_origin(to_origin, extents)
