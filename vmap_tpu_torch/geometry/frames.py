"""Coordinate-frame conversions for dataset generation and ingestion.

Counterpart of the reference's data_generation/transformation.py:5-48
(Habitat's y-up graphics frame vs the z-up world frame, OpenCV vs OpenGL
camera conventions, pose-from-quaternion). The Habitat-Sim renderer itself
is out of scope (pre-rendered sequences are the input; see
docs/data_generation.md), but these conversions are needed whenever poses
come from a y-up / OpenGL source.
"""

from __future__ import annotations

import numpy as np

# OpenGL camera (x right, y up, z backward) <-> OpenCV camera
# (x right, y down, z forward): flip y and z.
T_GL_CV = np.diag([1.0, -1.0, -1.0, 1.0])

# y-up world (Habitat) <-> z-up world: rotate -90deg about x.
T_YUP_ZUP = np.array([
    [1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, -1.0, 0.0],
    [0.0, 1.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
])


def opengl_to_opencv_pose(t_wc_gl: np.ndarray) -> np.ndarray:
    """Camera-to-world pose with an OpenGL camera frame -> OpenCV camera."""
    return np.asarray(t_wc_gl) @ T_GL_CV


def opencv_to_opengl_pose(t_wc_cv: np.ndarray) -> np.ndarray:
    return np.asarray(t_wc_cv) @ T_GL_CV  # involution


def yup_world_to_zup(t_wc_yup: np.ndarray) -> np.ndarray:
    """Re-express a pose whose world frame is y-up in a z-up world."""
    return T_YUP_ZUP @ np.asarray(t_wc_yup)


def zup_world_to_yup(t_wc_zup: np.ndarray) -> np.ndarray:
    return np.linalg.inv(T_YUP_ZUP) @ np.asarray(t_wc_zup)


def quat_to_rotation(q: np.ndarray, order: str = "wxyz") -> np.ndarray:
    """Unit quaternion -> 3x3 rotation matrix."""
    q = np.asarray(q, np.float64)
    if order == "xyzw":
        x, y, z, w = q
    elif order == "wxyz":
        w, x, y, z = q
    else:
        raise ValueError(order)
    n = w * w + x * x + y * y + z * z
    if n < 1e-12:
        return np.eye(3)
    s = 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ])


def pose_from_quat_trans(q: np.ndarray, t: np.ndarray,
                         order: str = "wxyz") -> np.ndarray:
    """(quaternion, translation) -> 4x4 camera-to-world pose
    (transformation.py:combine_pose counterpart)."""
    T = np.eye(4)
    T[:3, :3] = quat_to_rotation(q, order)
    T[:3, 3] = np.asarray(t, np.float64)
    return T
