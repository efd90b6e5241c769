"""Point-set reconstruction metrics.

Definition parity with the reference (metric/metrics.py:1-37):
  * accuracy          — mean NN distance, reconstruction -> GT
  * completion        — mean NN distance, GT -> reconstruction
  * completion_ratio  — fraction of GT points with a reconstruction
                        neighbour within a threshold (1 cm / 5 cm)
  * chamfer           — symmetric mean
KD-tree backed (scipy cKDTree, same backend the reference uses).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def accuracy(gt_points: np.ndarray, rec_points: np.ndarray) -> float:
    d, _ = cKDTree(gt_points).query(rec_points, workers=-1)
    return float(np.mean(d))


def completion(gt_points: np.ndarray, rec_points: np.ndarray) -> float:
    d, _ = cKDTree(rec_points).query(gt_points, workers=-1)
    return float(np.mean(d))


def completion_ratio(gt_points: np.ndarray, rec_points: np.ndarray,
                     dist_th: float = 0.01) -> float:
    d, _ = cKDTree(rec_points).query(gt_points, workers=-1)
    return float(np.mean((d < dist_th).astype(np.float64)))


def chamfer(gt_points: np.ndarray, rec_points: np.ndarray) -> float:
    return 0.5 * (accuracy(gt_points, rec_points)
                  + completion(gt_points, rec_points))


def all_metrics(gt_points: np.ndarray, rec_points: np.ndarray) -> dict:
    """The reference's standard 4-tuple (eval_3D_scene.py:17-33):
    Acc | Comp | Comp-ratio@1cm | Comp-ratio@5cm."""
    return {
        "accuracy": accuracy(gt_points, rec_points),
        "completion": completion(gt_points, rec_points),
        "completion_ratio_1cm": completion_ratio(gt_points, rec_points, 0.01),
        "completion_ratio_5cm": completion_ratio(gt_points, rec_points, 0.05),
    }
