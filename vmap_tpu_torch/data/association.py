"""3D instance association for noisy instance streams (ScanNet path).

Counterpart of the reference's ``box_filter`` (utils.py:112-208): each
frame's 2D instance masks are validated against persistent per-instance 3D
oriented boxes built from back-projected depth. Pixels whose 3D points fall
outside the remembered box are relabelled ``-1`` (unsure) so the mapper's
pixel-state machinery treats them as unknown; masks with no 3D support
are dropped to background. Uses the in-repo geometry stack (unprojection,
minimal OBB, voxel downsampling) instead of Open3D.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from vmap_tpu_torch.geometry.obb import OrientedBox, obb_from_points
from vmap_tpu_torch.geometry.pointcloud import unproject_depth, voxel_downsample


@dataclass
class InstanceTrack:
    """Persistent 3D state of one instance id (reference InstData,
    utils.py:101-109)."""
    inst_id: int
    points: np.ndarray
    bbox3d: OrientedBox | None = None
    class_id: int = -1
    merge_cnt: int = 0
    cmp_cnt: int = 0
    feature: np.ndarray | None = None  # running-mean semantic embedding


class FeatureAffinity:
    """Embedding-backed ``class_affinity``: two class ids match when their
    feature vectors' cosine similarity clears ``threshold``.

    Concrete implementation of the reference's optional CLIP-feature
    semantic merging in track_instance (utils.py:274-382, where per-track
    CLIP embeddings are averaged and compared instead of raw class ids).
    ``provider`` maps class_id -> feature vector: a dict, an .npz path
    (arrays keyed by str(class_id) — e.g. precomputed CLIP text embeddings
    of the label set), or any callable.
    """

    def __init__(self, provider, threshold: float = 0.9):
        if isinstance(provider, str):
            z = np.load(provider)
            provider = {int(k): z[k] for k in z.files}
        if isinstance(provider, dict):
            table = dict(provider)
            provider = table.get
        self._provider = provider
        self.threshold = float(threshold)
        self._cache: dict[int, np.ndarray | None] = {}

    def feature(self, class_id: int) -> np.ndarray | None:
        if class_id not in self._cache:
            f = self._provider(class_id)
            if f is not None:
                f = np.asarray(f, np.float32)
                f = f / max(float(np.linalg.norm(f)), 1e-12)
            self._cache[class_id] = f
        return self._cache[class_id]

    def __call__(self, c1: int, c2: int) -> bool:
        if c1 == c2:
            return True
        f1, f2 = self.feature(c1), self.feature(c2)
        if f1 is None or f2 is None:
            return False
        return float(f1 @ f2) >= self.threshold


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    na = float(np.linalg.norm(a))
    nb = float(np.linalg.norm(b))
    return float(a @ b) / max(na * nb, 1e-12)


@dataclass
class AssociationState:
    tracks: dict[int, InstanceTrack] = field(default_factory=dict)


def _erode(mask: np.ndarray, iterations: int = 3) -> np.ndarray:
    """5x5 binary erosion, ``iterations`` times (reference cv2.erode,
    utils.py:181). Outside the image counts as set, as ``cv2.erode``'s
    default border (the maximum) does, so the image border does not
    erode."""
    from scipy.ndimage import binary_erosion
    return binary_erosion(np.asarray(mask, bool), np.ones((5, 5), bool),
                          iterations=iterations, border_value=1)


def associate_frame(
    masks: list[np.ndarray],
    ids: list[int],
    depth: np.ndarray,
    state: AssociationState,
    fx: float, fy: float, cx: float, cy: float,
    t_wc: np.ndarray,
    min_pixels: int = 500,
    voxel_size: float = 0.01,
    bbox_scale: float = 1.0,
) -> np.ndarray:
    """Validate/merge this frame's masks against the persistent 3D tracks.

    Returns the relabelled (W, H) instance map: 0 background, -1 unsure,
    otherwise the instance id. Mirrors box_filter's decision tree
    (utils.py:112-208)."""
    inst_out = np.zeros(depth.shape, np.int32)
    for mask, inst_id in zip(masks, ids):
        if inst_id == 0:
            continue
        pts = unproject_depth(depth, fx, fy, cx, cy, t_wc=t_wc, mask=mask)
        if len(pts) <= 10:  # too small in 3D (utils.py:126-128)
            continue

        diff_mask = None
        track = state.tracks.get(inst_id)
        if track is not None and track.bbox3d is not None:
            track.cmp_cnt += 1
            inside = track.bbox3d.scaled(bbox_scale).contains(pts)
            if inside.sum() >= 1:
                track.points = voxel_downsample(
                    np.concatenate([track.points, pts[inside]]), voxel_size)
                # pixels with valid depth whose 3D point left the box ->
                # unsure (utils.py:139-155)
                valid_px = mask & (depth > 0)
                u, v = np.nonzero(valid_px)
                diff_mask = np.zeros_like(mask)
                diff_mask[u[~inside], v[~inside]] = True
                box = obb_from_points(track.points)
                if box is None:
                    inst_out[mask] = -1
                    continue
                track.bbox3d = box
                track.merge_cnt += 1
            else:  # no overlap at all: whole mask unsure (utils.py:158-161)
                inst_out[mask] = -1
                continue
        else:  # new instance (utils.py:177-201)
            small = _erode(mask)
            if small.sum() < min_pixels:
                continue  # too small -> background
            pts_small = unproject_depth(depth, fx, fy, cx, cy, t_wc=t_wc,
                                        mask=small)
            pts_small = voxel_downsample(pts_small, voxel_size)
            box = obb_from_points(pts_small)
            if box is None:
                continue
            state.tracks[inst_id] = InstanceTrack(
                inst_id=inst_id, points=pts_small, bbox3d=box)

        inst_out[mask] = inst_id
        if diff_mask is not None:
            inst_out[diff_mask] = -1
    return inst_out


def track_detections(
    masks: list[np.ndarray],
    class_ids: list[int],
    depth: np.ndarray,
    state: AssociationState,
    fx: float, fy: float, cx: float, cy: float,
    t_wc: np.ndarray,
    iou_thresh: float = 0.5,
    min_pixels: int = 2000,
    voxel_size: float = 0.1,
    min_extent: float = 0.05,
    class_affinity=None,
    features: list | None = None,
    feature_threshold: float = 0.9,
) -> np.ndarray:
    """Detection-based tracking for streams WITHOUT temporally consistent
    instance ids (live/detector input): assigns persistent ids by 3D
    inside-ratio against remembered boxes of same-class (or
    affinity-matched) tracks, creating new tracks otherwise.

    Counterpart of the reference's ``track_instance`` (utils.py:274-382,
    dormant there). Semantic matching, in precedence order:
      * ``features`` — one embedding per detection (e.g. CLIP image
        features): a detection matches a track when the cosine similarity
        of its feature to the track's running-mean feature clears
        ``feature_threshold`` (the reference's semantic branch); merged
        tracks running-average their feature.
      * ``class_affinity(c1, c2) -> bool`` — e.g. a ``FeatureAffinity``
        over precomputed per-class embeddings.
      * plain class-id equality.

    Returns the (W, H) instance map (0 background, -1 unsure).
    """
    inst_out = np.zeros(depth.shape, np.int32)
    if features is None:
        features = [None] * len(masks)
    for mask, cls, feat in zip(masks, class_ids, features):
        if feat is not None:
            feat = np.asarray(feat, np.float32)
        small = _erode(mask)
        if small.sum() <= min_pixels:
            continue
        pts_small = voxel_downsample(
            unproject_depth(depth, fx, fy, cx, cy, t_wc=t_wc, mask=small),
            voxel_size)
        if len(pts_small) <= 10:
            continue
        pts = unproject_depth(depth, fx, fy, cx, cy, t_wc=t_wc, mask=mask)

        def class_match(track):
            if feat is not None and track.feature is not None:
                return _cosine(feat, track.feature) >= feature_threshold
            if class_affinity is not None:
                return class_affinity(cls, track.class_id)
            return track.class_id == cls

        merged_id = None
        diff_mask = None
        for track in state.tracks.values():
            if track.bbox3d is None or not class_match(track):
                continue
            track.cmp_cnt += 1
            inside = track.bbox3d.contains(pts)
            if inside.mean() > iou_thresh:
                track.merge_cnt += 1
                track.points = voxel_downsample(
                    np.concatenate([track.points, pts[inside]]), voxel_size)
                box = obb_from_points(track.points, min_extent=min_extent)
                if box is not None:
                    track.bbox3d = box
                if feat is not None:  # running-mean semantic embedding
                    n = track.merge_cnt
                    track.feature = (feat if track.feature is None else
                                     (track.feature * n + feat) / (n + 1))
                valid_px = mask & (depth > 0)
                u, v = np.nonzero(valid_px)
                diff_mask = np.zeros_like(mask)
                diff_mask[u[~inside], v[~inside]] = True
                merged_id = track.inst_id
                break

        if merged_id is None:
            box = obb_from_points(pts_small, min_extent=min_extent)
            if box is None:
                continue
            merged_id = max(state.tracks.keys(), default=0) + 1
            t = InstanceTrack(inst_id=merged_id, points=pts_small, bbox3d=box)
            t.class_id = cls
            t.feature = feat
            state.tracks[merged_id] = t

        inst_out[mask] = merged_id
        if diff_mask is not None:
            inst_out[diff_mask] = -1
    return inst_out
