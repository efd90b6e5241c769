"""Image-space transforms and 2D bbox utilities.

Parity targets: DepthScale / DepthFilter / BGRtoRGB / Undistort
(the reference's image_transforms.py:1-61), the vectorised mask->bbox
helpers (utils.py:36-84), and bbox order conventions
([u_low, u_high, v_low, v_high] in the framework's (W, H) layout,
dataset.py:127-133).
"""

from __future__ import annotations

import numpy as np


def depth_scale(depth: np.ndarray, scale: float) -> np.ndarray:
    """Raw depth -> metres (image_transforms.py:13-21)."""
    return depth.astype(np.float32) * scale


def depth_filter(depth: np.ndarray, max_depth: float) -> np.ndarray:
    """Zero out readings beyond max_depth (image_transforms.py:24-32)."""
    out = depth.copy()
    out[out > max_depth] = 0.0
    return out


def bgr_to_rgb(image: np.ndarray) -> np.ndarray:
    return image[..., ::-1]


def make_undistorter(w, h, fx, fy, cx, cy, dist_coeffs, interpolation=None):
    """Undistort map (image_transforms.py:35-61): returns a callable that
    remaps a uint8 image as the JAX package's ``cv2.remap`` through
    ``cv2.initUndistortRectifyMap`` does (``utils/image.py``, no OpenCV).
    ``interpolation``: None or ``cv2.INTER_LINEAR`` (1) for linear,
    ``cv2.INTER_NEAREST`` (0) for nearest."""
    from vmap_tpu_torch.utils.image import remap, undistort_maps
    if interpolation not in (None, 0, 1):
        raise ValueError(f"interpolation {interpolation!r}: linear (None or "
                         "1) or nearest (0)")
    K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    map1x, map1y = undistort_maps(K, dist_coeffs, w, h)
    nearest = interpolation == 0
    return lambda im: remap(im, map1x, map1y, nearest)


def bbox_from_mask(mask: np.ndarray) -> list | None:
    """Tight [u_low, u_high, v_low, v_high] around a boolean (W, H) mask.
    Returns None for an empty mask. Half-open upper bounds, matching how
    the sampler draws uniform in [low, high) (vmap.py:343-351)."""
    us = np.nonzero(mask.any(axis=1))[0]
    vs = np.nonzero(mask.any(axis=0))[0]
    if us.size == 0 or vs.size == 0:
        return None
    return [int(us[0]), int(us[-1]) + 1, int(vs[0]), int(vs[-1]) + 1]


def bbox_from_mask_batch(masks: np.ndarray):
    """Vectorised bboxes for [B, W, H] boolean masks: returns
    (u_min, u_max, v_min, v_max) arrays with half-open maxes
    (counterpart of utils.py:75-84)."""
    b, w, h = masks.shape
    any_u = masks.any(axis=2)  # [B, W]
    any_v = masks.any(axis=1)  # [B, H]
    u_min = any_u.argmax(axis=1)
    u_max = w - any_u[:, ::-1].argmax(axis=1)
    v_min = any_v.argmax(axis=1)
    v_max = h - any_v[:, ::-1].argmax(axis=1)
    return u_min, u_max, v_min, v_max


def order_overlapping_masks(masks: list[np.ndarray], depth: np.ndarray,
                            obj_ids: list[int]) -> np.ndarray:
    """Resolve overlapping instance masks into a single label map using
    containment and mean depth (counterpart of the reference's
    ``check_mask_order``, utils.py:217-254): a mask fully inside another is
    in front; otherwise the mask with smaller mean depth wins the overlap.
    Returns an int32 (W, H) instance map."""
    assert len(masks) == len(obj_ids)
    masks = [np.asarray(m, bool) for m in masks]
    mod = [m.copy() for m in masks]
    depth = np.asarray(depth)
    for i in range(len(masks) - 1):
        for j in range(i + 1, len(masks)):
            inter = masks[i] & masks[j]
            if not inter.any():
                continue
            if (inter == masks[i]).all():      # i fully inside j: i in front
                mod[j] &= ~mod[i]
            elif (inter == masks[j]).all():    # j fully inside i
                mod[i] &= ~mod[j]
            else:
                di = depth[masks[i]].mean()
                dj = depth[masks[j]].mean()
                if di < dj:                    # i closer: i wins the overlap
                    mod[j] &= ~inter
                elif dj < di:
                    mod[i] &= ~inter
    out = np.zeros(depth.shape, np.int32)
    for m, oid in zip(mod, obj_ids):
        out[m] = oid
    return out


def enlarge_bbox(bbox, scale: float, w: int, h: int) -> list | None:
    """Grow a [u0, u1, v0, v1] bbox by ``scale/2`` of its size on each side,
    clipped to the image; degenerate boxes return None (utils.py:36-57)."""
    assert scale >= 0
    u0, u1, v0, v1 = bbox
    mu = int(0.5 * scale * (u1 - u0))
    mv = int(0.5 * scale * (v1 - v0))
    if mu == 0 or mv == 0:
        return None
    u0, u1 = np.clip(u0 - mu, 0, w - 1), np.clip(u1 + mu, 0, w - 1)
    v0, v1 = np.clip(v0 - mv, 0, h - 1), np.clip(v1 + mv, 0, h - 1)
    return [int(u0), int(u1), int(v0), int(v1)]
