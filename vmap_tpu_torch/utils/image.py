"""The OpenCV resampling the loaders use, without OpenCV: numpy arithmetic
that reproduces the ``cv2`` (5.0) the JAX loaders run, pixel for pixel.

  * ``resize_linear``: ``cv2.resize(..., INTER_LINEAR)`` on uint8 images:
    the source map (dx + 0.5) * scale - 0.5 in float32, 11-bit weights
    (``INTER_RESIZE_COEF_BITS``), clamped borders, the horizontal pass kept
    in int32; the vertical pass rounds as OpenCV's vector code does (each
    row sum shifted right by 4, times its weight, shifted right by 16, the
    two added and rounded by a shift of 2), not as its scalar code (one
    rounding shift of 22), which is one grey level off on about 13% of
    pixels; equal sizes are a copy.
  * ``resize_nearest``: ``cv2.resize(..., INTER_NEAREST)`` (any dtype).
  * ``undistort_maps`` / ``remap``: ``cv2.initUndistortRectifyMap`` (float64,
    stored as float32 maps) and ``cv2.remap`` with ``BORDER_CONSTANT`` 0:
    nearest, or linear as OpenCV 5 interpolates, in float32 from the
    map's exact fractions (two horizontal lerps, then a vertical one; a
    neighbour outside the image reads 0), rounded half to even. (OpenCV
    4's 1/32 coordinate steps and 15-bit weights differ from it by up to 4
    grey levels.)
"""

from __future__ import annotations

import numpy as np

RESIZE_BITS = 11          # INTER_RESIZE_COEF_BITS


def _linear_taps(n_out: int, n_in: int):
    """cv::resize's INTER_LINEAR source index and 11-bit weight pair for
    each output position along one axis (before clamping to the image)."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out, dtype=np.float64) + 0.5) * scale
         - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    frac = (f - s.astype(np.float32)).astype(np.float32)
    return s, frac


def _round_short(x: np.ndarray) -> np.ndarray:
    """saturate_cast<short>(float): round half to even."""
    return np.rint(x).astype(np.int32)


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] -> [height, width(, C)], as
    ``cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)``."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_linear takes uint8; got {img.dtype}")
    h, w = img.shape[:2]
    if (w, h) == (width, height):
        return img.copy()
    one = 1 << RESIZE_BITS
    src = img.reshape(h, w, -1)
    # horizontal: a source column outside the image clamps with weight 0
    sx, fx = _linear_taps(width, w)
    fx = np.where((sx < 0) | (sx >= w - 1), np.float32(0), fx)
    sx = np.clip(sx, 0, w - 1)
    sx1 = np.minimum(sx + 1, w - 1)
    ax0 = _round_short((np.float32(1) - fx) * np.float32(one))
    ax1 = _round_short(fx * np.float32(one))
    # vertical: the rows are clamped, the weights kept
    sy, fy = _linear_taps(height, h)
    by0 = _round_short((np.float32(1) - fy) * np.float32(one))
    by1 = _round_short(fy * np.float32(one))

    def rows(ys):
        """The horizontal pass's int sums of source rows ``ys``, >> 4."""
        r = src[ys]
        return (r[:, sx].astype(np.int32) * ax0[None, :, None]
                + r[:, sx1].astype(np.int32) * ax1[None, :, None]) >> 4

    out = ((((rows(np.clip(sy, 0, h - 1)) * by0[:, None, None]) >> 16)
            + ((rows(np.clip(sy + 1, 0, h - 1)) * by1[:, None, None]) >> 16)
            + 2) >> 2)
    out = np.clip(out, 0, 255).astype(np.uint8)
    return out.reshape((height, width) + img.shape[2:])


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """[H, W(, C)] -> [height, width(, C)], as ``cv2.resize(img, (width,
    height), interpolation=cv2.INTER_NEAREST)``."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    sx = np.minimum(np.floor(np.arange(width) * (1.0 / (width / w))), w - 1)
    sy = np.minimum(np.floor(np.arange(height) * (1.0 / (height / h))),
                    h - 1)
    return img[sy.astype(np.int64)][:, sx.astype(np.int64)]


def _inv3(a: np.ndarray) -> np.ndarray:
    """The inverse of a 3x3 matrix by OpenCV's closed form (cofactors times
    the reciprocal determinant), as ``Matx33d::inv(DECOMP_LU)`` computes."""
    d = (a[0, 0] * (a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1])
         - a[0, 1] * (a[1, 0] * a[2, 2] - a[1, 2] * a[2, 0])
         + a[0, 2] * (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]))
    d = 1.0 / d
    return np.array([
        [(a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1]) * d,
         (a[0, 2] * a[2, 1] - a[0, 1] * a[2, 2]) * d,
         (a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1]) * d],
        [(a[1, 2] * a[2, 0] - a[1, 0] * a[2, 2]) * d,
         (a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0]) * d,
         (a[0, 2] * a[1, 0] - a[0, 0] * a[1, 2]) * d],
        [(a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]) * d,
         (a[0, 1] * a[2, 0] - a[0, 0] * a[2, 1]) * d,
         (a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]) * d]])


def undistort_maps(K: np.ndarray, dist_coeffs, width: int, height: int):
    """``cv2.initUndistortRectifyMap(K, dist, I, K, (width, height),
    CV_32FC1)``: float32 [height, width] source x and y maps (distortion
    coefficients k1, k2, p1, p2[, k3[, k4, k5, k6]])."""
    K = np.asarray(K, np.float64)
    d = np.zeros(8)
    dist = np.asarray(dist_coeffs, np.float64).ravel()
    if dist.size not in (4, 5, 8):
        raise ValueError(f"undistort takes 4, 5 or 8 distortion "
                         f"coefficients; got {dist.size}")
    d[:dist.size] = dist
    k1, k2, p1, p2, k3, k4, k5, k6 = d
    ir = _inv3(K).ravel()
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    i = np.arange(height, dtype=np.float64)[:, None]

    def along(a, b, c):
        # OpenCV's loop starts each row at i * b + c and adds a once a
        # column; cumsum adds in that same order
        run = np.concatenate([i * b + c,
                              np.broadcast_to(a, (height, width - 1))], axis=1)
        return np.cumsum(run, axis=1)

    _x = along(ir[0], ir[1], ir[2])
    _y = along(ir[3], ir[4], ir[5])
    _w = along(ir[6], ir[7], ir[8])
    w = 1.0 / _w
    x, y = _x * w, _y * w
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = ((1 + ((k3 * r2 + k2) * r2 + k1) * r2)
          / (1 + ((k6 * r2 + k5) * r2 + k4) * r2))
    xd = x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy
    u = fx * xd + u0
    v = fy * yd + v0
    return u.astype(np.float32), v.astype(np.float32)


def remap(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
          nearest: bool = False) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, INTER_LINEAR or INTER_NEAREST)`` with
    ``BORDER_CONSTANT`` 0, for uint8 [H, W] or [H, W, C] images."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"remap takes uint8; got {img.dtype}")
    h, w = img.shape[:2]
    src = img.reshape(h, w, -1)
    if nearest:
        sx = np.rint(map_x).astype(np.int64)
        sy = np.rint(map_y).astype(np.int64)
        inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
        out = src[np.clip(sy, 0, h - 1), np.clip(sx, 0, w - 1)]
        out = np.where(inside[..., None], out, 0).astype(np.uint8)
        return out.reshape(map_x.shape + img.shape[2:])
    x0, y0 = np.floor(map_x), np.floor(map_y)
    a = (map_x - x0).astype(np.float32)[..., None]
    b = (map_y - y0).astype(np.float32)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)

    def at(dy, dx):
        px, py = x0 + dx, y0 + dy
        ok = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        v = src[np.clip(py, 0, h - 1), np.clip(px, 0, w - 1)]
        return np.where(ok[..., None], v, 0).astype(np.float32)

    p00, p01, p10, p11 = at(0, 0), at(0, 1), at(1, 0), at(1, 1)
    top = p00 + a * (p01 - p00)
    bottom = p10 + a * (p11 - p10)
    out = np.clip(np.rint(top + b * (bottom - top)), 0, 255).astype(np.uint8)
    return out.reshape(map_x.shape + img.shape[2:])
