"""The port's OpenCV-free resampling (``vmap_tpu_torch/utils/image.py``) and
erosion (``data/association.py::_erode``) against ``cv2``:

  * ``resize_linear`` against ``cv2.resize(INTER_LINEAR)`` at ScanNet's
    1296 x 968 -> 640 x 480 and at an upscale, ``resize_nearest`` against
    ``INTER_NEAREST`` on uint8 and uint16 masks;
  * ``remap`` through ``undistort_maps`` and the port's
    ``make_undistorter`` against the JAX package's ``make_undistorter``
    (``cv2.initUndistortRectifyMap`` + ``cv2.remap``) with ScanNet-like
    coefficients (k1, k2, p1, p2, k3);
  * ``_erode`` against ``cv2.erode`` (5 x 5, three iterations) on seeded
    masks that touch the border.

The bound for the resamplings is one grey level; each test prints the
share of pixels that differ (0 on this build of cv2: the port follows its
vector rounding and OpenCV 5's float remap).
"""

import cv2
import numpy as np
import pytest

from vmap_tpu.data.transforms import make_undistorter as j_undistorter
from vmap_tpu_torch.data.association import _erode
from vmap_tpu_torch.data.transforms import make_undistorter as t_undistorter
from vmap_tpu_torch.utils import image

# ScanNet scene0000's depth camera and a lens with visible distortion
K = np.array([[577.59, 0.0, 318.91], [0.0, 578.73, 242.68], [0.0, 0.0, 1.0]])
DIST = np.array([0.08, -0.21, 0.0012, -0.0019, 0.07])


def _image(h, w, c=3, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 110 * np.sin(x / 9.0 + k) * np.cos(y / 6.0)
                    for k in range(c)], -1)
    img += rng.normal(0, 30, img.shape)
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img if c > 1 else img[..., 0]


def _within_one_level(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    share = float((d > 0).mean())
    print(f"{what}: {share:.6f} of pixels differ, max {int(d.max())}")
    assert int(d.max()) <= 1, what
    return share


@pytest.mark.parametrize("src,dst", [((968, 1296), (480, 640)),
                                     ((23, 37), (61, 90)),
                                     ((480, 640), (480, 640))],
                         ids=["scannet", "upscale", "same"])
@pytest.mark.parametrize("channels", [3, 1])
def test_resize_linear_matches_cv2(src, dst, channels):
    img = _image(*src, c=channels)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    _within_one_level(image.resize_linear(img, dst[1], dst[0]), want,
                      f"resize_linear {src} -> {dst} x{channels}")


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("src,dst", [((968, 1296), (480, 640)),
                                     ((37, 23), (80, 51))])
def test_resize_nearest_matches_cv2(dtype, src, dst):
    rng = np.random.default_rng(1)
    mask = rng.integers(0, np.iinfo(dtype).max, src).astype(dtype)
    want = cv2.resize(mask, dst[::-1], interpolation=cv2.INTER_NEAREST)
    got = image.resize_nearest(mask, dst[1], dst[0])
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want)


def test_undistort_maps_match_cv2():
    mx, my = cv2.initUndistortRectifyMap(K, DIST, np.eye(3), K, (640, 480),
                                         cv2.CV_32FC1)
    ux, uy = image.undistort_maps(K, DIST, 640, 480)
    np.testing.assert_array_equal(ux, mx)
    np.testing.assert_array_equal(uy, my)


@pytest.mark.parametrize("interpolation", [None, cv2.INTER_NEAREST],
                         ids=["linear", "nearest"])
@pytest.mark.parametrize("dist", [DIST, np.array([-0.45, 0.3, 0.01, -0.01,
                                                  0.0])],
                         ids=["scannet", "strong"])
def test_undistort_matches_the_jax_undistorter(interpolation, dist):
    """The strong lens pulls samples from outside the image, so the
    constant border is exercised too."""
    img = _image(480, 640)
    args = (640, 480, K[0, 0], K[1, 1], K[0, 2], K[1, 2], dist)
    want = j_undistorter(*args, interpolation=interpolation)(img)
    got = t_undistorter(*args, interpolation=interpolation)(img)
    _within_one_level(got, want, f"undistort {interpolation}")
    if interpolation is None:
        _within_one_level(image.remap(img, *image.undistort_maps(K, dist,
                                                                 640, 480)),
                          want, "undistort")


def test_erode_matches_cv2_on_masks_at_the_border():
    rng = np.random.default_rng(0)
    for _ in range(50):
        h, w = rng.integers(20, 90, 2)
        m = np.zeros((h, w), bool)
        for _ in range(4):   # boxes, some cut by the border
            y0, x0 = rng.integers(-10, h), rng.integers(-10, w)
            m[max(y0, 0):y0 + rng.integers(5, 40),
              max(x0, 0):x0 + rng.integers(5, 40)] = True
        m |= rng.random((h, w)) < 0.02
        want = cv2.erode(m.astype(np.uint8), np.ones((5, 5), np.uint8),
                         iterations=3).astype(bool)
        np.testing.assert_array_equal(_erode(m), want)
    full = np.ones((12, 12), bool)
    assert _erode(full).all()     # the border itself does not erode
