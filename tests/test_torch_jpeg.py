"""The port's JPEG codec (``vmap_tpu_torch/utils/jpeg.py`` with
``native/jpeg.cpp``) against OpenCV's (libjpeg-turbo):

  * decode: files ``cv2.imwrite`` wrote read bit-equal to ``cv2.imread``
    (RGB order), at odd sizes and ScanNet's 1296 x 968 colour size, at
    quality 75 / 95 / 100, 4:2:0 / 4:2:2 / 4:4:4, greyscale (expanded to
    three channels) and with a restart interval;
  * encode: ``write_jpeg`` at its defaults gives the bytes ``cv2.imwrite``
    writes without parameters;
  * progressive files are refused, and so are corrupt headers: every
    index the native decoder takes from a file (Huffman table selectors,
    scan components, sampling factors, code counts) is checked before it
    is used.
"""

import cv2
import numpy as np
import pytest

from vmap_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg, write_jpeg

SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
SIZES = [(23, 37), (97, 129), (968, 1296)]


def _image(h, w, seed=0):
    """A smooth colour field with noise: coefficients at every frequency,
    samples that clip at both ends after the IDCT."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 110 * np.sin(x / 7.0 + c) * np.cos(y / 5.0)
                    for c in range(3)], -1)
    img += rng.normal(0, 25, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2_file(img_rgb, params=()):
    img = img_rgb[..., ::-1] if img_rgb.ndim == 3 else img_rgb
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf


def _held(buf):
    want = cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1]
    got = decode_jpeg(buf.tobytes())
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("quality", [75, 95, 100])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_decode_matches_cv2(size, quality, sampling):
    img = _image(*size)
    _held(_cv2_file(img, [cv2.IMWRITE_JPEG_QUALITY, quality,
                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                          SAMPLING[sampling]]))


@pytest.mark.parametrize("size", SIZES[:2], ids=lambda s: f"{s[1]}x{s[0]}")
def test_decode_greyscale_matches_cv2(size):
    _held(_cv2_file(_image(*size)[..., 1]))


@pytest.mark.parametrize("size", SIZES[:2], ids=lambda s: f"{s[1]}x{s[0]}")
def test_decode_with_restart_markers_matches_cv2(size):
    buf = _cv2_file(_image(*size), [cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
    assert b"\xff\xdd" in buf.tobytes()
    _held(buf)


@pytest.mark.parametrize("size", [(1, 1), (9, 17), *SIZES],
                         ids=lambda s: f"{s[1]}x{s[0]}")
def test_encode_gives_cv2_bytes(size, tmp_path):
    img = _image(*size, seed=3)
    path = str(tmp_path / "a.jpg")
    write_jpeg(path, img)
    with open(path, "rb") as f:
        assert f.read() == _cv2_file(img).tobytes()


def test_encode_decode_round_trip_stays_close():
    y, x = np.mgrid[0:61, 0:83]
    img = np.stack([x * 3, y * 4, (x + y) * 2], -1).astype(np.uint8)
    got = decode_jpeg(encode_jpeg(img)).astype(np.int32)
    assert np.abs(got - img).mean() < 2.0


def test_progressive_and_bad_input_raise():
    buf = _cv2_file(_image(40, 40), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive"):
        decode_jpeg(buf.tobytes())
    with pytest.raises(ValueError, match="SOI"):
        decode_jpeg(b"\x89PNG....")
    with pytest.raises(ValueError, match="uint8"):
        encode_jpeg(np.zeros((4, 4), np.uint8))


def _patched(marker, values):
    """A cv2-written 3-component 4:2:0 file with bytes of the first
    ``marker`` segment's body (after its length) set: {offset: value}."""
    buf = bytearray(_cv2_file(_image(40, 48)).tobytes())
    at = buf.index(bytes([0xFF, marker])) + 4
    for offset, value in values.items():
        buf[at + offset] = value
    return bytes(buf)


# (marker, {byte of its body: value}, the refusal). cv2's SOS body is
# ns, then (component, DC << 4 | AC table) per component; its SOF body
# precision, height, width, nc, then (component, h << 4 | v, table); its
# first DHT segment is the luma DC table: class << 4 | id, 16 code counts.
CORRUPT = {
    "dc-selector": (0xDA, {2: 0x40}, "selectors"),
    "ac-selector": (0xDA, {2: 0x04}, "selectors"),
    "no-components": (0xDA, {0: 0}, "scan of 0 components"),
    "more-components-than-the-frame": (0xDA, {0: 4}, "scan of 4 components"),
    "repeated-component": (0xDA, {3: 1}, "twice"),
    "unknown-component": (0xDA, {1: 9}, "does not define"),
    "zero-sampling-factor": (0xC0, {7: 0x02}, "sampling factors"),
    "repeated-frame-component": (0xC0, {9: 1}, "defined twice"),
    "values-past-the-segment": (0xC4, {1: 3}, "corrupt Huffman table"),
    "table-class": (0xC4, {0: 0x20}, "corrupt Huffman table"),
    # the same 12 codes, one of them 1 bit long: more 3-bit codes than
    # are left (the native decoder refuses the table before filling it)
    "codes-overflow": (0xC4, {1: 1, 2: 0}, "more codes than fit"),
}


@pytest.mark.parametrize("case", list(CORRUPT))
def test_corrupt_headers_raise(case):
    marker, values, match = CORRUPT[case]
    with pytest.raises(ValueError, match=match):
        decode_jpeg(_patched(marker, values))


def test_truncated_file_raises():
    buf = _cv2_file(_image(40, 48)).tobytes()
    for cut in (3, 30, len(buf) // 2, len(buf) - 2):
        with pytest.raises(ValueError):
            decode_jpeg(buf[:cut])
