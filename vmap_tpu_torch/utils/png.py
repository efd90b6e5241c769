"""PNG files without OpenCV: the Replica layout's images, read and written
with the standard library's ``zlib`` and numpy.

Writes 8-bit RGB and 8- or 16-bit greyscale (16-bit samples big-endian,
as PNG stores them), each row filtered by None, Sub or Up, whichever
gives the smallest sum of absolute filtered bytes; zlib at level 1, as
OpenCV writes. Reads 8- and 16-bit greyscale, grey + alpha, RGB and RGBA
with all five filter types, so files that libpng (OpenCV) wrote read
too. Every row is reconstructed by the port's native library
(``native.png_unfilter``, built with g++ at first use), since Average and
Paeth run along the row pixel by pixel; reading needs that library.
Interlaced, palette and 1/2/4-bit images are refused.

Arrays are image-major, as OpenCV's: [H, W] for greyscale, [H, W, C]
otherwise, but colour stays in file order (RGB, not OpenCV's BGR).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # grey, RGB, grey + alpha, RGBA
NONE, SUB, UP = range(3)             # the filter types the encoder writes


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filter_rows(raw: np.ndarray, bpp: int) -> np.ndarray:
    """[H, stride] bytes -> [H, 1 + stride]: each row under None, Sub or
    Up, the one with the smallest sum of |filtered byte| (as int8)."""
    sub = raw.copy()
    sub[:, bpp:] -= raw[:, :-bpp]
    up = raw.copy()
    up[1:] -= raw[:-1]
    cand = np.stack([raw, sub, up])                        # [3, H, stride]
    # |int8| as uint8 (|-128| wraps to -128, which reads back as 128)
    score = np.abs(cand.view(np.int8)).view(np.uint8).sum(-1,
                                                          dtype=np.uint32)
    kind = score.argmin(0)                                 # [H]
    rows = np.take_along_axis(cand, kind[None, :, None], 0)[0]
    return np.concatenate([kind.astype(np.uint8)[:, None], rows], axis=1)


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] / [H, W, 3] (RGB) or uint16 [H, W] -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        color, depth, data = 2, 8, img
    elif img.dtype == np.uint8 and img.ndim == 2:
        color, depth, data = 0, 8, img
    elif img.dtype == np.uint16 and img.ndim == 2:
        color, depth, data = 0, 16, img.astype(">u2")
    else:
        raise ValueError(f"write_png takes uint8 [H, W] or [H, W, 3], or "
                         f"uint16 [H, W]; got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    bpp = CHANNELS[color] * depth // 8
    raw = np.ascontiguousarray(data).view(np.uint8).reshape(h, w * bpp)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    idat = zlib.compress(_filter_rows(raw, bpp).tobytes(), 1)
    return (SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", idat)
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _unfilter(data: np.ndarray, bpp: int) -> np.ndarray:
    from vmap_tpu_torch import native
    if native.get_lib() is None:
        raise RuntimeError(
            "PNG rows decode through the port's native library "
            "(vmap_tpu_torch/native, built with g++); it is not available")
    return native.png_unfilter(data, bpp)


def decode_png(buf: bytes) -> np.ndarray:
    """PNG bytes -> uint8 / uint16 array ([H, W] or [H, W, C])."""
    if buf[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(buf):
        (n,) = struct.unpack_from(">I", buf, pos)
        kind = buf[pos + 4:pos + 8]
        body = buf[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack_from(">I", buf, pos + 8 + n)
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind[0] & 0x20 == 0 and kind != b"PLTE":
            raise ValueError(f"unsupported critical PNG chunk {kind!r}")
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if color not in CHANNELS:
        raise ValueError(f"PNG colour type {color} (palette) not supported")
    if depth not in (8, 16):
        raise ValueError(f"PNG bit depth {depth} not supported (8 or 16)")
    if interlace:
        raise ValueError("interlaced PNG not supported")
    ch = CHANNELS[color]
    bpp = ch * depth // 8
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if data.size != h * (1 + w * bpp):
        raise ValueError(f"PNG data holds {data.size} bytes, expected "
                         f"{h * (1 + w * bpp)}")
    rows = _unfilter(data.reshape(h, 1 + w * bpp), bpp)
    img = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    return img.reshape((h, w) if ch == 1 else (h, w, ch))


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
