"""JPEG files without OpenCV: the ScanNet layout's colour images.

Reads baseline and extended sequential Huffman-coded 8-bit JPEGs (greyscale
or YCbCr at 4:4:4, 4:2:2 or 4:2:0, restart markers, any number of scans)
to uint8 [H, W, 3] RGB, a greyscale file expanded to three channels, as
OpenCV's ``imread`` with ``IMREAD_COLOR`` gives them, but in RGB order.
Writes RGB as OpenCV's ``imwrite`` does by default: quality 95, 4:2:0, the
standard Huffman tables, no restarts, a JFIF APP0 marker. The markers are
parsed and written here; the entropy coding, the DCTs, the resampling and
the colour conversion run in the port's native library (``native/jpeg.cpp``,
built with g++ at first use), in libjpeg's integer arithmetic, so that
both directions agree with libjpeg-turbo (OpenCV's codec) bit for bit.
Progressive, arithmetic-coded, lossless, hierarchical and 12-bit files, and
CMYK, are refused with a ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

from vmap_tpu_torch import native

# zigzag index -> natural (row-major) index in an 8x8 block
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# the JPEG standard's example tables (Annex K), in zigzag order
STD_LUMA_Q = [
    16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40,
    26, 24, 22, 22, 24, 49, 35, 37, 29, 40, 58, 51, 61, 60, 57, 51,
    56, 55, 64, 72, 92, 78, 64, 68, 87, 69, 55, 56, 80, 109, 81, 87,
    95, 98, 103, 104, 103, 62, 77, 113, 121, 112, 100, 120, 92, 101, 103, 99]
STD_CHROMA_Q = [17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56, 66] + \
    [99] * 50

_AC_LUMA_VALS = bytes([
    1, 2, 3, 0, 4, 17, 5, 18, 33, 49, 65, 6, 19, 81, 97, 7, 34, 113, 20, 50,
    129, 145, 161, 8, 35, 66, 177, 193, 21, 82, 209, 240, 36, 51, 98, 114,
    130, 9, 10, 22, 23, 24, 25, 26, 37, 38, 39, 40, 41, 42, 52, 53, 54, 55,
    56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83, 84, 85, 86, 87, 88, 89,
    90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116, 117, 118, 119, 120,
    121, 122, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149,
    150, 151, 152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169, 170,
    178, 179, 180, 181, 182, 183, 184, 185, 186, 194, 195, 196, 197, 198,
    199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217, 218, 225,
    226, 227, 228, 229, 230, 231, 232, 233, 234, 241, 242, 243, 244, 245,
    246, 247, 248, 249, 250])
_AC_CHROMA_VALS = bytes([
    0, 1, 2, 3, 17, 4, 5, 33, 49, 6, 18, 65, 81, 7, 97, 113, 19, 34, 50, 129,
    8, 20, 66, 145, 161, 177, 193, 9, 35, 51, 82, 240, 21, 98, 114, 209, 10,
    22, 36, 52, 225, 37, 241, 23, 24, 25, 26, 38, 39, 40, 41, 42, 53, 54, 55,
    56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83, 84, 85, 86, 87, 88, 89,
    90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116, 117, 118, 119, 120,
    121, 122, 130, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148,
    149, 150, 151, 152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169,
    170, 178, 179, 180, 181, 182, 183, 184, 185, 186, 194, 195, 196, 197,
    198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217, 218,
    226, 227, 228, 229, 230, 231, 232, 233, 234, 242, 243, 244, 245, 246,
    247, 248, 249, 250])
# the standard Huffman tables: (class << 4 | id, 16 code counts, values)
STD_HUFFMAN = (
    (0x00, bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]),
     bytes(range(12))),
    (0x10, bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125]),
     _AC_LUMA_VALS),
    (0x01, bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]),
     bytes(range(12))),
    (0x11, bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119]),
     _AC_CHROMA_VALS),
)

SOF_REFUSED = {
    0xC2: "progressive", 0xC6: "progressive", 0xCA: "progressive",
    0xCE: "progressive", 0xC3: "lossless", 0xC7: "lossless",
    0xCB: "lossless", 0xCF: "lossless", 0xC5: "hierarchical",
    0xC9: "arithmetic-coded", 0xCD: "arithmetic-coded",
}


def _table_slot(bits: bytes, vals: bytes) -> np.ndarray:
    slot = np.zeros(272, np.uint8)
    slot[:16] = np.frombuffer(bits, np.uint8)
    slot[16:16 + len(vals)] = np.frombuffer(vals, np.uint8)
    return slot


def _q95(base: list[int]) -> np.ndarray:
    """libjpeg's jpeg_set_quality(95, force_baseline=TRUE) of a standard
    table: scale 200 - 2 * 95 = 10 percent, rounded, clipped to 1-255."""
    q = (np.asarray(base, np.int64) * 10 + 50) // 100
    return np.clip(q, 1, 255).astype(np.uint16)


# the tables OpenCV's imwrite writes by default (quality 95), zigzag order
Q95_LUMA, Q95_CHROMA = _q95(STD_LUMA_Q), _q95(STD_CHROMA_Q)


def _natural(zigzag: np.ndarray) -> np.ndarray:
    nat = np.empty(64, np.uint16)
    nat[NATURAL] = zigzag
    return nat


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] RGB -> the bytes of a baseline 4:2:0 JPEG at
    quality 95, those OpenCV's ``imwrite`` writes without parameters."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_jpeg takes uint8 [H, W, 3] RGB; got "
                         f"{rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"JPEG sizes are 1-65535; got {w}x{h}")
    qy, qc = Q95_LUMA, Q95_CHROMA
    huff = np.stack([_table_slot(bits, vals)
                     for _, bits, vals in STD_HUFFMAN])
    scan = native.jpeg_encode_420(rgb, _natural(qy), _natural(qc), huff)
    parts = [b"\xff\xd8",
             _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
             _segment(0xDB, b"\x00" + qy.astype(np.uint8).tobytes()),
             _segment(0xDB, b"\x01" + qc.astype(np.uint8).tobytes()),
             _segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                      + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))]
    parts += [_segment(0xC4, bytes([tc]) + bits + vals)
              for tc, bits, vals in STD_HUFFMAN]
    parts += [_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])),
              scan, b"\xff\xd9"]
    return b"".join(parts)


def write_jpeg(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_jpeg(rgb))


class _Frame:
    def __init__(self, body: bytes):
        if len(body) < 6:
            raise ValueError("JPEG: a truncated SOF segment")
        prec, self.h, self.w, nc = struct.unpack(">BHHB", body[:6])
        if prec != 8:
            raise ValueError(f"JPEG: {prec}-bit samples are not supported "
                             "(8-bit only)")
        if self.h == 0:
            raise ValueError("JPEG: a height defined by a DNL marker is not "
                             "supported")
        if nc not in (1, 3):
            raise ValueError(f"JPEG: {nc} components are not supported "
                             "(greyscale or YCbCr / RGB only)")
        if self.w == 0 or len(body) < 6 + 3 * nc:
            raise ValueError("JPEG: a truncated SOF segment or a width of 0")
        self.ids, self.hs, self.vs, self.tq = [], [], [], []
        for i in range(nc):
            cid, hv, tq = body[6 + 3 * i: 9 + 3 * i]
            if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                raise ValueError(f"JPEG: sampling factors {hv >> 4}x"
                                 f"{hv & 15} are not 1-4")
            if cid in self.ids:
                raise ValueError(f"JPEG: component {cid} is defined twice")
            self.ids.append(cid)
            self.hs.append(hv >> 4)
            self.vs.append(hv & 15)
            self.tq.append(tq)
        self.hmax, self.vmax = max(self.hs), max(self.vs)
        self.mcux = -(-self.w // (8 * self.hmax))
        self.mcuy = -(-self.h // (8 * self.vmax))
        # each component's blocks, padded to whole MCUs
        self.bw = [self.mcux * hh for hh in self.hs]
        self.bh = [self.mcuy * vv for vv in self.vs]
        sizes = [bw * bh for bw, bh in zip(self.bw, self.bh)]
        self.off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(
            np.int64)
        self.coef = np.zeros((sum(sizes), 64), np.int16)
        self.q = [None] * nc    # each component's table, latched at its scan

    def plane(self, c: int) -> np.ndarray:
        o = int(self.off[c])
        return self.coef[o:o + self.bw[c] * self.bh[c]].reshape(
            self.bh[c], self.bw[c], 64)


def decode_jpeg(buf: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3] RGB."""
    data = np.frombuffer(buf, np.uint8)
    if data.size < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise ValueError("not a JPEG file (no SOI marker)")
    qt = {}
    huff = np.zeros((8, 272), np.uint8)
    restart = 0
    frame = None
    jfif = False
    adobe = None
    pos = 2
    while True:
        while pos < data.size and data[pos] != 0xFF:   # stray bytes
            pos += 1
        while pos < data.size and data[pos] == 0xFF:   # fill bytes
            pos += 1
        if pos >= data.size:
            raise ValueError("JPEG: ends before its EOI marker")
        marker = int(data[pos])
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > data.size:
            raise ValueError("JPEG: ends inside a marker segment")
        (length,) = struct.unpack(">H", buf[pos:pos + 2])
        if length < 2 or pos + length > data.size:
            raise ValueError(f"JPEG: segment 0x{marker:02X} runs past the "
                             "end of the file")
        body = buf[pos + 2:pos + length]
        pos += length
        if marker in SOF_REFUSED:
            raise ValueError(f"JPEG: {SOF_REFUSED[marker]} files are not "
                             "supported (baseline / extended sequential "
                             "Huffman only)")
        if marker in (0xC0, 0xC1):
            frame = _Frame(body)
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc = body[i]
                bits = body[i + 1:i + 17]
                n = sum(bits)
                if tc >> 4 > 1 or tc & 15 > 3 or len(bits) < 16 or \
                        n > 256 or i + 17 + n > len(body):
                    raise ValueError("JPEG: a corrupt Huffman table")
                slot = 4 * (tc >> 4) + (tc & 15)
                huff[slot] = _table_slot(bits, body[i + 17:i + 17 + n])
                i += 17 + n
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq > 1 or tq > 3 or i + (129 if pq else 65) > len(body):
                    raise ValueError("JPEG: a corrupt quantisation table")
                if pq:
                    vals = np.frombuffer(body[i + 1:i + 129], ">u2")
                    i += 129
                else:
                    vals = np.frombuffer(body[i + 1:i + 65], np.uint8)
                    i += 65
                qt[tq] = _natural(vals.astype(np.uint16))
        elif marker == 0xDD:
            if len(body) < 2:
                raise ValueError("JPEG: a truncated DRI segment")
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG: SOS before SOF")
            # every index the native decoder takes from the file is
            # checked here: the tables it selects (0-3 each), the
            # components it fills (each of the frame's, once)
            ns = body[0] if body else 0
            if not 1 <= ns <= len(frame.ids) or len(body) < 1 + 2 * ns:
                raise ValueError(f"JPEG: a scan of {ns} components in a "
                                 f"frame of {len(frame.ids)}")
            comps = []
            for k in range(ns):
                cid, tbl = body[1 + 2 * k], body[2 + 2 * k]
                if cid not in frame.ids:
                    raise ValueError(f"JPEG: a scan names component {cid}, "
                                     "which the frame does not define")
                c = frame.ids.index(cid)
                if any(c == c0 for c0, _, _ in comps):
                    raise ValueError(f"JPEG: a scan names component {cid} "
                                     "twice")
                if tbl >> 4 > 3 or tbl & 15 > 3:
                    raise ValueError(f"JPEG: Huffman table selectors "
                                     f"{tbl >> 4} / {tbl & 15} are not 0-3")
                if frame.q[c] is None:
                    if frame.tq[c] not in qt:
                        raise ValueError("JPEG: a quantisation table is "
                                         "missing")
                    frame.q[c] = qt[frame.tq[c]]
                comps.append((c, tbl >> 4, tbl & 15))
            if ns == 1:   # non-interleaved: an MCU is one block
                c = comps[0][0]
                mcux = -(-(-(-frame.w * frame.hs[c] // frame.hmax)) // 8)
                mcuy = -(-(-(-frame.h * frame.vs[c] // frame.vmax)) // 8)
                shape = [(1, 1)]
            else:
                mcux, mcuy = frame.mcux, frame.mcuy
                shape = [(frame.hs[c], frame.vs[c]) for c, _, _ in comps]
            comp = np.array([[hh, vv, td, ta, frame.bw[c], frame.bh[c]]
                             for (c, td, ta), (hh, vv) in zip(comps, shape)],
                            np.int32)
            off = frame.off[[c for c, _, _ in comps]]
            pos = native.jpeg_decode_scan(data, pos, comp, off, huff, restart,
                                          mcux, mcuy, frame.coef)
    if frame is None:
        raise ValueError("JPEG: no frame")
    planes = []
    for c in range(len(frame.ids)):
        if frame.q[c] is None:
            raise ValueError("JPEG: a component has no scan")
        hf = frame.hmax // frame.hs[c]
        vf = frame.vmax // frame.vs[c]
        if (hf, vf) not in ((1, 1), (2, 1), (2, 2)) or \
                frame.hmax % frame.hs[c] or frame.vmax % frame.vs[c]:
            raise ValueError(
                f"JPEG: component sampling {frame.hs[c]}x{frame.vs[c]} of "
                f"{frame.hmax}x{frame.vmax} is not supported (4:4:4, 4:2:2 "
                "or 4:2:0)")
        samples = native.jpeg_idct_plane(frame.plane(c), frame.q[c])
        dw = -(-frame.w * frame.hs[c] // frame.hmax)
        dh = -(-frame.h * frame.vs[c] // frame.vmax)
        planes.append(native.jpeg_upsample(samples, dw, dh, hf, vf, frame.w,
                                           frame.h))
    if len(planes) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    # libjpeg's default_decompress_parms: which 3-component files are RGB
    rgb = (adobe == 0 if adobe is not None and not jfif
           else (not jfif and frame.ids == [82, 71, 66]))
    if rgb:
        return np.stack(planes, axis=-1)
    return native.jpeg_ycc_rgb(*planes)


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read())
