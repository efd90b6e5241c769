"""Native (C++) geometry core, loaded via ctypes.

Builds ``libvmapgeom.so`` on demand with g++ (no pybind/cmake needed) and
exposes drop-in replacements for the hot host-side geometry ops. Falls back
silently to the numpy implementations when no compiler is available.
``png_unfilter`` (``png.cpp``) reconstructs PNG rows for
``utils/png.py``, which reads every image through it; the ``jpeg_*``
functions (``jpeg.cpp``) are the entropy coding, transforms and colour
loops of ``utils/jpeg.py``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libvmapgeom.so")
_SRCS = [os.path.join(_HERE, f)
         for f in ("marching_cubes.cpp", "png.cpp", "jpeg.cpp")]
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    """Compile to a name of this process's own in the same directory, then
    rename it onto ``libvmapgeom.so``: processes that build at the same
    time (test workers on a fresh tree) each load a complete file, never
    one that another compiler is still writing."""
    tmp = f"{_SO}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-o", tmp, *_SRCS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """The loaded native library, or None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or max(
                os.path.getmtime(s) for s in _SRCS) > os.path.getmtime(_SO):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.mt_marching_tetrahedra.restype = ctypes.c_int
        lib.mt_marching_tetrahedra.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mt_free.argtypes = [ctypes.c_void_p]
        lib.png_unfilter.restype = ctypes.c_int64
        lib.png_unfilter.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        i32, i64, vp = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
        lib.jpeg_decode_scan.restype = i64
        lib.jpeg_decode_scan.argtypes = [vp, i64, i64, i32, vp, vp, vp, i32,
                                         i32, i32, vp]
        lib.jpeg_idct_plane.restype = None
        lib.jpeg_idct_plane.argtypes = [vp, i32, i32, vp, vp]
        lib.jpeg_upsample.restype = None
        lib.jpeg_upsample.argtypes = [vp, i64, i32, i32, i32, i32, vp, i32,
                                      i32]
        lib.jpeg_ycc_rgb.restype = None
        lib.jpeg_ycc_rgb.argtypes = [vp, vp, vp, i64, vp]
        lib.jpeg_encode_420.restype = i64
        lib.jpeg_encode_420.argtypes = [vp, i32, i32, vp, vp, vp, vp, i64]
        _lib = lib
        return _lib


def marching_cubes_native(volume: np.ndarray, level: float = 0.5):
    """Native marching tetrahedra; returns (verts, faces) or (None, None)
    on an empty level set. Raises RuntimeError if the library is missing
    (callers should use geometry.marching_cubes which dispatches)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native geometry library unavailable")
    vol = np.ascontiguousarray(volume, np.float32)
    nx, ny, nz = vol.shape
    pv = ctypes.POINTER(ctypes.c_float)()
    pf = ctypes.POINTER(ctypes.c_int64)()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.mt_marching_tetrahedra(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nx, ny, nz, ctypes.c_float(level),
        ctypes.byref(pv), ctypes.byref(nv), ctypes.byref(pf), ctypes.byref(nf))
    if rc != 0:
        return None, None
    try:
        verts = np.ctypeslib.as_array(pv, shape=(nv.value, 3)).copy()
        faces = np.ctypeslib.as_array(pf, shape=(nf.value, 3)).copy()
    finally:
        lib.mt_free(pv)
        lib.mt_free(pf)
    return verts, faces


def png_unfilter(data: np.ndarray, bpp: int) -> np.ndarray:
    """PNG rows ``data`` uint8 [H, 1 + stride] (filter type first) ->
    the reconstructed bytes [H, stride]. Raises ValueError on a filter
    type outside 0-4, RuntimeError if the library is missing."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native geometry library unavailable")
    data = np.ascontiguousarray(data, np.uint8)
    h, stride = data.shape[0], data.shape[1] - 1
    if stride % bpp:
        raise ValueError(f"row of {stride} bytes is not whole {bpp}-byte "
                         "pixels")
    out = np.empty((h, stride), np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    bad = lib.png_unfilter(data.ctypes.data_as(u8), out.ctypes.data_as(u8),
                           h, stride, bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1}: filter type "
                         f"{int(data[bad - 1, 0])} is not 0-4")
    return out


def _jpeg_lib():
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native geometry library unavailable (the JPEG "
                           "codec needs g++ to build it)")
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def jpeg_decode_scan(data: np.ndarray, pos: int, comp: np.ndarray,
                     off: np.ndarray, huff: np.ndarray,
                     restart_interval: int, mcux: int, mcuy: int,
                     coef: np.ndarray) -> int:
    """One Huffman-coded scan from byte ``pos`` of the file ``data`` into
    the int16 coefficient planes ``coef`` (see ``jpeg.cpp``); returns the
    position of the marker after it. Raises ValueError on corrupt data."""
    lib = _jpeg_lib()
    comp = np.ascontiguousarray(comp, np.int32)
    off = np.ascontiguousarray(off, np.int64)
    huff = np.ascontiguousarray(huff, np.uint8)
    end = lib.jpeg_decode_scan(_ptr(data), data.size, pos, comp.shape[0],
                               _ptr(comp), _ptr(off), _ptr(huff),
                               restart_interval, mcux, mcuy, _ptr(coef))
    if end == -2:
        raise ValueError("JPEG: a Huffman table has more codes than fit")
    if end < 0:
        raise ValueError("JPEG: corrupt entropy-coded data")
    return int(end)


def jpeg_idct_plane(coef: np.ndarray, q_natural: np.ndarray) -> np.ndarray:
    """int16 [bh, bw, 64] coefficients -> uint8 [bh * 8, bw * 8] samples
    (libjpeg's islow IDCT with the quantisation table ``q_natural``)."""
    lib = _jpeg_lib()
    bh, bw = coef.shape[:2]
    q = np.ascontiguousarray(q_natural, np.uint16)
    out = np.empty((bh * 8, bw * 8), np.uint8)
    lib.jpeg_idct_plane(_ptr(coef), bw, bh, _ptr(q), _ptr(out))
    return out


def jpeg_upsample(plane: np.ndarray, dw: int, dh: int, hf: int, vf: int,
                  out_w: int, out_h: int) -> np.ndarray:
    """The dw x dh samples at the top left of ``plane`` upsampled by
    (hf, vf) in {(1, 1), (2, 1), (2, 2)} as libjpeg's fancy upsampler does,
    cut to [out_h, out_w]."""
    lib = _jpeg_lib()
    plane = np.ascontiguousarray(plane, np.uint8)
    out = np.empty((out_h, out_w), np.uint8)
    lib.jpeg_upsample(_ptr(plane), plane.shape[1], dw, dh, hf, vf, _ptr(out),
                      out_w, out_h)
    return out


def jpeg_ycc_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Three uint8 [H, W] planes -> uint8 [H, W, 3] RGB (libjpeg's tables)."""
    lib = _jpeg_lib()
    out = np.empty(y.shape + (3,), np.uint8)
    lib.jpeg_ycc_rgb(_ptr(y), _ptr(cb), _ptr(cr), y.size, _ptr(out))
    return out


def jpeg_encode_420(rgb: np.ndarray, q_luma: np.ndarray,
                    q_chroma: np.ndarray, huff: np.ndarray) -> bytes:
    """uint8 [H, W, 3] RGB -> the entropy-coded scan of a baseline 4:2:0
    JPEG (quantisation tables in natural order, Huffman tables luma DC,
    luma AC, chroma DC, chroma AC)."""
    lib = _jpeg_lib()
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    qy = np.ascontiguousarray(q_luma, np.uint16)
    qc = np.ascontiguousarray(q_chroma, np.uint16)
    huff = np.ascontiguousarray(huff, np.uint8)
    cap = 4 * rgb.size + 4096   # past any coding of 8-bit samples
    out = np.empty(cap, np.uint8)
    n = lib.jpeg_encode_420(_ptr(rgb), w, h, _ptr(qy), _ptr(qc), _ptr(huff),
                            _ptr(out), cap)
    if n < 0:
        raise RuntimeError("JPEG encoder: output buffer too small")
    return out[:n].tobytes()


def available() -> bool:
    return get_lib() is not None
