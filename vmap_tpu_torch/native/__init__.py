"""Native (C++) geometry core, loaded via ctypes.

Builds ``libvmapgeom.so`` on demand with g++ (no pybind/cmake needed) and
exposes drop-in replacements for the hot host-side geometry ops. Falls back
silently to the numpy implementations when no compiler is available.
``png_unfilter`` (``png.cpp``) reconstructs PNG rows for
``utils/png.py``, which reads every image through it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "libvmapgeom.so")
_SRCS = [os.path.join(_HERE, f) for f in ("marching_cubes.cpp", "png.cpp")]
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


def available() -> bool:
    return get_lib() is not None
