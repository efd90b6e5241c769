"""Build and load the CUDA kernels of this package.

``load()`` compiles every ``kernels/csrc/*.cu`` with ``nvcc`` for sm_90a
(one ``nvcc`` per source, all started together) and links them into one
shared library with a plain C interface, at first use, and loads it with
``ctypes``. The build lands in ``kernels/_build/<hash>/`` (listed in
``.gitignore``), keyed by a hash of the sources and flags, so a second call
or process reuses it. Nothing is compiled when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
# No --use_fast_math: the kernels rely on accurate sinpif / cospif / expf.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libvmap_kernels.so"

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C signatures of kernels/csrc/train_step.cu, train_step_q8.cu and
# ensemble.cu
SIGNATURES = {
    "vmap_train_grad": ((I, I, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I,
                         I, I, I, I, I, I, F, F, P), I),
    "vmap_train_grad_q8": ((I, I) + (P,) * 13 + (I,) * 10 + (F, F, P), I),
    "vmap_train_quant_w": ((P, P, P, P, P, I, I, I, P), I),
    "vmap_train_adamw": ((P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, F,
                          P), I),
    "vmap_field_fwd": ((I, P, P, I, P, P, I, I, P, P, P), I),
    "vmap_field_bwd": ((I, P, P, I, P, P, P, P, I, I, I, P, P), I),
    "vmap_field_bwd_subtile": ((I,), I),
    "vmap_cuda_error_string": ((I,), ctypes.c_char_p),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, str]:
    """Compile the sources if needed. Returns (library path, compiler log;
    empty when the cached build was reused)."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()

    def run(cmds) -> list[str]:
        """Run the commands together, wait for all; raise if one failed."""
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        return logs

    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        logs = run([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                    for src, obj in zip(sources(), objs)])
        so = os.path.join(tmp, LIB_NAME)
        logs += run([[nvcc, "-shared", "-o", so, *objs]])
        os.replace(so, lib)
    return lib, "".join(logs)


@lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build (once) and load the kernel library with typed signatures."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.vmap_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
