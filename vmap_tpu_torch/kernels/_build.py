"""Build and load the CUDA kernel libraries of this package.

A ``Library`` names a source directory, a build root, a library name and
the C signatures of its entry points. ``Library.load()`` compiles every
``<csrc>/*.cu`` with ``nvcc`` for sm_90a (one ``nvcc`` per source, all
started together) and links them into one shared library with a plain C
interface, at first use, and loads it with ``ctypes``. The build lands in
``<build root>/<hash>/`` (listed in ``.gitignore``), keyed by a hash of the
sources and flags, so a second call or process reuses it; ``defines``
(preprocessor macros, as ``K1_PROFILE`` for ``chip_smoke.py --sections``)
give a build of their own. Nothing is compiled when the package is
imported.

Two libraries: ``KERNELS`` (``kernels/csrc``, the system's kernels K1-K3,
``libvmap_kernels.so``; the module-level ``build`` / ``load`` / ``check``
are its) and ``vmap_tpu_torch.probes.LIBRARY`` (the probe kernels).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path

# No --use_fast_math: the kernels rely on accurate sinpif / cospif / expf.
# ptxas's --split-compile 0 assembles a source's kernels on every core, so
# the longest source (train_step.cu, 18 instances) no longer runs on one
# core while the others idle. nvcc's own --split-compile, which splits the
# optimiser's module, changes the kernels' code; ``python -m
# vmap_tpu_torch.probes.sass --versus-unsplit`` compares a library built
# with NVCC_FLAGS and with BASE_FLAGS kernel by kernel.
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_FLAGS = BASE_FLAGS + ("-Xptxas", "--split-compile=0")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C signatures of kernels/csrc/train_step.cu, train_step_q8.cu and
# ensemble.cu
SIGNATURES = {
    "vmap_train_grad": ((I, I) + (P,) * 12 + (I,) * 10 + (F, F, P), I),
    "vmap_train_grad_q8": ((I, I) + (P,) * 15 + (I,) * 10 + (F, F, P), I),
    "vmap_train_quant_w": ((P, P, P, P, P, I, I, I, P), I),
    "vmap_train_adamw": ((P,) * 11 + (I,) * 6 + (F, F, P), I),
    "vmap_update_plan": ((I, I, I, P), I),
    "vmap_staged_size": ((I,), I),
    "vmap_q8_smem": ((I, I, I, I), I),
    "vmap_field_stage": ((I, P, P, I, I, P, P), I),
    "vmap_field_plan": ((I, I, I, I, P), I),
    "vmap_field_fwd": ((I, P, P, I, P, P, P, I, I, P, P, P), I),
    "vmap_field_bwd": ((I, P, P, I, P, P, P, P, P, I, I, I, P, P, P), I),
    "vmap_field_wgrad": ((I, P, I, I, I, P, P), I),
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


@dataclass(frozen=True, eq=False)
class Library:
    """One shared library: ``csrc/*.cu`` (and the ``*.cuh`` they include,
    there and in ``headers``) built into ``build_root/<hash>/name``, its
    entry points typed by ``signatures`` ({name: (argtypes, restype)}),
    plus the error-string entry every library of this package exports,
    ``vmap_cuda_error_string`` (int -> const char*)."""

    csrc: Path
    build_root: Path
    name: str
    signatures: dict
    headers: tuple = ()   # headers of other directories the sources include

    def sources(self) -> list[Path]:
        return sorted(self.csrc.glob("*.cu"))

    def source_hash(self, defines: tuple = (),
                    flags: tuple = NVCC_FLAGS) -> str:
        h = hashlib.sha256(" ".join(flags + _macros(defines)).encode())
        for src in (self.sources() + sorted(self.csrc.glob("*.cuh"))
                    + list(self.headers)):
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return h.hexdigest()[:16]

    def build(self, defines: tuple = (),
              flags: tuple = NVCC_FLAGS) -> tuple[Path, str]:
        """Compile the sources (with ``-D`` each of ``defines``, nvcc's
        ``flags``) if needed. Returns (library path, compiler log; empty
        when the cached build was reused)."""
        out_dir = self.build_root / self.source_hash(defines, flags)
        lib = out_dir / self.name
        if lib.exists():
            return lib, ""
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()

        def run(cmds) -> list[str]:
            """Run the commands together, wait for all; raise if one
            failed."""
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for cmd in cmds]
            logs = [proc.communicate()[0] for proc in procs]
            for cmd, proc, log in zip(cmds, procs, logs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                       f"{' '.join(cmd)}\n{log}")
            return logs

        srcs = self.sources()
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            objs = [os.path.join(tmp, src.stem + ".o") for src in srcs]
            logs = run([[nvcc, *flags, *_macros(defines), "-c",
                         str(src), "-o", obj]
                        for src, obj in zip(srcs, objs)])
            so = os.path.join(tmp, self.name)
            logs += run([[nvcc, "-shared", "-o", so, *objs]])
            os.replace(so, lib)
        return lib, "".join(logs)

    def load(self, defines: tuple = ()) -> ctypes.CDLL:
        """Build (once) and load the library with typed signatures."""
        key = (self.name, tuple(defines))
        if key not in _LOADED:
            path, _ = self.build(defines)
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            err = lib.vmap_cuda_error_string
            err.argtypes, err.restype = [I], ctypes.c_char_p
            _LOADED[key] = lib
        return _LOADED[key]

    def check(self, code: int, what: str) -> None:
        """Raise if one of this library's launchers returned a CUDA error
        code."""
        check(self.load(), code, what)


_LOADED: dict[tuple, ctypes.CDLL] = {}


def _macros(defines: tuple) -> tuple:
    return tuple(f"-D{d}" for d in defines)

KERNELS = Library(Path(__file__).resolve().parent / "csrc",
                  Path(__file__).resolve().parent / "_build",
                  "libvmap_kernels.so", SIGNATURES)
build, load = KERNELS.build, KERNELS.load


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher of the loaded library ``lib`` returned a CUDA
    error code."""
    if code != 0:
        msg = lib.vmap_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")
