"""Build the package's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes plain C entry points.  ``load(name)``
compiles it with ``nvcc`` for Hopper (``sm_90a``) into
``softwarerenderer_tpu_torch/_build/`` under a name that carries a hash of
the source and the flags, so an edited source rebuilds and an unchanged one
loads the library already built.  Nothing is written outside the package.

The flags keep float arithmetic IEEE: ``-fmad=false`` stops nvcc from
contracting a*b+c into one rounding, so the kernels round each operation
exactly as the plain PyTorch versions beside them do; no fast math, so
division and sqrt stay correctly rounded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict = {}
# name -> (seconds, compiler output) of each build this process ran
BUILD_LOG: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or under {home}/bin")
    return str(path)


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for this source exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG[name] = (time.perf_counter() - t0, proc.stderr + proc.stdout)
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
    return lib
