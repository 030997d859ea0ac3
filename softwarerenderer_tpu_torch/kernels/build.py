"""Build the package's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes plain C entry points and may include the
shared headers ``csrc/*.cuh``.  ``load(name)`` compiles it with ``nvcc`` for
Hopper (``sm_90a``) into ``softwarerenderer_tpu_torch/_build/`` under a name
that carries a hash of the source, every header and the flags, so an edited
source or header rebuilds and an unchanged one loads the library already
built.  ``build_all(names)`` starts one ``nvcc`` per source at once and
waits for all of them.  Nothing is written outside the package.

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
from typing import Dict, Iterable

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
    """Where csrc/<name>.cu's library goes: the name carries a hash of the
    source, of every shared header and of the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every csrc/<name>.cu whose library does not exist yet, one
    nvcc process per source, all started together."""
    out = {name: library_path(name) for name in names}
    todo = {name: path for name, path in out.items() if not path.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name}.cu:\n{stderr}")
            continue
        os.replace(tmp, todo[name])
        BUILD_LOG[name] = (time.perf_counter() - t0, stderr + stdout)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for this source exists."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
    return lib
