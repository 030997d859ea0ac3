"""ctypes bindings for the native asset kernels, with NumPy fallbacks."""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from softwarerenderer_tpu_torch.io_host import hostops
from softwarerenderer_tpu_torch.native.build import LIBRARY, build

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(LIBRARY):
        build()
    if not os.path.exists(LIBRARY):
        return None
    try:
        lib = ctypes.CDLL(LIBRARY)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i16p = ctypes.POINTER(ctypes.c_int16)
        lib.srt_accessor_to_f32.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int, f32p]
        lib.srt_accessor_to_f32.restype = ctypes.c_int
        lib.srt_bake_positions.argtypes = [f32p, ctypes.c_uint64, f32p]
        lib.srt_bake_normals.argtypes = [f32p, ctypes.c_uint64, f32p]
        lib.srt_scale_pcm16.argtypes = [i16p, ctypes.c_uint64,
                                        ctypes.c_float]
        lib.srt_bounding_sphere.argtypes = [f32p, ctypes.c_uint64, f32p]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def is_available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def accessor_to_f32(raw: bytes, count: int, ncomp: int, component_type: int,
                    stride: int, normalized: bool) -> Optional[np.ndarray]:
    """Strided/typed glTF accessor → contiguous (count, ncomp) float32.
    Returns None when the native library is unavailable (caller falls back
    to the NumPy path)."""
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(raw, dtype=np.uint8)
    dst = np.empty((count, ncomp), dtype=np.float32)
    rc = lib.srt_accessor_to_f32(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        count, ncomp, component_type, stride, int(normalized), _fptr(dst))
    return dst if rc == 0 else None


def bake_positions(pos: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """p' = p·M in place-sized copy; falls back to NumPy (hostops's
    form, equal to the library's on every value)."""
    lib = _load()
    pos = np.ascontiguousarray(pos, dtype=np.float32)
    m = np.ascontiguousarray(matrix, dtype=np.float32)
    if lib is None:
        return hostops.bake_positions(pos, m)
    out = pos.copy()
    lib.srt_bake_positions(_fptr(out), out.shape[0], _fptr(m))
    return out


def bake_normals(nrm: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    lib = _load()
    nrm = np.ascontiguousarray(nrm, dtype=np.float32)
    m = np.ascontiguousarray(matrix, dtype=np.float32)
    if lib is None:
        return hostops.bake_normals(nrm, m)
    out = nrm.copy()
    lib.srt_bake_normals(_fptr(out), out.shape[0], _fptr(m))
    return out


def scale_pcm16(samples: np.ndarray, volume: float) -> np.ndarray:
    """Software volume scaling of int16 PCM (Sounds.cs:24-38)."""
    lib = _load()
    s = np.ascontiguousarray(samples, dtype=np.int16).copy()
    if lib is None:
        v = np.clip(s.astype(np.float32) * volume, -32768, 32767)
        return v.astype(np.int16)
    lib.srt_scale_pcm16(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), s.size,
        ctypes.c_float(volume))
    return s


def bounding_sphere_native(pos: np.ndarray):
    """Native Ritter sphere; returns (center (3,), radius) or None."""
    lib = _load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.float32)
    out = np.empty(4, dtype=np.float32)
    lib.srt_bounding_sphere(_fptr(pos), pos.shape[0], _fptr(out))
    return out[:3].copy(), float(out[3])
