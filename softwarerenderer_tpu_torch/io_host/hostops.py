"""Numpy forms of helpers that the copied loaders call, so that
``io_host`` imports nothing of the JAX package:

  * ``bake_positions`` and ``bake_normals``: the ``native`` library's
    asset bakers (``native/srt_native.cpp``) in numpy, with the C++ code's
    float32 operations in its order, so a mesh baked without the library
    equals the one baked with it on every value; ``native``'s fallback
    when the library cannot be built;
  * ``compose_trs``: ``ops/skinning.compose_trs`` with ``xp=np``, the
    port's ``ops.skinning.compose_trs_np``.
"""

from __future__ import annotations

import numpy as np

from softwarerenderer_tpu_torch.ops.skinning import compose_trs_np


def bake_positions(pos: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """p' = (p, 1)·M for (n, 3) float32 points: x·M[0] + y·M[1] + z·M[2]
    + M[3], added left to right (srt_bake_positions)."""
    p = np.ascontiguousarray(pos, dtype=np.float32)
    m = np.ascontiguousarray(matrix, dtype=np.float32)
    x, y, z = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    return (((x * m[0, :3] + y * m[1, :3]) + z * m[2, :3])
            + m[3, :3]).astype(np.float32)


def bake_normals(nrm: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """n' = n·M[:3, :3], renormalised where its length is > 0
    (srt_bake_normals: the rotation part, not the inverse transpose)."""
    n = np.ascontiguousarray(nrm, dtype=np.float32)
    m = np.ascontiguousarray(matrix, dtype=np.float32)
    x, y, z = n[:, 0:1], n[:, 1:2], n[:, 2:3]
    out = (x * m[0, :3] + y * m[1, :3]) + z * m[2, :3]
    sq = (out[:, 0] * out[:, 0] + out[:, 1] * out[:, 1]) \
        + out[:, 2] * out[:, 2]
    ln = np.sqrt(sq)[:, None]
    return np.where(ln > 0, out / np.where(ln > 0, ln, np.float32(1)),
                    out).astype(np.float32)


def compose_trs(trans, rot, scl, xp=np) -> np.ndarray:
    """(..., 3) / (..., 4) / (..., 3) TRS -> (..., 4, 4) row-vector local
    matrices S·R·T; `xp` must be numpy, the only one the loaders pass."""
    if xp is not np:
        raise ValueError("the port's host compose_trs runs on numpy only")
    return compose_trs_np(np.asarray(trans), np.asarray(rot),
                          np.asarray(scl))
