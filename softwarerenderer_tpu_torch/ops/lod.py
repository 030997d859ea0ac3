"""Mesh LOD: one index set a mesh per frame, chosen by its size on screen.

Counterpart of ``softwarerenderer_tpu/ops/lod.py``.  A mesh may carry
decimated index sets over its own vertex buffer; the packed scene holds
every level's triangles (``tri_lod_level``) and each mesh's pixel
thresholds (``mesh_lod_px``, -inf padded), and ``lod_tri_mask`` keeps,
each frame, the triangles of each mesh's active level: the number of its
thresholds above the projected radius of its bounding sphere.  The render
paths AND the mask into the frustum-cull mask.

The host helpers (numpy) build the levels and bound a frame's triangle
count: ``decimate_indices``, ``add_lods``, ``suggested_active_cap`` and
``suggested_geom_cap``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from softwarerenderer_tpu_torch.utils import mathlib as ml


def decimate_indices(positions: np.ndarray, indices: np.ndarray,
                     cells: int = 8) -> np.ndarray:
    """Vertex-clustering decimation: vertices snapped to a cells³ grid
    over the mesh's box, each cell collapsed to its first vertex in index
    order, degenerate triangles dropped.  A (T', 3) index set over the
    same vertex buffer."""
    pos = np.asarray(positions, np.float64).reshape(-1, 3)
    idx = np.asarray(indices, np.int64).reshape(-1, 3)
    mn = pos.min(axis=0)
    ext = float((pos.max(axis=0) - mn).max())
    if ext <= 0:
        return np.asarray(indices, np.int32).reshape(-1, 3)
    cell = np.clip((pos - mn) / ext * cells, 0, cells - 1e-9).astype(
        np.int64)
    cell_id = cell[:, 0] + cells * (cell[:, 1] + cells * cell[:, 2])
    order = np.argsort(cell_id, kind="stable")
    sorted_ids = cell_id[order]
    first_of_cell = order[np.searchsorted(sorted_ids, cell_id)]
    tri = first_of_cell[idx]
    keep = (tri[:, 0] != tri[:, 1]) & (tri[:, 1] != tri[:, 2]) \
        & (tri[:, 0] != tri[:, 2])
    return tri[keep].astype(np.int32)


def add_lods(mesh: Dict, cells: Sequence[int] = (6, 3),
             px: Sequence[float] = (60.0, 24.0)) -> Dict:
    """A copy of mesh with decimated levels: level i+1 is active when the
    projected radius falls below px[i] pixels (px strictly descending);
    level 0 is the mesh as authored."""
    if len(cells) != len(px):
        raise ValueError("cells and px must have equal length")
    if any(px[i] <= px[i + 1] for i in range(len(px) - 1)):
        raise ValueError("px thresholds must be strictly descending")
    out = dict(mesh)
    out["lod_indices"] = [decimate_indices(mesh["position"],
                                           mesh["indices"], c)
                          for c in cells]
    out["lod_px"] = [float(p) for p in px]
    return out


def suggested_active_cap(scene: Dict) -> int:
    """A bound on a frame's valid clip-fan slots: one level a mesh, so
    2 · Σ_m max_l tris(m, l) (every slot without LOD)."""
    mesh_id = np.asarray(scene["tri_mesh_id"])
    if "tri_lod_level" not in scene:
        return int(2 * mesh_id.shape[0])
    lvl = np.asarray(scene["tri_lod_level"])
    m = int(mesh_id.max()) + 1 if mesh_id.size else 0
    nl = int(lvl.max()) + 1 if lvl.size else 1
    counts = np.bincount(mesh_id.astype(np.int64) * nl + lvl,
                         minlength=m * nl).reshape(m, nl)
    return int(2 * counts.max(axis=1).sum())


def suggested_geom_cap(scene: Dict) -> int:
    """suggested_active_cap in input triangles (before the clip fan)."""
    return suggested_active_cap(scene) // 2


def lod_tri_mask(scene: Dict[str, torch.Tensor], uniforms: Dict,
                 height: int) -> torch.Tensor:
    """(T,) bool: the triangles of each mesh's active level.  The
    projected radius is the world bounding sphere's (radius scaled by the
    model's largest row norm) over its distance from the camera (at least
    near_clip), times height / 2 / tan(fov / 2).  uniforms hold device
    tensors camera_position, near_clip and tan_half_fov
    (engine.device_uniforms); every sum runs left to right and every root
    is correctly rounded (ml.sqrt_rn), so the card's levels are the
    CPU's."""
    mm = scene["mesh_matrices"]
    wc = ml.transform_point(scene["bounds_center"], mm)
    rows = mm[:, :3, :3]
    wr = scene["bounds_radius"] * ml.sqrt_rn(ml.dot(rows, rows)).amax(-1)
    off = wc - uniforms["camera_position"]
    dist = ml.sqrt_rn(ml.dot(off, off).clamp(min=1e-12))
    dist = torch.maximum(dist, uniforms["near_clip"])
    px_r = wr / dist * float(np.float32(height * 0.5)) \
        / uniforms["tan_half_fov"]
    level = (px_r[:, None] < scene["mesh_lod_px"]).sum(1)
    return level[scene["tri_mesh_id"].long()] == scene["tri_lod_level"]
