"""The benchmark's input generators, frozen here so that the yardstick
does not move when the program's own scene helpers change.

Everything is host numpy, made from a seed: the UV sphere and its
vertex-clustering decimation (the LOD crowd's mesh), the crowd's grid
placement and the camera's yaw/pitch quaternion.  Each is a copy of the
formula the program's ``models.primitives``, ``ops.lod``, ``scenes`` and
``utils.mathlib`` used when the benchmark was written; a seed picks the
jitter.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

F32 = np.float32


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one input of one seed (any whole
    seed, also past 64 bits)."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1),
                                  int(seed) >> 64, stream])


def uv_sphere(radius=0.5, rings=12, sectors=24) -> Dict[str, np.ndarray]:
    """Latitude/longitude sphere: (rings + 1) x (sectors + 1) vertices,
    two triangles a quad (the poles' quads give zero-area triangles)."""
    rs = np.linspace(0.0, np.pi, rings + 1, dtype=F32)
    ss = np.linspace(0.0, 2.0 * np.pi, sectors + 1, dtype=F32)
    phi, theta = np.meshgrid(ss, rs)
    x = np.sin(theta) * np.cos(phi)
    y = np.cos(theta)
    z = np.sin(theta) * np.sin(phi)
    normals = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(F32)
    positions = normals * F32(radius)
    u = (phi / (2.0 * np.pi)).reshape(-1)
    v = (theta / np.pi).reshape(-1)
    uvs = np.stack([u, v], axis=-1).astype(F32)
    stride = sectors + 1
    r, s = np.meshgrid(np.arange(rings), np.arange(sectors), indexing="ij")
    i0 = (r * stride + s).reshape(-1)
    i1, i2 = i0 + 1, i0 + stride
    i3 = i2 + 1
    indices = np.stack([np.stack([i0, i1, i2], -1),
                        np.stack([i1, i3, i2], -1)], 1).reshape(-1, 3)
    return {"position": positions, "uv": uvs, "normal": normals,
            "color": np.ones((positions.shape[0], 4), dtype=F32),
            "indices": indices.astype(np.int32)}


def decimate_indices(positions: np.ndarray, indices: np.ndarray,
                     cells: int) -> np.ndarray:
    """Vertex-clustering decimation: vertices snapped to a cells^3 grid
    over the mesh's box, each cell collapsed to its first vertex in index
    order, degenerate triangles dropped; (T', 3) int32 over the same
    vertex buffer."""
    pos = np.asarray(positions, np.float64).reshape(-1, 3)
    idx = np.asarray(indices, np.int64).reshape(-1, 3)
    mn = pos.min(axis=0)
    ext = float((pos.max(axis=0) - mn).max())
    if ext <= 0:
        return idx.astype(np.int32)
    cell = np.clip((pos - mn) / ext * cells, 0, cells - 1e-9).astype(np.int64)
    cell_id = cell[:, 0] + cells * (cell[:, 1] + cells * cell[:, 2])
    order = np.argsort(cell_id, kind="stable")
    first_of_cell = order[np.searchsorted(cell_id[order], cell_id)]
    tri = first_of_cell[idx]
    keep = (tri[:, 0] != tri[:, 1]) & (tri[:, 1] != tri[:, 2]) \
        & (tri[:, 0] != tri[:, 2])
    return tri[keep].astype(np.int32)


def lod_sphere(radius: float, rings: int, sectors: int,
               cells: Sequence[int], px: Sequence[float]) -> Dict:
    """A UV sphere with decimated levels: level i + 1 is drawn when the
    projected radius falls below px[i] pixels."""
    mesh = uv_sphere(radius, rings, sectors)
    mesh["lod_indices"] = [decimate_indices(mesh["position"],
                                            mesh["indices"], c)
                           for c in cells]
    mesh["lod_px"] = [float(p) for p in px]
    return mesh


def crowd_offsets(seed: int, grid: int, pitch_x: float, pitch_z: float,
                  z0: float, jitter: float, y_jitter: float) -> np.ndarray:
    """(grid * grid, 3) float32 instance positions: a grid receding from
    the camera down -z, each cell jittered from the seed."""
    rng = rng_of(seed, 1)
    gz, gx = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    jit = rng.uniform(-1.0, 1.0, (grid * grid, 3))
    x = (gx.reshape(-1) - (grid - 1) / 2.0) * pitch_x + jit[:, 0] * jitter
    z = z0 - gz.reshape(-1) * pitch_z + jit[:, 1] * jitter
    y = jit[:, 2] * y_jitter
    return np.stack([x, y, z], -1).astype(F32)


def translation(t) -> np.ndarray:
    """Row-vector translation matrix (the offset in the last row)."""
    m = np.eye(4, dtype=F32)
    m[3, :3] = np.asarray(t, dtype=F32)
    return m


def quat_from_yaw_pitch(yaw: float, pitch: float) -> np.ndarray:
    """Quaternion (x, y, z, w) of a yaw about +y then a pitch about +x,
    roll 0, in float32 (Quaternion.CreateFromYawPitchRoll)."""
    hy, hp = F32(yaw) * F32(0.5), F32(pitch) * F32(0.5)
    sy, cy = np.sin(hy), np.cos(hy)
    sp, cp = np.sin(hp), np.cos(hp)
    sr, cr = F32(0.0), F32(1.0)
    return np.stack([cy * sp * cr + sy * cp * sr,
                     sy * cp * cr - cy * sp * sr,
                     cy * cp * sr - sy * sp * cr,
                     cy * cp * cr + sy * sp * sr]).astype(F32)

