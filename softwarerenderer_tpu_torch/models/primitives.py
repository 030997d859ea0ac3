"""Procedural mesh generators for tests, demos and benchmarks.

Copied from softwarerenderer_tpu/models/primitives.py (numpy only) so that
the port imports nothing of the JAX package; keep the two equal."""

from __future__ import annotations

import numpy as np

F32 = np.float32


def cube(size=1.0):
    """Axis-aligned cube centered at origin with per-face normals/UVs.

    Winding is counter-clockwise viewed from outside, chosen so faces are
    front-facing under the reference's reversed-order raster convention
    (front = signed area < 0 after the {v2,v1,v0} flip, Rasterizer.cs:367,414)
    with the .NET row-vector view/projection chain.
    """
    s = F32(size) / F32(2.0)
    # positions per face (4 corners), normal, then two triangles 0-1-2, 0-2-3
    faces = [
        # +Z
        ([[-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s]], [0, 0, 1]),
        # -Z
        ([[s, -s, -s], [-s, -s, -s], [-s, s, -s], [s, s, -s]], [0, 0, -1]),
        # +X
        ([[s, -s, s], [s, -s, -s], [s, s, -s], [s, s, s]], [1, 0, 0]),
        # -X
        ([[-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s]], [-1, 0, 0]),
        # +Y
        ([[-s, s, s], [s, s, s], [s, s, -s], [-s, s, -s]], [0, 1, 0]),
        # -Y
        ([[-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s]], [0, -1, 0]),
    ]
    uvs_face = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], dtype=F32)
    positions, normals, uvs, indices = [], [], [], []
    for fi, (corners, normal) in enumerate(faces):
        base = 4 * fi
        positions.extend(corners)
        normals.extend([normal] * 4)
        uvs.extend(uvs_face)
        indices.extend([[base, base + 1, base + 2], [base, base + 2, base + 3]])
    return {
        "position": np.asarray(positions, dtype=F32),
        "uv": np.asarray(uvs, dtype=F32),
        "normal": np.asarray(normals, dtype=F32),
        "color": np.ones((24, 4), dtype=F32),
        "indices": np.asarray(indices, dtype=np.int32),
    }


def plane(size=10.0, y=0.0):
    """A ground quad in the XZ plane facing +Y."""
    s = F32(size) / F32(2.0)
    positions = np.array(
        [[-s, y, -s], [s, y, -s], [s, y, s], [-s, y, s]], dtype=F32)
    return {
        "position": positions,
        "uv": np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=F32),
        "normal": np.tile(np.array([[0, 1, 0]], dtype=F32), (4, 1)),
        "color": np.ones((4, 4), dtype=F32),
        "indices": np.array([[0, 2, 1], [0, 3, 2]], dtype=np.int32),
    }


def uv_sphere(radius=0.5, rings=12, sectors=24):
    """Latitude/longitude sphere."""
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
    indices = []
    stride = sectors + 1
    for r in range(rings):
        for s_ in range(sectors):
            i0 = r * stride + s_
            i1 = i0 + 1
            i2 = i0 + stride
            i3 = i2 + 1
            indices.append([i0, i1, i2])
            indices.append([i1, i3, i2])
    return {
        "position": positions,
        "uv": uvs,
        "normal": normals,
        "color": np.ones((positions.shape[0], 4), dtype=F32),
        "indices": np.asarray(indices, dtype=np.int32),
    }


def random_triangle_soup(n_triangles, seed=0, extent=2.0, z_range=(-6.0, -2.0)):
    """Random colored triangles in front of the default camera — the
    stress-test scene for golden-image parity."""
    rng = np.random.default_rng(seed)
    centers = np.stack([
        rng.uniform(-extent, extent, n_triangles),
        rng.uniform(-extent, extent, n_triangles),
        rng.uniform(z_range[0], z_range[1], n_triangles),
    ], axis=-1)
    offsets = rng.uniform(-0.8, 0.8, (n_triangles, 3, 3))
    positions = (centers[:, None, :] + offsets).reshape(-1, 3).astype(F32)
    colors = rng.uniform(0.0, 1.0, (n_triangles, 1, 4)).astype(F32)
    colors = np.broadcast_to(colors, (n_triangles, 3, 4)).reshape(-1, 4).copy()
    colors[:, 3] = 1.0
    e1 = positions.reshape(-1, 3, 3)[:, 1] - positions.reshape(-1, 3, 3)[:, 0]
    e2 = positions.reshape(-1, 3, 3)[:, 2] - positions.reshape(-1, 3, 3)[:, 0]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    normals = np.repeat(n, 3, axis=0).astype(F32)
    uvs = np.tile(np.array([[0, 0], [1, 0], [0, 1]], dtype=F32), (n_triangles, 1))
    indices = np.arange(n_triangles * 3, dtype=np.int32).reshape(-1, 3)
    return {
        "position": positions,
        "uv": uvs,
        "normal": normals,
        "color": colors,
        "indices": indices,
    }
