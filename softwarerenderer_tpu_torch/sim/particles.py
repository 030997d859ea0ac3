"""Particle billboards: the render half of the particle system.

Counterpart of the rendering hooks of ``softwarerenderer_tpu/sim/
particles.py``.  A packed scene reserves 4·N vertices for an emitter of
N particle slots (``MeshInstance(particles_mesh(N), particles=N)``); each
frame ``apply_billboards`` writes camera-facing quad corners for the
particle uniforms ``particle_centers`` (P, 3), ``particle_size`` (P,) and
``particle_color`` (P, 4), P the scene's slots in instance order.  Dead
slots carry size 0 and alpha 0: zero-area quads the raster drops.

The particle step (emission, integration, the ring of slots) and its
uniforms stay in the JAX package: they draw through jax.random, whose
streams torch cannot reproduce.  A caller of the port feeds the uniforms
itself.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# Quad corner offsets, in (right, up) units of one particle size; order
# matches particles_mesh's uv/index layout.
_CORNERS = np.asarray([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]],
                      np.float32)


def particles_mesh(capacity: int, extent: float = 50.0) -> Dict:
    """Placeholder billboard mesh: 4·N vertices and 2·N triangles at the
    origin until apply_billboards writes a frame's corners.  The
    instance's model matrix stays identity (corners are in world space);
    `extent` is the culling radius the emitter must stay inside."""
    n = int(capacity)
    quad_uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    # A camera-facing quad is front-facing (area < 0 after the viewport's
    # Y flip) under BACK culling.
    tri = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    base = 4 * np.arange(n, dtype=np.int32)[:, None, None]
    return {
        "name": f"particles[{n}]",
        "position": np.zeros((4 * n, 3), np.float32),
        "uv": np.tile(quad_uv, (n, 1)),
        "normal": np.tile(np.asarray([[0, 0, 1]], np.float32), (4 * n, 1)),
        "color": np.ones((4 * n, 4), np.float32),
        "indices": (base + tri[None]).reshape(-1, 3),
        "bounds_center": np.zeros(3, np.float32),
        "bounds_radius": float(extent),
    }


def soft_disc_texture(res: int = 32, hardness: float = 2.0) -> np.ndarray:
    """Radial-falloff sprite: white with alpha (1 - r²)^hardness."""
    y, x = np.mgrid[0:res, 0:res]
    r2 = (((x + 0.5) / res - 0.5) ** 2
          + ((y + 0.5) / res - 0.5) ** 2) * 4.0
    a = np.clip(1.0 - r2, 0.0, 1.0) ** hardness
    tex = np.ones((res, res, 4), np.float32)
    tex[..., 3] = a
    return tex


def apply_billboards(vin: Dict, scene: Dict[str, torch.Tensor],
                     uniforms: Dict, view: torch.Tensor) -> Dict:
    """A copy of vin with the reserved slots' positions, normals and
    colors written: corners center + (cx·s)·right + (cy·s)·up, the normal
    toward the camera.  With the row-vector view V, right = V[:3, 0], up
    = V[:3, 1] and V[:3, 2] points from the scene to the camera."""
    dev = view.device
    idx = scene["particle_vert_index"].long()
    pidx = scene["particle_vert_pidx"].long()
    corner = scene["particle_corner"]
    centers, size, color = (
        torch.as_tensor(uniforms[k], dtype=torch.float32, device=dev)
        for k in ("particle_centers", "particle_size", "particle_color"))
    s = size[pidx][:, None]
    pos = centers[pidx] + (corner[:, 0:1] * s) * view[:3, 0] \
        + (corner[:, 1:2] * s) * view[:3, 1]
    out = dict(vin)
    out["position"] = vin["position"].index_put((idx,), pos)
    out["normal"] = vin["normal"].index_put((idx,),
                                            view[:3, 2].expand(pos.shape))
    out["color"] = vin["color"].index_put((idx,), color[pidx])
    return out
