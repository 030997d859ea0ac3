"""Frustum culling: Gribb–Hartmann planes and one batched sphere test.

Counterpart of ``softwarerenderer_tpu/ops/culling.py``.  For the row-vector
viewProjection = view·projection, plane k comes from matrix COLUMNS,
normalised by its xyz magnitude; a sphere is visible when its signed
distance is > -radius against all six planes (FrustumCuller.cs:153-224).
"""

from __future__ import annotations

from typing import Dict

import torch

from softwarerenderer_tpu_torch.utils import mathlib as ml


def frustum_planes(view_projection: torch.Tensor) -> torch.Tensor:
    """(6, 4) normalised planes [normal_xyz, d]: near, far, left, right,
    top, bottom (the reference's extraction order)."""
    m = view_projection
    w = m[:, 3]
    raw = torch.stack([w + m[:, 2], w - m[:, 2], w + m[:, 0], w - m[:, 0],
                       w + m[:, 1], w - m[:, 1]])
    mag = torch.sqrt(raw[:, 0] ** 2 + raw[:, 1] ** 2 + raw[:, 2] ** 2)
    return raw / mag[:, None]


def spheres_in_frustum(centers: torch.Tensor, radii: torch.Tensor,
                       model_matrices: torch.Tensor,
                       view_projection: torch.Tensor) -> torch.Tensor:
    """(M,) bool: each mesh's bounding sphere against the six planes.  The
    world radius scales by the max row norm of the model's upper 3x3 (the
    reference's conservative max-scale)."""
    world_center = ml.transform_point(centers, model_matrices)      # (M, 3)
    row_norms = torch.sqrt((model_matrices[:, :3, :3] ** 2).sum(-1))
    world_radius = radii * row_norms.amax(-1)
    planes = frustum_planes(view_projection)                        # (6, 4)
    # n·c + d per (mesh, plane), written out instead of a matmul so no
    # backend rounds it through TF32.
    c = world_center[:, None, :]
    dist = ((c[..., 0] * planes[:, 0] + c[..., 1] * planes[:, 1])
            + c[..., 2] * planes[:, 2]) + planes[:, 3]
    return (dist > -world_radius[:, None]).all(-1)


def model_matrices_per_vertex(scene: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(V, 4, 4) model matrix per packed vertex: the per-mesh transform
    fanned out to vertices every frame, so mesh_matrices stay live."""
    return scene["mesh_matrices"].index_select(0, scene["vert_mesh_id"])
