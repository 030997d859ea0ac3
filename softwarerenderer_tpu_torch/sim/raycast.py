"""Batched raycast physics: Möller–Trumbore over all triangles at once.

Counterpart of ``softwarerenderer_tpu/sim/raycast.py`` (Physics.cs:136-179
semantics): epsilon 1e-8; IgnoreBackfaces rejects det < ε,
IgnoreFrontfaces rejects det > -ε, then |det| < ε rejects; u ∈ [0, 1],
v ≥ 0, u + v ≤ 1, t ≥ 0; the hit normal interpolates the smooth vertex
normals at the barycentrics; the nearest hit wins and ties go to the
LOWEST triangle index.

``raycast_batch`` is the game's physics query, the brute route of the
ray-traced frame and the fallback of the bundle casts.  It runs R rays ×
T triangles in chunks of rays, so that no (rays, triangles) temporary
holds more than ``MAX_BLOCK`` elements on the card, ``CPU_BLOCK`` on the
CPU (a (chunk, T, 3) vector temporary three times that).  A ray's hit
does not depend on its chunk.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = torch.float32
EPSILON = 1e-8
BIG = torch.finfo(torch.float32).max

FACE_MASK_NONE = 0
FACE_MASK_IGNORE_BACKFACES = 1
FACE_MASK_IGNORE_FRONTFACES = 2

# The most (ray, triangle) pairs one chunk of raycast_batch evaluates:
# 2^22 pairs make each scalar temporary 16 MB of float32.  On the CPU a
# chunk of 2^18 (1 MB temporaries) runs twice as fast as one of 2^22
# (the 32-agent crowd step on the bench scene: 1.0 s against 2.1 s).
MAX_BLOCK = 1 << 22
CPU_BLOCK = 1 << 18


def build_collision_world(scene: Dict[str, torch.Tensor]) -> Dict:
    """World-space triangle soup from packed scene tensors
    (models.convert.scene_to_torch), on their device.

    Every vertex is transformed by its mesh matrix and every normal by the
    mesh's transpose-inverse (Physics.cs:38-49, JAX's cofactor inverse),
    then gathered per triangle corner."""
    mats = scene["mesh_matrices"].to(F32)                    # (M, 4, 4)
    inv, _ok = ml.invert(mats)
    normal_mat = inv.transpose(-1, -2)
    vm = scene["vert_mesh_id"].long()
    pos = ml.transform_point(scene["position"].to(F32), mats[vm])
    nrm = scene["normal"].to(F32)
    n4 = ml.transform(torch.cat([nrm, torch.zeros_like(nrm[..., :1])], -1),
                      normal_mat[vm])[..., :3]
    normal = ml.safe_normalize(n4)
    idx = scene["indices"].long()                            # (T, 3)
    v = pos[idx]                                             # (T, 3, 3)
    n = normal[idx]
    return {
        "v0": v[:, 0], "v1": v[:, 1], "v2": v[:, 2],
        "n0": n[:, 0], "n1": n[:, 1], "n2": n[:, 2],
        "tri_mesh_id": scene["tri_mesh_id"].to(torch.int32),
    }


def mt_block(o, d, v0, e1, e2, face_mask: int):
    """Möller–Trumbore over broadcastable (..., 3) ray and triangle
    blocks; returns (ok, t, u, v).  The formulas of raycast_batch operand
    for operand (rt_accel._mt_block in the JAX package); callers add their
    own slot masks."""
    pvec = ml.cross(d, e2)
    det = ml.dot(e1, pvec)
    ok = det.abs() >= EPSILON
    if face_mask & FACE_MASK_IGNORE_BACKFACES:
        ok &= det >= EPSILON
    if face_mask & FACE_MASK_IGNORE_FRONTFACES:
        ok &= det <= -EPSILON
    inv_det = 1.0 / torch.where(det == 0, 1.0, det)
    tvec = o - v0
    u = ml.dot(tvec, pvec) * inv_det
    ok &= (u >= 0) & (u <= 1)
    qvec = ml.cross(tvec, e1)
    v = ml.dot(d, qvec) * inv_det
    ok &= (v >= 0) & (u + v <= 1)
    t = ml.dot(e2, qvec) * inv_det
    ok &= t >= 0
    return ok, t, u, v


def raycast_batch(origins: torch.Tensor, directions: torch.Tensor,
                  world: Dict, face_mask: int = FACE_MASK_IGNORE_BACKFACES,
                  tri_mask: Optional[torch.Tensor] = None) -> Dict:
    """R rays vs T triangles; nearest hit per ray.

    origins/directions: (R, 3) (directions are normalized here, as
    Physics.RaycastInternal does).  tri_mask: optional (T,) bool to exclude
    triangles.  Returns {"hit": (R,) bool, "distance": (R,), "point":
    (R, 3), "normal": (R, 3), "tri": (R,) int32}; misses report distance
    = float32 max, zero point and normal, and tri 0."""
    o_all = origins.to(F32)
    d_all = ml.safe_normalize(directions.to(F32))
    v0 = world["v0"]
    e1 = world["v1"] - world["v0"]
    e2 = world["v2"] - world["v0"]
    T = v0.shape[0]
    block = MAX_BLOCK if o_all.is_cuda else CPU_BLOCK
    step = max(1, block // max(T, 1))
    parts = []
    for r0 in range(0, o_all.shape[0], step):
        o = o_all[r0:r0 + step, None, :]                      # (C, 1, 3)
        d = d_all[r0:r0 + step, None, :]
        ok, t, u, v = mt_block(o, d, v0[None], e1[None], e2[None], face_mask)
        if tri_mask is not None:
            ok &= tri_mask.to(torch.bool)[None, :]
        t_masked = torch.where(ok, t, BIG)
        tri = torch.argmin(t_masked, dim=1)                   # lowest index
        col = tri[:, None]
        parts.append((tri, t_masked.gather(1, col)[:, 0],
                      ok.gather(1, col)[:, 0], u.gather(1, col)[:, 0],
                      v.gather(1, col)[:, 0]))
    tri, dist, hit, ub, vb = (torch.cat(p) for p in zip(*parts))
    wb = 1.0 - ub - vb
    normal = ml.safe_normalize(world["n0"][tri] * wb[:, None]
                               + world["n1"][tri] * ub[:, None]
                               + world["n2"][tri] * vb[:, None])
    point = o_all + d_all * dist[:, None]
    return {
        "hit": hit,
        "distance": torch.where(hit, dist, BIG),
        "point": torch.where(hit[:, None], point, 0.0),
        "normal": torch.where(hit[:, None], normal, 0.0),
        "tri": tri.to(torch.int32),
    }


def raycast_batch_bary(origins: torch.Tensor, directions: torch.Tensor,
                       world: Dict, face_mask: int,
                       tri_mask: Optional[torch.Tensor] = None) -> Dict:
    """raycast_batch plus the winner's barycentrics "u"/"v", recomputed by
    mt_block on the winning triangle's corners along the normalized
    direction the cast used (JAX's brute_path in rt_pallas).  The brute
    route of the ray-traced frame and the bundle casts' overflow fallback
    shade at these."""
    res = raycast_batch(origins, directions, world, face_mask=face_mask,
                        tri_mask=tri_mask)
    tri = res["tri"].long()
    v0 = world["v0"][tri]
    _ok, _t, res["u"], res["v"] = mt_block(
        origins.to(F32), ml.safe_normalize(directions.to(F32)), v0,
        world["v1"][tri] - v0, world["v2"][tri] - v0, face_mask)
    return res


def raycast(origin: torch.Tensor, direction: torch.Tensor, world: Dict,
            face_mask: int = FACE_MASK_IGNORE_BACKFACES,
            tri_mask: Optional[torch.Tensor] = None) -> Dict:
    """One ray (3,) through raycast_batch (Physics.Raycast's shape):
    the same dict with scalar and (3,) leaves."""
    out = raycast_batch(origin.reshape(1, 3), direction.reshape(1, 3),
                        world, face_mask, tri_mask)
    return {k: v[0] for k, v in out.items()}
