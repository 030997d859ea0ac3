"""Skeletal (linear-blend) skinning.

Counterpart of ``softwarerenderer_tpu/ops/skinning.py``, driven by
``uniforms["anim_time"]`` (seconds; a scalar, or one clock a skin):

  * ``sample_tracks`` samples each joint's uniform-clock TRS keys at its
    skin's fractional frame (two keys, a lerp, a hemisphere-aligned nlerp
    for the rotation) and composes row-vector local matrices S·R·T;
  * ``forward_kinematics_levels`` computes world_j = local_j ·
    world_parent one topological level at a time (the packed
    ``joint_level_ids``), so a crowd of skeletons costs the depth of one;
    ``forward_kinematics`` is the sequential form the tests hold it to;
  * ``skin_matrices`` = inverse_bind · world; ``apply_skinning`` blends
    each vertex's 4 joint matrices by its weights and transforms its
    position and normal (renormalised).

Every 4x4 product and per-vertex transform is written as ordered
multiply-adds (ml.mat4_mul, ml.transform) and the 4-joint blend as a left
to right sum, never a matmul or a reduction, and every root is correctly
rounded (ml.sqrt_rn), so the card computes the CPU's values bit for bit
(XLA's einsum rounds in its own order: the JAX package differs by ulps).
The frame indices cast as XLA's convert does (morph.frame_index).
Nothing writes into the scene's buffers.

The numpy functions at the end (``*_np`` and ``skinned_positions_np``)
are the JAX module's numpy branches, which the scene packer bounds
skinned meshes with.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from softwarerenderer_tpu_torch.ops.morph import frame_index, renormalize
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = torch.float32


def quat_matrices(q: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) row-vector rotation matrices of (..., 4) xyzw quats."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    one = torch.ones_like(x)
    r0 = torch.stack([one - 2.0 * (y * y + z * z), 2.0 * (x * y + w * z),
                      2.0 * (x * z - w * y)], dim=-1)
    r1 = torch.stack([2.0 * (x * y - w * z), one - 2.0 * (x * x + z * z),
                      2.0 * (y * z + w * x)], dim=-1)
    r2 = torch.stack([2.0 * (x * z + w * y), 2.0 * (y * z - w * x),
                      one - 2.0 * (x * x + y * y)], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def compose_trs(trans: torch.Tensor, rot: torch.Tensor,
                scl: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) local matrices S·R·T: rows scale·rotation, last row the
    translation."""
    rs = quat_matrices(rot) * scl[..., :, None]
    m = torch.cat([rs, torch.zeros_like(rs[..., :1])], dim=-1)
    last = torch.cat([trans, torch.ones_like(trans[..., :1])], dim=-1)
    return torch.cat([m, last[..., None, :]], dim=-2)


def sample_tracks(trans: torch.Tensor, rot: torch.Tensor, scl: torch.Tensor,
                  frame: torch.Tensor, n_frames: torch.Tensor
                  ) -> torch.Tensor:
    """Local joint matrices (J, 4, 4) from TRS tracks trans (F, J, 3), rot
    (F, J, 4), scl (F, J, 3) at each joint's fractional `frame` (J,) of a
    clip n_frames (J,) keys long, looping."""
    i0, i1, a = frame_index(frame, n_frames)
    j = torch.arange(trans.shape[1], device=trans.device)
    t0, t1 = trans[i0, j], trans[i1, j]
    q0, q1 = rot[i0, j], rot[i1, j]
    s0, s1 = scl[i0, j], scl[i1, j]
    q1 = torch.where((ml.dot(q0, q1) < 0)[..., None], -q1, q1)
    q = renormalize(q0 + (q1 - q0) * a)
    return compose_trs(t0 + (t1 - t0) * a, q, s0 + (s1 - s0) * a)


def forward_kinematics(local: torch.Tensor,
                       parent: torch.Tensor) -> torch.Tensor:
    """World joint matrices, one joint at a time: world_j = local_j ·
    world_parent[j] (parent[j] < j, -1 for a root).  Reads `parent` on the
    host."""
    world = []
    for j, p in enumerate(parent.tolist()):
        world.append(local[j] if p < 0 else ml.mat4_mul(local[j], world[p]))
    return torch.stack(world)


def forward_kinematics_levels(local: torch.Tensor, parent: torch.Tensor,
                              level_ids: torch.Tensor) -> torch.Tensor:
    """forward_kinematics one topological level at a time: level_ids
    (D, L) holds each depth's joint ids, rows padded with J.  The pad rows
    compute a throwaway product into an extra row J, dropped at the end
    (JAX's scatter drops them by mode="drop")."""
    J = local.shape[0]
    eye = torch.eye(4, dtype=local.dtype, device=local.device)
    world = torch.zeros((J + 1, 4, 4), dtype=local.dtype, device=local.device)
    for d in range(level_ids.shape[0]):
        ids = level_ids[d].long()
        idc = ids.clamp(max=J - 1)
        p = parent[idc].long()
        pm = torch.where((p < 0)[:, None, None], eye, world[p.clamp(min=0)])
        world = world.index_put((ids,), ml.mat4_mul(local[idc], pm))
    return world[:J]


def skin_matrices(scene: Dict[str, torch.Tensor],
                  uniforms: Dict) -> torch.Tensor:
    """Per-joint skinning matrices (J, 4, 4) at uniforms["anim_time"]
    seconds (scalar or one a skin)."""
    slot = scene["joint_skin_slot"].long()
    rate = scene["skin_rate"]
    t = torch.as_tensor(uniforms.get("anim_time", 0.0), dtype=F32,
                        device=rate.device)
    t = torch.atleast_1d(t).expand(rate.shape[0])
    local = sample_tracks(scene["skin_trans"], scene["skin_rot"],
                          scene["skin_scale"], (t * rate)[slot],
                          scene["skin_n_frames"][slot])
    world = forward_kinematics_levels(local, scene["joint_parent"],
                                      scene["joint_level_ids"])
    return ml.mat4_mul(scene["joint_inv_bind"], world)


def apply_skinning(vin: Dict, scene: Dict[str, torch.Tensor],
                   uniforms: Dict) -> Dict:
    """A copy of vin with the skinned vertices' positions and normals
    replaced: each vertex's 4 joint matrices blended by its weights (left
    to right), its position transformed by the blend and its normal by
    the blend's 3x3, renormalised."""
    mats = skin_matrices(scene, uniforms)
    g = mats[scene["skin_joints"].long()]                  # (Vs, 4, 4, 4)
    wt = scene["skin_weights"][..., None, None]
    blend = g[:, 0] * wt[:, 0]
    for k in range(1, g.shape[1]):
        blend = blend + g[:, k] * wt[:, k]
    vidx = scene["skin_vert_index"].long()
    pos = ml.transform(ml.homogenize(vin["position"][vidx]), blend)[..., :3]
    nrm = renormalize(ml.transform_normal(vin["normal"][vidx], blend))
    out = dict(vin)
    out["position"] = vin["position"].index_put((vidx,), pos)
    out["normal"] = vin["normal"].index_put((vidx,), nrm)
    return out


# ---------------------------------------------------------------------------
# Host reference (numpy), the JAX module's numpy branches
# ---------------------------------------------------------------------------

F32_NP = np.float32


def quat_matrices_np(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two = F32_NP(2.0)
    one = np.ones_like(x)
    r0 = np.stack([one - two * (y * y + z * z), two * (x * y + w * z),
                   two * (x * z - w * y)], axis=-1)
    r1 = np.stack([two * (x * y - w * z), one - two * (x * x + z * z),
                   two * (y * z + w * x)], axis=-1)
    r2 = np.stack([two * (x * z + w * y), two * (y * z - w * x),
                   one - two * (x * x + y * y)], axis=-1)
    return np.stack([r0, r1, r2], axis=-2)


def compose_trs_np(trans, rot, scl) -> np.ndarray:
    rs = quat_matrices_np(rot) * scl[..., :, None]
    m = np.concatenate([rs, np.zeros_like(rs[..., :1])], axis=-1)
    last = np.concatenate([trans, np.ones_like(trans[..., :1])], axis=-1)
    return np.concatenate([m, last[..., None, :]], axis=-2)


def sample_tracks_np(trans, rot, scl, frame, n_frames) -> np.ndarray:
    nf = np.maximum(n_frames, 1)
    f0 = np.floor(frame)
    a = (frame - f0)[..., None].astype(F32_NP)
    i0 = (f0.astype(np.int32) % nf + nf) % nf
    i1 = (i0 + 1) % nf
    j = np.arange(trans.shape[1])
    t0, t1 = trans[i0, j], trans[i1, j]
    q0, q1 = rot[i0, j], rot[i1, j]
    s0, s1 = scl[i0, j], scl[i1, j]
    t = t0 + (t1 - t0) * a
    s = s0 + (s1 - s0) * a
    q1 = np.where((np.sum(q0 * q1, axis=-1) < 0)[..., None], -q1, q1)
    q = q0 + (q1 - q0) * a
    q = q / np.sqrt(np.maximum(np.sum(q * q, axis=-1, keepdims=True),
                               F32_NP(1e-30)))
    return compose_trs_np(t, q, s)


def forward_kinematics_np(local: np.ndarray, parent) -> np.ndarray:
    world = np.empty_like(local)
    for j in range(local.shape[0]):
        p = parent[j]
        world[j] = local[j] if p < 0 else local[j] @ world[p]
    return world


def skinned_positions_np(skin, mesh_positions: np.ndarray,
                         frame: float) -> np.ndarray:
    """Host reference: one instance's skinned positions at a frame of its
    own clock (the packer's conservative bounds)."""
    J = skin.parent.shape[0]
    local = sample_tracks_np(skin.trans, skin.rot, skin.scale,
                             np.full(J, frame, F32_NP),
                             np.full(J, skin.trans.shape[0], np.int32))
    world = forward_kinematics_np(local, skin.parent)
    mats = skin.inverse_bind.astype(F32_NP) @ world
    gathered = mats[skin.joints.reshape(-1)].reshape(
        skin.joints.shape + (4, 4))
    blend = np.sum(gathered * skin.weights[..., None, None], axis=1)
    ph = np.concatenate([mesh_positions,
                         np.ones_like(mesh_positions[..., :1])], axis=-1)
    return np.einsum("vi,vij->vj", ph, blend)[..., :3]
