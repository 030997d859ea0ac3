"""Tangent-space normal mapping.

Counterpart of ``softwarerenderer_tpu/ops/normalmap.py``:

  * ``compute_tangents``: per-vertex (V, 4) tangents at pack time (numpy,
    float64 accumulation over triangles, Gram-Schmidt against the normal,
    bitangent handedness in w), for meshes with a normal map;
  * ``normal_mapped_vertex_shader`` / ``normal_mapped_fragment_shader``:
    the game's shader pair with a world-space tangent varying and the
    normal perturbed by the map's tangent-space normal before lighting.

The map sits in the scene's atlas; its per-triangle region (the nm_*
channels) is resolved per triangle by engine.frame_setup, like tex_*.
The tangent varying is 4-wide, so it interpolates perspective-correct
without the vec3 renormalisation; the fragment shader orthonormalises it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from softwarerenderer_tpu_torch.ops import texture as tex_ops
from softwarerenderer_tpu_torch.ops.morph import renormalize
from softwarerenderer_tpu_torch.shaders import atlas_sample, lit_and_fogged
from softwarerenderer_tpu_torch.utils import mathlib as ml


def compute_tangents(position: np.ndarray, uv: np.ndarray,
                     normal: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Per-vertex (V, 4) float32 tangents: xyz the uv-aligned tangent,
    orthogonalised against the normal, w the bitangent's handedness (±1);
    (1, 0, 0) or (0, 0, 1) where a vertex has no uv gradient."""
    idx = np.asarray(indices, np.int64).reshape(-1, 3)
    p = np.asarray(position, np.float64)
    t = np.asarray(uv, np.float64)
    v0, v1, v2 = idx[:, 0], idx[:, 1], idx[:, 2]
    e1 = p[v1] - p[v0]
    e2 = p[v2] - p[v0]
    du1 = t[v1] - t[v0]
    du2 = t[v2] - t[v0]
    det = du1[:, 0] * du2[:, 1] - du2[:, 0] * du1[:, 1]
    r = np.where(np.abs(det) < 1e-12, 0.0, 1.0 / np.where(det == 0, 1, det))
    tan = (e1 * du2[:, 1:2] - e2 * du1[:, 1:2]) * r[:, None]
    bit = (e2 * du1[:, 0:1] - e1 * du2[:, 0:1]) * r[:, None]

    acc_t = np.zeros_like(p)
    acc_b = np.zeros_like(p)
    for vk in (v0, v1, v2):
        np.add.at(acc_t, vk, tan)
        np.add.at(acc_b, vk, bit)
    n = np.asarray(normal, np.float64)
    tangent = acc_t - n * np.sum(n * acc_t, axis=-1, keepdims=True)
    ln = np.linalg.norm(tangent, axis=-1, keepdims=True)
    fallback = np.where(np.abs(n[:, 0:1]) < 0.9,
                        np.asarray([1.0, 0, 0]), np.asarray([0, 0, 1.0]))
    tangent = np.where(ln > 1e-8, tangent / np.where(ln == 0, 1, ln),
                       fallback)
    hand = np.sign(np.sum(np.cross(n, tangent) * acc_b, axis=-1))
    hand = np.where(hand == 0, 1.0, hand)
    return np.concatenate([tangent, hand[:, None]], axis=-1).astype(
        np.float32)


def normal_mapped_vertex_shader(vin: Dict, uniforms: Dict) -> Dict:
    """The game's vertex shader plus a world-space tangent varying: xyz
    rotated by the model matrix and normalised, w passed through."""
    model = uniforms["model"]
    world = ml.transform(ml.homogenize(vin["position"]), model)
    view_pos = ml.transform(world, uniforms["view"])
    clip = ml.transform(view_pos, uniforms["projection"])
    world_normal = ml.normalize(ml.transform_normal(vin["normal"], model),
                                eps=1e-30)
    tan = vin["tangent"]
    world_tan = ml.normalize(ml.transform_normal(tan[..., :3], model),
                             eps=1e-30)
    return {"clip_position": clip, "color": vin["color"], "uv": vin["uv"],
            "normal": vin["normal"],
            "data": {"world_normal": world_normal,
                     "world_tangent": torch.cat([world_tan, tan[..., 3:4]],
                                                dim=-1)}}


def normal_mapped_fragment_shader(frag: Dict, uniforms: Dict
                                  ) -> torch.Tensor:
    """The game's shader (texture × color, half-Lambert, fog) with the
    normal replaced by the map's: n and t orthonormalised, b = (n × t)·w,
    world normal = t·m.x + b·m.y + n·m.z of the texel m = rgb·2 - 1."""
    n = renormalize(frag["data"]["world_normal"])
    t4 = frag["data"]["world_tangent"]
    t = t4[..., :3]
    t = renormalize(t - n * ml.dot(n, t)[..., None])
    b = ml.cross(n, t) * t4[..., 3:4]
    tri = frag["tri"]
    nm = tex_ops.sample_atlas_region(
        uniforms["atlas_data"], tri["nm_oy"], tri["nm_ox"], tri["nm_h"],
        tri["nm_w"], frag["uv"])
    nm = nm[..., :3] * 2.0 - 1.0
    world_n = renormalize(t * nm[..., 0:1] + b * nm[..., 1:2]
                          + n * nm[..., 2:3])
    frag = dict(frag, data=dict(frag["data"], world_normal=world_n))
    return lit_and_fogged(frag, uniforms, atlas_sample(frag, uniforms))


# The JAX shader's registries, the same values.
normal_mapped_fragment_shader.varyings = (
    "color", "uv", "data.world_normal", "data.world_tangent")
normal_mapped_fragment_shader.tri_extras = (
    "tex_oy", "tex_ox", "tex_h", "tex_w", "nm_oy", "nm_ox", "nm_h", "nm_w")
normal_mapped_fragment_shader.alpha_sources = ("color", "texture")
