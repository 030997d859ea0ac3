"""Shaders as PyTorch functions over tensors, leading dimensions broadcast.

Counterpart of ``softwarerenderer_tpu/shaders.py``:

  vertex_shader(vin: dict, uniforms: dict) -> dict
      vin:  {"position": (..., 3), "uv": (..., 2), "normal": (..., 3),
             "color": (..., 4)}
      out:  {"clip_position": (..., 4), "color", "uv", "normal",
             "data": {name: (..., K)}}

  fragment_shader(frag: dict, uniforms: dict) -> rgba (..., 4)
      Discard by returning alpha <= 0.

A fragment shader carries the JAX package's registries as attributes:
``varyings`` (the flat varyings it reads; the rest are pruned from the tile
payload), ``tri_extras`` (the per-triangle channels it reads, in
``frag["tri"]``) and ``alpha_sources`` (where its alpha comes from, which
lets the K-buffer stop peeling behind opaque winners).  A shader without a
registry gets everything and never short-circuits.

``make_vertex_input`` assembles a vertex-attribute dict on the host (numpy
float32, the JAX function's numpy path) with the reference's defaults.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from softwarerenderer_tpu_torch.ops import texture as tex_ops
from softwarerenderer_tpu_torch.utils import mathlib as ml

VARYING_KEYS = ("clip_position", "color", "uv", "normal")


def make_vertex_input(position, uv=None, normal=None, color=None) -> Dict:
    """Assemble the vertex-attribute dict with reference defaults
    (white vertex color, zero normal/uv when absent — ModelLoader.cs:188-194)
    as numpy float32 arrays."""
    position = np.asarray(position, dtype=np.float32)
    n = position.shape[:-1]
    if uv is None:
        uv = np.zeros(n + (2,), dtype=np.float32)
    if normal is None:
        normal = np.zeros(n + (3,), dtype=np.float32)
    if color is None:
        color = np.ones(n + (4,), dtype=np.float32)
    return {
        "position": position,
        "uv": np.asarray(uv, dtype=np.float32),
        "normal": np.asarray(normal, dtype=np.float32),
        "color": np.asarray(color, dtype=np.float32),
    }


def default_vertex_shader(vin: Dict, uniforms: Dict) -> Dict:
    """The game's vertex shader (Renderer.cs:830-846): MVP transform plus a
    world-space normal in the `data` varying, with uniforms["model"] one
    (4, 4) matrix or (V, 4, 4) per-vertex matrices."""
    model = uniforms["model"]
    world = ml.transform(ml.homogenize(vin["position"]), model)
    view_pos = ml.transform(world, uniforms["view"])
    clip = ml.transform(view_pos, uniforms["projection"])
    world_normal = ml.normalize(ml.transform_normal(vin["normal"], model),
                                eps=1e-30)
    return {"clip_position": clip, "color": vin["color"], "uv": vin["uv"],
            "normal": vin["normal"], "data": {"world_normal": world_normal}}


def smoothstep01(t: torch.Tensor) -> torch.Tensor:
    return t * t * (3.0 - 2.0 * t)


def fog_factor(frag: Dict, uniforms: Dict) -> torch.Tensor:
    """Smoothstep fog on clip-space z (Renderer.cs:848-860): 1 up to
    fog_start, 0 from fog_end."""
    depth = frag["clip_position"][..., 2]
    fog_end = uniforms["fog_end"]
    fog = ((fog_end - depth) / (fog_end - uniforms["fog_start"])).clamp(0, 1)
    return smoothstep01(fog)


def atlas_sample(frag: Dict, uniforms: Dict) -> torch.Tensor:
    """The texel of each fragment's atlas region: the scene shaders'
    texture fetch, through the per-triangle tex_* channels."""
    tri = frag["tri"]
    return tex_ops.sample_atlas_region(
        uniforms["atlas_data"], tri["tex_oy"], tri["tex_ox"], tri["tex_h"],
        tri["tex_w"], frag["uv"])


def lit_and_fogged(frag: Dict, uniforms: Dict,
                   tex_color: torch.Tensor) -> torch.Tensor:
    """Texture color × vertex color, half-Lambert max(0.25, N·-L),
    smoothstep fog on clip-space z, alpha unfogged (Renderer.cs:848-860)."""
    diffuse = ml.dot(frag["data"]["world_normal"],
                     -uniforms["light_direction"]).clamp(min=0.25)
    base = frag["color"] * tex_color
    lit = base * (0.1 + 0.9 * diffuse[..., None]) * uniforms["light_color"]
    fog_color = uniforms["fog_color"]
    fog = fog_factor(frag, uniforms)
    rgba = fog_color + (lit - fog_color) * fog[..., None]
    return torch.cat([rgba[..., :3], base[..., 3:4]], dim=-1)


def default_fragment_shader(frag: Dict, uniforms: Dict) -> torch.Tensor:
    """The game's fragment shader (Renderer.cs:848-860): texture (the
    nearest sample of uniforms["texture"], white without one) × vertex
    color, lit and fogged."""
    texture = uniforms.get("texture")
    uv = frag["uv"]
    if texture is not None:
        tex_color = tex_ops.sample_nearest(texture, uv)
    else:
        tex_color = torch.ones(uv.shape[:-1] + (4,), dtype=uv.dtype,
                               device=uv.device)
    return lit_and_fogged(frag, uniforms, tex_color)


def flat_color_fragment_shader(frag: Dict, uniforms: Dict) -> torch.Tensor:
    """Minimal unlit shader: interpolated vertex color only."""
    return frag["color"]


def textured_fragment_shader(frag: Dict, uniforms: Dict) -> torch.Tensor:
    """Texture × vertex color, no lighting or fog."""
    return frag["color"] * tex_ops.sample_nearest(uniforms["texture"],
                                                  frag["uv"])


# The JAX shaders' registries, the same values.
default_fragment_shader.varyings = ("color", "uv", "data.world_normal")
flat_color_fragment_shader.varyings = ("color",)
textured_fragment_shader.varyings = ("color", "uv")
