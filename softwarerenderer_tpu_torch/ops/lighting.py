"""Multi-light and PBR shading over packed scenes.

Counterpart of ``softwarerenderer_tpu/ops/lighting.py``: the scene's light
records pack into fixed-size uniform arrays (``pack_lights``, host numpy),
and every fragment sums all lights in one broadcast over the light axis
(``accumulate_lights``): no loop over lights.  Light model (Light.cs's
fields):

  directional: L = -direction, no attenuation
  point:       L = normalize(pos - x), atten = 1/(c + l·d + q·d²)
  spot:        point × smoothstep cone falloff between outer and inner
  ambient:     constant color

``lit_scene_vertex_shader`` adds the world position varying the lit
shaders read; ``multi_light_fragment_shader`` lights the game's textured
surface with every packed light (golden config 3);
``pbr_scene_fragment_shader`` shades the metallic / roughness / emissive /
base-color material channels that ``engine.frame_setup`` packs per
triangle (``mat_*``), with its environment terms (``env_panorama``,
``env_irradiance``) sampled through ``ops.sky``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from softwarerenderer_tpu_torch.models.scene import Light, LightType
from softwarerenderer_tpu_torch.ops import sky
from softwarerenderer_tpu_torch.shaders import (atlas_sample, fog_factor,
                                                smoothstep01)
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = torch.float32


def pack_lights(lights: List[Light], max_lights: int = 8) -> Dict:
    """Scene Light records -> fixed-size uniform arrays (padded, masked),
    numpy, as the JAX package packs them."""
    n = min(len(lights), max_lights)
    out = {
        "light_position": np.zeros((max_lights, 3), np.float32),
        "light_dir": np.zeros((max_lights, 3), np.float32),
        "light_rgb": np.zeros((max_lights, 3), np.float32),
        "light_type": np.zeros(max_lights, np.int32),
        "light_atten": np.zeros((max_lights, 3), np.float32),  # c, l, q
        "light_cone": np.zeros((max_lights, 2), np.float32),   # cos in, out
        "light_on": np.zeros(max_lights, bool),
    }
    for i, l in enumerate(lights[:n]):
        out["light_position"][i] = l.position
        d = np.asarray(l.direction, np.float32)
        norm = np.linalg.norm(d)
        out["light_dir"][i] = d / norm if norm > 0 else d
        out["light_rgb"][i] = l.color
        out["light_type"][i] = l.light_type
        out["light_atten"][i] = (l.attenuation_constant,
                                 l.attenuation_linear,
                                 l.attenuation_quadratic)
        out["light_cone"][i] = (np.cos(l.spot_inner), np.cos(l.spot_outer))
        out["light_on"][i] = True
    return out


def accumulate_lights(world_pos: torch.Tensor, world_normal: torch.Tensor,
                      uniforms: Dict) -> torch.Tensor:
    """Summed RGB irradiance at each fragment, (..., 3).

    world_pos and world_normal (..., 3); the pack_lights arrays ride in
    `uniforms` as tensors on their device.  Broadcasts to (..., L, 3) and
    sums over L."""
    lp = uniforms["light_position"]          # (L, 3)
    ld = uniforms["light_dir"]
    lc = uniforms["light_rgb"]
    lt = uniforms["light_type"]
    la = uniforms["light_atten"]
    cone = uniforms["light_cone"]
    on = uniforms["light_on"]

    p = world_pos[..., None, :]              # (..., 1, 3)
    n = world_normal[..., None, :]

    to_light = lp - p                        # (..., L, 3)
    dist = torch.sqrt(ml.dot(to_light, to_light))
    safe = torch.where(dist == 0, 1.0, dist)
    point_dir = to_light / safe[..., None]

    is_dir = lt == LightType.DIRECTIONAL
    is_amb = lt == LightType.AMBIENT
    ldir = torch.where(is_dir[..., None], -ld, point_dir)

    ndotl = ml.dot(n, ldir).clamp(min=0.0)

    atten = 1.0 / (la[..., 0] + la[..., 1] * dist
                   + la[..., 2] * dist * dist)
    atten = torch.where(is_dir, 1.0, atten)

    # spot cone: smoothstep between cos(outer) and cos(inner)
    cos_angle = ml.dot(-ldir, ld)
    width = torch.where(cone[..., 0] == cone[..., 1], 1.0,
                        cone[..., 0] - cone[..., 1])
    t = ((cos_angle - cone[..., 1]) / width).clamp(0.0, 1.0)
    factor = torch.where(lt == LightType.SPOT, smoothstep01(t), 1.0)

    contrib = torch.where(is_amb, 1.0, ndotl * atten * factor)
    rgb = lc * (contrib * on)[..., None]
    return rgb.sum(-2)


def multi_light_fragment_shader(frag: Dict, uniforms: Dict) -> torch.Tensor:
    """Texture(atlas) × vertex color lit by all packed lights plus an
    ambient floor, fogged as the game shader is (Renderer.cs:848-860)."""
    world_normal = frag["data"]["world_normal"]
    world_pos = frag["data"]["world_position"][..., :3]
    base = frag["color"] * atlas_sample(frag, uniforms)
    light = accumulate_lights(world_pos, world_normal, uniforms)
    ambient = uniforms.get("ambient", 0.1)
    lit_rgb = base[..., :3] * (ambient + light)
    fog_rgb = uniforms["fog_color"][..., :3]
    rgb = fog_rgb + (lit_rgb - fog_rgb) * fog_factor(frag, uniforms)[..., None]
    return torch.cat([rgb, base[..., 3:4]], dim=-1)


def lit_scene_vertex_shader(vin: Dict, uniforms: Dict) -> Dict:
    """The game's vertex shader plus a world position varying for the
    lit shaders."""
    world = ml.transform(ml.homogenize(vin["position"]), uniforms["model"])
    view_pos = ml.transform(world, uniforms["view"])
    clip = ml.transform(view_pos, uniforms["projection"])
    world_normal = ml.normalize(
        ml.transform_normal(vin["normal"], uniforms["model"]), eps=1e-30)
    # world_position rides as a 4-vector: the interpolation renormalises
    # every 3-wide data varying (the reference's Data channel,
    # Rasterizer.cs:680-688), which would destroy positions.
    return {"clip_position": clip, "color": vin["color"], "uv": vin["uv"],
            "normal": vin["normal"],
            "data": {"world_normal": world_normal, "world_position": world}}


def _unit(v: torch.Tensor) -> torch.Tensor:
    """v / |v| with |v|² floored at 1e-30."""
    return v / torch.sqrt(ml.dot(v, v).clamp(min=1e-30))[..., None]


def _q256(tri: Dict, *names: str) -> torch.Tensor:
    """8-bit material channels as floats in [0, 1020/256], stacked on the
    last axis (one channel: no axis)."""
    q = torch.stack([tri[k] for k in names], dim=-1).to(F32) * (1 / 256.0)
    return q[..., 0] if len(names) == 1 else q


def pbr_scene_fragment_shader(frag: Dict, uniforms: Dict) -> torch.Tensor:
    """Metalness-workflow shading of the reference's imported but unused
    metallic / roughness / emissive material (Material.cs:14-22):
    Blinn-Phong specular with a roughness-driven exponent, F0 between
    dielectric 0.04 and the albedo by metalness, emissive added to the
    light, then fog.  The per-triangle 8-bit channels ride the integer
    extras.  With uniforms["env_panorama"] (the sky panorama, which
    render_frame's sky stage passes under that name) metals mirror it
    along the reflected view ray, faded by roughness; with
    uniforms["env_irradiance"] (sky.irradiance_panorama) the normal's
    irradiance lights the diffuse lobe."""
    tri = frag["tri"]
    m = _q256(tri, "mat_m256")[..., None]
    r = _q256(tri, "mat_r256")
    emissive = _q256(tri, "mat_er256", "mat_eg256", "mat_eb256")

    n = _unit(frag["data"]["world_normal"])
    wp = frag["data"]["world_position"][..., :3]
    v = _unit(uniforms["camera_position"] - wp)
    ld = uniforms["light_direction"]
    l = -ld / torch.sqrt(ml.dot(ld, ld).clamp(min=1e-30))
    h = _unit(l + v)
    ndl = ml.dot(n, l).clamp(min=0.0)
    ndh = ml.dot(n, h).clamp(min=0.0)

    base = frag["color"] * atlas_sample(frag, uniforms)
    # The material base color tints the albedo (glTF's baseColorFactor).
    albedo = base[..., :3] * _q256(tri, "mat_br256", "mat_bg256",
                                   "mat_bb256")

    # The game's half-Lambert floor on the diffuse lobe; roughness sets
    # the Blinn-Phong exponent, clamped for float32.
    diffuse = ml.dot(n, l).clamp(min=0.25)
    shininess = (2.0 / (r * r).clamp(min=1e-3)).clamp(2.0, 2048.0)
    spec = torch.pow(ndh, shininess) * (shininess + 8.0) * (1 / 8.0)
    f0 = 0.04 * (1.0 - m) + albedo * m

    lit = (albedo * (1.0 - m) * (0.1 + 0.9 * diffuse[..., None])
           + f0 * (spec * ndl)[..., None]) \
        * uniforms["light_color"][..., :3] + emissive
    if "env_panorama" in uniforms:
        refl = 2.0 * ml.dot(n, v)[..., None] * n - v
        env = sky.sample_panorama(uniforms["env_panorama"], refl)
        gloss = (1.0 - r).clamp(0.0, 1.0)[..., None] * m
        lit = lit + f0 * env[..., :3] * gloss
    if "env_irradiance" in uniforms:
        irr = sky.sample_panorama(uniforms["env_irradiance"], n)
        lit = lit + albedo * (1.0 - m) * irr[..., :3]

    fog_rgb = uniforms["fog_color"][..., :3]
    rgb = fog_rgb + (lit - fog_rgb) * fog_factor(frag, uniforms)[..., None]
    return torch.cat([rgb, base[..., 3:4]], dim=-1)


# The JAX shaders' registries, the same values: the varyings each reads,
# its per-triangle channels and where its alpha comes from (vertex color.a
# × texture alpha; material and lights touch rgb only).
multi_light_fragment_shader.varyings = (
    "color", "uv", "data.world_normal", "data.world_position")
multi_light_fragment_shader.tri_extras = (
    "tex_oy", "tex_ox", "tex_h", "tex_w")
multi_light_fragment_shader.alpha_sources = ("color", "texture")
pbr_scene_fragment_shader.varyings = multi_light_fragment_shader.varyings
pbr_scene_fragment_shader.tri_extras = (
    "tex_oy", "tex_ox", "tex_h", "tex_w",
    "mat_m256", "mat_r256", "mat_er256", "mat_eg256", "mat_eb256",
    "mat_br256", "mat_bg256", "mat_bb256")
pbr_scene_fragment_shader.alpha_sources = ("color", "texture")
