"""Shadow maps: directional, point (cube) and spot lights.

Counterpart of ``softwarerenderer_tpu/ops/shadows.py``.  A shadow map is
one extra depth-only pass of the frame's own geometry stage and binned
visibility fold, from a light camera:

  1. ``directional_light_camera`` fits an orthographic camera over a
     sphere (the scene's bounds), ``spot_light_camera`` a perspective one
     along the cone axis, ``point_light_cameras`` six 90° faces;
  2. ``render_shadow_depth`` folds the scene's depth from that camera: for
     CUDA tensors under LESS_EQUAL (the default) through K5
     (``vis_fold.visibility_fold``, ``csrc/vis_fold.cu``), which computes
     that fold exactly, otherwise through ``binning.visibility_binned``
     (JAX's fold); ``render_point_shadow_depth`` runs it once per face;
  3. ``shadow_factor`` and ``point_shadow_factor`` project world positions
     into the map and compare depths: {0, 1} per fragment.

Animated geometry casts its current pose: engine.posed_geometry runs the
frame's vertex updates (engine.apply_vertex_updates, the billboards facing
the main camera) and its LOD mask (at the main frame's height) once a
frame, and every light pass and the main pass share them.

Depths keep the frame's convention: the stored value is the negated
(ndcZ + 1) / 2, decreasing away from the light, and an empty texel holds
raster.DEPTH_CLEAR, so a fragment that maps to one is lit.  The three
fragment shaders light the game's textured surface with one light each
and scale the lit term by the factor.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch
from softwarerenderer_tpu_torch.utils.profiling import span

from softwarerenderer_tpu_torch.config import DepthTest, RenderParams
from softwarerenderer_tpu_torch.ops import binning, culling, geometry
from softwarerenderer_tpu_torch.ops import vis_fold
from softwarerenderer_tpu_torch.shaders import (atlas_sample, fog_factor,
                                                smoothstep01)
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = torch.float32
# Light passes clip at this near plane (JAX's render_shadow_depth).
LIGHT_NEAR_CLIP = 1e-4
SHADOW_BIAS = 4e-3


def _f32s(device, *xs):
    """Host values or tensors as float32 tensors on `device`, the host
    values moved in one host->device copy (each copy waits for the
    device)."""
    host = [np.asarray(x, np.float32) for x in xs
            if not isinstance(x, torch.Tensor)]
    if host:
        packed = torch.from_numpy(np.concatenate(
            [a.reshape(-1) for a in host]))
        with span("sync.light_uniforms"):
            packed = packed.to(device)
    out, off = [], 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x.to(device=device, dtype=F32))
        else:
            n = np.asarray(x).size
            out.append(packed[off:off + n].reshape(np.shape(x)))
            off += n
    return out


@functools.lru_cache(maxsize=None)
def _constant(value, device: torch.device) -> torch.Tensor:
    """A host constant (a float or a tuple) as a float32 tensor on
    `device`, moved once per value and device."""
    return torch.tensor(value, dtype=F32, device=device)


def _scalar(x, device) -> torch.Tensor:
    """A near or far plane: a tensor as it is, a number as a constant."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=F32)
    return _constant(float(x), device)


def _light_up(d: torch.Tensor) -> torch.Tensor:
    """+Y, or +X when the light looks (almost) straight up or down."""
    return torch.where(d[1].abs() > 0.95,
                       _constant((1.0, 0.0, 0.0), d.device),
                       _constant((0.0, 1.0, 0.0), d.device))


def directional_light_camera(light_direction, center, radius):
    """Orthographic (view, proj, view·proj) of a directional light covering
    the sphere (center, radius); float32 tensors on center's device."""
    center = torch.as_tensor(center, dtype=F32)
    dev = center.device
    light_direction, radius = _f32s(dev, light_direction, radius)
    d = ml.normalize(light_direction)
    eye = center - d * (radius * 2.0)
    view = ml.look_at(eye, center, _light_up(d))
    extent = radius * 2.2
    proj = ml.orthographic(extent, extent, 0.05 * radius, radius * 4.0)
    return view, proj, ml.transform(view, proj)


def scene_bounds(scene: Dict[str, torch.Tensor]):
    """(center (3,), radius ()) of a sphere around every mesh's world
    bounding sphere, radii scaled by the max row norm of the model's 3x3
    as frustum culling scales them (JAX's render_frame_with_shadows)."""
    mm = scene["mesh_matrices"]
    wc = ml.transform_point(scene["bounds_center"], mm)
    row_norms = torch.sqrt((mm[:, :3, :3] ** 2).sum(-1))
    wr = scene["bounds_radius"] * row_norms.amax(-1)
    center = wc.mean(0)
    off = wc - center
    return center, (torch.sqrt(ml.dot(off, off)) + wr).amax()


def light_vertex_shader(vin: Dict, uniforms: Dict) -> Dict:
    """Clip position only: the light pass reads no varying."""
    world = ml.transform(ml.homogenize(vin["position"]), uniforms["model"])
    view_pos = ml.transform(world, uniforms["view"])
    return {"clip_position": ml.transform(view_pos, uniforms["projection"])}


def shadow_params(params: Optional[RenderParams], S: int) -> RenderParams:
    """The light pass's parameters: S x S, no culling (back faces occlude
    too), tiles no larger than the map."""
    sp = (params or RenderParams(S, S)).replace(width=S, height=S,
                                                cull_mode=0)
    return sp.replace(tile_h=min(sp.tile_h, S), tile_w=min(sp.tile_w, S))


def light_pass_visibility(sp: RenderParams, device) -> Callable:
    """The light pass's fold: K5 for CUDA tensors under LESS_EQUAL, the
    binned fold of sp.depth_test otherwise (both tiled as sp)."""
    if device.type == "cuda" and sp.depth_test == DepthTest.LESS_EQUAL:
        return vis_fold.visibility_fold
    return binning.make_binned_visibility(sp.tile_h, sp.tile_w,
                                          sp.span_cap)


def _light_setup(scene: Dict[str, torch.Tensor], S: int,
                 params: Optional[RenderParams]):
    """(sp, model): the light passes' parameters and per-vertex model
    matrices, shared by a frame's passes."""
    sp = shadow_params(params, S)
    with span("shadow.geometry"):
        return sp, culling.model_matrices_per_vertex(scene)


def _posed(scene, uniforms, S, params, posed):
    """posed, or engine.posed_geometry for the main frame of params (JAX's
    light pass: S x S without them)."""
    if posed is not None:
        return posed
    from softwarerenderer_tpu_torch.engine.renderer import (device_uniforms,
                                                            posed_geometry)
    w, h = (params.width, params.height) if params is not None else (S, S)
    return posed_geometry(scene, device_uniforms(
        uniforms, w, h, scene["position"].device), h)


def _light_pass(scene: Dict[str, torch.Tensor], model: torch.Tensor,
                light_view: torch.Tensor, light_proj: torch.Tensor,
                sp: RenderParams, visibility_fn: Optional[Callable],
                posed: Dict) -> torch.Tensor:
    """One depth-only pass from a light camera -> (S, S) f32 map."""
    dev = scene["position"].device
    with span("shadow.geometry"):
        u = {"model": model, "view": light_view, "projection": light_proj,
             "near_clip": _constant(LIGHT_NEAR_CLIP, dev)}
        tris = geometry.build_triangles(
            light_vertex_shader, posed["vin"], scene["indices"], u,
            width=sp.width, height=sp.height, cull_mode=0,
            tri_mask=posed["tri_mask"], keep_varyings=())
    with span("shadow.fold"):
        depth, _ = (visibility_fn or light_pass_visibility(sp, dev))(tris,
                                                                     sp)
    return depth


def render_shadow_depth(scene: Dict[str, torch.Tensor], uniforms: Dict,
                        light_view: torch.Tensor, light_proj: torch.Tensor,
                        shadow_size: int = 512,
                        params: Optional[RenderParams] = None,
                        visibility_fn: Optional[Callable] = None,
                        posed: Optional[Dict] = None) -> torch.Tensor:
    """Depth-only render of the scene from the light camera -> (S, S) f32
    shadow map on the scene's device.

    The frame's geometry stage with cull_mode 0, a near clip of
    LIGHT_NEAR_CLIP and no varyings, then visibility_fn(tris, sp) ->
    (depth, ids), light_pass_visibility(sp) by default.  The geometry is
    `posed` (engine.posed_geometry), computed here for the main frame of
    params when not given."""
    sp, model = _light_setup(scene, shadow_size, params)
    return _light_pass(scene, model, light_view, light_proj, sp,
                       visibility_fn, _posed(scene, uniforms, shadow_size,
                                             params, posed))


def _to_light_screen(wp: torch.Tensor, view_proj: torch.Tensor, S: int):
    """(sx, sy, d_f): wp projected into an S x S light map, the viewport's
    Y flip included, and its depth in the map's convention."""
    clip = ml.transform(ml.homogenize(wp), view_proj)
    w = torch.where(clip[..., 3] == 0, 1.0, clip[..., 3])
    ndc = clip[..., :3] / w[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * float(S)
    sy = (1.0 - (ndc[..., 1] * 0.5 + 0.5)) * float(S)
    d_f = -(ndc[..., 2] + 1.0) * 0.5
    return sx, sy, d_f


def _lookup(smap_flat: torch.Tensor, base, sx, sy, d_f, S: int,
            bias: float) -> torch.Tensor:
    """Lit factor {0, 1}: the fragment is lit when its depth is at or
    above the texel's less the bias, or when it falls outside the map.

    inside comes from the floats and the index is clamped after the cast:
    a NaN or out-of-range coordinate casts differently on the CPU and on
    CUDA, and is harmless only so."""
    xi = sx.to(torch.int32).clamp(0, S - 1)
    yi = sy.to(torch.int32).clamp(0, S - 1)
    d_m = smap_flat[(base + yi * S + xi).long()]
    inside = (sx >= 0) & (sx < S) & (sy >= 0) & (sy < S)
    lit = (d_f >= d_m - bias) | ~inside
    return lit.to(F32)


def shadow_factor(world_position: torch.Tensor, uniforms: Dict,
                  bias: float = SHADOW_BIAS) -> torch.Tensor:
    """Per-fragment lit factor {0, 1} from uniforms' shadow_map (S, S),
    shadow_view and shadow_proj.  world_position (..., 3) or (..., 4).
    Points outside the light's frustum are lit."""
    smap = uniforms["shadow_map"]
    S = smap.shape[0]
    vp = ml.transform(uniforms["shadow_view"], uniforms["shadow_proj"])
    sx, sy, d_f = _to_light_screen(world_position[..., :3], vp, S)
    return _lookup(smap.reshape(-1), 0, sx, sy, d_f, S, bias)


def shadowed_scene_fragment_shader(frag: Dict, uniforms: Dict
                                   ) -> torch.Tensor:
    """The game shader with shadowed fragments falling to the ambient
    floor of its half-Lambert term."""
    diffuse = ml.dot(frag["data"]["world_normal"],
                     -uniforms["light_direction"]).clamp(min=0.25)
    shade = shadow_factor(frag["data"]["world_position"], uniforms)
    diffuse = 0.25 + (diffuse - 0.25) * shade
    base = frag["color"] * atlas_sample(frag, uniforms)
    lit = base * (0.1 + 0.9 * diffuse[..., None]) * uniforms["light_color"]
    fog_color = uniforms["fog_color"]
    fog = fog_factor(frag, uniforms)
    rgba = fog_color + (lit - fog_color) * fog[..., None]
    return torch.cat([rgba[..., :3], base[..., 3:4]], dim=-1)


# Point-light cube faces: +X -X +Y -Y +Z -Z, with up vectors that avoid a
# degenerate look_at along +-Y.
CUBE_DIRS = ((1.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
             (0.0, -1.0, 0.0), (0.0, 0.0, 1.0), (0.0, 0.0, -1.0))
CUBE_UPS = ((0.0, 1.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
            (0.0, 0.0, -1.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0))


def point_light_cameras(light_position, near, far, device=None):
    """(views (6, 4, 4), projs (6, 4, 4)): a 90° square perspective camera
    a cube face, the six tiling every direction."""
    lp, = _f32s(device, light_position)
    dev = lp.device
    views = torch.stack([
        ml.look_at(lp, lp + _constant(CUBE_DIRS[f], dev),
                   _constant(CUBE_UPS[f], dev)) for f in range(6)])
    proj = ml.perspective_fov(_constant(np.pi / 2, dev),
                              _constant(1.0, dev), _scalar(near, dev),
                              _scalar(far, dev))
    return views, proj.expand(6, 4, 4)


def render_point_shadow_depth(scene: Dict[str, torch.Tensor], uniforms: Dict,
                              light_position, shadow_size: int = 256,
                              near: float = 0.05, far: float = 100.0,
                              params: Optional[RenderParams] = None,
                              visibility_fn: Optional[Callable] = None,
                              posed: Optional[Dict] = None):
    """Six depth-only renders from the light -> (maps (6, S, S), views,
    projs), one light pass a face (JAX's static loop), all of the same
    posed geometry (render_shadow_depth's)."""
    views, projs = point_light_cameras(light_position, near, far,
                                       scene["position"].device)
    sp, model = _light_setup(scene, shadow_size, params)
    posed = _posed(scene, uniforms, shadow_size, params, posed)
    maps = [_light_pass(scene, model, views[f], projs[f], sp, visibility_fn,
                        posed) for f in range(6)]
    return torch.stack(maps), views, projs


def point_shadow_factor(world_position: torch.Tensor, uniforms: Dict,
                        bias: float = SHADOW_BIAS) -> torch.Tensor:
    """Per-fragment lit factor {0, 1} from a cube shadow map: uniforms'
    point_shadow_map (6, S, S), point_shadow_views and point_shadow_projs
    (6, 4, 4) and point_light_position (3,).  The face is the dominant
    axis of (wp - light); every face's projection is computed and the
    face's selected, so the only gather is the one texel."""
    smap = uniforms["point_shadow_map"]
    S = smap.shape[-1]
    wp = world_position[..., :3]
    v = wp - uniforms["point_light_position"]
    ax, ay, az = v[..., 0].abs(), v[..., 1].abs(), v[..., 2].abs()
    neg = (~(v >= 0)).to(torch.int32)      # the -axis face, NaN included
    face = torch.where((ax >= ay) & (ax >= az), neg[..., 0],
                       torch.where(ay >= az, 2 + neg[..., 1],
                                   4 + neg[..., 2]))
    sx_sel = torch.zeros(face.shape, dtype=F32, device=v.device)
    sy_sel, d_f_sel = sx_sel, sx_sel
    for f in range(6):
        vp = ml.transform(uniforms["point_shadow_views"][f],
                          uniforms["point_shadow_projs"][f])
        sx, sy, d_f = _to_light_screen(wp, vp, S)
        sel = face == f
        sx_sel = torch.where(sel, sx, sx_sel)
        sy_sel = torch.where(sel, sy, sy_sel)
        d_f_sel = torch.where(sel, d_f, d_f_sel)
    return _lookup(smap.reshape(-1), face * (S * S), sx_sel, sy_sel,
                   d_f_sel, S, bias)


def _range_falloff(dist: torch.Tensor, uniforms: Dict, key: str):
    """clip(1 - dist / range, 0, 1)², range = uniforms[key] or 25 (a
    device tensor: CUDA divides by a host scalar as a multiply by its
    reciprocal)."""
    rng = uniforms.get(key)
    rng = _constant(25.0, dist.device) if rng is None else _f32s(
        dist.device, rng)[0]
    return (1.0 - dist / rng).clamp(0.0, 1.0) ** 2


def _toward(lp: torch.Tensor, wp: torch.Tensor):
    """(dist, unit direction) from wp to the light at lp."""
    to_light = lp - wp
    dist = torch.sqrt(ml.dot(to_light, to_light).clamp(min=1e-12))
    return dist, to_light / dist[..., None]


def point_shadowed_fragment_shader(frag: Dict, uniforms: Dict
                                   ) -> torch.Tensor:
    """The game's textured surface lit by one point light, cube-shadowed,
    with a (1 - d / range)² falloff (uniforms point_light_position,
    point_light_color, point_light_range and the cube map's)."""
    wp = frag["data"]["world_position"][..., :3]
    dist, ldir = _toward(uniforms["point_light_position"], wp)
    diffuse = ml.dot(frag["data"]["world_normal"], ldir).clamp(min=0.25)
    shade = point_shadow_factor(wp, uniforms)
    diffuse = 0.25 + (diffuse - 0.25) * shade
    atten = _range_falloff(dist, uniforms, "point_light_range")
    base = frag["color"] * atlas_sample(frag, uniforms)
    lit = base * (0.1 + 0.9 * (diffuse * atten)[..., None]) \
        * uniforms["point_light_color"]
    return torch.cat([lit[..., :3], base[..., 3:4]], dim=-1)


def spot_light_camera(position, direction, outer_angle, near=0.05,
                      far=100.0, device=None):
    """(view, proj) of a spot light: a perspective camera at the light
    looking along the cone axis, FOV 2·outer_angle (the cone fills the
    frustum)."""
    lp, d, outer = _f32s(device, position, direction, outer_angle)
    dev = lp.device
    d = ml.normalize(d)
    view = ml.look_at(lp, lp + d, _light_up(d))
    proj = ml.perspective_fov(2.0 * outer, _constant(1.0, dev),
                              _scalar(near, dev), _scalar(far, dev))
    return view, proj


def spot_shadowed_fragment_shader(frag: Dict, uniforms: Dict
                                  ) -> torch.Tensor:
    """The game's textured surface lit by one spot light: smoothstep cone
    falloff × range falloff × shadow-map occlusion (uniforms
    spot_position, spot_direction, spot_inner, spot_outer (radians),
    spot_color, spot_range and the map's)."""
    wp = frag["data"]["world_position"][..., :3]
    sdir = ml.normalize(uniforms["spot_direction"])
    dist, ldir = _toward(uniforms["spot_position"], wp)
    diffuse = ml.dot(frag["data"]["world_normal"], ldir).clamp(min=0.25)
    shade = shadow_factor(wp, uniforms)
    diffuse = 0.25 + (diffuse - 0.25) * shade
    cos_angle = ml.dot(-ldir, sdir)
    ci = torch.cos(uniforms["spot_inner"])
    co = torch.cos(uniforms["spot_outer"])
    t = ((cos_angle - co) / torch.where(ci == co, 1.0, ci - co)).clamp(0, 1)
    cone = smoothstep01(t)
    atten = _range_falloff(dist, uniforms, "spot_range")
    base = frag["color"] * atlas_sample(frag, uniforms)
    lit = base * (0.1 + 0.9 * (diffuse * cone * atten)[..., None]) \
        * uniforms["spot_color"]
    return torch.cat([lit[..., :3], base[..., 3:4]], dim=-1)


# The JAX shaders' registries, the same values.
for _fs in (shadowed_scene_fragment_shader, point_shadowed_fragment_shader,
            spot_shadowed_fragment_shader):
    _fs.varyings = ("color", "uv", "data.world_normal",
                    "data.world_position")
    _fs.tri_extras = ("tex_oy", "tex_ox", "tex_h", "tex_w")
del _fs
