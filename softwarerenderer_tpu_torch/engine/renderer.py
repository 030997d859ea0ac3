"""Frame engine: packed scene + camera -> one frame on the device.

Counterpart of ``softwarerenderer_tpu/engine/renderer.py`` (and, through
``Engine(frame_fn=...)``, of any frame function such as
``ops.raytrace.render_frame_raytraced``): camera and frustum culling,
vertex shading, near clip and setup, then the route ``render_frame``
picks as JAX's ``_dispatch`` does:

  * the OVERDRAW and DEPTH debug views (ops.debugviz); WIREFRAME through
    the deferred wireframe, or the forward route under EQUAL / NOT_EQUAL
    or with ``deferred=False``;
  * ``deferred=False``, EQUAL or NOT_EQUAL: the exact forward route
    (ops.forward);
  * binned LESS_EQUAL frames with ``kbuffer > 1``: the depth-peeled
    K-buffer (K tile-kernel passes and a submission-order replay),
    whatever ``use_pallas`` says; binned frames with ``kbuffer > 1``
    under the other monotone depth tests: the K-slot K-buffer
    (ops.kbuffer, K rounds of the binned fold and the same replay);
  * binned LESS_EQUAL frames with ``use_pallas=True`` (the default): the
    opaque tile route (the tile kernel's fold, resolve and interpolation,
    one full-frame shading pass, blend);
  * every other frame: the deferred route (ops.raster.render_deferred),
    whose visibility pass is the visibility-fold kernel for binned
    LESS_EQUAL frames (``use_pallas=False``), the binned fold for the
    other monotone depth tests and the brute force with ``binned=False``
    (which ignores ``kbuffer``, as JAX's does);

and ``to_rgb8`` for present.  Around the route, as in JAX's
render_frame: ``ssaa=f`` renders the frame at f× in each axis and
box-filters it down; the post chain (``params.post_fx``: the sky
panorama, SSAO, bloom, tone mapping, FXAA and callable stages, in the
order given) runs on the finished frame; ``use_mipmaps`` picks each
triangle's mip (two and a fraction for "trilinear") in ``frame_setup``.
The vertex and fragment shaders are arguments, the game's by default
(``scene_fragment_shader_bilinear`` and ``_trilinear`` filter the
atlas); ``fb=(color, depth)`` seeds the framebuffer, so passes stack.
``render_frame_with_shadows``,
``render_frame_with_point_shadows`` and ``render_frame_with_spot_shadow``
run one or six depth-only light passes (ops.shadows) and then
render_frame with the maps in the uniforms.  PyTorch runs it eagerly; the
scene stays on the device and the host uniforms cross in one copy a
dtype.

Before the geometry, ``frame_setup`` runs the per-frame vertex updates
(``apply_vertex_updates``: tangents, flip-book frames, morph targets,
skinning, particle billboards) and ANDs each mesh's LOD level
(``ops.lod``) into the frustum-cull mask; the shadowed frames pose once
(``posed_geometry``) and share the pose with their light passes.

The capacity caps act in ``frame_setup`` as in JAX's render_frame:
``geom_cap`` before the geometry, ``active_cap`` after it, ``pair_cap``
in the binning every binned route runs and ``global_cap`` in the tile
kernels' inputs; ``active_cap_stats`` returns their counters as a third
value.  ``Engine`` runs a scene with LOD levels at the scene's LOD bound
as ``geom_cap`` where the caller sets none (exact: one level a mesh);
render_frame and frame_setup apply only the caps they are given.
``shade_rate`` shades every r-th row on the opaque tile route.
``render_frame_multiview`` (split screen) and ``render_frame_pip`` (an
inset of a second camera) render each view as a render_frame, and
``Engine(rtt_passes=...)`` renders to texture first (engine.rtt).  A
fragment shader's ``tri_extras`` prunes the channels frame_setup packs; a
name it does not pack is dropped, as JAX's render_frame drops it, and a
shader that reads such a channel fails with a KeyError in both packages.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch
from softwarerenderer_tpu_torch.utils.profiling import span

from softwarerenderer_tpu_torch.config import (BlendMode, DebugMode,
                                               DepthTest, RenderParams)
from softwarerenderer_tpu_torch import shaders
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.models.scene import MAX_MIP_LEVELS
from softwarerenderer_tpu_torch.ops import (binning, bloom, culling,
                                            debugviz, forward, fxaa,
                                            geometry, kbuffer, lighting, lod,
                                            morph, raster, shadows, skinning,
                                            sky, ssao, tonemap)
from softwarerenderer_tpu_torch.ops import texture as tex_ops
from softwarerenderer_tpu_torch.ops import tile_raster
from softwarerenderer_tpu_torch.sim import particles
from softwarerenderer_tpu_torch.utils import mathlib as ml
from softwarerenderer_tpu_torch.utils.staging import upload

F32 = torch.float32


# The game's vertex shader over a packed scene, whose uniforms["model"]
# holds (V, 4, 4) per-vertex model matrices: JAX's scene_vertex_shader,
# which computes what shaders.default_vertex_shader does.
scene_vertex_shader = shaders.default_vertex_shader


def scene_fragment_shader(frag: Dict, uniforms: Dict) -> torch.Tensor:
    """Texture(atlas) × vertex color, half-Lambert max(0.25, N·-L),
    smoothstep fog on clip-space z, alpha unfogged (Renderer.cs:848-860)."""
    return shaders.lit_and_fogged(frag, uniforms,
                                  shaders.atlas_sample(frag, uniforms))


# The same registries as the JAX shader: the varyings it reads (the rest
# are pruned from the payload), the per-triangle channels it samples
# through, and where its alpha comes from; and the port's own, its fused
# form on the tile route (ops/tile_shade.py: the texel fetch the shading
# kernel runs for it).
scene_fragment_shader.varyings = ("color", "uv", "data.world_normal")
scene_fragment_shader.tri_extras = ("tex_oy", "tex_ox", "tex_h", "tex_w")
scene_fragment_shader.alpha_sources = ("color", "texture")
scene_fragment_shader.tile_shade = "nearest_region"


def scene_fragment_shader_bilinear(frag: Dict,
                                   uniforms: Dict) -> torch.Tensor:
    """scene_fragment_shader with bilinear filtering of the texture's
    base level, its region looked up by tex_id in the atlas tables (as
    JAX's bilinear shader does, with or without use_mipmaps)."""
    tex = tex_ops.sample_atlas_bilinear(
        uniforms["atlas_data"], uniforms["atlas_offsets"],
        uniforms["atlas_sizes"], frag["tri"]["tex_id"], frag["uv"])
    return shaders.lit_and_fogged(frag, uniforms, tex)


def scene_fragment_shader_trilinear(frag: Dict,
                                    uniforms: Dict) -> torch.Tensor:
    """Trilinear filtering: bilinear in each of the triangle's two mip
    regions (tex_* and tex_*2), mixed by its 8-bit mip fraction; for
    RenderParams(use_mipmaps="trilinear")."""
    tri, atlas, uv = frag["tri"], uniforms["atlas_data"], frag["uv"]
    t0 = tex_ops.sample_atlas_region_bilinear(
        atlas, tri["tex_oy"], tri["tex_ox"], tri["tex_h"], tri["tex_w"], uv)
    t1 = tex_ops.sample_atlas_region_bilinear(
        atlas, tri["tex_oy2"], tri["tex_ox2"], tri["tex_h2"], tri["tex_w2"],
        uv)
    a = tri["mip_frac256"].to(F32)[..., None] / 256.0
    return shaders.lit_and_fogged(frag, uniforms, t0 + (t1 - t0) * a)


scene_fragment_shader_bilinear.varyings = scene_fragment_shader.varyings
scene_fragment_shader_bilinear.tri_extras = (
    "tex_id", "tex_oy", "tex_ox", "tex_h", "tex_w")
scene_fragment_shader_bilinear.alpha_sources = ("color", "texture")
scene_fragment_shader_trilinear.varyings = scene_fragment_shader.varyings
scene_fragment_shader_trilinear.tri_extras = (
    "tex_oy", "tex_ox", "tex_h", "tex_w",
    "tex_oy2", "tex_ox2", "tex_h2", "tex_w2", "mip_frac256")
scene_fragment_shader_trilinear.alpha_sources = ("color", "texture")
scene_fragment_shader_trilinear.tile_shade = "trilinear_regions"


def opaque_tri_flags(scene: Dict[str, torch.Tensor], vin: Dict,
                     fragment_shader: Callable, params: RenderParams,
                     indices: Optional[torch.Tensor] = None,
                     tri_texture_id: Optional[torch.Tensor] = None
                     ) -> Optional[torch.Tensor]:
    """Per-triangle 'semantically opaque' flags for the K-buffer peel's
    short-circuit, int32 ×2 for the clipper's fan slots, or None when
    unprovable (JAX's opaque_tri_flags).

    A triangle is flagged when the shader's alpha_sources evaluate to
    exactly 1 from pack-time data: "color" = all three vertex alphas are 1,
    "texture" = the texture's pack-time min alpha (scene["tex_min_alpha"])
    is 1.  None unless blend_mode is ALPHA and the shader declares
    alpha_sources (NONE blending stops on shaded alpha alone; ADDITIVE and
    MULTIPLY never stop).  indices and tri_texture_id: the frame's
    triangles when they are not the scene's (geom_cap's compaction)."""
    srcs = getattr(fragment_shader, "alpha_sources", None)
    if srcs is None or params.blend_mode != BlendMode.ALPHA:
        return None
    idx = (scene["indices"] if indices is None else indices) \
        .reshape(-1, 3).long()
    tid = scene["tri_texture_id"] if tri_texture_id is None \
        else tri_texture_id
    opq = torch.ones(idx.shape[0], dtype=torch.bool, device=idx.device)
    if "color" in srcs:
        a = vin["color"][:, 3][idx]                       # (T, 3)
        opq &= (a.amin(1) == 1.0) & (a.amax(1) == 1.0)
    if "texture" in srcs:
        if "tex_min_alpha" not in scene:
            return None
        opq &= scene["tex_min_alpha"][tid.long()] >= 1.0
    return opq.to(torch.int32).repeat_interleave(2)


def default_frame_uniforms(width: int, height: int) -> Dict:
    """Per-frame parameters with the reference game's defaults
    (Renderer.cs:34-46, 74, 406-413), as numpy values."""
    ld = np.asarray([0.5, -1.0, -0.3], np.float32)
    return {
        "camera_position": np.zeros(3, np.float32),
        "camera_rotation": np.asarray([0.0, 0.0, 0.0, 1.0], np.float32),
        "fov_degrees": np.float32(90.0),
        "near_clip": np.float32(0.1),
        "far_clip": np.float32(1000.0),
        "light_direction": ld / np.linalg.norm(ld),
        "light_color": np.ones(4, np.float32),
        "fog_color": np.asarray([0.45, 0.64, 0.76, 1.0], np.float32),
        "fog_start": np.float32(40.0),
        "fog_end": np.float32(100.0),
        "clear_color": np.asarray([0.45, 0.64, 0.76, 1.0], np.float32),
    }


def _f32(x, device=None) -> torch.Tensor:
    """A uniform as a float32 tensor: on the host, or on `device` (a
    tensor is moved, a host value copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    t = torch.from_numpy(np.array(x, dtype=np.float32))
    return t if device is None else t.to(device)


@functools.lru_cache(maxsize=None)
def _camera_axes(device) -> tuple:
    """The camera's local front and up axes, once per device."""
    return _f32([0.0, 0.0, -1.0], device), _f32([0.0, 1.0, 0.0], device)


def _camera_device(uniforms: Dict):
    """Where the camera is computed: the device of a camera_position
    tensor (a simulation's pose, never read back), else the host (None)."""
    pos = uniforms["camera_position"]
    return pos.device if isinstance(pos, torch.Tensor) else None


def _fov_radians(uniforms: Dict, device=None) -> torch.Tensor:
    return _f32(uniforms["fov_degrees"], device) \
        * float(np.float32(np.pi / 180.0))


def camera_matrices(uniforms: Dict, width: int, height: int):
    """View from position + quaternion (Camera.cs:12-26) and the .NET
    perspective from the live FOV (Renderer.cs:406-410), computed as
    float32 tensors on the host, or on the device of a camera_position
    tensor (the other camera uniforms then best live there too)."""
    dev = _camera_device(uniforms)
    pos = _f32(uniforms["camera_position"], dev)
    rot = _f32(uniforms["camera_rotation"], dev)
    front_axis, up_axis = _camera_axes(dev)
    front = ml.quat_rotate(front_axis, rot)
    up = ml.quat_rotate(up_axis, rot)
    view = ml.look_at(pos, pos + front, up)
    fov = _fov_radians(uniforms, dev)
    aspect = torch.full((), float(np.float32(width) / np.float32(height)),
                        dtype=torch.float32, device=dev)
    proj = ml.perspective_fov(fov, aspect, _f32(uniforms["near_clip"], dev),
                              _f32(uniforms["far_clip"], dev))
    return view, proj


# The camera and shading uniforms every frame reads on the device
# (tan_half_fov for the LOD levels, computed on the host like the camera).
_DEVICE_UNIFORMS = (("view", (4, 4)), ("projection", (4, 4)),
                    ("tan_half_fov", ()), ("camera_position", (3,)),
                    ("light_direction", (3,)), ("light_color", (4,)),
                    ("fog_color", (4,)), ("clear_color", (4,)),
                    ("fog_start", ()), ("fog_end", ()), ("near_clip", ()))


# Uniforms the host reads (the camera) or render_frame applies itself; any
# other key the caller adds (a shader's texture, say) goes to the shaders
# as device tensors.
_HOST_UNIFORMS = frozenset(("camera_position", "camera_rotation",
                            "fov_degrees", "far_clip", "mesh_visible"))


def _host_array(v) -> np.ndarray:
    """A host uniform as the array the device gets (float64 as float32,
    the JAX package's default precision)."""
    a = np.asarray(v)
    return a.astype(np.float32) if a.dtype == np.float64 else a


def _to_device(v, device):
    """A uniform, or a dict of them, as device tensors."""
    if isinstance(v, dict):
        return {k: _to_device(x, device) for k, x in v.items()}
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.from_numpy(np.ascontiguousarray(_host_array(v))).to(device)


def on_device(x, dtype, device, name: str) -> torch.Tensor:
    """x as a `dtype` tensor on `device`: a tensor already there as it is,
    anything else moved in the span `name` (a host value's move to a card
    waits for it)."""
    if isinstance(x, torch.Tensor) and x.device == torch.device(device):
        return x.to(dtype)
    with span(name):
        return torch.as_tensor(x, dtype=dtype, device=device)


def device_uniforms(uniforms: Dict, width: int, height: int,
                    device, staged: bool = False) -> Dict[str, torch.Tensor]:
    """The uniforms the frame reads on the device: the camera matrices,
    the shading uniforms and every other key the caller added (a shader's
    lights or texture, say).  Host arrays move in one host->device copy a
    dtype, as each copy waits for the device, or with `staged` in one
    pinned copy that does not wait (_stage); tensors and dicts move as
    they are."""
    view, proj = camera_matrices(uniforms, width, height)
    cam_dev = _camera_device(uniforms)
    tan_half = torch.tan(_fov_radians(uniforms, cam_dev) * 0.5)
    if cam_dev is None:
        view, proj, tan_half = view.numpy(), proj.numpy(), tan_half.numpy()
    host = dict(uniforms, view=view, projection=proj, tan_half_fov=tan_half)
    f32 = {k: (host[k].to(torch.float32) if isinstance(host[k], torch.Tensor)
               else np.asarray(host[k], np.float32)).reshape(shape)
           for k, shape in _DEVICE_UNIFORMS}
    move = _stage if staged else _upload
    return move({**f32, **{k: v for k, v in uniforms.items()
                          if k not in f32 and k not in _HOST_UNIFORMS}},
                device, "sync.uniforms")


def post_uniforms(uniforms: Dict, device) -> Dict[str, torch.Tensor]:
    """The caller's uniforms as the post chain reads them (a callable
    stage gets them as its third argument): every key but mesh_visible
    as device tensors, staged (_stage), so the chain is issued while the
    frame under it still runs."""
    return _stage({k: v for k, v in uniforms.items()
                   if k != "mesh_visible"}, device, "sync.post_uniforms")


def _stage(uniforms: Dict, device, name: str) -> Dict[str, torch.Tensor]:
    """_upload's tensors, the host arrays in one pinned copy that does not
    wait for the card (utils.staging.upload); tensors and dicts move as
    they are, in the span `name` (a host tensor's move waits)."""
    host = {k: v for k, v in uniforms.items()
            if not isinstance(v, (torch.Tensor, dict))}
    moved = {}
    if len(host) < len(uniforms):
        with span(name):
            moved = {k: _to_device(v, device) for k, v in uniforms.items()
                     if k not in host}
    staged = upload(host, device)
    return {k: moved[k] if k in moved else staged[k] for k in uniforms}


def _upload(uniforms: Dict, device, name: str) -> Dict[str, torch.Tensor]:
    """Host arrays as device tensors in one host->device copy a dtype;
    tensors and dicts move as they are.  The moves run in the span `name`:
    a pageable copy to a card waits for it."""
    groups, moved = {}, {}
    for k, v in uniforms.items():
        if isinstance(v, (torch.Tensor, dict)):
            moved[k] = v
        else:
            a = _host_array(v)
            groups.setdefault(a.dtype, {})[k] = a
    host = [torch.from_numpy(np.concatenate(
        [a.reshape(-1) for a in arrays.values()]))
        for arrays in groups.values()]
    with span(name):
        u = {k: _to_device(v, device) for k, v in moved.items()}
        copies = [h.to(device) for h in host]
    for arrays, packed in zip(groups.values(), copies):
        off = 0
        for k, a in arrays.items():
            u[k] = packed[off:off + a.size].reshape(a.shape)
            off += a.size
    return u


# The per-triangle channels frame_setup packs for a fragment shader's
# `tri_extras` ("opq" rides along for the K-buffer's short-circuit): ids
# and atlas regions, and the PBR material channels, each quantised to
# 1/256 (scene key of the table, column or None).
MATERIAL_TRI_EXTRAS = {
    "mat_m256": ("mesh_metallic", None), "mat_r256": ("mesh_roughness", None),
    "mat_er256": ("mesh_emissive", 0), "mat_eg256": ("mesh_emissive", 1),
    "mat_eb256": ("mesh_emissive", 2), "mat_br256": ("base_color", 0),
    "mat_bg256": ("base_color", 1), "mat_bb256": ("base_color", 2)}
# The mip regions use_mipmaps packs: the region of the triangle's mip
# (tex_* then name it), and for "trilinear" the next mip's and the 8-bit
# fraction between the two.
MIP_TRI_EXTRAS = ("tex_oy2", "tex_ox2", "tex_h2", "tex_w2", "mip_frac256")
# The normal map's region (ops.normalmap), with tri_normal_tex_id in the
# scene.
NORMAL_MAP_TRI_EXTRAS = ("nm_oy", "nm_ox", "nm_h", "nm_w")
PACKED_TRI_EXTRAS = ("tex_id", "mesh_id", "tex_oy", "tex_ox", "tex_h",
                     "tex_w") + tuple(MATERIAL_TRI_EXTRAS) + MIP_TRI_EXTRAS \
    + NORMAL_MAP_TRI_EXTRAS


def enabled_post_fx(params: RenderParams, uniforms: Dict) -> tuple:
    """The params.post_fx entries whose switches are on, in order (JAX's
    _enabled_post_fx): "sky" when uniforms hold "sky_panorama", "ssao",
    "bloom", "tonemap" and "fxaa" by their flags, callables always.  An
    unknown name, or a switch that is on while its name is absent, is a
    ValueError."""
    on = {"sky": "sky_panorama" in uniforms,
          "ssao": bool(params.ssao),
          "bloom": bool(params.bloom),
          "tonemap": bool(params.tonemap),
          "fxaa": bool(params.fxaa)}
    names = [f for f in params.post_fx if isinstance(f, str)]
    unknown = [f for f in names if f not in on]
    if unknown:
        raise ValueError(f"unknown post_fx entries {unknown!r}; "
                         f"valid: {sorted(on)} or a callable "
                         "(color, depth, uniforms) -> (color, depth)")
    for f in on:
        if on[f] and f not in names:
            raise ValueError(f"post-fx {f!r} is enabled but absent from "
                             f"params.post_fx {params.post_fx!r}")
    return tuple(f for f in params.post_fx
                 if not isinstance(f, str) or on[f])


def tile_route(params: RenderParams) -> bool:
    """True when render_frame takes the opaque tile route (the tile
    kernel's fold, one shading pass): binned deferred LESS_EQUAL frames
    with use_pallas, no debug view and kbuffer <= 1.  The counterpart of
    JAX's _pallas_route for shade_rate, which only that route
    implements."""
    return (params.use_pallas and params.deferred and params.binned
            and params.debug_mode == DebugMode.NONE
            and params.depth_test == DepthTest.LESS_EQUAL
            and params.kbuffer <= 1)


def check_supported(params: RenderParams, uniforms=None):
    """Raise JAX's ValueErrors: an unknown or absent post_fx entry,
    kbuffer_stats without a binned deferred K-buffer, kbuffer_stats or
    active_cap_stats with ssaa or post-FX (their stats are a third return
    value the wrappers do not pass on), and shade_rate > 1 off the opaque
    tile route (tile_route)."""
    wrapped = params.ssaa > 1 or bool(enabled_post_fx(params,
                                                      uniforms or {}))
    if params.kbuffer_stats and (wrapped or params.kbuffer <= 1 or not (
            params.binned and params.deferred)):
        raise ValueError("kbuffer_stats needs kbuffer > 1 on the binned "
                         "deferred route and no ssaa/post-fx (the stats "
                         "dict is the K-buffer's third return value)")
    if params.active_cap_stats and wrapped:
        raise ValueError("active_cap_stats needs no ssaa/post-fx (the "
                         "stats dict is a third return value)")
    if params.shade_rate > 1 and not tile_route(params):
        raise ValueError("shade_rate > 1 is implemented on the opaque tile "
                         "route only (use_pallas deferred binned "
                         "LESS_EQUAL, kbuffer <= 1): elsewhere it would "
                         "shade at full rate")


def quantize256(x: torch.Tensor) -> torch.Tensor:
    """A material value as an 8-bit-step int32 channel: round(x · 256),
    half to even as JAX's, clipped to [0, 1020]."""
    return torch.round(x.to(F32) * 256.0).clamp(0, 1020).to(torch.int32)


def _mip_index(x: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """int32(x) clipped to [0, hi], x >= 0 or NaN: XLA's cast maps NaN to
    0 and saturates, torch's gives the CPU's and CUDA's own values, so x
    is clipped as a float first (NaN as 0) and cast after."""
    return torch.minimum(torch.nan_to_num(x, nan=0.0).clamp(min=0.0),
                         hi.to(F32)).to(torch.int32)


def mip_regions(scene: Dict[str, torch.Tensor], indices: torch.Tensor,
                inv_area: torch.Tensor, tid2: torch.Tensor,
                trilinear: bool) -> Dict:
    """JAX render_frame's per-triangle LOD, per clip-fan slot: lod = 0.5 ·
    log2(max(|uv cross| · texels · |inv_area|, 1)), the texel-per-pixel
    ratio of the slot's own screen area; the region of mip int(lod + 0.5),
    or with `trilinear` the regions of mips floor(lod) and the next one
    (tex_*2) and the fraction round(frac · 256) between them.  A slot whose
    lod + 0.5 lands within an ulp of an integer may pick the neighbouring
    mip on another device (log2 differs by an ulp between libraries).
    indices: the frame's triangles (the scene's, or geom_cap's compacted
    prefix), tid2 their texture ids, x2 for the fan slots."""
    uvb = scene["uv"].to(F32)
    idx = indices.reshape(-1, 3).long()
    e1 = uvb[idx[:, 1]] - uvb[idx[:, 0]]
    e2 = uvb[idx[:, 2]] - uvb[idx[:, 0]]
    uv_cross = (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]).abs()
    asiz = scene["atlas_sizes"]
    texels = (asiz[:, 0] * asiz[:, 1]).to(F32)[tid2[::2]]
    uv2 = (uv_cross * texels).repeat_interleave(2)
    lod = 0.5 * torch.log2((uv2 * inv_area.abs()).clamp(min=1.0))
    top = scene["atlas_n_mips"].long()[tid2] - 1
    moff = scene["atlas_mip_offsets"].reshape(-1, 2)
    msiz = scene["atlas_mip_sizes"].reshape(-1, 2)

    def region(mip, suffix=""):
        flat = tid2 * MAX_MIP_LEVELS + mip
        return {"tex_oy" + suffix: moff[:, 0][flat],
                "tex_ox" + suffix: moff[:, 1][flat],
                "tex_h" + suffix: msiz[:, 0][flat],
                "tex_w" + suffix: msiz[:, 1][flat]}
    if not trilinear:
        return region(_mip_index(lod + 0.5, top))
    floor = torch.floor(lod)
    mip0 = _mip_index(floor, top)
    mip1 = torch.minimum(mip0 + 1, top.to(torch.int32))
    frac = torch.where(mip1 > mip0, lod - floor, 0.0)
    frac256 = _mip_index(torch.round(frac * 256.0),
                         torch.full_like(top, 255))
    return {**region(mip0), **region(mip1, "2"), "mip_frac256": frac256}


def apply_vertex_updates(vin: Dict, scene: Dict[str, torch.Tensor],
                         uniforms: Dict, view: torch.Tensor) -> Dict:
    """The per-frame vertex updates every raster path runs, in JAX's
    order, each a copy (the scene's buffers are never written): the
    tangents (ops.normalmap), each flip-book mesh's frame
    uniforms["anim_frame"] (scalar or one a mesh, floor modulo its frame
    count), the morph targets (ops.morph), skinning (ops.skinning) and,
    with uniforms["particle_centers"], the particle billboards facing
    `view` (sim.particles).  uniforms are the frame's device uniforms."""
    vin = dict(vin)
    if "tangent" in scene:
        vin["tangent"] = scene["tangent"]
    if "anim_positions" in scene:
        nf = scene["anim_n_frames"]
        af = torch.as_tensor(uniforms.get("anim_frame", 0), device=nf.device)
        af = torch.atleast_1d(af.to(torch.int32)).expand(nf.shape[0])
        fv = torch.remainder(af, nf)[scene["anim_slot"].long()].long()
        va = torch.arange(fv.shape[0], device=nf.device)
        vidx = scene["anim_vert_index"].long()
        vin["position"] = vin["position"].index_put(
            (vidx,), scene["anim_positions"][fv, va])
        vin["normal"] = vin["normal"].index_put(
            (vidx,), scene["anim_normals"][fv, va])
    if "morph_vert_index" in scene:
        vin = morph.apply_morphs(vin, scene, uniforms)
    if "skin_joints" in scene:
        vin = skinning.apply_skinning(vin, scene, uniforms)
    if "particle_vert_index" in scene and "particle_centers" in uniforms:
        vin = particles.apply_billboards(vin, scene, uniforms, view)
    return vin


def frame_vertices(scene: Dict[str, torch.Tensor], u: Dict) -> Dict:
    """The frame's vertex inputs (position, uv, normal, color and, with a
    normal map, tangent) after apply_vertex_updates, the billboards facing
    the camera of the device uniforms u (device_uniforms)."""
    vin = {k: scene[k] for k in ("position", "uv", "normal", "color")}
    with span("frame.vertex_updates"):
        return apply_vertex_updates(vin, scene, u, u["view"])


def posed_geometry(scene: Dict[str, torch.Tensor], u: Dict,
                   height: int) -> Dict:
    """What a frame draws, computed once a frame and shared by its main
    pass and its light passes: {"vin": frame_vertices(scene, u),
    "tri_mask": each triangle's active LOD level for a frame `height`
    pixels high, None when the scene has no levels}.  u: the main
    camera's device uniforms (device_uniforms)."""
    posed = {"vin": frame_vertices(scene, u), "tri_mask": None}
    if "tri_lod_level" in scene:
        with span("frame.camera_cull"):
            posed["tri_mask"] = lod.lod_tri_mask(scene, u, height)
    return posed


def frame_setup(scene: Dict[str, torch.Tensor], uniforms: Dict,
                params: RenderParams,
                vertex_shader: Callable = scene_vertex_shader,
                fragment_shader: Callable = scene_fragment_shader,
                fb: Optional[tuple] = None,
                posed: Optional[Dict] = None, staged: bool = False) -> Dict:
    """Everything a route takes for one frame: {"tris": the set-up
    triangles, "uniforms": the device uniforms the shaders read,
    "per_tri": the per-triangle extras, "fb_color" and "fb_depth": the
    framebuffer, fb = (color (H, W, 4), depth (H, W)) or cleared,
    "overflow": the capacity caps' dropped counts, 0-d int32 device
    tensors by stats name ("geom_cap_overflow", "active_cap_overflow")
    for the caps that are set}.  render_frame routes them; a caller may
    hand them to another route of ops.tile_raster or ops.raster.  posed:
    what the caller computed of the frame's geometry (posed_geometry at
    params.height); a missing entry is computed here.  A scene with a
    "tri_valid" entry (parallel.shard_scene_triangles' mask of real
    triangles) draws only those.  staged: the uniforms' host arrays cross
    without waiting for the card (device_uniforms), for a caller that
    paces the host itself (post_chained).

    The caps, as JAX's render_frame applies them: params.geom_cap
    compacts the masked-in input triangles (and their texture, mesh and
    normal-map ids) before the geometry (geometry.precompact_inputs);
    params.active_cap compacts the valid fan slots and their extras after
    it (geometry.compact_triangles).  Both keep submission order, so the
    frame is the uncapped one while the caps hold."""
    H, W = params.height, params.width
    dev = scene["position"].device
    with span("frame.camera_cull"):
        u = device_uniforms(uniforms, W, H, dev, staged)
        view_proj = ml.transform(u["view"], u["projection"])     # V·P
        visible = culling.spheres_in_frustum(
            scene["bounds_center"], scene["bounds_radius"],
            scene["mesh_matrices"], view_proj)
        if "mesh_visible" in uniforms:
            visible = visible & on_device(uniforms["mesh_visible"],
                                          torch.bool, dev,
                                          "sync.mesh_visible")
        tri_mesh = scene["tri_mesh_id"].long()
        tri_mask = visible[tri_mesh]
    posed = posed or {}
    vin = posed.get("vin")
    if vin is None:
        vin = frame_vertices(scene, u)
    if "tri_lod_level" in scene:
        lod_mask = posed.get("tri_mask")
        with span("frame.camera_cull"):
            if lod_mask is None:
                lod_mask = lod.lod_tri_mask(scene, u, H)
            tri_mask = tri_mask & lod_mask
    if "tri_valid" in scene:
        tri_mask = tri_mask & scene["tri_valid"]
    # The per-input-triangle tensors every later stage reads; geom_cap
    # swaps them for their compacted prefix.
    indices = scene["indices"]
    tri_tex = scene["tri_texture_id"].long()
    tri_ntex = (scene["tri_normal_tex_id"].long()
                if "tri_normal_tex_id" in scene else None)
    overflow = {}
    if params.geom_cap:
        with span("frame.geom_cap"):
            pt = {"tex": tri_tex, "mesh": tri_mesh}
            if tri_ntex is not None:
                pt["ntex"] = tri_ntex
            tri_mask, indices, pt, overflow["geom_cap_overflow"] = \
                geometry.precompact_inputs(tri_mask, params.geom_cap,
                                           indices, pt)
            tri_tex, tri_mesh, tri_ntex = pt["tex"], pt["mesh"], pt.get(
                "ntex")
    with span("frame.geometry"):
        u.update(model=culling.model_matrices_per_vertex(scene),
                 atlas_data=scene["atlas_data"],
                 atlas_offsets=scene["atlas_offsets"],
                 atlas_sizes=scene["atlas_sizes"])
        tris = geometry.build_triangles(
            vertex_shader, vin, indices, u, width=W, height=H,
            cull_mode=params.cull_mode, tri_mask=tri_mask,
            keep_varyings=getattr(fragment_shader, "varyings", None))

    # Per-triangle material channels, ×2 for the clipper's fan slots, as
    # JAX's render_frame packs them: texture and mesh ids and the atlas
    # regions, resolved per triangle so the shader's only per-pixel memory
    # access is the texel fetch, and with "mesh_metallic" in the scene the
    # PBR channels; pruned to the shader's `tri_extras` (the material
    # channels are computed only when kept).
    with span("frame.extras"):
        keep = getattr(fragment_shader, "tri_extras", None)
        tid2 = tri_tex.repeat_interleave(2)
        mid2 = tri_mesh.repeat_interleave(2)
        aoff, asiz = scene["atlas_offsets"], scene["atlas_sizes"]
        per_tri = {"tex_id": tid2, "mesh_id": mid2,
                   "tex_oy": aoff[:, 0][tid2], "tex_ox": aoff[:, 1][tid2],
                   "tex_h": asiz[:, 0][tid2], "tex_w": asiz[:, 1][tid2]}
        if tri_ntex is not None:
            nid2 = tri_ntex.repeat_interleave(2)
            per_tri.update(nm_oy=aoff[:, 0][nid2], nm_ox=aoff[:, 1][nid2],
                           nm_h=asiz[:, 0][nid2], nm_w=asiz[:, 1][nid2])
        if "mesh_metallic" in scene:
            for k, (table, col) in MATERIAL_TRI_EXTRAS.items():
                if keep is None or k in keep:
                    t = scene[table] if col is None else scene[table][:, col]
                    per_tri[k] = quantize256(t[mid2])
        if params.use_mipmaps and "atlas_mip_offsets" in scene:
            per_tri.update(mip_regions(scene, indices, tris["inv_area"],
                                       tid2,
                                       params.use_mipmaps == "trilinear"))
        if keep is not None:
            per_tri = {k: v for k, v in per_tri.items() if k in keep}
        if params.kbuffer > 1 and params.kbuffer_short_circuit:
            # The opaque flags ride the payload so the peel can stop
            # behind opaque visible winners.
            opq = opaque_tri_flags(scene, vin, fragment_shader, params,
                                   indices, tri_tex)
            if opq is not None:
                per_tri["opq"] = opq

    if params.active_cap:
        with span("frame.active_cap"):
            n_slots = tris["valid"].shape[0]
            tris, per_tri, n_valid = geometry.compact_triangles(
                tris, params.active_cap, per_tri)
            overflow["active_cap_overflow"] = (
                n_valid - min(params.active_cap, n_slots)).clamp(min=0)

    if fb is None:
        fb_color = u["clear_color"].expand(H, W, 4)
        fb_depth = torch.full((H, W), raster.DEPTH_CLEAR, dtype=F32,
                              device=dev)
    else:
        fb_color, fb_depth = (on_device(x, F32, dev, "sync.fb")
                              for x in fb)
    return {"tris": tris, "uniforms": u, "per_tri": per_tri,
            "fb_color": fb_color, "fb_depth": fb_depth,
            "overflow": overflow}


def render_frame(scene: Dict[str, torch.Tensor], uniforms: Dict,
                 params: RenderParams,
                 vertex_shader: Callable = scene_vertex_shader,
                 fragment_shader: Callable = scene_fragment_shader,
                 fold: Optional[Callable] = None,
                 fb: Optional[tuple] = None, posed: Optional[Dict] = None,
                 staged: bool = False):
    """One frame over a packed scene already on the device
    (models.convert.scene_to_torch), drawn with the given shaders over
    fb = (color (H, W, 4), depth (H, W)), the cleared framebuffer by
    default.  Returns (color (H, W, 4) f32, depth (H, W) f32) on the
    scene's device, and a third value with params.kbuffer_stats,
    {"kbuffer_saturated_px": n}, or params.active_cap_stats, {"live_pairs",
    "live_globals" and the "*_overflow" counter of each cap that is set}
    (merged when both are set; 0-d int32 device tensors).  The route is
    the module docstring's; frame_setup applies the capacity caps.

    With params.ssaa = f > 1 the frame renders at f× in each axis (the
    fb seeds replicated f × f) and is box-filtered down, depth taken at
    every f-th sample; the post chain (enabled_post_fx) then runs on
    the supersampled frame.

    fold: the tile fold the tile routes run, tile_raster.tile_fold by
    default; tile_raster.tile_fold_plain renders the same frame through
    the plain twins.  posed: the frame's posed geometry (posed_geometry)
    when the caller shares it with its light passes.  staged: as
    frame_setup's; a frame with a post chain chooses it itself
    (post_chained)."""
    check_supported(params, uniforms)
    shaders_kw = dict(vertex_shader=vertex_shader,
                      fragment_shader=fragment_shader, fold=fold)
    posed = posed or {}
    dev = scene["position"].device
    if params.ssaa > 1:
        f = params.ssaa
        if fb is not None:
            fb = tuple(on_device(x, F32, dev, "sync.fb")
                       .repeat_interleave(f, 0).repeat_interleave(f, 1)
                       for x in fb)
        # The vertices carry over; the LOD levels are the f×-high frame's.
        return supersampled(lambda hi: render_frame(
            scene, uniforms, hi, fb=fb, posed={"vin": posed.get("vin")},
            staged=staged, **shaders_kw), params, dev)
    chain = enabled_post_fx(params, uniforms)
    if chain:
        paced = _paces(uniforms, dev)
        return post_chained(lambda u2, base: render_frame(
            scene, u2, base, fb=fb, posed=posed, staged=paced,
            **shaders_kw), uniforms, params, chain, dev)
    f = frame_setup(scene, uniforms, params, vertex_shader, fragment_shader,
                    fb, posed, staged)
    out = _route(f, fragment_shader, params, fold)
    if not params.active_cap_stats:
        return out
    # The capacity counters (JAX's render_frame): the frame is exact iff
    # every *_overflow is 0; live_pairs and live_globals are always there
    # so a workload can be measured before a cap is chosen.  Device
    # tensors: reading them is the caller's choice of a sync.
    with span("frame.cap_stats"):
        live = binning.live_pair_count(f["tris"], params)
        live_glob = binning.global_count(f["tris"], params)
        stats = {"live_pairs": live, "live_globals": live_glob,
                 **f["overflow"]}
        if params.pair_cap:
            stats["pair_cap_overflow"] = binning.pair_cap_overflow(
                f["tris"], params)
        if params.global_cap:
            stats["global_cap_overflow"] = (live_glob - max(
                params.global_cap, tile_raster.GLOB_RESIDENT)).clamp(min=0)
    if len(out) == 3:
        return out[0], out[1], {**out[2], **stats}
    return out[0], out[1], stats


def supersampled(render: Callable, params: RenderParams, device):
    """The params.ssaa = f frame: render(params at f× in each axis, ssaa
    1) box-filtered down, depth taken at every f-th sample.  The inner
    frame runs in the span frame.ssaa, the filter in frame.ssaa_resolve."""
    f = params.ssaa
    with span("frame.ssaa"):
        color, depth = render(params.replace(width=params.width * f,
                                             height=params.height * f,
                                             ssaa=1))
    with span("frame.ssaa_resolve"):
        H, W = params.height, params.width
        n = torch.full((), float(f * f), device=device)
        color = color.reshape(H, f, W, f, 4).sum((1, 3)) / n
        return color, depth[::f, ::f]


def _holds_host(tree) -> bool:
    """Whether a uniform, or a dict of them, holds a value that is not a
    CUDA tensor (its move to the card waits for it)."""
    if isinstance(tree, dict):
        return any(_holds_host(v) for v in tree.values())
    return not (isinstance(tree, torch.Tensor) and tree.is_cuda)


def _paces(uniforms: Dict, device) -> bool:
    """Whether post_chained paces the host: on a card, where the uniforms
    hold a host value (the frame would wait for their upload anyway)."""
    return torch.device(device).type == "cuda" and _holds_host(uniforms)


def post_chained(render: Callable, uniforms: Dict, params: RenderParams,
                 chain: tuple, device):
    """The post chain (enabled_post_fx) over render(uniforms, params) of
    the base frame: every effect stripped from params (callable stages
    too, or it would recurse); in the sky branch the shaders still see
    the panorama as env_panorama (PBR's reflections).  The chain, with
    its uniforms' upload, runs in the span frame.post, each stage in its
    own post.<stage>.

    Nothing in the chain waits for the card while it is issued.  On a
    card, where the uniforms hold host values (_paces), the host waits
    once, in sync.post_chain, until the second half of the chain (from
    stage len // 2) has begun: the caller's present and the next frame's
    set-up overlap that half, so the card does not wait for the host, and
    the next frame's inputs are read no more than that half ahead of the
    card.  render_frame then stages the base frame's uniforms too, so
    that this is the frame's one wait.  Uniforms all on the card (the
    game's staged ones) keep frames in flight with no wait."""
    base = params.replace(
        tonemap=None, bloom=False, ssao=False, fxaa=False,
        post_fx=tuple(f for f in params.post_fx if isinstance(f, str)))
    u2 = uniforms
    if "sky" in chain:
        u2 = {k: v for k, v in uniforms.items() if k != "sky_panorama"}
        u2["env_panorama"] = uniforms["sky_panorama"]
    color, depth = render(u2, base)
    paced = _paces(uniforms, device)
    last = None
    with span("frame.post"):
        pu = post_uniforms(uniforms, device)
        for i, fx in enumerate(chain):
            if paced and i == len(chain) // 2:
                last = torch.cuda.Event()
                last.record(torch.cuda.current_stream(device))
            with span("post.callable" if callable(fx) else f"post.{fx}"):
                color, depth = apply_post_fx(fx, color, depth, uniforms, pu,
                                             params)
        if last is not None:
            with span("sync.post_chain"):
                last.synchronize()
    return color, depth


def _route(f: Dict, fragment_shader: Callable, params: RenderParams,
           fold: Optional[Callable]):
    """frame_setup's frame through the route the module docstring gives."""
    args = (f["tris"], fragment_shader, f["uniforms"], params,
            f["fb_color"], f["fb_depth"])
    order_dependent = params.depth_test in (DepthTest.EQUAL,
                                            DepthTest.NOT_EQUAL)
    if params.debug_mode == DebugMode.OVERDRAW:
        return debugviz.render_overdraw(f["tris"], params)
    if params.debug_mode == DebugMode.DEPTH:
        return debugviz.render_depth_view(f["tris"], params, f["fb_depth"])
    if params.debug_mode == DebugMode.WIREFRAME and params.deferred \
            and not order_dependent:
        return raster.render_wireframe_deferred(*args,
                                                per_tri_extra=f["per_tri"])
    if params.debug_mode == DebugMode.WIREFRAME or not params.deferred \
            or order_dependent:
        return forward.render_forward(*args, per_tri_extra=f["per_tri"])
    less_equal = params.depth_test == DepthTest.LESS_EQUAL
    if params.binned and params.kbuffer > 1:
        if less_equal:
            return tile_raster.render_tile_kbuffer(
                *args, per_tri_extra=f["per_tri"], fold=fold,
                with_stats=params.kbuffer_stats)
        return kbuffer.render_binned_kbuffer(
            *args, per_tri_extra=f["per_tri"],
            with_stats=params.kbuffer_stats)
    if params.binned and less_equal and params.use_pallas:
        return tile_raster.render_tile(*args, per_tri_extra=f["per_tri"],
                                       fold=fold)
    return raster.render_deferred(*args, per_tri_extra=f["per_tri"])


def apply_post_fx(fx, color: torch.Tensor, depth: torch.Tensor,
                  uniforms: Dict, post_u: Dict[str, torch.Tensor],
                  params: RenderParams):
    """One post stage over the frame (JAX's _apply_post_fx): a callable
    gets (color, depth, post_u) and may return color alone; the named
    stages read the device uniforms post_u, the sky its camera from the
    host uniforms."""
    if callable(fx):
        out = fx(color, depth, post_u)
        return out if isinstance(out, tuple) else (out, depth)
    if fx == "sky":
        return sky.composite_sky(color, depth, uniforms,
                                 post_u["sky_panorama"])
    if fx == "ssao":
        return ssao.apply_ssao(color, depth, post_u)
    if fx == "bloom":
        return bloom.apply_bloom(
            color, threshold=post_u.get("bloom_threshold", 0.8),
            strength=post_u.get("bloom_strength", 0.7)), depth
    if fx == "fxaa":
        return fxaa.apply_fxaa(color), depth
    return tonemap.apply_tonemap(color, params.tonemap, post_u), depth


def render_frame_multiview(scene: Dict[str, torch.Tensor], uniforms: Dict,
                           params: RenderParams, views, layout: str = "h",
                           vertex_shader: Callable = scene_vertex_shader,
                           fragment_shader: Callable = scene_fragment_shader,
                           fold: Optional[Callable] = None):
    """Split screen: len(views) views of the scene tiled into the (H, W)
    frame, side by side ("h") or stacked ("v"); the split axis must
    divide evenly.  views: per-view uniform overrides (camera pose, fov,
    lights, "mesh_visible"), the rest from `uniforms`.  Each tile is
    render_frame at the tile's size, so it equals that view rendered
    alone (one K1 launch a view on the tile route).  Returns (color
    (H, W, 4), depth (H, W))."""
    n = len(views)
    if n < 1:
        raise ValueError("views must be non-empty")
    if layout not in ("h", "v"):
        raise ValueError("layout must be 'h' or 'v'")
    size = params.width if layout == "h" else params.height
    if size % n:
        raise ValueError(f"{'width' if layout == 'h' else 'height'} "
                         f"{size} not divisible by {n} views")
    vp = params.replace(width=params.width // n) if layout == "h" \
        else params.replace(height=params.height // n)
    frames = [render_frame(scene, {**uniforms, **ov}, vp,
                           vertex_shader=vertex_shader,
                           fragment_shader=fragment_shader, fold=fold)
              for ov in views]
    axis = 1 if layout == "h" else 0
    return (torch.cat([f[0] for f in frames], axis),
            torch.cat([f[1] for f in frames], axis))


# The inset's frame colour in render_frame_pip.
PIP_BORDER_COLOR = (0.05, 0.05, 0.05, 1.0)


def render_frame_pip(scene: Dict[str, torch.Tensor], uniforms: Dict,
                     params: RenderParams, pip_frac: int = 4,
                     corner: str = "tc", mirror: bool = True,
                     border: int = 2,
                     vertex_shader: Callable = scene_vertex_shader,
                     fragment_shader: Callable = scene_fragment_shader,
                     fold: Optional[Callable] = None):
    """The main view with a picture-in-picture inset of a second camera
    (a rear-view mirror, a kill cam): the inset is render_frame at
    (W, H) // pip_frac with the overrides in uniforms["pip_view"] (camera
    pose, fov, "mesh_visible") and without uniforms["hud_text"] (the
    burned-in HUD is not drawn again inside it), flipped left to right
    when `mirror`, and pasted over a `border`-pixel frame in `corner`
    ("tl", "tr", "bl", "br" or "tc", top centre).  Depth is the main
    view's.  Two render_frame calls: two K1 launches on the tile
    route."""
    main_u = {k: v for k, v in uniforms.items() if k != "pip_view"}
    color, depth = render_frame(scene, main_u, params,
                                vertex_shader=vertex_shader,
                                fragment_shader=fragment_shader, fold=fold)
    pw = max(1, params.width // pip_frac)
    ph = max(1, params.height // pip_frac)
    pu = {k: v for k, v in main_u.items() if k != "hud_text"}
    pu.update(uniforms.get("pip_view", {}))
    pc, _ = render_frame(scene, pu, params.replace(width=pw, height=ph),
                         vertex_shader=vertex_shader,
                         fragment_shader=fragment_shader, fold=fold)
    if mirror:
        pc = pc.flip(1)
    m = border
    H, W = params.height, params.width
    offs = {"tl": (m, m), "tr": (m, W - pw - m),
            "bl": (H - ph - m, m), "br": (H - ph - m, W - pw - m),
            "tc": (m, (W - pw) // 2)}
    if corner not in offs:
        raise ValueError(f"corner must be one of {sorted(offs)}")
    y0, x0 = (max(0, v) for v in offs[corner])
    yb0, xb0 = max(0, y0 - m), max(0, x0 - m)
    color = color.clone()
    for c, v in enumerate(PIP_BORDER_COLOR):     # fills: no host copy
        color[yb0:y0 + ph + m, xb0:x0 + pw + m, c] = v
    color[y0:y0 + ph, x0:x0 + pw] = pc[:H - y0, :W - x0]
    return color, depth


def render_frame_with_shadows(scene: Dict[str, torch.Tensor], uniforms: Dict,
                              params: RenderParams, shadow_size: int = 512,
                              vertex_shader: Optional[Callable] = None,
                              fragment_shader: Optional[Callable] = None,
                              fold: Optional[Callable] = None,
                              visibility_fn: Optional[Callable] = None):
    """A frame with a directional shadow map: one depth-only light pass
    (ops.shadows.render_shadow_depth) from an orthographic light camera
    fitted to the scene's world bounds, then render_frame with the map in
    the uniforms (shadow_map, shadow_view, shadow_proj).

    The shaders default to the lit vertex shader and
    shadows.shadowed_scene_fragment_shader only when not given: Engine
    hands its own to a frame_fn, so through Engine name them.  fold is
    render_frame's; visibility_fn folds the light pass
    (shadows.light_pass_visibility by default)."""
    fragment_shader = fragment_shader or shadows.shadowed_scene_fragment_shader
    check_supported(params, uniforms)
    center, radius = shadows.scene_bounds(scene)
    view, proj, _ = shadows.directional_light_camera(
        uniforms["light_direction"], center, radius)
    posed = posed_geometry(scene, device_uniforms(
        uniforms, params.width, params.height, scene["position"].device),
        params.height)
    smap = shadows.render_shadow_depth(scene, uniforms, view, proj,
                                       shadow_size, params, visibility_fn,
                                       posed=posed)
    u = dict(uniforms, shadow_map=smap, shadow_view=view, shadow_proj=proj)
    return render_frame(scene, u, params,
                        vertex_shader or lighting.lit_scene_vertex_shader,
                        fragment_shader, fold=fold, posed=posed)


def render_frame_with_point_shadows(scene: Dict[str, torch.Tensor],
                                    uniforms: Dict, params: RenderParams,
                                    shadow_size: int = 256,
                                    vertex_shader: Optional[Callable] = None,
                                    fragment_shader: Optional[Callable] = None,
                                    fold: Optional[Callable] = None,
                                    visibility_fn: Optional[Callable] = None):
    """A frame lit by one point light with cube shadows: six depth-only
    light passes, one a face, then render_frame.  uniforms carry
    point_light_position and point_light_color (point_light_range
    optional).  Shaders, fold and visibility_fn as
    render_frame_with_shadows (default fragment shader
    shadows.point_shadowed_fragment_shader)."""
    fragment_shader = fragment_shader or shadows.point_shadowed_fragment_shader
    check_supported(params, uniforms)
    posed = posed_geometry(scene, device_uniforms(
        uniforms, params.width, params.height, scene["position"].device),
        params.height)
    smap, views, projs = shadows.render_point_shadow_depth(
        scene, uniforms, uniforms["point_light_position"], shadow_size,
        params=params, visibility_fn=visibility_fn, posed=posed)
    u = dict(uniforms, point_shadow_map=smap, point_shadow_views=views,
             point_shadow_projs=projs)
    return render_frame(scene, u, params,
                        vertex_shader or lighting.lit_scene_vertex_shader,
                        fragment_shader, fold=fold, posed=posed)


def render_frame_with_spot_shadow(scene: Dict[str, torch.Tensor],
                                  uniforms: Dict, params: RenderParams,
                                  shadow_size: int = 512,
                                  vertex_shader: Optional[Callable] = None,
                                  fragment_shader: Optional[Callable] = None,
                                  fold: Optional[Callable] = None,
                                  visibility_fn: Optional[Callable] = None):
    """A frame lit by one spot light with a shadow map: one perspective
    depth-only light pass along the cone axis, then render_frame.
    uniforms carry spot_position, spot_direction, spot_inner and
    spot_outer (radians) and spot_color (spot_range optional).  Shaders,
    fold and visibility_fn as render_frame_with_shadows (default
    fragment shader shadows.spot_shadowed_fragment_shader)."""
    fragment_shader = fragment_shader or shadows.spot_shadowed_fragment_shader
    check_supported(params, uniforms)
    view, proj = shadows.spot_light_camera(
        uniforms["spot_position"], uniforms["spot_direction"],
        uniforms["spot_outer"], device=scene["position"].device)
    posed = posed_geometry(scene, device_uniforms(
        uniforms, params.width, params.height, scene["position"].device),
        params.height)
    smap = shadows.render_shadow_depth(scene, uniforms, view, proj,
                                       shadow_size, params, visibility_fn,
                                       posed=posed)
    u = dict(uniforms, shadow_map=smap, shadow_view=view, shadow_proj=proj)
    return render_frame(scene, u, params,
                        vertex_shader or lighting.lit_scene_vertex_shader,
                        fragment_shader, fold=fold, posed=posed)


def _lod_geom_bound(scene: Dict) -> int:
    """The most input triangles a frame of a packed scene can draw when
    its LOD levels leave some out of every frame: lod.suggested_geom_cap
    (one level a mesh), or 0 where that is every triangle.  Counted on the
    host once a scene (a device scene is read back once)."""
    if "tri_lod_level" not in scene:
        return 0
    host = {k: np.asarray(scene[k].cpu() if torch.is_tensor(scene[k])
                          else scene[k])
            for k in ("tri_mesh_id", "tri_lod_level")}
    bound = lod.suggested_geom_cap(host)
    return bound if bound < host["tri_mesh_id"].shape[0] else 0


def to_rgb8(color: torch.Tensor) -> torch.Tensor:
    """RGBA f32 -> RGB u8 (MainWindow.cs:236-240), on the device."""
    return (color[..., :3].clamp(0.0, 1.0) * 255.0).to(torch.uint8)


class Engine(torch.nn.Module):
    """Holds the scene's device tensors and renders frames from them.

    Usage:
        eng = Engine(build_scene_buffers(instances), RenderParams(w, h))
        u = eng.uniforms               # numpy values, mutate freely
        color, depth = eng.render(u)   # device tensors
        rgb = eng.present(u)           # uint8 RGB numpy array

    `scene` is a packed scene (models.scene.build_scene_buffers) or
    another engine's ``scene``, whose tensors on `device` are shared, not
    copied.  The shaders are the game's unless given.  `device` defaults to
    "cuda"; asking for CUDA where there is none raises, it never renders
    on the CPU instead.  frame_fn: a render_frame-compatible callable,
    called as frame_fn(scene, uniforms, params=..., vertex_shader=...,
    fragment_shader=...) in place of render_frame (for example
    functools.partial(ops.raytrace.render_frame_raytraced,
    cluster_cap=24), or render_frame_pip); render and present both go
    through it.  rtt_passes: render-to-texture passes (engine.rtt.RttPass)
    run before each frame through engine.rtt.render_frame_rtt, each with
    its uniforms sub-dict uniforms[pass.uniforms_key], created here with
    the pass's defaults; they do not combine with frame_fn.

    On a scene with LOD levels and no params.geom_cap, every frame runs
    at the scene's LOD bound (_lod_geom_bound) as its geom_cap: the
    masked-in triangles are compacted before the geometry, which then
    scales with the triangles a frame can draw.  One level is active a
    mesh, so the cap never overflows and the frame is the uncapped one;
    params stays as given, and active_cap_stats reports no counter for
    this cap."""

    def __init__(self, scene: Dict, params: RenderParams,
                 vertex_shader: Callable = scene_vertex_shader,
                 fragment_shader: Callable = scene_fragment_shader,
                 device="cuda", frame_fn: Optional[Callable] = None,
                 rtt_passes: tuple = ()):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda') needs a CUDA device "
                               "and none is available")
        if rtt_passes and frame_fn is not None:
            raise ValueError("frame_fn cannot combine with rtt_passes (the "
                             "render-to-texture frame owns the whole "
                             "frame); wrap engine.rtt.render_frame_rtt "
                             "yourself")
        check_supported(params)
        self.params = params
        self.vertex_shader = vertex_shader
        self.fragment_shader = fragment_shader
        self.frame_fn = frame_fn or render_frame
        self._lod_bound = _lod_geom_bound(scene)
        self._lod_params = (None, None)
        for k, v in scene_to_torch(scene, device).items():
            self.register_buffer(k, v, persistent=False)
        self.uniforms = default_frame_uniforms(params.width, params.height)
        if rtt_passes:
            from softwarerenderer_tpu_torch.engine import rtt
            for p in rtt_passes:
                self.uniforms[p.uniforms_key] = default_frame_uniforms(
                    p.params.width, p.params.height)
            self.frame_fn = functools.partial(rtt.render_frame_rtt,
                                              passes=tuple(rtt_passes))

    @property
    def scene(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_buffers())

    def frame_params(self) -> RenderParams:
        """The params a frame runs with: self.params, with the scene's LOD
        bound as geom_cap where the scene has one and params sets none."""
        p = self.params
        if not self._lod_bound or p.geom_cap:
            return p
        if self._lod_params[0] is not p:
            self._lod_params = (p, p.replace(geom_cap=self._lod_bound))
        return self._lod_params[1]

    def forward(self, uniforms: Optional[Dict] = None,
                fb: Optional[tuple] = None):
        kw = {} if fb is None else {"fb": fb}
        params = self.frame_params()
        with span("engine.render"):
            out = self.frame_fn(self.scene, uniforms or self.uniforms,
                                params=params,
                                vertex_shader=self.vertex_shader,
                                fragment_shader=self.fragment_shader, **kw)
        if params is not self.params and len(out) == 3 \
                and isinstance(out[2], dict):
            # The bound cannot overflow: its counter is not the caller's.
            stats = {k: v for k, v in out[2].items()
                     if k != "geom_cap_overflow"}
            return out[0], out[1], stats
        return out

    def render(self, uniforms: Optional[Dict] = None,
               fb: Optional[tuple] = None):
        """One frame, over fb = (color, depth) when given (render_frame's
        seed)."""
        return self(uniforms, fb)

    def present(self, uniforms: Optional[Dict] = None) -> np.ndarray:
        rgb = to_rgb8(self.render(uniforms)[0])
        with span("sync.present"):
            return rgb.cpu().numpy()
