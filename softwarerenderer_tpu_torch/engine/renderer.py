"""Frame engine: packed scene + camera -> one frame on the device.

Counterpart of ``softwarerenderer_tpu/engine/renderer.py`` on its tile
routes (and, through ``Engine(frame_fn=...)``, of any frame function such
as ``ops.raytrace.render_frame_raytraced``): camera and frustum culling,
vertex shading, near clip and setup, tile binning, then either the opaque
route (the tile kernel's fold, resolve and interpolation, one full-frame
shading pass, blend) or, with ``RenderParams(kbuffer=K)``, the
depth-peeled K-buffer (K tile-kernel passes and a submission-order
replay), and ``to_rgb8`` for present.  The
vertex and fragment shaders are arguments, the game's by default.
PyTorch runs it eagerly; the scene stays on the device and the per-frame
uniforms cross from the host in one copy.

A ``RenderParams`` field or scene key whose feature this package does not
implement yet raises ``NotImplementedError`` instead of rendering another
image.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from softwarerenderer_tpu_torch.config import (BlendMode, DebugMode,
                                               DepthTest, RenderParams)
from softwarerenderer_tpu_torch import shaders
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import culling, geometry, raster
from softwarerenderer_tpu_torch.ops import texture as tex_ops
from softwarerenderer_tpu_torch.ops import tile_raster
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = torch.float32


# The game's vertex shader over a packed scene, whose uniforms["model"]
# holds (V, 4, 4) per-vertex model matrices: JAX's scene_vertex_shader,
# which computes what shaders.default_vertex_shader does.
scene_vertex_shader = shaders.default_vertex_shader


def scene_fragment_shader(frag: Dict, uniforms: Dict) -> torch.Tensor:
    """Texture(atlas) × vertex color, half-Lambert max(0.25, N·-L),
    smoothstep fog on clip-space z, alpha unfogged (Renderer.cs:848-860)."""
    tri = frag["tri"]
    tex_color = tex_ops.sample_atlas_region(
        uniforms["atlas_data"], tri["tex_oy"], tri["tex_ox"], tri["tex_h"],
        tri["tex_w"], frag["uv"])
    return shaders.lit_and_fogged(frag, uniforms, tex_color)


# The same registries as the JAX shader: the varyings it reads (the rest
# are pruned from the payload), the per-triangle channels it samples
# through, and where its alpha comes from.
scene_fragment_shader.varyings = ("color", "uv", "data.world_normal")
scene_fragment_shader.tri_extras = ("tex_oy", "tex_ox", "tex_h", "tex_w")
scene_fragment_shader.alpha_sources = ("color", "texture")


def opaque_tri_flags(scene: Dict[str, torch.Tensor], vin: Dict,
                     fragment_shader: Callable,
                     params: RenderParams) -> Optional[torch.Tensor]:
    """Per-triangle 'semantically opaque' flags for the K-buffer peel's
    short-circuit, int32 ×2 for the clipper's fan slots, or None when
    unprovable (JAX's opaque_tri_flags).

    A triangle is flagged when the shader's alpha_sources evaluate to
    exactly 1 from pack-time data: "color" = all three vertex alphas are 1,
    "texture" = the texture's pack-time min alpha (scene["tex_min_alpha"])
    is 1.  None unless blend_mode is ALPHA and the shader declares
    alpha_sources (NONE blending stops on shaded alpha alone; ADDITIVE and
    MULTIPLY never stop)."""
    srcs = getattr(fragment_shader, "alpha_sources", None)
    if srcs is None or params.blend_mode != BlendMode.ALPHA:
        return None
    idx = scene["indices"].reshape(-1, 3).long()
    opq = torch.ones(idx.shape[0], dtype=torch.bool, device=idx.device)
    if "color" in srcs:
        a = vin["color"][:, 3][idx]                       # (T, 3)
        opq &= (a.amin(1) == 1.0) & (a.amax(1) == 1.0)
    if "texture" in srcs:
        if "tex_min_alpha" not in scene:
            return None
        opq &= scene["tex_min_alpha"][scene["tri_texture_id"].long()] >= 1.0
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


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def camera_matrices(uniforms: Dict, width: int, height: int):
    """View from position + quaternion (Camera.cs:12-26) and the .NET
    perspective from the live FOV (Renderer.cs:406-410), computed on the
    host as float32 tensors."""
    pos = _f32(uniforms["camera_position"])
    rot = _f32(uniforms["camera_rotation"])
    front = ml.quat_rotate(_f32([0.0, 0.0, -1.0]), rot)
    up = ml.quat_rotate(_f32([0.0, 1.0, 0.0]), rot)
    view = ml.look_at(pos, pos + front, up)
    fov = _f32(uniforms["fov_degrees"]) * float(np.float32(np.pi / 180.0))
    aspect = _f32(np.float32(width) / np.float32(height))
    proj = ml.perspective_fov(fov, aspect, _f32(uniforms["near_clip"]),
                              _f32(uniforms["far_clip"]))
    return view, proj


# Uniforms the frame reads on the device, packed into one host->device copy.
_DEVICE_UNIFORMS = (("view", (4, 4)), ("projection", (4, 4)),
                    ("camera_position", (3,)),
                    ("light_direction", (3,)), ("light_color", (4,)),
                    ("fog_color", (4,)), ("clear_color", (4,)),
                    ("fog_start", ()), ("fog_end", ()), ("near_clip", ()))


def _upload_uniforms(uniforms: Dict, width: int, height: int,
                     device) -> Dict[str, torch.Tensor]:
    """Camera matrices and the shading uniforms as device tensors, moved
    in one host->device copy."""
    view, proj = camera_matrices(uniforms, width, height)
    host = dict(uniforms, view=view.numpy(), projection=proj.numpy())
    packed = torch.from_numpy(np.concatenate(
        [np.asarray(host[k], np.float32).reshape(-1)
         for k, _ in _DEVICE_UNIFORMS])).to(device)
    u, off = {}, 0
    for k, shape in _DEVICE_UNIFORMS:
        size = int(np.prod(shape))
        u[k] = packed[off:off + size].reshape(shape)
        off += size
    return u


# Uniforms the host reads (the camera) or render_frame applies itself; any
# other key the caller adds (a shader's texture, say) goes to the shaders
# as device tensors.
_HOST_UNIFORMS = frozenset(("camera_position", "camera_rotation",
                            "fov_degrees", "far_clip", "mesh_visible"))


def _to_device(v, device):
    """A uniform, or a dict of them, as device tensors (float64 as
    float32, the JAX package's default precision)."""
    if isinstance(v, dict):
        return {k: _to_device(x, device) for k, x in v.items()}
    if isinstance(v, torch.Tensor):
        return v.to(device)
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def device_uniforms(uniforms: Dict, width: int, height: int,
                    device) -> Dict[str, torch.Tensor]:
    """The uniforms the frame reads on the device: the camera matrices and
    shading uniforms in one host->device copy, and every other key the
    caller added (a shader's texture, say) as device tensors."""
    u = _upload_uniforms(uniforms, width, height, device)
    for k, v in uniforms.items():
        if k not in u and k not in _HOST_UNIFORMS:
            u[k] = _to_device(v, device)
    return u


_UNSUPPORTED_SCENE_PREFIXES = ("tangent", "anim_", "morph_", "skin_",
                               "particle_", "tri_lod_level")


def check_supported(params: RenderParams, scene_keys=(), uniforms=None):
    """Raise NotImplementedError for anything outside the routes this
    package renders, and JAX's ValueError for kbuffer_stats without a
    K-buffer."""
    if params.kbuffer_stats and params.kbuffer <= 1:
        raise ValueError("kbuffer_stats needs kbuffer > 1 (the stats dict "
                         "is the K-buffer's third return value)")
    bad = [name for name, off in (
        ("ssaa", params.ssaa != 1),
        ("ssao", params.ssao), ("bloom", params.bloom),
        ("tonemap", params.tonemap is not None), ("fxaa", params.fxaa),
        ("post_fx callables", any(callable(f) for f in params.post_fx)),
        ("kbuffer with a depth_test other than LESS_EQUAL",
         params.kbuffer > 1 and params.depth_test != DepthTest.LESS_EQUAL),
        ("debug_mode", params.debug_mode != DebugMode.NONE),
        ("deferred", not params.deferred), ("binned", not params.binned),
        ("depth_test", params.depth_test != DepthTest.LESS_EQUAL),
        ("active_cap", bool(params.active_cap)),
        ("active_cap_stats", params.active_cap_stats),
        ("geom_cap", bool(params.geom_cap)),
        ("pair_cap", bool(params.pair_cap)),
        ("global_cap", bool(params.global_cap)),
        ("use_mipmaps", bool(params.use_mipmaps)),
        ("shade_rate", params.shade_rate != 1)) if off]
    bad += [f"scene key {k}" for k in scene_keys
            if k.startswith(_UNSUPPORTED_SCENE_PREFIXES)]
    if uniforms is not None and "sky_panorama" in uniforms:
        bad.append("sky_panorama")
    if bad:
        raise NotImplementedError(
            f"not implemented in softwarerenderer_tpu_torch yet: {bad}")


def frame_setup(scene: Dict[str, torch.Tensor], uniforms: Dict,
                params: RenderParams,
                vertex_shader: Callable = scene_vertex_shader,
                fragment_shader: Callable = scene_fragment_shader) -> Dict:
    """Everything a tile route takes for one frame: {"tris": the set-up
    triangles, "uniforms": the device uniforms the shaders read,
    "per_tri": the per-triangle extras, "fb_color" and "fb_depth": the
    cleared framebuffer}.  render_frame routes them; a caller may hand
    them to another route of ops.tile_raster."""
    H, W = params.height, params.width
    dev = scene["position"].device
    with record_function("frame.camera_cull"):
        u = device_uniforms(uniforms, W, H, dev)
        view_proj = ml.transform(u["view"], u["projection"])     # V·P
        visible = culling.spheres_in_frustum(
            scene["bounds_center"], scene["bounds_radius"],
            scene["mesh_matrices"], view_proj)
        if "mesh_visible" in uniforms:
            visible = visible & torch.as_tensor(
                np.asarray(uniforms["mesh_visible"], bool)).to(dev)
        tri_mesh = scene["tri_mesh_id"].long()
        tri_mask = visible[tri_mesh]

    with record_function("frame.geometry"):
        u.update(model=culling.model_matrices_per_vertex(scene),
                 atlas_data=scene["atlas_data"])
        vin = {k: scene[k] for k in ("position", "uv", "normal", "color")}
        tris = geometry.build_triangles(
            vertex_shader, vin, scene["indices"], u, width=W, height=H,
            cull_mode=params.cull_mode, tri_mask=tri_mask,
            keep_varyings=getattr(fragment_shader, "varyings", None))

    # Per-triangle material channels, ×2 for the clipper's fan slots, as
    # JAX's render_frame packs them: texture and mesh ids and the atlas
    # regions, resolved per triangle so the shader's only per-pixel memory
    # access is the texel fetch; pruned to the shader's `tri_extras`.
    with record_function("frame.extras"):
        tid2 = scene["tri_texture_id"].long().repeat_interleave(2)
        aoff, asiz = scene["atlas_offsets"], scene["atlas_sizes"]
        per_tri = {"tex_id": tid2, "mesh_id": tri_mesh.repeat_interleave(2),
                   "tex_oy": aoff[:, 0][tid2], "tex_ox": aoff[:, 1][tid2],
                   "tex_h": asiz[:, 0][tid2], "tex_w": asiz[:, 1][tid2]}
        keep = getattr(fragment_shader, "tri_extras", None)
        if keep is not None:
            per_tri = {k: v for k, v in per_tri.items() if k in keep}
        if params.kbuffer > 1 and params.kbuffer_short_circuit:
            # The opaque flags ride the payload so the peel can stop
            # behind opaque visible winners.
            opq = opaque_tri_flags(scene, vin, fragment_shader, params)
            if opq is not None:
                per_tri["opq"] = opq

    return {"tris": tris, "uniforms": u, "per_tri": per_tri,
            "fb_color": u["clear_color"].expand(H, W, 4),
            "fb_depth": torch.full((H, W), raster.DEPTH_CLEAR, dtype=F32,
                                   device=dev)}


def render_frame(scene: Dict[str, torch.Tensor], uniforms: Dict,
                 params: RenderParams,
                 vertex_shader: Callable = scene_vertex_shader,
                 fragment_shader: Callable = scene_fragment_shader,
                 fold: Optional[Callable] = None):
    """One frame over a packed scene already on the device
    (models.convert.scene_to_torch), drawn with the given shaders.
    Returns (color (H, W, 4) f32, depth (H, W) f32) on the scene's device,
    and with params.kbuffer_stats a third value, {"kbuffer_saturated_px":
    n}.

    kbuffer > 1 renders the depth-peeled K-buffer
    (tile_raster.render_tile_kbuffer); otherwise the opaque route
    (tile_raster.render_tile).  fold: the tile fold the passes run,
    tile_raster.tile_fold by default; tile_raster.tile_fold_plain renders
    the same frame through the plain twins."""
    check_supported(params, scene.keys(), uniforms)
    f = frame_setup(scene, uniforms, params, vertex_shader, fragment_shader)
    if params.kbuffer > 1:
        return tile_raster.render_tile_kbuffer(
            f["tris"], fragment_shader, f["uniforms"], params,
            f["fb_color"], f["fb_depth"], per_tri_extra=f["per_tri"],
            fold=fold, with_stats=params.kbuffer_stats)
    return tile_raster.render_tile(f["tris"], fragment_shader, f["uniforms"],
                                   params, f["fb_color"], f["fb_depth"],
                                   per_tri_extra=f["per_tri"], fold=fold)


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

    The shaders are the game's unless given.  `device` defaults to
    "cuda"; asking for CUDA where there is none raises, it never renders
    on the CPU instead.  frame_fn: a render_frame-compatible callable,
    called as frame_fn(scene, uniforms, params=..., vertex_shader=...,
    fragment_shader=...) in place of render_frame (for example
    functools.partial(ops.raytrace.render_frame_raytraced,
    cluster_cap=24)); render and present both go through it."""

    def __init__(self, scene: Dict, params: RenderParams,
                 vertex_shader: Callable = scene_vertex_shader,
                 fragment_shader: Callable = scene_fragment_shader,
                 device="cuda", frame_fn: Optional[Callable] = None):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda') needs a CUDA device "
                               "and none is available")
        check_supported(params, scene.keys())
        self.params = params
        self.vertex_shader = vertex_shader
        self.fragment_shader = fragment_shader
        self.frame_fn = frame_fn or render_frame
        for k, v in scene_to_torch(scene, device).items():
            self.register_buffer(k, v, persistent=False)
        self.uniforms = default_frame_uniforms(params.width, params.height)

    @property
    def scene(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_buffers())

    def forward(self, uniforms: Optional[Dict] = None):
        return self.frame_fn(self.scene, uniforms or self.uniforms,
                             params=self.params,
                             vertex_shader=self.vertex_shader,
                             fragment_shader=self.fragment_shader)

    def render(self, uniforms: Optional[Dict] = None):
        return self(uniforms)

    def present(self, uniforms: Optional[Dict] = None) -> np.ndarray:
        return to_rgb8(self.render(uniforms)[0]).cpu().numpy()
