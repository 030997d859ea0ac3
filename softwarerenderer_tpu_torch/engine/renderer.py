"""Frame engine: packed scene + camera -> one opaque frame on the device.

Counterpart of ``softwarerenderer_tpu/engine/renderer.py`` on its default
route: camera and frustum culling, vertex shading, near clip and setup,
tile binning, the tile kernel (fold, resolve, interpolation), one
full-frame shading pass with the game's default shaders, blend, and
``to_rgb8`` for present.  PyTorch runs it eagerly; the scene stays on the
device and only the per-frame uniforms cross from the host, in one copy.

A ``RenderParams`` field or scene key whose feature this package does not
implement yet raises ``NotImplementedError`` instead of rendering another
image.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from softwarerenderer_tpu.config import DebugMode, DepthTest, RenderParams
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import culling, geometry, raster
from softwarerenderer_tpu_torch.ops import texture as tex_ops
from softwarerenderer_tpu_torch.ops import tile_raster
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = torch.float32


def scene_vertex_shader(vin: Dict, uniforms: Dict) -> Dict:
    """MVP transform + world normal varying (Renderer.cs:830-846), with
    uniforms["model"] the (V, 4, 4) per-vertex model matrices."""
    model = uniforms["model"]
    world = ml.transform(ml.homogenize(vin["position"]), model)
    view_pos = ml.transform(world, uniforms["view"])
    clip = ml.transform(view_pos, uniforms["projection"])
    world_normal = ml.normalize(ml.transform_normal(vin["normal"], model),
                                eps=1e-30)
    return {"clip_position": clip, "color": vin["color"], "uv": vin["uv"],
            "normal": vin["normal"], "data": {"world_normal": world_normal}}


def scene_fragment_shader(frag: Dict, uniforms: Dict) -> torch.Tensor:
    """Texture(atlas) × vertex color, half-Lambert max(0.25, N·-L),
    smoothstep fog on clip-space z, alpha unfogged (Renderer.cs:848-860)."""
    diffuse = ml.dot(frag["data"]["world_normal"],
                     -uniforms["light_direction"]).clamp(min=0.25)
    tri = frag["tri"]
    tex_color = tex_ops.sample_atlas_region(
        uniforms["atlas_data"], tri["tex_oy"], tri["tex_ox"], tri["tex_h"],
        tri["tex_w"], frag["uv"])
    base = frag["color"] * tex_color
    depth = frag["clip_position"][..., 2]
    fog_end = uniforms["fog_end"]
    fog = ((fog_end - depth) / (fog_end - uniforms["fog_start"])).clamp(0, 1)
    fog = fog * fog * (3.0 - 2.0 * fog)
    lit = base * (0.1 + 0.9 * diffuse[..., None]) * uniforms["light_color"]
    fog_color = uniforms["fog_color"]
    rgba = fog_color + (lit - fog_color) * fog[..., None]
    return torch.cat([rgba[..., :3], base[..., 3:4]], dim=-1)


# The same registries as the JAX shader: the varyings it reads (the rest
# are pruned from the payload), the per-triangle channels it samples
# through, and where its alpha comes from.
scene_fragment_shader.varyings = ("color", "uv", "data.world_normal")
scene_fragment_shader.tri_extras = ("tex_oy", "tex_ox", "tex_h", "tex_w")
scene_fragment_shader.alpha_sources = ("color", "texture")


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


_UNSUPPORTED_SCENE_PREFIXES = ("tangent", "anim_", "morph_", "skin_",
                               "particle_", "tri_lod_level")


def check_supported(params: RenderParams, scene_keys=(), uniforms=None):
    """Raise NotImplementedError for anything outside the opaque default
    route this package renders."""
    bad = [name for name, off in (
        ("ssaa", params.ssaa != 1),
        ("ssao", params.ssao), ("bloom", params.bloom),
        ("tonemap", params.tonemap is not None), ("fxaa", params.fxaa),
        ("post_fx callables", any(callable(f) for f in params.post_fx)),
        ("kbuffer", params.kbuffer > 1),
        ("kbuffer_stats", params.kbuffer_stats),
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


def render_frame(scene: Dict[str, torch.Tensor], uniforms: Dict,
                 params: RenderParams, fold: Optional[Callable] = None):
    """One opaque frame of the game's default shaders over a packed scene
    already on the device (models.convert.scene_to_torch).  Returns
    (color (H, W, 4) f32, depth (H, W) f32) on the scene's device.

    fold: the tile fold to run (tile_raster.tile_fold by default)."""
    check_supported(params, scene.keys(), uniforms)
    H, W = params.height, params.width
    dev = scene["position"].device
    with record_function("frame.camera_cull"):
        u = _upload_uniforms(uniforms, W, H, dev)
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
            scene_vertex_shader, vin, scene["indices"], u, width=W, height=H,
            cull_mode=params.cull_mode, tri_mask=tri_mask,
            keep_varyings=scene_fragment_shader.varyings)

    # Per-triangle material channels, ×2 for the clipper's fan slots: the
    # atlas regions the shader declares in `tri_extras`, resolved per
    # triangle so its only per-pixel memory access is the texel fetch.
    with record_function("frame.extras"):
        tid2 = scene["tri_texture_id"].long().repeat_interleave(2)
        aoff, asiz = scene["atlas_offsets"], scene["atlas_sizes"]
        per_tri = {"tex_oy": aoff[:, 0][tid2], "tex_ox": aoff[:, 1][tid2],
                   "tex_h": asiz[:, 0][tid2], "tex_w": asiz[:, 1][tid2]}

    fb_color = u["clear_color"].expand(H, W, 4)
    fb_depth = torch.full((H, W), raster.DEPTH_CLEAR, dtype=F32, device=dev)
    return tile_raster.render_tile(tris, scene_fragment_shader, u, params,
                                   fb_color, fb_depth, per_tri_extra=per_tri,
                                   fold=fold)


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

    `device` defaults to "cuda"; asking for CUDA where there is none
    raises, it never renders on the CPU instead."""

    def __init__(self, scene: Dict, params: RenderParams, device="cuda"):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine(device='cuda') needs a CUDA device "
                               "and none is available")
        check_supported(params, scene.keys())
        self.params = params
        for k, v in scene_to_torch(scene, device).items():
            self.register_buffer(k, v, persistent=False)
        self.uniforms = default_frame_uniforms(params.width, params.height)

    @property
    def scene(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_buffers())

    def forward(self, uniforms: Optional[Dict] = None):
        return render_frame(self.scene, uniforms or self.uniforms,
                            self.params)

    def render(self, uniforms: Optional[Dict] = None):
        return self(uniforms)

    def present(self, uniforms: Optional[Dict] = None) -> np.ndarray:
        return to_rgb8(self.render(uniforms)[0]).cpu().numpy()
