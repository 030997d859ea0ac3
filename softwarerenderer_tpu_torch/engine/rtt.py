"""Render to texture: passes that render the scene into an atlas slot
which the main view then samples (a security monitor, a mirror, a
portal).

Counterpart of ``softwarerenderer_tpu/engine/rtt.py``.  The atlas is a
tensor of the scene dict, so writing a render target is an indexed write
into the slot's rectangle, on the device and with no host read (the
slot's offsets are read on the device, clamped into the atlas as
``lax.dynamic_update_slice`` clamps them).  The image is quantized as
``ops.texture.pack_rgba8`` quantizes and its mips are rebuilt with the
pack-time box filter summed in the pack-time order, so a dynamic slot
holds the bytes the same image packed statically holds.

Usage:
    slot = rtt_slot(128, 128)                 # placeholder image
    inst = MeshInstance(screen_quad, M, texture=slot)
    sc = build_scene_buffers([inst, ...])
    tid = atlas_id_of([inst, ...], slot)
    passes = (RttPass(tex_id=tid, params=RenderParams(128, 128),
                      uniforms_key="cctv"),)
    eng = Engine(sc, params, rtt_passes=passes)   # or render_frame_rtt
    eng.uniforms["cctv"]["camera_position"] = ...
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from softwarerenderer_tpu_torch.config import RenderParams
from softwarerenderer_tpu_torch.models.scene import (MAX_MIP_LEVELS,
                                                     assign_texture_ids)

F32 = np.float32


def rtt_slot(height: int, width: int,
             fill=(0.0, 0.0, 0.0, 0.0)) -> np.ndarray:
    """A placeholder image reserving a (height, width) atlas region whose
    content is written each frame on the device.  The default fill has
    alpha 0, so the slot is not opaque at pack time and the K-buffer's
    opaque short-circuit stays conservative whatever is rendered into
    it."""
    return np.broadcast_to(np.asarray(fill, F32),
                           (height, width, 4)).copy()


def atlas_id_of(instances, texture) -> int:
    """The atlas texture id build_scene_buffers gives `texture`
    (models.scene.assign_texture_ids, the function it packs with)."""
    _textures, id_of, _neutral = assign_texture_ids(instances)
    if id(texture) not in id_of:
        raise ValueError("texture is not used by any instance "
                         "(build_scene_buffers would not pack it)")
    return id_of[id(texture)]


def box_downsample(im: torch.Tensor) -> torch.Tensor:
    """The 2x2 box filter of models.scene._box_downsample (odd last row
    and column repeated) in its float32 rounding: numpy's mean over the
    two axes sums ((top left + top right) + bottom left) + bottom right
    and divides by 4, and so does this."""
    if im.shape[0] % 2:
        im = torch.cat([im, im[-1:]], 0)
    if im.shape[1] % 2:
        im = torch.cat([im, im[:, -1:]], 1)
    r = im.reshape(im.shape[0] // 2, 2, im.shape[1] // 2, 2, -1)
    return (((r[:, 0, :, 0] + r[:, 0, :, 1]) + r[:, 1, :, 0])
            + r[:, 1, :, 1]) / 4.0


def quantize_u8(img: torch.Tensor) -> torch.Tensor:
    """f32 [0, 1] -> u8, as ops.texture.pack_rgba8: round half to even,
    clipped before the cast."""
    return torch.round(img.to(torch.float32) * 255.0).clamp(
        0.0, 255.0).to(torch.uint8)


def _write_region(atlas: torch.Tensor, img: torch.Tensor,
                  offset: torch.Tensor) -> None:
    """atlas[oy:oy + h, ox:ox + w] = img in place, the (oy, ox) device
    tensor clamped into the atlas as dynamic_update_slice clamps it."""
    h, w = img.shape[:2]
    ah, aw = atlas.shape[:2]
    dev = atlas.device
    oy = offset[0].long().clamp(0, ah - h)
    ox = offset[1].long().clamp(0, aw - w)
    rows = (oy + torch.arange(h, device=dev))[:, None]
    cols = (ox + torch.arange(w, device=dev))[None, :]
    atlas.index_put_((rows, cols), img)


def write_atlas_texture(scene: Dict[str, torch.Tensor], tex_id: int,
                        color: torch.Tensor,
                        update_mips: bool = True) -> Dict:
    """A new scene dict whose atlas holds `color` ((h, w, 4) f32 in
    [0, 1], the slot's placeholder size) in texture tex_id's region, and,
    with update_mips, its box-filtered mip chain in the texture's mip
    regions (stopping at 1 pixel or MAX_MIP_LEVELS, as pack_atlas does).
    Every other buffer is shared; the atlas is a copy."""
    img = color.to(torch.float32)
    atlas = scene["atlas_data"].clone()
    _write_region(atlas, quantize_u8(img), scene["atlas_offsets"][tex_id])
    if update_mips and "atlas_mip_offsets" in scene:
        moff = scene["atlas_mip_offsets"][tex_id]
        m, lv = img, 1
        while lv < MAX_MIP_LEVELS and min(m.shape[0], m.shape[1]) > 1:
            m = box_downsample(m)
            _write_region(atlas, quantize_u8(m), moff[lv])
            lv += 1
    return dict(scene, atlas_data=atlas)


@dataclasses.dataclass(frozen=True)
class RttPass:
    """One offscreen pass: render the scene with `params` from the
    uniforms sub-dict uniforms[uniforms_key] (a complete frame-uniforms
    dict; its "mesh_visible" can hide the monitor from its own feed) and
    write the colour into atlas slot `tex_id`, which later passes and the
    main view sample."""

    tex_id: int
    params: RenderParams
    uniforms_key: str
    vertex_shader: Optional[Callable] = None
    fragment_shader: Optional[Callable] = None
    update_mips: bool = True

    def __post_init__(self):
        if self.params.kbuffer_stats or self.params.active_cap_stats:
            raise ValueError("RttPass params cannot request stats dicts "
                             "(the pass discards the third return value)")


def render_frame_rtt(scene: Dict[str, torch.Tensor], uniforms: Dict,
                     params: RenderParams, passes: Tuple[RttPass, ...],
                     vertex_shader: Optional[Callable] = None,
                     fragment_shader: Optional[Callable] = None,
                     fold: Optional[Callable] = None,
                     return_atlas: bool = False):
    """Each pass in order (each sees the slots the passes before it
    wrote), then the main view over the written atlas, its uniforms
    without the passes' sub-dicts.  Returns (color, depth), and the
    written atlas third with return_atlas (feed it back as
    scene["atlas_data"] for a monitor that shows itself a frame late).
    fold: render_frame's, for every pass and the main view."""
    from softwarerenderer_tpu_torch.engine import renderer as eng
    for p in passes:
        color, _ = eng.render_frame(
            scene, uniforms[p.uniforms_key], p.params,
            vertex_shader=p.vertex_shader or eng.scene_vertex_shader,
            fragment_shader=p.fragment_shader or eng.scene_fragment_shader,
            fold=fold)
        scene = write_atlas_texture(scene, p.tex_id, color,
                                    update_mips=p.update_mips)
    keys = {p.uniforms_key for p in passes}
    out = eng.render_frame(
        scene, {k: v for k, v in uniforms.items() if k not in keys}, params,
        vertex_shader=vertex_shader or eng.scene_vertex_shader,
        fragment_shader=fragment_shader or eng.scene_fragment_shader,
        fold=fold)
    if return_atlas:
        return out[0], out[1], scene["atlas_data"]
    return out
