"""The tile route's shading pass on the card: one hand-written CUDA kernel
(``csrc/tile_shade.cu``) for the scene shaders.

A fragment shader declares its fused form beside its other registries:
``shader.tile_shade`` names the texel fetch the kernel runs in its place,
one of FETCHES ("nearest_region": ``scene_fragment_shader``'s nearest
texel of the triangle's atlas region; "trilinear_regions":
``scene_fragment_shader_trilinear``'s two bilinear regions mixed by the
mip fraction).  ``fused_fetch`` says whether a frame takes the kernel:
the shader declares the attribute, the G-buffer lies on a CUDA device and
every channel the kernel reads is packed in it.  Then ``shade`` replaces
the whole eager body of ``tile_raster.render_tile``'s shading
(``tile_raster.shade_plain``: the shader over the G-buffer planes,
shade_rate's repeat, the blend and the selects); otherwise the eager body
runs, as it does on the CPU, where it is what the tests hold against the
JAX package.  There is no fallback from one to the other: a declared
shader on the card takes the kernel, whose frame equals the eager body's
bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

F32 = torch.float32
I32 = torch.int32
FETCHES = {"nearest_region": 0, "trilinear_regions": 1}
# Kernel launches so far, by fetch; chip_smoke.py and the card tests reset
# and read them to show that a frame's shading went through the kernel.
LAUNCHES = dict.fromkeys(FETCHES, 0)
# The G-buffer channels the kernel reads, in csrc/tile_shade.cu's Planes
# order: (varying, width) first, then clip-space z (packed alone, as
# "clip_z", for a shader that does not read clip_position), then the
# per-triangle channels of the fetch.
VARYINGS = (("color", 4), ("uv", 2), ("data.world_normal", 3))
REGION = ("tex_oy", "tex_ox", "tex_h", "tex_w")
TRI_CHANNELS = {
    "nearest_region": REGION,
    "trilinear_regions": REGION + ("tex_oy2", "tex_ox2", "tex_h2", "tex_w2",
                                   "mip_frac256")}
# The uniforms the kernel reads through their pointers, with their sizes.
UNIFORMS = (("light_direction", 3), ("light_color", 4), ("fog_color", 4),
            ("fog_start", 1), ("fog_end", 1))

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P, _L, _I, _P, _P, _P, _L, _L, _P, _L, _L, _P, _I, _I, _P, _I,
             _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _P]


def planes_of(ctx: Dict, fetch: str) -> Optional[list]:
    """The plane index in the G-buffer of each channel the kernel reads
    for `fetch` (csrc/tile_shade.cu's Planes order), from the packed
    layout ctx["gb_slices"]; None when one of them is not packed."""
    if fetch not in FETCHES:
        raise ValueError(f"unknown fetch {fetch!r}; valid: "
                         f"{sorted(FETCHES)}")
    sl = ctx["gb_slices"]
    keys = VARYINGS + (("clip_z", 1),) \
        + tuple(("tri." + k, 1) for k in TRI_CHANNELS[fetch])
    if any(k not in sl or sl[k][1] - sl[k][0] != n for k, n in keys):
        return None
    return [sl[k][0] for k, _ in keys]


def fused_fetch(fragment_shader, ctx: Dict,
                gbuf: torch.Tensor) -> Optional[str]:
    """The fetch the kernel shades this frame with, or None for the eager
    body: the shader's declared ``tile_shade``, when the G-buffer is on a
    CUDA device and holds every channel the kernel reads."""
    fetch = getattr(fragment_shader, "tile_shade", None)
    if fetch is None or not gbuf.is_cuda or planes_of(ctx, fetch) is None:
        return None
    return fetch


def _check(name: str, t, dtype, dims: int, device) -> None:
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, not "
                         f"{type(t).__name__} on "
                         f"{getattr(t, 'device', 'the host')}")
    if t.device != device or t.dtype != dtype or t.dim() != dims:
        raise ValueError(f"{name} must be {dtype} with {dims} dimensions on "
                         f"{device}, not {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _uniform(uniforms: Dict, name: str, size: int, device) -> torch.Tensor:
    t = uniforms[name]
    if not isinstance(t, torch.Tensor) or not t.is_cuda \
            or t.device != device or t.dtype != F32 or t.numel() != size:
        raise ValueError(f"uniform {name} must be {size} float32 value(s) "
                         f"on {device}, not {t!r:.80}")
    return t.contiguous()


def shade(fetch: str, ctx: Dict, gbuf: torch.Tensor, best_d: torch.Tensor,
          best_i: torch.Tensor, uniforms: Dict, params,
          fb_color: torch.Tensor, fb_depth: torch.Tensor):
    """tile_raster.shade_plain's (color (H, W, 4), depth (H, W)) for a
    shader whose ``tile_shade`` is `fetch`, in one launch of
    csrc/tile_shade.cu on the current stream.

    gbuf (C, Hp, Wp), best_d (Hp, Wp) f32 and best_i (Hp, Wp) int32 are the
    fold's outputs, contiguous; ctx["H"] x ctx["W"] the frame (or band)
    shaded; fb_color (H, W, 4) and fb_depth (H, W) f32 in any strides (the
    clear color may be expanded); uniforms["atlas_data"] the (AH, AW, 4)
    uint8 atlas, and the lighting and fog uniforms float32 tensors on the
    card (the kernel reads them in place).  params.shade_rate must divide
    H.  Raises ValueError on anything else."""
    planes = planes_of(ctx, fetch)
    if planes is None:
        raise ValueError(f"the G-buffer lacks a channel of {fetch!r}: "
                         f"{sorted(ctx['gb_slices'])}")
    H, W = ctx["H"], ctx["W"]
    sr = int(params.shade_rate)
    if sr < 1 or H % sr:
        raise ValueError(f"shade_rate={sr} needs the frame height "
                         f"divisible by it, got {H}")
    _check("gbuf", gbuf, F32, 3, gbuf.device)
    dev = gbuf.device
    C, Hp, Wp = gbuf.shape
    if not gbuf.is_contiguous() or H > Hp or W > Wp or max(planes) >= C:
        raise ValueError(f"gbuf must be a contiguous ({max(planes) + 1}+, "
                         f">={H}, >={W}) G-buffer, not {tuple(gbuf.shape)}")
    for name, t, dtype in (("best_d", best_d, F32), ("best_i", best_i, I32)):
        _check(name, t, dtype, 2, dev)
        if tuple(t.shape) != (Hp, Wp) or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous ({Hp}, {Wp}), not "
                             f"{tuple(t.shape)}")
    _check("fb_color", fb_color, F32, 3, dev)
    _check("fb_depth", fb_depth, F32, 2, dev)
    if tuple(fb_color.shape) != (H, W, 4) or tuple(fb_depth.shape) != (H, W):
        raise ValueError(f"fb_color must be ({H}, {W}, 4) and fb_depth "
                         f"({H}, {W}), not {tuple(fb_color.shape)} and "
                         f"{tuple(fb_depth.shape)}")
    if fb_color.stride(2) != 1:
        fb_color = fb_color.contiguous()
    atlas = uniforms["atlas_data"]
    _check("atlas_data", atlas, torch.uint8, 3, dev)
    if atlas.shape[2] != 4 or atlas.numel() == 0:
        raise ValueError(f"atlas_data must be (AH, AW, 4) uint8, not "
                         f"{tuple(atlas.shape)}")
    if not atlas.is_contiguous() or atlas.data_ptr() % 4:
        atlas = atlas.clone(memory_format=torch.contiguous_format)
    uni = [_uniform(uniforms, k, n, dev) for k, n in UNIFORMS]
    out_c = torch.empty((H, W, 4), dtype=F32, device=dev)
    out_d = torch.empty((H, W), dtype=F32, device=dev)
    if H == 0 or W == 0:
        return out_c, out_d
    from softwarerenderer_tpu_torch.kernels import build
    fn = build.load("tile_shade").tile_shade_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    idx = (ctypes.c_int * len(planes))(*planes)
    err = fn(gbuf.data_ptr(), Hp * Wp, Wp, best_i.data_ptr(),
             best_d.data_ptr(), fb_color.data_ptr(), fb_color.stride(0),
             fb_color.stride(1), fb_depth.data_ptr(), fb_depth.stride(0),
             fb_depth.stride(1), atlas.data_ptr(), atlas.shape[0],
             atlas.shape[1], idx, len(planes), *(t.data_ptr() for t in uni),
             FETCHES[fetch], int(params.blend_mode), sr, out_c.data_ptr(),
             out_d.data_ptr(), H, W,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tile_shade launch failed: CUDA error {err}")
    LAUNCHES[fetch] += 1
    return out_c, out_d
