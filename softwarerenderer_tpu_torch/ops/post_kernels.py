"""The post chain's stages on the card: one hand-written CUDA kernel a
stage (``csrc/post_fx.cu``).

``sky``, ``ssao``, ``bloom``, ``tonemap`` and ``fxaa`` take CUDA tensors
and launch their stage's kernel on the current stream.  The stage modules
(``ops/sky.py``, ``ssao.py``, ``bloom.py``, ``tonemap.py``, ``fxaa.py``)
call them for CUDA tensors and run their plain PyTorch twins
(``composite_sky_plain``, ``apply_ssao_plain``, ``apply_bloom_plain``,
``apply_tonemap_plain``, ``apply_fxaa_plain``) for CPU tensors; there is
no fallback from one to the other.  A kernel rounds every operation as
its twin does, in the same order, so the two frames are equal bit for
bit.

A scalar parameter (bloom's threshold and strength, the exposure) is a
number or a one-element tensor; on the card it is read by the kernel
through its pointer, so nothing waits for it.  SSAO's radii and bloom's
dilations are at most MAX_TAPS ints whose halo (SSAO's largest radius,
bloom's sum of dilations) is at most MAX_HALO pixels, the most a block's
shared tile holds.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

F32 = torch.float32
STAGES = ("sky", "ssao", "bloom", "tonemap", "fxaa")
# Kernel launches so far, by stage; chip_smoke.py and the card tests reset
# and read them to show that a frame's post chain went through the kernels.
LAUNCHES = dict.fromkeys(STAGES, 0)
# csrc/post_fx.cu's kMaxTaps and kMaxHalo.
MAX_TAPS = 8
MAX_HALO = 16
TONEMAP_MODES = {"reinhard": 0, "aces": 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "post_sky_launch": [_P] * 4 + [_I] * 3 + [_P, _I, _I, _P],
    "post_ssao_launch": [_P] * 5 + [_I, _F, _F, _F, _P, _I, _I, _P],
    "post_bloom_launch": [_P, _P, _I, _P, _F, _P, _F, _P, _I, _I, _P],
    "post_tonemap_launch": [_P, _I, _P, _F, _P, ctypes.c_longlong, _P],
    "post_fxaa_launch": [_P, _F, _F, _F, _P, _I, _I, _P],
}


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t contiguous and starting on a 16-byte boundary, as the kernels read
    it (a copy only where it is not)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _taps(name: str, values, halo: int) -> ctypes.Array:
    if len(values) > MAX_TAPS:
        raise ValueError(f"{name}: at most {MAX_TAPS} values, got "
                         f"{len(values)}")
    if halo > MAX_HALO:
        raise ValueError(f"{name} {tuple(values)} need a halo of {halo} "
                         f"pixels; the post kernels' shared tile holds at "
                         f"most MAX_HALO = {MAX_HALO}")
    return (ctypes.c_int * max(len(values), 1))(*values)


def _frame(color: torch.Tensor, depth: Optional[torch.Tensor] = None):
    """color (H, W, 4) and depth (H, W), both float32 on one card, laid
    out densely; returns (color, depth, device, H, W)."""
    for name, t, dims in (("color", color, 3), ("depth", depth, 2)):
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, not on "
                             f"{t.device}")
        if t.device != color.device or t.dtype != F32 or t.dim() != dims:
            raise ValueError(f"{name} must be float32 with {dims} "
                             f"dimensions on {color.device}, not {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    H, W = color.shape[:2]
    if color.shape[2] != 4 or (depth is not None
                               and tuple(depth.shape) != (H, W)):
        raise ValueError(f"color must be (H, W, 4) and depth (H, W), not "
                         f"{tuple(color.shape)} and "
                         f"{None if depth is None else tuple(depth.shape)}")
    return (_dense(color), None if depth is None else _dense(depth),
            color.device, H, W)


def _scalar(name: str, value, device):
    """(device f32 one-element tensor or None, value): a CUDA tensor is
    passed by pointer, anything else (a number, a CPU tensor) by value."""
    if isinstance(value, torch.Tensor) and value.is_cuda:
        if value.numel() != 1 or value.device != device:
            raise ValueError(f"{name} must be one value on {device}, not "
                             f"{tuple(value.shape)} on {value.device}")
        return value.to(F32), 0.0
    return None, float(value)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(stage: str, entry: str, *args, device) -> None:
    from softwarerenderer_tpu_torch.kernels import build
    fn = getattr(build.load("post_fx"), entry)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"post_fx {stage} launch failed: CUDA error {err}")
    LAUNCHES[stage] += 1


def sky(color: torch.Tensor, depth: torch.Tensor, rays: torch.Tensor,
        panorama: torch.Tensor) -> torch.Tensor:
    """ops/sky.composite_sky_plain's color: rays (11 + W + H,) f32 as
    ops/sky.ray_basis stages them, panorama (PH, PW, 4) u8 or any type
    the twin reads as float32."""
    color, depth, dev, H, W = _frame(color, depth)
    if rays.device != dev or rays.dtype != F32 \
            or tuple(rays.shape) != (11 + W + H,) \
            or not rays.is_contiguous():
        raise ValueError(f"rays must be ({11 + W + H},) float32 on {dev}")
    if panorama.device != dev or panorama.dim() != 3 \
            or panorama.shape[-1] != 4 or panorama.numel() == 0:
        raise ValueError(f"panorama must be (PH, PW, 4) on {dev}, not "
                         f"{tuple(panorama.shape)} on {panorama.device}")
    u8 = panorama.dtype == torch.uint8
    pano = _dense(panorama if u8 else panorama.to(F32))
    out = torch.empty_like(color)
    if not out.numel():
        return out
    _launch("sky", "post_sky_launch", color.data_ptr(), depth.data_ptr(),
            rays.data_ptr(), pano.data_ptr(), pano.shape[0], pano.shape[1],
            int(u8), out.data_ptr(), H, W, device=dev)
    return out


def ssao(color: torch.Tensor, depth: torch.Tensor, near_clip: torch.Tensor,
         far_clip: torch.Tensor, strength=0.9, radii=(1, 2, 4),
         range_frac=0.02, bias_frac=0.002) -> torch.Tensor:
    """ops/ssao.apply_ssao_plain's color; near_clip and far_clip float32
    one-element tensors on the frame's card."""
    radii = [int(r) for r in radii]
    taps = _taps("ssao radii", radii, max((abs(r) for r in radii),
                                          default=0))
    color, depth, dev, H, W = _frame(color, depth)
    for name, v in (("near_clip", near_clip), ("far_clip", far_clip)):
        if not isinstance(v, torch.Tensor) or v.device != dev \
                or v.dtype != F32 or v.numel() != 1:
            raise ValueError(f"{name} must be one float32 value on {dev}")
    out = torch.empty_like(color)
    if not out.numel():
        return out
    _launch("ssao", "post_ssao_launch", color.data_ptr(), depth.data_ptr(),
            near_clip.data_ptr(), far_clip.data_ptr(), taps, len(radii),
            range_frac, bias_frac, strength, out.data_ptr(), H, W,
            device=dev)
    return out


def bloom(color: torch.Tensor, threshold=0.8, strength=0.7,
          dilations=(1, 2, 4)) -> torch.Tensor:
    """ops/bloom.apply_bloom_plain."""
    dilations = [int(d) for d in dilations]
    taps = _taps("bloom dilations", dilations,
                 sum(abs(d) for d in dilations))
    color, _, dev, H, W = _frame(color)
    thr, thr_v = _scalar("threshold", threshold, dev)
    st, st_v = _scalar("strength", strength, dev)
    out = torch.empty_like(color)
    if not out.numel():
        return out
    _launch("bloom", "post_bloom_launch", color.data_ptr(), taps,
            len(dilations), _ptr(thr), thr_v, _ptr(st), st_v, out.data_ptr(),
            H, W, device=dev)
    return out


def tonemap(color: torch.Tensor, mode: str, exposure=1.0) -> torch.Tensor:
    """ops/tonemap.apply_tonemap_plain with `mode` "reinhard" or "aces"."""
    code = TONEMAP_MODES[mode]
    color, _, dev, H, W = _frame(color)
    ex, ex_v = _scalar("exposure", exposure, dev)
    out = torch.empty_like(color)
    if not out.numel():
        return out
    _launch("tonemap", "post_tonemap_launch", color.data_ptr(), code,
            _ptr(ex), ex_v, out.data_ptr(), H * W, device=dev)
    return out


def fxaa(color: torch.Tensor, abs_threshold=1.0 / 24.0,
         rel_threshold=1.0 / 8.0, subpix_cap=0.75) -> torch.Tensor:
    """ops/fxaa.apply_fxaa_plain."""
    color, _, dev, H, W = _frame(color)
    out = torch.empty_like(color)
    if not out.numel():
        return out
    _launch("fxaa", "post_fxaa_launch", color.data_ptr(), abs_threshold,
            rel_threshold, subpix_cap, out.data_ptr(), H, W, device=dev)
    return out
