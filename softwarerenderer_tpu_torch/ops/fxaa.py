"""FXAA-style anti-aliasing, a post stage: FXAA 3.11's detection and
subpixel blend over static neighbour shifts.

Counterpart of ``softwarerenderer_tpu/ops/fxaa.py``: Rec.601 luma; a
pixel whose 4-neighbourhood contrast is below ``max(abs_threshold,
rel_threshold · luma_max)`` stays as it is; otherwise it blends toward
the mean of the two neighbours across the edge (the orientation from the
second differences), by the smoothstep of its normalised distance from
the neighbourhood mean, squared and capped at ``subpix_cap``.  The edge
search of full FXAA is left out, as in JAX.  Its compares can flip on one
ulp of luma, so a frame may differ from JAX's on a few edge pixels.  On
the card the stage is one kernel (ops/post_kernels.fxaa), whose plain
twin is ``apply_fxaa_plain``.
"""

from __future__ import annotations

import numpy as np
import torch

from softwarerenderer_tpu_torch.ops import post_kernels
from softwarerenderer_tpu_torch.ops.ssao import shift

F32 = np.float32


def luma(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma of an (H, W, 3+) image, (H, W)."""
    return (rgb[..., 0] * float(F32(0.299)) + rgb[..., 1] * float(F32(0.587))
            + rgb[..., 2] * float(F32(0.114)))


def apply_fxaa(color: torch.Tensor, abs_threshold=1.0 / 24.0,
               rel_threshold=1.0 / 8.0, subpix_cap=0.75) -> torch.Tensor:
    """Anti-alias an (H, W, 4) frame; alpha passes through.  CUDA tensors
    launch csrc/post_fx.cu's FXAA kernel (ops/post_kernels.fxaa), CPU
    tensors run apply_fxaa_plain."""
    if not color.is_cuda:
        return apply_fxaa_plain(color, abs_threshold, rel_threshold,
                                subpix_cap)
    return post_kernels.fxaa(color, abs_threshold, rel_threshold,
                             subpix_cap)


def apply_fxaa_plain(color: torch.Tensor, abs_threshold=1.0 / 24.0,
                     rel_threshold=1.0 / 8.0,
                     subpix_cap=0.75) -> torch.Tensor:
    """apply_fxaa in plain PyTorch, the FXAA kernel's twin."""
    rgb = color[..., :3]
    c = luma(rgb)
    n, s = shift(c, -1, 0), shift(c, 1, 0)
    e, w = shift(c, 0, 1), shift(c, 0, -1)

    lmax = torch.maximum(c, torch.maximum(torch.maximum(n, s),
                                          torch.maximum(e, w)))
    lmin = torch.minimum(c, torch.minimum(torch.minimum(n, s),
                                          torch.minimum(e, w)))
    contrast = lmax - lmin
    active = contrast >= (lmax * float(F32(rel_threshold))).clamp(
        min=float(F32(abs_threshold)))

    # The subpixel blend factor: the centre's distance from its cross
    # mean, normalised by the contrast, through a smoothstep, squared.
    avg4 = (n + s + e + w) * 0.25
    amount = ((avg4 - c).abs() / contrast.clamp(min=1e-6)).clamp(0.0, 1.0)
    amount = amount * amount * (3.0 - 2.0 * amount)
    amount = (amount * amount).clamp(max=float(F32(subpix_cap)))

    # Blend across the edge: a horizontal edge mixes the vertical
    # neighbours.
    horiz = (n + s - c - c).abs() >= (e + w - c - c).abs()
    perp = torch.where(horiz[..., None],
                       (shift(rgb, -1, 0) + shift(rgb, 1, 0)) * 0.5,
                       (shift(rgb, 0, 1) + shift(rgb, 0, -1)) * 0.5)
    t = torch.where(active, amount, 0.0)[..., None]
    out = rgb + (perp - rgb) * t
    return torch.cat([out, color[..., 3:4]], dim=-1)
