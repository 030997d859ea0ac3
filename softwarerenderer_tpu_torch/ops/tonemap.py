"""Tone mapping, a post stage: Reinhard or Narkowicz's ACES fit over the
exposure-scaled rgb.

Counterpart of ``softwarerenderer_tpu/ops/tonemap.py``; the exposure is
uniforms["exposure"] (1 by default).  On the card the stage is one kernel
(ops/post_kernels.tonemap), whose plain twin is ``apply_tonemap_plain``.
"""

from __future__ import annotations

from typing import Dict

import torch

from softwarerenderer_tpu_torch.ops import post_kernels


def reinhard(x: torch.Tensor) -> torch.Tensor:
    """x / (1 + x), the classic global operator."""
    return x / (1.0 + x)


def aces(x: torch.Tensor) -> torch.Tensor:
    """Narkowicz's ACES filmic fit, clipped to [0, 1]."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return ((x * (a * x + b)) / (x * (c * x + d) + e)).clamp(0.0, 1.0)


OPERATORS = {"reinhard": reinhard, "aces": aces}


def apply_tonemap(color: torch.Tensor, mode: str,
                  uniforms: Dict) -> torch.Tensor:
    """The operator `mode` over max(rgb, 0) · exposure; alpha kept.  CUDA
    tensors launch csrc/post_fx.cu's tone-map kernel
    (ops/post_kernels.tonemap), CPU tensors run apply_tonemap_plain."""
    if not color.is_cuda:
        return apply_tonemap_plain(color, mode, uniforms)
    return post_kernels.tonemap(color, mode, uniforms.get("exposure", 1.0))


def apply_tonemap_plain(color: torch.Tensor, mode: str,
                        uniforms: Dict) -> torch.Tensor:
    """apply_tonemap in plain PyTorch, the tone-map kernel's twin."""
    exposure = uniforms.get("exposure", 1.0)
    rgb = OPERATORS[mode](color[..., :3].clamp(min=0.0) * exposure)
    return torch.cat([rgb, color[..., 3:4]], dim=-1)
