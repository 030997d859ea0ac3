"""Bloom, a post stage: bright pass, separable dilated [1, 2, 1] / 4 blur
and additive composite.

Counterpart of ``softwarerenderer_tpu/ops/bloom.py``: three blur passes
at dilations 1, 2 and 4 along each axis, every tap an edge-replicated
shift (``ops.ssao.shift``).  On the card the stage is one kernel
(ops/post_kernels.bloom), whose plain twin is ``apply_bloom_plain``.
"""

from __future__ import annotations

import torch

from softwarerenderer_tpu_torch.ops import post_kernels
from softwarerenderer_tpu_torch.ops.ssao import shift


def _blur121(a: torch.Tensor, axis: int, d: int) -> torch.Tensor:
    if axis == 0:
        lo, hi = shift(a, -d, 0), shift(a, d, 0)
    else:
        lo, hi = shift(a, 0, -d), shift(a, 0, d)
    return (lo + a + a + hi) * 0.25


def compute_bloom(color: torch.Tensor, threshold=0.8,
                  dilations=(1, 2, 4)) -> torch.Tensor:
    """The blurred bright pass of an (H, W, 4) frame, (H, W, 3)."""
    b = (color[..., :3] - threshold).clamp(min=0.0)
    for d in dilations:
        b = _blur121(b, 0, d)
        b = _blur121(b, 1, d)
    return b


def apply_bloom(color: torch.Tensor, threshold=0.8, strength=0.7,
                dilations=(1, 2, 4)) -> torch.Tensor:
    """color + strength · blur(max(color - threshold, 0)), clipped to
    [0, 1]; alpha kept.  threshold and strength are floats or device
    scalars (uniforms["bloom_threshold"], ["bloom_strength"]).  CUDA
    tensors launch csrc/post_fx.cu's bloom kernel (ops/post_kernels.bloom),
    CPU tensors run apply_bloom_plain."""
    if not color.is_cuda:
        return apply_bloom_plain(color, threshold, strength, dilations)
    return post_kernels.bloom(color, threshold, strength, dilations)


def apply_bloom_plain(color: torch.Tensor, threshold=0.8, strength=0.7,
                      dilations=(1, 2, 4)) -> torch.Tensor:
    """apply_bloom in plain PyTorch, the bloom kernel's twin."""
    glow = compute_bloom(color, threshold=threshold, dilations=dilations)
    rgb = (color[..., :3] + strength * glow).clamp(0.0, 1.0)
    return torch.cat([rgb, color[..., 3:4]], dim=-1)
