"""Framebuffer constants and the blend equation.

Counterpart of ``DEPTH_CLEAR`` and ``_blend`` in
``softwarerenderer_tpu/ops/raster.py``.
"""

from __future__ import annotations

import torch

from softwarerenderer_tpu.config import BlendMode

# float.MinValue (MainWindow.cs:434): the depth buffer's clear value.
DEPTH_CLEAR = torch.finfo(torch.float32).min


def blend(src: torch.Tensor, dst: torch.Tensor,
          mode: BlendMode) -> torch.Tensor:
    """Rasterizer.Blend (Rasterizer.cs:57-65)."""
    if mode == BlendMode.ALPHA:
        a = src[..., 3:4]
        return src * a + dst * (1.0 - a)
    if mode == BlendMode.ADDITIVE:
        return torch.clamp(src + dst, max=1.0)
    if mode == BlendMode.MULTIPLY:
        return src * dst
    return src
