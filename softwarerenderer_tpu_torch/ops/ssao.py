"""Screen-space ambient occlusion, a post stage over the finished
(color, depth) frame.

Counterpart of ``softwarerenderer_tpu/ops/ssao.py``: each pixel's linear
view distance comes from the stored depth (the reference's negated
(ndcZ + 1) / 2), is compared with fixed-offset neighbours in four
direction pairs at radii 1, 2 and 4, and pixels whose neighbourhood is
nearer on both sides of a pair (creases, contact lines) darken.
Neighbours are edge-replicated shifts (``shift``), which ops.bloom and
ops.fxaa share.  Every division has a tensor divisor: CUDA divides by a
host scalar as a multiply by its reciprocal, which rounds once more.  On
the card the stage is one kernel (ops/post_kernels.ssao), whose plain
twin is ``apply_ssao_plain``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from softwarerenderer_tpu_torch.ops import post_kernels
from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR

F32 = np.float32

# Four direction pairs: occlusion needs both sides of a pair nearer than
# the centre (a valley); a planar slope has one side nearer and one
# farther, so flat geometry at any angle adds nothing.
_PAIRS = [(1, 0), (0, 1), (1, 1), (1, -1)]


def shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """a (H, W, ...) shifted so that out[y, x] = a[y + dy, x + dx], the
    indices clamped into the image (JAX's edge-mode pad and slice, never
    a wrap)."""
    H, W = a.shape[0], a.shape[1]
    ys = (torch.arange(H, device=a.device) + dy).clamp(0, H - 1)
    xs = (torch.arange(W, device=a.device) + dx).clamp(0, W - 1)
    return a[ys][:, xs]


def linear_view_distance(depth: torch.Tensor, near: torch.Tensor,
                         far: torch.Tensor) -> torch.Tensor:
    """Stored depth -> linear view distance in [near, far]; clear pixels
    map to `far`.  Clear depth (-FLT_MAX) is swapped for a finite stand-in
    before the linearisation, so -2 · depth never overflows to inf."""
    clear = depth == DEPTH_CLEAR
    s = torch.where(clear, -0.5, depth)
    ndc = -2.0 * s - 1.0
    den = far + ndc * (near - far)
    d = far * near / torch.where(den == 0, 1e-9, den)
    return torch.where(clear, far, torch.minimum(torch.maximum(d, near), far))


def compute_ssao(depth: torch.Tensor, uniforms: Dict, radii=(1, 2, 4),
                 range_frac=0.02, bias_frac=0.002) -> torch.Tensor:
    """Occlusion (H, W) in [0, 1] from the stored depth: a tap occludes
    when the neighbour is nearer by more than the bias, fading out once
    the gap passes the range (both relative to the centre distance)."""
    d = linear_view_distance(depth, uniforms["near_clip"],
                             uniforms["far_clip"])
    ao = torch.zeros_like(d)
    taps = 0
    for r in radii:
        rng = d * float(F32(range_frac)) * float(r)
        bias = d * float(F32(bias_frac))
        for dy, dx in _PAIRS:
            gp = d - shift(d, dy * r, dx * r)          # > 0: nearer
            gm = d - shift(d, -dy * r, -dx * r)
            gap = torch.minimum(gp, gm)                # both sides nearer
            occ = ((gap - bias) / rng.clamp(min=1e-6)).clamp(0.0, 1.0)
            # a fully ranged gap is a silhouette over open space, not a
            # crease: fade it back out
            occ = occ * (2.0 - occ).clamp(0.0, 1.0)
            ao = ao + occ
            taps += 1
    n_taps = torch.full((), float(taps), device=depth.device)
    return (ao * 2.0 / n_taps).clamp(0.0, 1.0)


def apply_ssao(color: torch.Tensor, depth: torch.Tensor, uniforms: Dict,
               strength: float = 0.9, radii=(1, 2, 4), range_frac=0.02,
               bias_frac=0.002):
    """(color, depth) with covered pixels darkened by the occlusion;
    clear-depth pixels pass through.  CUDA tensors launch
    csrc/post_fx.cu's SSAO kernel (ops/post_kernels.ssao), CPU tensors
    run apply_ssao_plain."""
    if not depth.is_cuda:
        return apply_ssao_plain(color, depth, uniforms, strength, radii,
                                range_frac, bias_frac)
    return post_kernels.ssao(
        color, depth, uniforms["near_clip"], uniforms["far_clip"],
        strength=strength, radii=radii, range_frac=range_frac,
        bias_frac=bias_frac), depth


def apply_ssao_plain(color: torch.Tensor, depth: torch.Tensor,
                     uniforms: Dict, strength: float = 0.9, radii=(1, 2, 4),
                     range_frac=0.02, bias_frac=0.002):
    """apply_ssao in plain PyTorch, the SSAO kernel's twin."""
    ao = compute_ssao(depth, uniforms, radii=radii, range_frac=range_frac,
                      bias_frac=bias_frac)
    covered = depth != DEPTH_CLEAR
    shade = 1.0 - float(F32(strength)) * ao
    rgb = color[..., :3] * torch.where(covered, shade, 1.0)[..., None]
    return torch.cat([rgb, color[..., 3:4]], dim=-1), depth
