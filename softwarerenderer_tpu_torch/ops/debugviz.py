"""Debug views beyond the reference's wireframe: the per-pixel OVERDRAW
heatmap and the DEPTH-buffer view.

Counterpart of ``softwarerenderer_tpu/ops/debugviz.py``.  Overdraw counts
every valid triangle slot whose inside test passes at the pixel centre
(both windings, integer centres, Rasterizer.cs:481-494), whatever its
depth.  The depth view maps the frame's covered depth range to a gray
ramp, nearer (larger, under the reversed convention) brighter.
"""

from __future__ import annotations

from typing import Dict

import torch

from softwarerenderer_tpu_torch.config import RenderParams
from softwarerenderer_tpu_torch.ops import raster

F32 = torch.float32

# Heatmap stops: black (0) -> blue -> green -> yellow -> red (saturation).
_RAMP_T = (0.0, 0.25, 0.5, 0.75, 1.0)
_RAMP_RGB = ((0.0, 0.0, 0.0),
             (0.1, 0.25, 0.9),
             (0.1, 0.85, 0.2),
             (0.95, 0.9, 0.1),
             (1.0, 0.12, 0.08))


def overdraw_count(tris: Dict, params: RenderParams, chunk: int = 128
                   ) -> torch.Tensor:
    """(H, W) int32 count of valid triangle slots covering each pixel:
    valid slots only, at most raster.MAX_CHUNK_ELEMS (slot, pixel) pairs
    at a time; `chunk` changes nothing here."""
    H, W = params.height, params.width
    dev = tris["screen"].device
    setup = raster.setup_rows(tris)
    px, py = raster.pixel_grid(H, W, dev)
    ids = torch.nonzero(tris["valid"]).squeeze(1)
    count = torch.zeros(H * W, dtype=torch.int32, device=dev)
    step = max(1, raster.MAX_CHUNK_ELEMS // (H * W))
    for c in range(0, ids.numel(), step):
        inside, _ = raster.fragments(setup[ids[c:c + step]], px, py)
        count += inside.sum(0, dtype=torch.int32)
    return count.reshape(H, W)


def overdraw_to_color(count: torch.Tensor, saturate: int = 8
                      ) -> torch.Tensor:
    """Count -> (H, W, 4) heatmap, red at `saturate` fragments per pixel:
    jnp.interp over the ramp's stops, written out (the divisors are device
    tensors: CUDA divides by a host scalar as a multiply by its
    reciprocal)."""
    dev = count.device
    xp = torch.tensor(_RAMP_T, dtype=F32, device=dev)
    fp = torch.tensor(_RAMP_RGB, dtype=F32, device=dev)
    sat = torch.tensor(float(max(1, saturate)), dtype=F32, device=dev)
    t = (count.to(F32) / sat).clamp(0.0, 1.0)
    i = torch.searchsorted(xp, t, right=True).clamp(1, len(_RAMP_T) - 1)
    delta = (t - xp[i - 1])[..., None]
    rgb = fp[i - 1] + delta / (xp[i] - xp[i - 1])[..., None] \
        * (fp[i] - fp[i - 1])
    rgb = torch.where((t > xp[-1])[..., None], fp[-1], rgb)
    return torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)


def depth_view(depth: torch.Tensor, clear=raster.DEPTH_CLEAR
               ) -> torch.Tensor:
    """Depth buffer -> (H, W, 4) gray ramp over the frame's covered range
    (nearer brighter under the reversed convention); uncovered pixels
    black."""
    covered = depth != clear
    inf = float("inf")
    dmin = torch.where(covered, depth, inf).amin()
    dmax = torch.where(covered, depth, -inf).amax()
    span = torch.clamp(dmax - dmin, min=1e-20)
    t = ((depth - dmin) / span).clamp(0.0, 1.0)
    g = torch.where(covered, 0.08 + 0.92 * t, 0.0)
    return torch.cat([g[..., None].expand(*g.shape, 3),
                      torch.ones_like(g)[..., None]], dim=-1)


def render_overdraw(tris: Dict, params: RenderParams):
    """OVERDRAW frame: (heatmap color, the counts as f32 in the depth
    plane, so a caller reads exact numbers)."""
    count = overdraw_count(tris, params)
    return overdraw_to_color(count), count.to(F32)


def render_depth_view(tris: Dict, params: RenderParams,
                      fb_depth: torch.Tensor, chunk: int = 128):
    """DEPTH frame: the gray view of the winner depth buffer, computed by
    the frame's own visibility pass (raster.default_visibility, seeded
    from fb_depth), and that buffer."""
    best_d, _ = raster.default_visibility(params)(
        tris, params, chunk, init_depth=fb_depth)
    return depth_view(best_d), best_d
