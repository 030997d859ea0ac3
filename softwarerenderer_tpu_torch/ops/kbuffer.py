"""The K-slot K-buffer: order-correct translucency under any monotone
depth test.

Counterpart of ``softwarerenderer_tpu/ops/kbuffer.py``
(``render_binned_kbuffer``), the route JAX's render_frame takes for a
binned deferred K-buffer frame off its Pallas route.  The port renders a
LESS_EQUAL K-buffer through the depth peel (tile_raster.render_tile_kbuffer)
and every other monotone depth test here.  JAX computes this in XLA, not
in Pallas, so plain PyTorch is its counterpart on the card too: it has no
kernel.  The contract, not JAX's one-hot-matmul shape, is carried over:

  * Pass A, the K slots: each pixel keeps its K best fragments by the
    rank of ``rank_mode``, as K rounds of binning.fold_binned's
    integer-key fold, round r admitting only keys strictly below round
    r - 1's winner at that pixel.  The rank is raster.fold_keys' under
    LESS, GREATER and GREATER_EQUAL, and LESS_EQUAL's (the largest depth
    first, later ids winning ties) under ALWAYS and DISABLED: JAX's
    comment says those rank by index alone, its code (``use_max = True``)
    ranks by depth, and the code is followed.  The slots start empty and
    do not see fb_depth; the seed enters only in the replay.  A fragment
    at the rank's worst depth (-inf when the largest depth ranks first,
    +inf when the smallest does) never takes a slot, as in JAX.
  * A NaN fragment never takes a slot.  JAX's chunked max lets one NaN
    fragment void every fragment of its ``params.chunk``-triangle chunk at
    that pixel, which depends on the chunking; that is not carried over
    (the same choice as ops.raster's folds).
  * Pass B: each non-empty slot's winner is interpolated
    (raster.winner_fragments) and shaded.  A round that fills no slot
    ends the fold (one host read a round), so slots past the last
    non-empty one are neither folded nor shaded.
  * Pass C: tile_raster.replay_layers with the frame's depth test, in
    submission order, over fb_color and fb_depth; no depth write under
    DISABLED.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from softwarerenderer_tpu_torch.utils.profiling import span

from softwarerenderer_tpu_torch.config import DepthTest, RenderParams
from softwarerenderer_tpu_torch.ops import binning, raster, tile_raster

F32 = torch.float32


def rank_mode(mode: DepthTest) -> DepthTest:
    """The depth test whose fold keys rank a pixel's K slots under `mode`:
    `mode` itself, LESS_EQUAL for ALWAYS and DISABLED.
    NotImplementedError for EQUAL and NOT_EQUAL."""
    use_max, _ = raster.reduce_rules(mode)
    return DepthTest.LESS_EQUAL if use_max is None else mode


def kslot_fold(tris: Dict, params: RenderParams, row_offset=0):
    """Pass A: (depths (n, H, W) f32, ids (n, H, W) i32) of each pixel's n
    <= params.kbuffer best fragments by rank_mode, slot 0 first; an empty
    slot holds the worst depth and id -1.  n stops at the first round
    that fills no slot."""
    mode = rank_mode(params.depth_test)
    worst = float("-inf") if raster.reduce_rules(mode)[0] else float("inf")
    H, W = params.height, params.width
    empty = torch.full((H, W), worst, dtype=F32,
                       device=tris["screen"].device)
    args, kwargs = binning.fold_inputs(tris, params, params.tile_h,
                                       params.tile_w, params.span_cap, empty,
                                       row_offset)
    depths, ids, below = [], [], None
    for _ in range(params.kbuffer):
        bd, bi = binning.fold_binned(*args, **kwargs, mode=mode, below=below)
        bi = torch.where(bd == worst, raster.NO_TRI, bi)
        live = (bi[:H, :W] >= 0).any()
        with span("sync.kslot_live"):
            live = bool(live)
        if not live:
            break
        depths.append(bd[:H, :W])
        ids.append(bi[:H, :W])
        below = raster.fold_keys(bd, bi.long(), mode)
    if not ids:
        return empty.new_empty((0, H, W)), \
            empty.new_empty((0, H, W), dtype=torch.int32)
    return torch.stack(depths), torch.stack(ids)


def render_binned_kbuffer(tris: Dict, fragment_shader: Callable,
                          uniforms: Dict, params: RenderParams,
                          fb_color: torch.Tensor, fb_depth: torch.Tensor,
                          per_tri_extra: Optional[Dict] = None,
                          row_offset=0, with_stats: bool = False):
    """The K-buffer frame under params.depth_test, binned with
    params.tile_h x params.tile_w tiles and params.span_cap, over fb_color
    (H, W, 4) and fb_depth (H, W), K = params.kbuffer.

    Returns (color (H, W, 4), depth (H, W)), and with with_stats a third
    value {"kbuffer_saturated_px": pixels whose K-th slot holds a
    fragment}."""
    with span("kbuffer.slots"):
        sd, si = kslot_fold(tris, params, row_offset)
    with span("kbuffer.shade"):
        src = torch.stack([fragment_shader(raster.winner_fragments(
            tris, ids, per_tri_extra, row_offset), uniforms) for ids in si]) \
            if si.shape[0] else fb_color.new_zeros((0, *fb_color.shape))
    with span("kbuffer.replay"):
        return tile_raster.replay_layers(src, sd, si, fb_color, fb_depth,
                                         params, with_stats)
