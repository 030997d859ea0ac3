"""Exact forward rasterization: the triangles in submission order.

Counterpart of ``softwarerenderer_tpu/ops/forward.py``: each valid
triangle in turn is evaluated, depth-tested against the CURRENT buffer,
shaded, blended and written, as the reference's per-triangle pipeline
(Rasterizer.cs:401-539) does in its pinned sequential order.  It is the
exact route for what the deferred route cannot do: EQUAL and NOT_EQUAL
depth tests, ordered translucency, a discard that reveals a farther
triangle, ``deferred=False``, and the wireframe with an order-dependent
depth test.  O(T·H·W) work in the worst case, one host loop step per
triangle: not a hot path.

Each step evaluates its triangle over its screen bbox only (each edge, in
wireframe, over the edge's truncated bbox), the window that holds every
pixel it covers, and leaves the rest of the buffer as it was; triangles
that are not valid change nothing and are skipped (one host read of the
valid ids and the windows).

Wireframe (Rasterizer.cs:232-340 DrawLine, dispatched at :419-424): each
triangle's three screen edges draw as lines of 0.5 px half-width with the
reference's quirks: depth 1 / lerp(depths[0], depths[1], t) for every
edge, attributes from raster vertices 0 and 1 with weights (1-t, t, 0),
pixel centres at +0.5, the truncated bbox, written where alpha != 0.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from softwarerenderer_tpu_torch.config import (EPSILON, DebugMode, DepthTest,
                                               RenderParams)
from softwarerenderer_tpu_torch.ops import raster

F32 = torch.float32


def _depth_passes(mode: DepthTest, new: torch.Tensor, old: torch.Tensor):
    """The reference's inverted comparison table (Rasterizer.cs:542-559),
    elementwise, with the order-dependent EQUAL and NOT_EQUAL rows."""
    if mode == DepthTest.LESS_EQUAL:
        return new >= old
    if mode == DepthTest.LESS:
        return new > old
    if mode == DepthTest.GREATER:
        return new < old
    if mode == DepthTest.GREATER_EQUAL:
        return new <= old
    if mode == DepthTest.EQUAL:
        return (new - old).abs() < EPSILON
    if mode == DepthTest.NOT_EQUAL:
        return (new - old).abs() >= EPSILON
    return torch.ones_like(new, dtype=torch.bool)


def _pack_attrs(tris: Dict):
    """Every varying in one (N, 3, K) block, its column slices and
    keys."""
    keys = sorted(tris["attrs"])
    slices, off = {}, 0
    for k in keys:
        slices[k] = (off, off + tris["attrs"][k].shape[-1])
        off = slices[k][1]
    return torch.cat([tris["attrs"][k] for k in keys], dim=-1), slices, keys


def _interp_fragment(av, slices: Dict, clip_w, ws) -> Dict:
    """Rasterizer.Interpolate over a window for ONE triangle's attrs av
    (3, K) with edge weights ws = (w0, w1, w2) already times 1/area."""
    return raster.interpolate([av[0], av[1], av[2]],
                              raster.rcp_weights(ws, clip_w), slices)


def _windows(tris: Dict, ids: torch.Tensor, wireframe: bool, H: int, W: int,
             row_offset: int):
    """Host lists of each drawn triangle's (or, in wireframe, each of its
    three edges') window: inclusive (x0, x1, y0, y1) band rows."""
    if wireframe:
        s = tris["screen"][ids]
        p0, p1 = s[:, [0, 1, 2]], s[:, [1, 2, 0]]
        x0, x1, y0, y1 = raster.segment_bbox(p0, p1, W, H - 1 + row_offset)
        box = torch.stack([x0, x1, y0, y1], dim=-1)           # (n, 3, 4)
    else:
        b = tris["bbox"][ids]
        box = torch.stack([b[:, 0], b[:, 2], b[:, 1], b[:, 3]], dim=-1)
        box = box[:, None]
    box = box.clone()
    box[..., 0] = box[..., 0].clamp(min=0)
    box[..., 1] = box[..., 1].clamp(max=W - 1)
    box[..., 2] = (box[..., 2] - row_offset).clamp(min=0)
    box[..., 3] = (box[..., 3] - row_offset).clamp(max=H - 1)
    return box.tolist()


def render_forward(tris: Dict, fragment_shader: Callable, uniforms: Dict,
                   params: RenderParams, fb_color: torch.Tensor,
                   fb_depth: torch.Tensor,
                   per_tri_extra: Optional[Dict] = None, row_offset=0):
    """Sequential blend-exact pass; render_deferred's contract.  Returns
    (color (H, W, 4), depth (H, W)), new tensors."""
    H, W = fb_depth.shape
    dev = fb_depth.device
    packed, slices, _ = _pack_attrs(tris)
    cw = slices["clip_position"][1] - 1
    wireframe = params.debug_mode == DebugMode.WIREFRAME
    depth_writes = params.depth_test != DepthTest.DISABLED
    color = fb_color.expand(H, W, 4).clone()
    depth = fb_depth.clone()
    setup = raster.setup_rows(tris)
    ids = torch.nonzero(tris["valid"]).squeeze(1)

    def grid(box):
        """The window's (rows, cols) slices and its pixel columns (1, w)
        and screen rows (h, 1)."""
        x0, x1, y0, y1 = box
        px = torch.arange(x0, x1 + 1, device=dev).to(F32)[None]
        py = torch.arange(y0 + row_offset, y1 + row_offset + 1,
                          device=dev).to(F32)[:, None]
        return (slice(y0, y1 + 1), slice(x0, x1 + 1)), px, py

    def draw(i, win, covered, d, ws, av):
        """Depth-test, shade and blend triangle i's fragments over the
        window win of the buffers."""
        win_c, win_d = color[win], depth[win]
        passes = covered & _depth_passes(params.depth_test, d, win_d)
        frag = _interp_fragment(av, slices, av[:, cw], ws)
        if per_tri_extra:
            frag["tri"] = {k: v[i] for k, v in per_tri_extra.items()}
        src = fragment_shader(frag, uniforms)
        alpha = src[..., 3]
        written = passes & ((alpha != 0) if wireframe else (alpha > 0))
        win_c.copy_(torch.where(written[..., None],
                                raster.blend(src, win_c, params.blend_mode),
                                win_c))
        if depth_writes:
            win_d.copy_(torch.where(written, d, win_d))

    for i, boxes in zip(ids.tolist(), _windows(tris, ids, wireframe, H, W,
                                               row_offset)):
        if wireframe:
            s, dd = tris["screen"][i], tris["depth"][i, :2]
            line_av = packed[i][[0, 1, 0]]
        for e, box in enumerate(boxes):
            if box[0] > box[1] or box[2] > box[3]:
                continue
            win, px, py = grid(box)
            if not wireframe:
                draw(i, win, *raster.fragment_of(setup[i].unbind(), px, py),
                     packed[i])
                continue
            covered, d, t = raster.segment_fragments(
                s[e], s[(e + 1) % 3], dd, px, py, W, H - 1 + row_offset)
            draw(i, win, covered, d, [1.0 - t, t, torch.zeros_like(t)],
                 line_av)
    return color, depth
