"""Deferred (visibility-buffer) rasterization.

Counterpart of ``softwarerenderer_tpu/ops/raster.py``: a per-pixel
(depth, triangle id) visibility pass under the active depth test, then one
full-frame interpolation and shading of each pixel's winner, blended over
the framebuffer (``render_deferred``); the brute-force visibility pass
(``visibility_brute_force``); the deferred wireframe
(``render_wireframe_deferred``); and the framebuffer constants and blend
equation every route shares.

Every monotone depth test is a lexicographic order on (depth, submission
index) (``_REDUCE_RULES``), so a pass keeps, per pixel, the largest int64
key of ``fold_keys`` over its fragments and the framebuffer seed; the
order of the fold does not matter.  A fragment whose depth is NaN never
wins under a depth test (the JAX fold lets one void its whole chunk, which
depends on the chunking); under ALWAYS and DISABLED the depth is not
compared and the latest covering triangle wins.  EQUAL and NOT_EQUAL are
order-dependent: ops.forward renders them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from softwarerenderer_tpu_torch.utils.profiling import span

from softwarerenderer_tpu_torch.config import BlendMode, DepthTest, RenderParams
from softwarerenderer_tpu_torch.ops.geometry import unflatten_varyings

F32 = torch.float32
I32 = torch.int32

# float.MinValue (MainWindow.cs:434): the depth buffer's clear value.
DEPTH_CLEAR = torch.finfo(torch.float32).min
NO_TRI = -1

# Depth-test reduction rules: mode -> (use_max, later_wins_ties), from the
# reference's inverted comparison table (Rasterizer.cs:542-559):
# LESS_EQUAL = "new >= old" is a max where the latest triangle wins ties,
# LESS = "new > old" a max where the earliest wins, and so on; ALWAYS and
# DISABLED keep the last covering triangle.
_REDUCE_RULES = {
    DepthTest.LESS_EQUAL: (True, True),
    DepthTest.LESS: (True, False),
    DepthTest.GREATER: (False, False),
    DepthTest.GREATER_EQUAL: (False, True),
    DepthTest.ALWAYS: (None, True),
    DepthTest.DISABLED: (None, True),
}

# Temporaries of the brute-force passes stay under this many elements.
MAX_CHUNK_ELEMS = 1 << 22
NEVER = torch.iinfo(torch.int64).min     # the key of a fragment that lost
_TIE_SPAN = 1 << 31
_LOW32 = 0xFFFFFFFF


def reduce_rules(mode: DepthTest):
    """(use_max, later_wins) of a monotone depth test; NotImplementedError
    for EQUAL and NOT_EQUAL."""
    if mode not in _REDUCE_RULES:
        raise NotImplementedError(
            f"depth test {mode!r} is order-dependent; use render_forward")
    return _REDUCE_RULES[mode]


def _ordered(d: torch.Tensor) -> torch.Tensor:
    """int64 of the same order as the float32 d, -0.0 folded into +0.0."""
    bits = (d + 0.0).view(I32).long()
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def fold_keys(d: torch.Tensor, idx: torch.Tensor, mode: DepthTest
              ) -> torch.Tensor:
    """int64 keys whose maximum over a pixel's fragments and its seed
    (idx = NO_TRI) is the winner under `mode`.

    Depth tests put the depth's order (reversed for the min modes) in the
    high 32 bits and the tie rank in the low: idx + 1 when later triangles
    win ties (the seed loses every tie, as "new >= old"), 2^31 - 1 - idx
    when earlier ones do (the seed wins every tie, as "new > old").
    ALWAYS and DISABLED rank by idx alone and carry the depth's bits
    below it."""
    use_max, later = reduce_rules(mode)
    if use_max is None:
        return (idx + 1) * (1 << 32) + (d.view(I32).long() & _LOW32)
    v = _ordered(d)
    if not use_max:
        v = ~v
    tie = idx + 1 if later else _TIE_SPAN - 1 - idx
    return v * (1 << 32) + tie


def decode_keys(keys: torch.Tensor, seed: torch.Tensor, mode: DepthTest):
    """(best_d f32, best_i i32) of folded keys; pixels the seed kept keep
    the seed's depth, and a NaN seed keeps every pixel (no depth beats
    it)."""
    use_max, later = reduce_rules(mode)
    if use_max is None:
        idx = (keys >> 32) - 1
        d = (keys & _LOW32).to(I32).view(F32)
    else:
        v = keys >> 32
        if not use_max:
            v = ~v
        d = torch.where(v < 0, v ^ 0x7FFFFFFF, v).to(I32).view(F32)
        low = keys & _LOW32
        idx = low - 1 if later else _TIE_SPAN - 1 - low
        idx = torch.where(torch.isnan(seed), NO_TRI, idx)
    won = idx >= 0
    return torch.where(won, d, seed), idx.to(I32)


def admitted(inside: torch.Tensor, d: torch.Tensor, mode: DepthTest):
    """Fragments that enter the fold: inside, and under a depth test not
    NaN."""
    if _REDUCE_RULES[mode][0] is None:
        return inside
    return inside & ~torch.isnan(d)


def setup_rows(tris: Dict) -> torch.Tensor:
    """(N, 10) f32 set-up rows of the folds: s0x s0y s1x s1y s2x s2y d0 d1
    d2 and 1/area, zeroed for invalid slots (pallas_raster._build_streams);
    row t is triangle t's."""
    screen = tris["screen"]
    n = screen.shape[0]
    inv_area = torch.where(tris["valid"], tris["inv_area"], 0.0)
    return torch.cat([screen.reshape(n, 6), tris["depth"],
                      inv_area[:, None]], dim=1).contiguous()


def edge_functions(c, px, py):
    """The edge functions (w0, w1, w2) of Rasterizer.cs:445-494 at pixel
    centres (px, py), of set-up columns c = (s0x, s0y, s1x, s1y, s2x,
    s2y, ...)."""
    s0x, s0y, s1x, s1y, s2x, s2y = c[:6]
    return [(s1y - s2y) * (px - s1x) + (s2x - s1x) * (py - s1y),
            (s2y - s0y) * (px - s2x) + (s0x - s2x) * (py - s2y),
            (s0y - s1y) * (px - s0x) + (s1x - s0x) * (py - s0y)]


def fragment_of(c, px, py):
    """(inside, depth, edge weights w_v·(1/area)) of set-up columns c
    (setup_rows' ten) at (px, py): inside either winding, the barycentric
    depth."""
    w = edge_functions(c, px, py)
    inside = ((w[0] >= 0) & (w[1] >= 0) & (w[2] >= 0)) | \
             ((w[0] <= 0) & (w[1] <= 0) & (w[2] <= 0))
    wf = [wv * c[9] for wv in w]
    return inside, c[6] * wf[0] + c[7] * wf[1] + c[8] * wf[2], wf


def fragments(s: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """(inside, depth) of the triangles with set-up rows s (n, 10) at pixel
    centres px, py broadcast against (n, 1)."""
    inside, d, _ = fragment_of([s[:, k:k + 1] for k in range(10)], px, py)
    return inside, d


def pixel_grid(H: int, W: int, device, row_offset=0):
    """(1, H*W) f32 pixel columns and rows, row-major."""
    px = torch.arange(W, device=device)
    py = torch.arange(H, device=device) + row_offset
    return (px.repeat(H).to(F32)[None],
            py.repeat_interleave(W).to(F32)[None])


def _brute_fold(seed: torch.Tensor, ids: torch.Tensor, evaluate: Callable,
                mode: DepthTest):
    """Fold items ids (their submission indices) over every pixel of the
    (H, W) seed, MAX_CHUNK_ELEMS at a time: evaluate(chunk) gives (inside,
    depth) of shape (len(chunk), H*W)."""
    keys = fold_keys(seed.reshape(-1), torch.full_like(
        seed.reshape(-1), NO_TRI, dtype=torch.long), mode)
    step = max(1, MAX_CHUNK_ELEMS // max(1, seed.numel()))
    for c in range(0, ids.numel(), step):
        t = ids[c:c + step]
        inside, d = evaluate(t)
        key = torch.where(admitted(inside, d, mode),
                          fold_keys(d, t[:, None], mode), NEVER)
        keys = torch.maximum(keys, key.amax(0))
    best_d, best_i = decode_keys(keys, seed.reshape(-1), mode)
    return best_d.reshape(seed.shape), best_i.reshape(seed.shape)


def visibility_brute_force(tris: Dict, params: RenderParams,
                           chunk: int = 128,
                           init_depth: Optional[torch.Tensor] = None,
                           row_offset=0, col_offset=0):
    """Per-pixel (depth, triangle id) winner over all triangles.

    Returns (best_depth (H, W) f32, best_tri (H, W) i32, NO_TRI where the
    seed init_depth (the cleared or previous depth buffer, DEPTH_CLEAR by
    default) kept the pixel).  Every fragment must beat the seed under the
    active comparison, as the reference tests against the buffer.  The
    frame is the (H, W) block at screen (row_offset, col_offset).  Only
    valid slots are evaluated (one host read of their ids), in chunks of
    at most MAX_CHUNK_ELEMS (slot, pixel) pairs; `chunk` is the JAX
    package's step size and changes nothing here."""
    reduce_rules(params.depth_test)
    H, W = params.height, params.width
    dev = tris["screen"].device
    if init_depth is None:
        init_depth = torch.full((H, W), DEPTH_CLEAR, dtype=F32, device=dev)
    setup = setup_rows(tris)
    px, py = pixel_grid(H, W, dev, row_offset)
    px = px + col_offset
    ids = torch.nonzero(tris["valid"]).squeeze(1)
    return _brute_fold(init_depth, ids,
                       lambda t: fragments(setup[t], px, py),
                       params.depth_test)


def default_visibility(params: RenderParams) -> Callable:
    """render_deferred's visibility pass for params: K5
    (vis_fold.visibility_fold) for binned LESS_EQUAL frames, the binned
    fold for the other depth tests, the brute force with binned=False."""
    from softwarerenderer_tpu_torch.ops import binning, vis_fold
    if not params.binned:
        return visibility_brute_force
    if params.depth_test == DepthTest.LESS_EQUAL:
        return vis_fold.visibility_fold
    return binning.make_binned_visibility(
        tile_h=params.tile_h, tile_w=params.tile_w,
        span_cap=params.span_cap)


def _normalized(v):
    """The vec3 "data" renormalization (Rasterizer.cs:680-688) of three
    channels, summed left to right."""
    lsq = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    den = torch.sqrt(torch.where(lsq > 0, lsq, 1.0))
    keep = lsq > 1e-6
    return [torch.where(keep, c / den, c) for c in v]


def interpolate(attrs, weights, slices: Dict) -> Dict:
    """Rasterizer.Interpolate (Rasterizer.cs:566-640) of gathered per-vertex
    values: attrs[v][c] is vertex v's column c, broadcast against the
    weights: the per-vertex reciprocal-w-corrected weights rcp_v and their
    normalizer w.  "data." varyings take the plain weights rcp_v·w (vec3
    ones renormalized), the rest the perspective form (Σ a_v·rcp_v)·w.
    Returns the fragment dict, channels last, with "barycentric"."""
    rcp, w = weights
    plain = [r * w for r in rcp]
    flat = {}
    for k, (lo, hi) in slices.items():
        cols = range(lo, hi)
        if k.startswith("data."):
            v = [sum_terms(a[c] * p for a, p in zip(attrs, plain))
                 for c in cols]
            if hi - lo == 3:
                v = _normalized(v)
        else:
            v = [sum_terms(a[c] * r for a, r in zip(attrs, rcp)) * w
                 for c in cols]
        flat[k] = torch.stack(v, dim=-1)
    frag = unflatten_varyings(flat)
    frag["barycentric"] = torch.stack(
        plain + [torch.zeros_like(w)] * (3 - len(plain)), dim=-1)
    return frag


def sum_terms(terms):
    """Left-to-right sum, the reference's summation order."""
    terms = list(terms)
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def rcp_weights(ws, clip_w):
    """The clip-w reciprocal correction: rcp_v = w_v / clip_w_v and the
    normalizer 1 / Σ rcp_v (1 where the sum is 0)."""
    rcp = [wv / cw for wv, cw in zip(ws, clip_w)]
    wsum = sum_terms(rcp)
    return rcp, 1.0 / torch.where(wsum == 0, 1.0, wsum)


def _packed(tris: Dict):
    """Every varying, the screen positions and 1/area in one (N, 3, Ktot)
    block, so each pixel gathers one row; with the varyings' column
    slices."""
    slices, parts, off = {}, [], 0
    for k in sorted(tris["attrs"]):
        arr = tris["attrs"][k]
        parts.append(arr)
        slices[k] = (off, off + arr.shape[-1])
        off += arr.shape[-1]
    n = tris["screen"].shape[0]
    parts += [tris["screen"], tris["inv_area"][:, None, None].expand(n, 3, 1)]
    return torch.cat(parts, dim=-1), slices, off


def interpolate_at_pixels(tris: Dict, tri_id: torch.Tensor,
                          covered: torch.Tensor, row_offset=0,
                          coords=None) -> Dict:
    """Perspective-correct fragment inputs of each pixel's winning triangle
    (Rasterizer.Interpolate, Rasterizer.cs:566-640): area-normalized edge
    weights at integer pixel centres, the clip-w reciprocal correction
    summed left to right, the vec3 "data" renormalization.  Pixels not
    covered read triangle 0.  Every varying, the screen positions and
    1/area are packed into one row per triangle and gathered once per
    pixel into planes, (3·Ktot, H·W): each column a contiguous plane.
    A pixel sits at screen row row_offset + y, or at coords, its (x, y)
    as two (1, H*W) f32 rows (the pixels of a band mapped by a tile origin
    map, binning.band_coords)."""
    H, W = tri_id.shape
    packed, slices, sl_screen = _packed(tris)
    n, _, ktot = packed.shape
    t = torch.where(covered, tri_id, 0).reshape(-1).long()
    planes = packed.reshape(n, 3 * ktot).t().contiguous()[:, t]
    a = [planes[v * ktot:(v + 1) * ktot] for v in range(3)]
    px, py = coords or pixel_grid(H, W, tri_id.device, row_offset)
    px, py = px[0], py[0]
    corners = [r[sl_screen + j] for r in a for j in (0, 1)]
    ia = a[0][sl_screen + 2]
    ws = [w * ia for w in edge_functions(corners, px, py)]
    cw = slices["clip_position"][1] - 1
    frag = interpolate(a, rcp_weights(ws, [r[cw] for r in a]), slices)
    return _reshape_frag(frag, (H, W))


def _reshape_frag(frag: Dict, shape) -> Dict:
    """Every tensor of a fragment dict from (P, ...) to (*shape, ...)."""
    if isinstance(frag, dict):
        return {k: _reshape_frag(v, shape) for k, v in frag.items()}
    return frag.reshape(*shape, *frag.shape[1:])


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


def write(color, written, best_depth, params: RenderParams, fb_color,
          fb_depth):
    """Blend color over fb_color where written, and write best_depth
    there unless the depth test is DISABLED."""
    out_c = torch.where(written[..., None],
                        blend(color, fb_color, params.blend_mode), fb_color)
    if params.depth_test == DepthTest.DISABLED:
        return out_c, fb_depth
    return out_c, torch.where(written, best_depth, fb_depth)


def winner_fragments(tris: Dict, best_tri: torch.Tensor,
                     per_tri_extra: Optional[Dict] = None,
                     row_offset=0, coords=None) -> Dict:
    """The fragment shader's input at each pixel's winner best_tri (H, W)
    (interpolate_at_pixels at row_offset or coords; a pixel at NO_TRI
    reads triangle 0), with per_tri_extra's (T,) per-triangle tensors
    gathered into frag["tri"]."""
    covered = best_tri != NO_TRI
    frag = interpolate_at_pixels(tris, best_tri, covered, row_offset,
                                 coords)
    if per_tri_extra:
        t = torch.where(covered, best_tri, 0).long()
        frag["tri"] = {k: v[t] for k, v in per_tri_extra.items()}
    return frag


def shade_deferred(tris: Dict, best_depth, best_tri,
                   fragment_shader: Callable, uniforms: Dict,
                   params: RenderParams, fb_color: torch.Tensor,
                   fb_depth: torch.Tensor,
                   per_tri_extra: Optional[Dict] = None,
                   row_offset=0, coords=None):
    """Shade each covered pixel's winner once, blend where the shaded alpha
    is > 0, and write its depth there (none with DISABLED).
    per_tri_extra: (T,) per-triangle tensors gathered into frag["tri"];
    row_offset or coords place the pixels on the screen
    (interpolate_at_pixels)."""
    covered = best_tri != NO_TRI
    with span("deferred.interp"):
        frag = winner_fragments(tris, best_tri, per_tri_extra, row_offset,
                                coords)
    with span("deferred.shade"):
        color = fragment_shader(frag, uniforms)
        return write(color, covered & (color[..., 3] > 0), best_depth,
                     params, fb_color, fb_depth)


def _segments(tris: Dict):
    """Each triangle's three edges (0→1, 1→2, 2→0), interleaved: (3N, 2)
    start and end points, (3N, 2) the first two vertices' depths (the
    reference uses them for every edge) and (3N,) validity."""
    screen = tris["screen"]
    p0 = screen[:, [0, 1, 2]].reshape(-1, 2)
    p1 = screen[:, [1, 2, 0]].reshape(-1, 2)
    return (p0, p1, tris["depth"][:, :2].repeat_interleave(3, 0),
            tris["valid"].repeat_interleave(3))


def _trunc(v: torch.Tensor, size: int) -> torch.Tensor:
    """int32 of v truncated toward zero, as XLA's float->int cast, clamped
    to [-1, size] first (which keeps every bbox test's answer)."""
    return v.clamp(-1, size).to(I32)


def segment_bbox(a0, a1, W: int, max_y):
    """DrawLine's truncated, clamped bbox (Rasterizer.cs:246-249, 262-266):
    (min_x, max_x, min_y, max_y) int32, max_y clamped to `max_y`."""
    return (_trunc(torch.clamp(torch.minimum(a0[..., 0], a1[..., 0]),
                               min=0), W),
            _trunc(torch.clamp(torch.maximum(a0[..., 0], a1[..., 0]),
                               max=W - 1), W),
            _trunc(torch.clamp(torch.minimum(a0[..., 1], a1[..., 1]),
                               min=0), max_y + 1),
            _trunc(torch.clamp(torch.maximum(a0[..., 1], a1[..., 1]),
                               max=max_y), max_y + 1))


def segment_t(a0, a1, pxc, pyc):
    """The clamped line parameter of pixel centres (pxc, pyc) on the
    segment a0 -> a1, and (dx, dy)."""
    dx = a1[..., 0] - a0[..., 0]
    dy = a1[..., 1] - a0[..., 1]
    len_sq = dx * dx + dy * dy
    t = torch.where(len_sq <= 0, 0.0,
                    ((pxc - a0[..., 0]) * dx + (pyc - a0[..., 1]) * dy)
                    / torch.where(len_sq == 0, 1.0, len_sq))
    return t.clamp(0.0, 1.0), dx, dy


def segment_fragments(a0, a1, dd, px, py, W: int, max_y):
    """(covered, depth, t) of segments a0 -> a1 (…, 2) at pixels (px, py):
    within the truncated bbox and 0.5 px of the line through pixel centres
    at +0.5, depth 1 / lerp(dd0, dd1, t) (Rasterizer.cs:262-310)."""
    min_x, max_x, min_y, max_y = segment_bbox(a0, a1, W, max_y)
    pxc, pyc = px + 0.5, py + 0.5
    t, dx, dy = segment_t(a0, a1, pxc, pyc)
    cx = a0[..., 0] + t * dx
    cy = a0[..., 1] + t * dy
    dist_sq = (pxc - cx) ** 2 + (pyc - cy) ** 2
    covered = (px >= min_x) & (px <= max_x) & (py >= min_y) & \
        (py <= max_y) & (dist_sq <= 0.25)
    d = 1.0 / (dd[..., 0] * (1.0 - t) + dd[..., 1] * t)
    return covered, d, t


def render_wireframe_deferred(tris: Dict, fragment_shader: Callable,
                              uniforms: Dict, params: RenderParams,
                              fb_color: torch.Tensor, fb_depth: torch.Tensor,
                              per_tri_extra: Optional[Dict] = None,
                              chunk: Optional[int] = None):
    """Deferred wireframe: the per-pixel (depth, edge) winner over the 3N
    triangle edges, then one shade of it.

    DrawLine's quirks (Rasterizer.cs:232-340): pixel centres at +0.5, the
    truncated bbox, depth from the first two vertices for every edge,
    attributes from vertices 0 and 1 with weights (1-t, t, 0), written
    where alpha != 0.  Edges of valid triangles only are evaluated, in
    chunks of at most MAX_CHUNK_ELEMS (edge, pixel) pairs; `chunk` changes
    nothing here."""
    mode = params.depth_test
    reduce_rules(mode)
    H, W = fb_depth.shape
    dev = fb_depth.device
    p0, p1, d01, valid = _segments(tris)
    px, py = pixel_grid(H, W, dev)

    def evaluate(s):
        covered, d, _ = segment_fragments(p0[s][:, None], p1[s][:, None],
                                          d01[s][:, None], px, py, W, H - 1)
        return covered, d

    best_d, best_i = _brute_fold(fb_depth, torch.nonzero(valid).squeeze(1),
                                 evaluate, mode)
    covered = best_i != NO_TRI
    seg = torch.where(covered, best_i, 0).long()
    tri_of = seg // 3
    px, py = px.reshape(H, W), py.reshape(H, W)
    t, _, _ = segment_t(p0[seg], p1[seg], px + 0.5, py + 0.5)
    packed, slices, _ = _packed(tris)
    av = packed[:, :2][tri_of]                        # (H, W, 2, Ktot)
    a = [av[..., 0, :].movedim(-1, 0), av[..., 1, :].movedim(-1, 0)]
    cw = slices["clip_position"][1] - 1
    frag = interpolate(a, rcp_weights([1.0 - t, t], [r[cw] for r in a]),
                       slices)
    if per_tri_extra:
        frag["tri"] = {k: v[tri_of] for k, v in per_tri_extra.items()}
    color = fragment_shader(frag, uniforms)
    return write(color, covered & (color[..., 3] != 0), best_d, params,
                 fb_color, fb_depth)


def render_deferred(tris: Dict, fragment_shader: Callable, uniforms: Dict,
                    params: RenderParams, fb_color: torch.Tensor,
                    fb_depth: torch.Tensor,
                    per_tri_extra: Optional[Dict] = None,
                    chunk: Optional[int] = None,
                    visibility_fn: Optional[Callable] = None,
                    row_offset=0):
    """Full deferred pass: visibility fold, one shade per covered pixel,
    blend.

    The fold is seeded with fb_depth, so stacked passes depth-test against
    earlier ones as the reference's shared buffer does.  visibility_fn
    (tris, params, chunk, init_depth=, row_offset=) -> (best_d, best_tri)
    defaults to default_visibility(params): K5 for binned LESS_EQUAL
    frames."""
    if visibility_fn is None:
        visibility_fn = default_visibility(params)
    with span("vis.fold"):
        best_d, best_i = visibility_fn(tris, params, chunk or params.chunk,
                                       init_depth=fb_depth,
                                       row_offset=row_offset)
    return shade_deferred(tris, best_d, best_i, fragment_shader, uniforms,
                          params, fb_color, fb_depth, per_tri_extra,
                          row_offset=row_offset)
