"""Tile binning: sort-middle rasterization without locks.

Counterpart of ``bin_triangles``, ``visibility_binned`` and
``make_binned_visibility`` in ``softwarerenderer_tpu/ops/binning.py``.
Every valid triangle emits (tile, triangle) pairs for the screen tiles its
clamped bbox overlaps (up to `span_cap` of them); the pairs are sorted by
tile with the triangle id as the tiebreak (submission order inside a tile)
and each tile's segment is found with ``searchsorted``.  Triangles spanning
more than `span_cap` tiles go to a "global" list that every tile folds.
The fold is order-independent (lexicographic on (depth, index)), so the
global/binned split changes no pixel.

The sort key is tile << tri_bits | tri in int64: torch on the CPU has no
``>>`` for uint32, and 64 bits never overflow where the JAX package needs a
two-key sort.  With ``params.pair_cap`` the live pairs are compacted to
that many before the sort, as JAX's are; ``live_pair_count`` and
``global_count`` count what pair_cap and global_cap truncate.

``visibility_binned`` folds every tile's globals and segment under any
monotone depth test (ops.raster's keys) for the contiguous band of rows at
``row_offset``.  The JAX function's ``tile_row_map`` and ``tile_map``
modes, which let a device own an arbitrary set of tiles, belong to the
multi-device port (``parallel/``) and are not here; ``render_binned_fused``,
a one-hot-matmul TPU shape of the same fold, resolve and shade, is not
ported: the tile kernel and ops.raster.render_deferred cover its frame.
"""

from __future__ import annotations

from typing import Dict

import torch

from softwarerenderer_tpu_torch.config import DepthTest, RenderParams
from softwarerenderer_tpu_torch.ops import raster
from softwarerenderer_tpu_torch.ops.geometry import compaction


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bin_triangles(tris: Dict, params: RenderParams, tile_h: int,
                  tile_w: int, span_cap: int, row_offset: int = 0) -> Dict:
    """The sorted (tile, triangle) pair table and the global list.

    params.height is the band's height and row_offset its first screen
    row: bbox rows are shifted by it, and a triangle outside the band
    emits nothing.

    Returns a dict of int32 tensors:
      order      (N,)            triangle ids, globals first, each class in
                                 submission order
      n_global   (1,)            number of globals leading `order`
      sorted_tri (N * span_cap,) pair-table triangle ids, sorted by tile
                                 (params.pair_cap long when that is set
                                 and below N * span_cap)
      starts, counts (ntiles,)   each tile's segment of sorted_tri
    """
    H, W = params.height, params.width
    nty, ntx = cdiv(H, tile_h), cdiv(W, tile_w)
    ntiles = nty * ntx
    bbox = tris["bbox"].long()
    n = bbox.shape[0]
    dev = bbox.device

    by0, by1 = bbox[:, 1] - row_offset, bbox[:, 3] - row_offset
    valid = tris["valid"] & (by1 >= 0) & (by0 <= H - 1)
    tx0 = bbox[:, 0] // tile_w
    ty0 = by0.clamp(0, H - 1) // tile_h
    tx1 = bbox[:, 2] // tile_w
    ty1 = by1.clamp(0, H - 1) // tile_h
    span_w = tx1 - tx0 + 1
    span = span_w * (ty1 - ty0 + 1)
    is_global = valid & (span > span_cap)
    is_binned = valid & ~is_global

    # Stable partition, globals first: slot i goes to its running count
    # within its class.
    gi = is_global.long()
    n_global = gi.sum()
    tgt = torch.where(is_global, gi.cumsum(0) - 1,
                      n_global + (1 - gi).cumsum(0) - 1)
    ids = torch.arange(n, device=dev)
    order = torch.empty(n, dtype=torch.long, device=dev).scatter_(0, tgt, ids)

    # Pair expansion: slot s of triangle t covers bbox tile (s // span_w,
    # s % span_w); slots past the span and non-binned triangles get the
    # ntiles sentinel and sort to the tail.
    s_idx = torch.arange(span_cap, device=dev)[None, :]
    sw = span_w.clamp(min=1)[:, None]
    tile_id = (ty0[:, None] + s_idx // sw) * ntx + (tx0[:, None] + s_idx % sw)
    pair_ok = is_binned[:, None] & (s_idx < span[:, None])
    tile_id = torch.where(pair_ok, tile_id, ntiles).reshape(-1)

    tri_bits = max(1, (n - 1).bit_length())
    tri_id = ids[:, None].expand(n, span_cap).reshape(-1)
    key = (tile_id << tri_bits) | tri_id
    # Live-pair compaction (params.pair_cap): the live pairs, in their
    # triangle-major order, stable-compacted to a pair_cap prefix before
    # the sort, so the sort and the table scale with the cap.  Sorting the
    # prefix gives the live head of the full table's sort; past the cap the
    # last-submitted pairs are dropped.  A cap at or above the table is
    # off.
    pair_cap = int(params.pair_cap or 0)
    if 0 < pair_cap < n * span_cap:
        perm, kept, _ = compaction(tile_id < ntiles, pair_cap)
        key = torch.where(kept, key[perm], ntiles << tri_bits)
    skey, _ = torch.sort(key)
    sorted_tile = skey >> tri_bits
    sorted_tri = skey & ((1 << tri_bits) - 1)

    tids = torch.arange(ntiles, device=dev)
    starts = torch.searchsorted(sorted_tile, tids)
    ends = torch.searchsorted(sorted_tile, tids, right=True)
    i32 = torch.int32
    return {
        "order": order.to(i32),
        "n_global": n_global.reshape(1).to(i32),
        "sorted_tri": sorted_tri.to(i32),
        "starts": starts.to(i32),
        "counts": (ends - starts).to(i32),
        "ntx": ntx, "nty": nty,
    }


def _tile_spans(tris: Dict, params: RenderParams, row_offset: int = 0):
    """(tile span, validity) of each slot at params' tiling: the bbox
    arithmetic of bin_triangles without the pair table."""
    H, th, tw = params.height, params.tile_h, params.tile_w
    bbox = tris["bbox"].long()
    by0, by1 = bbox[:, 1] - row_offset, bbox[:, 3] - row_offset
    valid = tris["valid"] & (by1 >= 0) & (by0 <= H - 1)
    span = (bbox[:, 2] // tw - bbox[:, 0] // tw + 1) \
        * (by1.clamp(0, H - 1) // th - by0.clamp(0, H - 1) // th + 1)
    return span, valid


def live_pair_count(tris: Dict, params: RenderParams,
                    row_offset: int = 0) -> torch.Tensor:
    """The live (tile, triangle) pairs binning emits at params' tiling and
    span_cap, the quantity params.pair_cap truncates, as a 0-d int32
    device tensor (the JAX function's, at its default tiling)."""
    span, valid = _tile_spans(tris, params, row_offset)
    return torch.where(valid & (span <= params.span_cap), span, 0).sum(
        dtype=torch.int32)


def global_count(tris: Dict, params: RenderParams,
                 row_offset: int = 0) -> torch.Tensor:
    """The global (span > span_cap) triangles at params' tiling, the
    quantity params.global_cap truncates, as a 0-d int32 device
    tensor."""
    span, valid = _tile_spans(tris, params, row_offset)
    return (valid & (span > params.span_cap)).sum(dtype=torch.int32)


def tile_pairs(order, n_global, sorted_tri, starts, counts):
    """Every (tile, triangle) pair a tile fold evaluates: each tile with
    every global (order[:n_global]), then with its own segment of
    sorted_tri.  Returns (pair_tile, pair_tri) int64."""
    counts = counts.long()
    ntiles = counts.numel()
    dev = counts.device
    tiles = torch.arange(ntiles, device=dev)
    ng = int(n_global[0])
    seg_tile = tiles.repeat_interleave(counts)
    first = counts.cumsum(0) - counts
    seg_pos = starts.long()[seg_tile] + torch.arange(
        seg_tile.numel(), device=dev) - first[seg_tile]
    return (torch.cat([tiles.repeat_interleave(ng), seg_tile]),
            torch.cat([order[:ng].long().repeat(ntiles),
                       sorted_tri.long()[seg_pos]]))


def to_tiles(img: torch.Tensor, tile_h: int, tile_w: int) -> torch.Tensor:
    """(Hp, Wp) -> flat, tile by tile, each tile row-major."""
    Hp, Wp = img.shape
    return img.reshape(Hp // tile_h, tile_h, Wp // tile_w, tile_w) \
        .permute(0, 2, 1, 3).reshape(-1)


def to_image(t: torch.Tensor, Hp: int, Wp: int, tile_h: int,
             tile_w: int) -> torch.Tensor:
    """The inverse of to_tiles."""
    return t.reshape(Hp // tile_h, Wp // tile_w, tile_h, tile_w) \
        .permute(0, 2, 1, 3).reshape(Hp, Wp)


def fold_binned(fbd, setup, order, n_global, sorted_tri, starts, counts, *,
                tile_h: int, tile_w: int, row_offset: int = 0,
                mode: DepthTest = DepthTest.LESS_EQUAL, below=None):
    """The binned per-pixel winner under `mode` over padded (Hp, Wp)
    tiles: each pixel's seed fbd, then every tile's globals and segment.

    setup: (N, 10) set-up rows (raster.setup_rows), indexed by triangle
    id.  Pixel (x, y) of the band is evaluated at screen row
    y + row_offset.  Pairs are expanded over their tile's pixels at most
    raster.MAX_CHUNK_ELEMS at a time, each fragment becomes a
    raster.fold_keys key and a scatter-amax keeps each pixel's largest.
    below: None, or (Hp, Wp) int64 keys; a fragment then enters only if
    its key is strictly below its pixel's (the K-slot fold's rounds,
    ops.kbuffer).  Returns (best_d (Hp, Wp) f32, best_i (Hp, Wp) i32)."""
    dev = fbd.device
    Hp, Wp = fbd.shape
    ntx, tpx = Wp // tile_w, tile_h * tile_w
    lane = torch.arange(tpx, device=dev)
    lx, ly = lane % tile_w, lane // tile_w + row_offset
    pair_tile, pair_tri = tile_pairs(order, n_global, sorted_tri, starts,
                                     counts)
    seed = to_tiles(fbd, tile_h, tile_w)
    keys = raster.fold_keys(seed, torch.full_like(
        seed, raster.NO_TRI, dtype=torch.long), mode)
    if below is not None:
        below = to_tiles(below, tile_h, tile_w)
    step = max(1, raster.MAX_CHUNK_ELEMS // tpx)
    for c0 in range(0, pair_tile.numel(), step):
        tl = pair_tile[c0:c0 + step]
        tri = pair_tri[c0:c0 + step]
        px = (((tl % ntx) * tile_w)[:, None] + lx).to(torch.float32)
        py = (((tl // ntx) * tile_h)[:, None] + ly).to(torch.float32)
        inside, d = raster.fragments(setup[tri], px, py)
        key = raster.fold_keys(d, tri[:, None], mode)
        pix = (tl[:, None] * tpx + lane).reshape(-1)
        ok = raster.admitted(inside, d, mode)
        if below is not None:
            ok &= key < below[pix].reshape(key.shape)
        key = torch.where(ok, key, raster.NEVER)
        keys.scatter_reduce_(0, pix, key.reshape(-1), reduce="amax")
    best_d, best_i = raster.decode_keys(keys, seed, mode)
    return (to_image(best_d, Hp, Wp, tile_h, tile_w),
            to_image(best_i, Hp, Wp, tile_h, tile_w))


def fold_inputs(tris: Dict, params: RenderParams, tile_h: int, tile_w: int,
                span_cap: int, init_depth=None, row_offset: int = 0):
    """(args, kwargs) of fold_binned (and of K5, vis_fold.vis_fold) for a
    frame: the seed init_depth (DEPTH_CLEAR by default) padded to whole
    tiles, the set-up rows and the bins."""
    H, W = params.height, params.width
    nty, ntx = cdiv(H, tile_h), cdiv(W, tile_w)
    if init_depth is None:
        init_depth = torch.full((H, W), raster.DEPTH_CLEAR,
                                dtype=torch.float32,
                                device=tris["screen"].device)
    fbd = torch.nn.functional.pad(init_depth,
                                  (0, ntx * tile_w - W, 0, nty * tile_h - H))
    bins = bin_triangles(tris, params, tile_h, tile_w, span_cap, row_offset)
    args = (fbd.contiguous(), raster.setup_rows(tris), bins["order"],
            bins["n_global"], bins["sorted_tri"], bins["starts"],
            bins["counts"])
    return args, dict(tile_h=tile_h, tile_w=tile_w, row_offset=row_offset)


def visibility_binned(tris: Dict, params: RenderParams, chunk: int = 32,
                      init_depth=None, row_offset: int = 0, *,
                      tile_h: int = 32, tile_w: int = 128,
                      span_cap: int = 16):
    """Binned per-pixel (depth, triangle id) winner under any monotone
    depth test: the contract of raster.visibility_brute_force, with work
    proportional to the triangle-tile overlap.

    The frame is the band of params.height rows starting at screen row
    row_offset.  chunk is the JAX package's working-set size and changes
    nothing here; its tile_group goes with the tile maps.  Returns (best_depth (H, W) f32,
    best_tri (H, W) i32)."""
    mode = params.depth_test
    raster.reduce_rules(mode)
    args, kwargs = fold_inputs(tris, params, tile_h, tile_w, span_cap,
                               init_depth, row_offset)
    best_d, best_i = fold_binned(*args, **kwargs, mode=mode)
    return best_d[:params.height, :params.width], \
        best_i[:params.height, :params.width]


def make_binned_visibility(tile_h: int = 32, tile_w: int = 128,
                           span_cap: int = 16):
    """A visibility_fn for raster.render_deferred: visibility_binned with
    this tiling."""
    def fn(tris, params, chunk=32, init_depth=None, row_offset=0):
        return visibility_binned(tris, params, chunk, init_depth, row_offset,
                                 tile_h=tile_h, tile_w=tile_w,
                                 span_cap=span_cap)
    return fn
