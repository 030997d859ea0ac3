"""Tile binning: sort-middle rasterization without locks.

Counterpart of ``bin_triangles`` in ``softwarerenderer_tpu/ops/binning.py``.
Every valid triangle emits (tile, triangle) pairs for the screen tiles its
clamped bbox overlaps (up to `span_cap` of them); the pairs are sorted by
tile with the triangle id as the tiebreak (submission order inside a tile)
and each tile's segment is found with ``searchsorted``.  Triangles spanning
more than `span_cap` tiles go to a "global" list that every tile folds.
The fold is order-independent (lexicographic on (depth, index)), so the
global/binned split changes no pixel.

The sort key is tile << tri_bits | tri in int64: torch on the CPU has no
``>>`` for uint32, and 64 bits never overflow where the JAX package needs a
two-key sort.
"""

from __future__ import annotations

from typing import Dict

import torch

from softwarerenderer_tpu.config import RenderParams


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def bin_triangles(tris: Dict, params: RenderParams, tile_h: int,
                  tile_w: int, span_cap: int) -> Dict:
    """The sorted (tile, triangle) pair table and the global list.

    Returns a dict of int32 tensors:
      order      (N,)            triangle ids, globals first, each class in
                                 submission order
      n_global   (1,)            number of globals leading `order`
      sorted_tri (N * span_cap,) pair-table triangle ids, sorted by tile
      starts, counts (ntiles,)   each tile's segment of sorted_tri
    """
    H, W = params.height, params.width
    nty, ntx = cdiv(H, tile_h), cdiv(W, tile_w)
    ntiles = nty * ntx
    bbox = tris["bbox"].long()
    n = bbox.shape[0]
    dev = bbox.device

    overlap = (bbox[:, 3] >= 0) & (bbox[:, 1] <= H - 1)
    valid = tris["valid"] & overlap
    tx0 = bbox[:, 0] // tile_w
    ty0 = bbox[:, 1].clamp(0, H - 1) // tile_h
    tx1 = bbox[:, 2] // tile_w
    ty1 = bbox[:, 3].clamp(0, H - 1) // tile_h
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
    skey, _ = torch.sort((tile_id << tri_bits) | tri_id)
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
