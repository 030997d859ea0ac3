"""K5's split lists on the CPU.  csrc/vis_fold.cu cuts each tile's list
(its globals, then its segment) into parts of part_len triangles and takes
(tile, block, part) work items from the list vis_fold.fold_items builds
with the device's tensor ops.  Here that list covers every entry of every
tile exactly once, longest tiles first; and a plain emulation of the
kernel's split (each part folded alone with the twin's keys, merged with
torch.maximum, then decoded with the seed) equals visibility_fold_plain
bit for bit on tests/test_torch_vis_fold.py's scenes, on chip_smoke.py's
edge cases and on its split edge cases, for several part_len."""

import os
import sys

import pytest
import torch

from softwarerenderer_tpu_torch.config import DepthTest
from softwarerenderer_tpu_torch.ops import binning, raster, vis_fold

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import vis_fold_edge_cases, vis_fold_split_cases  # noqa: E402
from test_torch_vis_fold import (PARAMS, SCENES, jax_tris,  # noqa: E402
                                 scene_mesh, to_torch)

LE = DepthTest.LESS_EQUAL
# part_len 1 puts every entry in its own part; 10**6 is longer than every
# list, so no tile splits.
PART_LENS = [1, 3, 16, 10 ** 6]


def expand_items(tiles, first, blocks):
    """Every work item as the kernel decodes it: (tile, part, block,
    parts of its tile), the tile at the last position j with first[j] <=
    item."""
    first = first.long()
    item = torch.arange(int(first[-1]))
    j = torch.searchsorted(first, item, right=True) - 1
    local = item - first[j]
    return (tiles[j], local // blocks, local % blocks,
            (first[j + 1] - first[j]) // blocks)


def part_entries(n_global, counts, tile, part, part_len):
    """The list positions [lo, hi) of part `part` of each tile in `tile`."""
    lens = n_global.long() + counts.long()
    lo = part * part_len
    return lo, torch.minimum(lens[tile], torch.as_tensor(lo + part_len))


def fold_by_parts(fbd, setup, order, n_global, sorted_tri, starts, counts,
                  *, tile_h, tile_w, origin=None, part_len):
    """The kernel's split in plain PyTorch.  Each (tile, triangle) pair
    falls in part (its position in the tile's list) // part_len, as in
    fold_items' list; each part is folded alone with the twin's keys (a
    scatter-amax over its own pixels, from nothing), publishes only the
    pixels where it found a fragment, as the kernel's atomics do, and the
    parts are merged with the seed's keys by torch.maximum and decoded as
    the twin decodes."""
    Hp, Wp = fbd.shape
    ntx, tpx = Wp // tile_w, tile_h * tile_w
    npix = Hp * Wp
    ng, ntiles = int(n_global[0]), counts.numel()
    pair_tile, pair_tri = binning.tile_pairs(order, n_global, sorted_tri,
                                             starts, counts)
    c = counts.long()
    seg_tile = pair_tile[ng * ntiles:]
    pos = torch.cat([torch.arange(ng).repeat(ntiles),
                     ng + torch.arange(seg_tile.numel())
                     - (c.cumsum(0) - c)[seg_tile]])
    part = pos // part_len
    nparts = int(part.max()) + 1 if pos.numel() else 1
    lane = torch.arange(tpx)
    lx, ly = lane % tile_w, lane // tile_w
    parts = torch.full((nparts * npix,), raster.NEVER, dtype=torch.long)
    step = max(1, raster.MAX_CHUNK_ELEMS // tpx)
    for c0 in range(0, pair_tile.numel(), step):
        tl, tri = pair_tile[c0:c0 + step], pair_tri[c0:c0 + step]
        if origin is None:             # a tile at its own place
            y0, x0 = (tl // ntx) * tile_h, (tl % ntx) * tile_w
        else:                          # at its screen origin (y0, x0)
            y0, x0 = origin[tl, 0].long(), origin[tl, 1].long()
        px = (x0[:, None] + lx).to(torch.float32)
        py = (y0[:, None] + ly).to(torch.float32)
        inside, d = raster.fragments(setup[tri], px, py)
        key = torch.where(raster.admitted(inside, d, LE),
                          raster.fold_keys(d, tri[:, None], LE),
                          raster.NEVER)
        at = part[c0:c0 + step, None] * npix + tl[:, None] * tpx + lane
        parts.scatter_reduce_(0, at.reshape(-1), key.reshape(-1),
                              reduce="amax")
    # A part's fold starts at (-inf, no triangle), which every fragment it
    # admits beats; it publishes nothing where it found none.
    nothing = raster.fold_keys(torch.tensor(float("-inf")),
                               torch.tensor(raster.NO_TRI), LE)
    parts = parts.reshape(nparts, npix)
    published = torch.where(parts > nothing, parts, raster.NEVER)
    seed = binning.to_tiles(fbd, tile_h, tile_w)
    keys = torch.maximum(raster.fold_keys(seed, torch.full_like(
        seed, raster.NO_TRI, dtype=torch.long), LE), published.amax(0))
    best_d, best_i = raster.decode_keys(keys, seed, LE)
    return (binning.to_image(best_d, Hp, Wp, tile_h, tile_w),
            binning.to_image(best_i, Hp, Wp, tile_h, tile_w))


def scene_inputs(name):
    tris = to_torch(jax_tris(scene_mesh(name)))
    return binning.fold_inputs(tris, PARAMS, PARAMS.tile_h, PARAMS.tile_w,
                               PARAMS.span_cap)


@pytest.mark.parametrize("part_len", PART_LENS)
@pytest.mark.parametrize("scene", SCENES)
def test_work_list_covers_every_entry_once(scene, part_len):
    """Every (tile, part, block) item once, the parts of a tile cutting
    [0, len) into consecutive runs of part_len, each part on every block
    of the tile, and the tiles in order of nonincreasing list length."""
    args, kwargs = scene_inputs(scene)
    n_global, counts = args[3], args[6]
    blocks = -(-kwargs["tile_h"] * kwargs["tile_w"] // 1024)
    assert blocks == 2
    tiles, first = vis_fold.fold_items(n_global, counts, part_len, blocks)
    assert first.dtype == torch.int32 and int(first[0]) == 0
    tile, part, blk, nparts = expand_items(tiles, first, blocks)
    lens = n_global.long() + counts.long()
    seen = set(zip(tile.tolist(), part.tolist(), blk.tolist()))
    assert len(seen) == tile.numel()
    for t in range(counts.numel()):
        want = -(-int(lens[t]) // part_len) or 1
        assert {(p, b) for tt, p, b in seen if tt == t} \
            == {(p, b) for p in range(want) for b in range(blocks)}
        lo, hi = part_entries(n_global, counts, torch.tensor([t] * want),
                              torch.arange(want), part_len)
        assert lo[0] == 0 and hi[-1] == lens[t]
        assert torch.equal(lo[1:], hi[:-1]) and bool((hi >= lo).all())
    assert bool((nparts == ((lens[tile] + part_len - 1) // part_len)
                 .clamp(min=1)).all())
    assert bool((lens[tile][1:] <= lens[tile][:-1]).all())
    if part_len == 1:
        assert int(first[-1]) == blocks * int(lens.clamp(min=1).sum())


@pytest.mark.parametrize("part_len", PART_LENS)
@pytest.mark.parametrize("scene", SCENES)
def test_split_emulation_equals_twin(scene, part_len):
    args, kwargs = scene_inputs(scene)
    want_d, want_i = vis_fold.visibility_fold_plain(*args, **kwargs)
    d, i = fold_by_parts(*args, **kwargs, part_len=part_len)
    assert (want_i >= 0).float().mean() > 0.05
    assert torch.equal(i, want_i)
    assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))


@pytest.mark.parametrize("case", range(5))
def test_split_emulation_on_the_edge_cases(case):
    """chip_smoke.py's K5 edge cases, each list split to one entry a
    part, which phase 14 also runs through the kernel."""
    name, args, kwargs, want_i, want_d = vis_fold_edge_cases("cpu")[case]
    d, i = fold_by_parts(*args, **kwargs, part_len=1)
    assert torch.equal(i, want_i), name
    assert torch.equal(d.view(torch.int32), want_d.view(torch.int32)), name


@pytest.mark.parametrize("case", range(6))
def test_split_edge_cases(case):
    """chip_smoke.py's split edge cases: the twin and the emulation at the
    case's part_len give the expected winners and depths, bit for bit, so
    a failure on the card is the kernel's."""
    name, args, kwargs, part_len, want_i, want_d = \
        vis_fold_split_cases("cpu")[case]
    for fold in (vis_fold.vis_fold, lambda *a, **k: fold_by_parts(
            *a, **k, part_len=part_len)):
        d, i = fold(*args, **kwargs)
        assert torch.equal(i, want_i), name
        assert torch.equal(d.view(torch.int32), want_d.view(torch.int32)), \
            name
    tiles, first = vis_fold.fold_items(args[3], args[6], part_len, 1)
    assert int(first[-1]) > tiles.numel()          # some tile splits


def test_vis_fold_rejects_a_part_len_below_one():
    name, args, kwargs, _, _ = vis_fold_edge_cases("cpu")[0]
    with pytest.raises(ValueError, match="part_len"):
        vis_fold.vis_fold(*args, **kwargs, part_len=0)
