"""Multi-device rendering: framebuffer and triangle sharding over a mesh of
ranks.

Counterpart of ``softwarerenderer_tpu/parallel/sharding.py``.  JAX shards
one jitted program over a device mesh with ``shard_map``; the port runs
SPMD the PyTorch way: one process a rank (``parallel.multihost``), every
rank calling ``render_frame_sharded`` with the same arguments, on an
("fb", "tri") ``DeviceMesh`` (``make_mesh``).  The two axes are JAX's:

  * "fb": framebuffer bands.  Each rank renders its own rows; triangles
    are replicated.  Contiguous bands by default, or with ``balanced`` an
    equal share of tile rows ("rows") or tiles ("tiles") chosen by
    triangle-bbox occupancy (a greedy longest-first assignment).
  * "tri": triangle shards (``shard_scene_triangles``).  Each rank folds
    its own triangles; the shards' winners combine with a lexicographic
    (depth, global submission index) all-reduce (``_lex_allreduce``),
    each rank shades the pixels its shard won, and a masked sum composites
    them (exactly one shard writes a covered pixel).

A band is the port's own frame: ``engine.frame_setup`` (camera, culling,
the vertex updates, geometry and the caps, per shard) over the whole
screen, then the route the single-device frame would take, over the
band's tiles: on the tile route K1 (``tile_raster.render_tile``), with
``kbuffer`` the peel (K1 and K2) or the K-slot fold, elsewhere K5 (or the
binned fold of another depth test, or the brute force) and the deferred
resolve.  A band is placed on the screen by its tile origin map
(``binning.tile_pixels``): the kernels and the deferred resolve take it,
so every pixel is folded and interpolated at its screen position and a
band's pixels equal the single-device frame's.  A contiguous band is
binned at its row offset; a band that owns any set of tile rows or tiles
is binned once over the whole frame (``binning.bin_tiles``).  The bands
are gathered over "fb" so that every rank holds the whole frame; ``ssaa``
and the post chain wrap the sharded frame as they wrap ``render_frame``.
The routes that keep JAX's row-offset interface, the unbinned brute force
and the K-slot K-buffer, run on contiguous bands only.

JAX's one-hot ``shade_binned_fused`` resolve, a TPU shape of what K1 and
K5 compute, has no counterpart.  The balanced assignment runs on the
device, as JAX's ``fori_loop`` does (``lpt_assign``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from softwarerenderer_tpu_torch.config import DepthTest, RenderParams
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import (binning, kbuffer, raster,
                                            tile_raster, vis_fold)
from softwarerenderer_tpu_torch.ops.binning import cdiv
from softwarerenderer_tpu_torch.parallel import collectives
from softwarerenderer_tpu_torch.parallel.multihost import local_rank

F32 = torch.float32

# The triangle-major scene arrays a triangle shard slices.
TRI_KEYS = ("indices", "tri_mesh_id", "tri_texture_id", "tri_lod_level",
            "tri_normal_tex_id")


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` when given ("cpu" for gloo ranks,
    "cuda:i" for a card), else its card, cuda:<local rank>
    (multihost.local_rank)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a rank renders on its CUDA card unless asked for "
                           "device='cpu', and none is available")
    return torch.device("cuda", local_rank(dist.get_rank()))


def make_mesh(n_fb: int, n_tri: int = 1, device=None) -> DeviceMesh:
    """An ("fb", "tri") DeviceMesh over ranks 0 .. n_fb * n_tri - 1, laid out
    row-major as JAX's reshape(n_fb, n_tri).  Every rank of the process
    group calls it (torch.distributed must be initialised first:
    multihost.initialize_from_env).  Each rank renders on rank_device
    (device), which becomes its current CUDA device."""
    if not dist.is_initialized():
        raise RuntimeError("initialise torch.distributed first "
                           "(multihost.initialize_from_env), one process a "
                           "rank")
    need = n_fb * n_tri
    if dist.get_world_size() < need:
        raise ValueError(f"need {need} ranks, have {dist.get_world_size()}")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return DeviceMesh(dev.type, torch.arange(need).reshape(n_fb, n_tri),
                      mesh_dim_names=("fb", "tri"))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank renders on for `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_coordinate(mesh: DeviceMesh) -> tuple:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return tuple(coord)


def shard_scene_triangles(scene: Dict, n_tri: int) -> Dict:
    """The packed scene (numpy) with its triangle-major arrays padded to a
    multiple of n_tri, so each "tri" rank takes an equal slice, and
    "tri_valid" masking the padding out (padded slots index vertex 0 and
    never draw).  With n_tri > 1 the mesh-segment starts, which describe
    the whole triangle list, are dropped."""
    t = scene["indices"].shape[0]
    t_pad = -(-t // n_tri) * n_tri
    out = dict(scene)
    if n_tri > 1:
        out.pop("tri_seg_starts", None)
    pad = t_pad - t
    if pad:
        for k in TRI_KEYS:
            if k in scene:
                a = np.asarray(scene[k])
                out[k] = np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))
    out["tri_valid"] = np.arange(t_pad, dtype=np.int32) < t
    return out


def tri_shard(scene: Dict[str, torch.Tensor], tri_idx: int,
              n_tri: int) -> Dict[str, torch.Tensor]:
    """Rank tri_idx's slice of a padded scene's triangle-major arrays
    (views, no copy); the vertex arrays stay whole."""
    t_pad = scene["indices"].shape[0]
    if t_pad % n_tri:
        raise ValueError("run the scene through shard_scene_triangles first")
    if n_tri == 1:
        return scene
    t_local = t_pad // n_tri
    lo, hi = tri_idx * t_local, (tri_idx + 1) * t_local
    return {k: (v[lo:hi] if k in TRI_KEYS or k == "tri_valid" else v)
            for k, v in scene.items() if k != "tri_seg_starts"}


def _lex_allreduce(depth, idx, covered, mode: DepthTest, n_total: int,
                   group):
    """Combine each shard's (depth, global index) winner over `group` by
    the total preorder the single-device fold uses (raster.reduce_rules):
    (covered, depth, index) of the frame's winner.  Only covered depths
    enter the MAX / MIN, uncovered pixels at -inf / +inf, so no NaN meets
    a backend's reduce."""
    use_max, later = raster.reduce_rules(mode)
    MAX, MIN, SUM = dist.ReduceOp.MAX, dist.ReduceOp.MIN, dist.ReduceOp.SUM
    if use_max is None:               # ALWAYS, DISABLED: the last one wins
        gidx = torch.where(covered, idx, -1)
        istar = collectives.all_reduce(gidx.clone(), MAX, group)
        owner = covered & (gidx == istar)
        dstar = collectives.all_reduce(torch.where(owner, depth, 0.0), SUM,
                                       group)
        return istar >= 0, dstar, istar
    bad = float("-inf") if use_max else float("inf")
    dstar = collectives.all_reduce(torch.where(covered, depth, bad),
                                   MAX if use_max else MIN, group)
    at = covered & (depth == dstar)
    if later:
        istar = collectives.all_reduce(torch.where(at, idx, -1), MAX, group)
        return istar >= 0, dstar, istar
    istar = collectives.all_reduce(torch.where(at, idx, n_total), MIN, group)
    covered_star = istar < n_total
    return covered_star, dstar, torch.where(covered_star, istar, -1)


def lpt_assign(occ: torch.Tensor, n_dev: int) -> torch.Tensor:
    """JAX's greedy longest-processing-time assignment under an equal count
    per device, on occ's device with no host read: items in descending
    occupancy (a stable sort, so ties keep item order; negative occupancy
    marks padding, sorted last, load 0), each to the least-loaded device
    with room (the first such on ties), loads summed in float32.  Returns
    each item's device, (len(occ),) int64; every device gets
    len(occ) // n_dev items."""
    n = occ.numel()
    cap = n // n_dev
    occ = occ.to(F32)
    order = torch.argsort(-occ, stable=True)
    # Column i: item i's load and a count of 1, added to its device's
    # (load, count) in one launch; three launches an item in all.
    step = torch.stack([occ[order].clamp(min=0.0), torch.ones_like(occ)])
    state = torch.zeros((2, n_dev), dtype=F32, device=occ.device)
    full = torch.full((n_dev,), float("inf"), device=occ.device)
    picks = []
    for i in range(n):
        k = torch.where(state[1] < cap, state[0], full).argmin().view(1)
        state.index_add_(1, k, step[:, i:i + 1])
        picks.append(k)
    assign = torch.cat(picks) if picks else order.new_empty(0)
    return torch.empty_like(assign).scatter_(0, order, assign)


def _tile_spans(tris: Dict, H: int, W: int, th: int, tw: int):
    """Each slot's clamped tile-row and tile-column span, JAX's occupancy
    bounds: (ty0, ty1, tx0, tx1, valid)."""
    bbox = tris["bbox"].long()
    return ((bbox[:, 1].clamp(0, H - 1) // th),
            (bbox[:, 3].clamp(0, H - 1) // th),
            (bbox[:, 0].clamp(0, W - 1) // tw),
            (bbox[:, 2].clamp(0, W - 1) // tw), tris["valid"].long())


def row_occupancy(tris: Dict, H: int, W: int, th: int) -> torch.Tensor:
    """Valid slots whose clamped bbox overlaps each tile row (H // th,)
    int64, as a difference array over the rows."""
    ty0, ty1, _, _, v = _tile_spans(tris, H, W, th, 1)
    n = H // th
    d = torch.zeros(n + 1, dtype=torch.long, device=v.device)
    d.index_add_(0, ty0, v).index_add_(0, ty1 + 1, -v)
    return d.cumsum(0)[:n]


def tile_occupancy(tris: Dict, H: int, W: int, th: int,
                   tw: int) -> torch.Tensor:
    """Valid slots whose clamped bbox overlaps each tile, (nty * ntx,)
    int64 row-major: JAX's matmul of the row and column overlap masks, as
    a two-dimensional difference array."""
    ty0, ty1, tx0, tx1, v = _tile_spans(tris, H, W, th, tw)
    nty, ntx = cdiv(H, th), cdiv(W, tw)
    d = torch.zeros((nty + 1) * (ntx + 1), dtype=torch.long, device=v.device)
    for y, x, sign in ((ty0, tx0, 1), (ty0, tx1 + 1, -1),
                       (ty1 + 1, tx0, -1), (ty1 + 1, tx1 + 1, 1)):
        d.index_add_(0, y * (ntx + 1) + x, sign * v)
    d = d.reshape(nty + 1, ntx + 1).cumsum(0).cumsum(1)
    return d[:nty, :ntx].reshape(-1)


class _Band:
    """What one "fb" rank renders: a stored (height, width) frame of tiles
    that sit on the screen at a row offset (contiguous) or at full-frame
    tile ids `tiles` of tiling (th, tw) (balanced), and for the balanced
    modes every item (tile row or tile) grouped by its device, which
    restores the frame's order after the gather."""

    def __init__(self, params: RenderParams, n_fb: int, fb_idx: int,
                 mode: Optional[str], occ: Optional[torch.Tensor], dev):
        H, W = params.height, params.width
        self.mode, self.dev = mode, dev
        self.th, self.tw = params.tile_h, params.tile_w
        self.ntx = cdiv(W, self.tw)
        self.row_offset, self.tiles, self.perm = 0, None, None
        if mode is None:
            self.height, self.width = H // n_fb, W
            self.row_offset = fb_idx * self.height
            return
        if mode == "tiles":           # padding tiles, sorted last, load 0
            occ = torch.nn.functional.pad(
                occ.to(F32), (0, -(-occ.numel() // n_fb) * n_fb
                              - occ.numel()), value=-1.0)
        # Each device's items, ascending, one device after another.
        self.perm = torch.argsort(lpt_assign(occ, n_fb), stable=True)
        cap = occ.numel() // n_fb
        mine = self.perm[fb_idx * cap:(fb_idx + 1) * cap]
        if mode == "rows":
            self.height, self.width = cap * self.th, W
            self.tiles = (mine[:, None] * self.ntx + torch.arange(
                self.ntx, device=dev)).reshape(-1)
        else:
            ntiles = cdiv(H, self.th) * self.ntx
            self.height, self.width = cap * self.th, self.tw
            self.tiles = mine.clamp(max=ntiles - 1)

    def origin(self, th: int) -> torch.Tensor:
        """The band's tile origin map at (th, self.tw) tiles; th is the
        band's tiling but for a contiguous band under K1's 32-row cap."""
        if self.tiles is None:
            return binning.band_origin(cdiv(self.height, th), self.ntx, th,
                                       self.tw, self.row_offset, self.dev)
        return binning.tile_origins(self.tiles, self.ntx, th, self.tw)

    def bins(self, tris: Dict, params: RenderParams, th: int) -> Dict:
        """The band's bins at (th, self.tw) tiles: at its row offset, or
        the whole frame's gathered at its tiles."""
        if self.tiles is None:
            return binning.bin_triangles(
                tris, params.replace(height=self.height), th, self.tw,
                params.span_cap, self.row_offset)
        return binning.bin_tiles(tris, params, th, self.tw, params.span_cap,
                                 self.tiles)

    def coords(self):
        """Screen (x, y) of the band's stored pixels (binning.band_coords),
        the deferred resolve's coords."""
        return binning.band_coords(self.origin(self.th), self.height,
                                   self.width, self.th, self.tw)

    def assemble(self, bands: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """The (H, W, C) frame from the gathered (n_fb, height, width, C)
        bands."""
        C = bands.shape[-1]
        if self.mode is None:
            return bands.reshape(H, W, C)
        inv = torch.argsort(self.perm)
        if self.mode == "rows":
            rows = bands.reshape(-1, self.th, W, C)
            return rows[inv].reshape(H, W, C)
        nty = cdiv(H, self.th)
        t = bands.reshape(-1, self.th, self.tw, C)[inv[:nty * self.ntx]]
        return t.reshape(nty, self.ntx, self.th, self.tw, C) \
            .permute(0, 2, 1, 3, 4).reshape(nty * self.th, self.ntx * self.tw,
                                            C)[:H, :W]


def _check(params: RenderParams, mode, n_fb: int, n_tri: int):
    """JAX's refusals, raised before any rank renders."""
    H = params.height
    if H % n_fb:
        raise ValueError(f"height {H} not divisible by fb axis {n_fb}")
    if mode not in (None, "rows", "tiles"):
        raise ValueError(f"balanced must be False/True/'rows'/'tiles', got "
                         f"{mode!r}")
    if mode and not params.binned:
        raise ValueError("balanced fb sharding requires binned=True")
    raster.reduce_rules(params.depth_test)
    less_equal = params.depth_test == DepthTest.LESS_EQUAL
    if params.kbuffer > 1 and (n_tri != 1 or not params.binned
                               or mode == "tiles"
                               or (mode == "rows"
                                   and not (less_equal
                                            and params.tile_h <= 32))):
        raise NotImplementedError(
            "sharded K-buffer supports replicated triangles (n_tri == 1, "
            "binned) over contiguous fb bands or balanced='rows' through "
            "the tile kernels' row map (LESS_EQUAL depth, tile_h <= 32)")
    if mode == "rows" and (H % params.tile_h
                           or (H // params.tile_h) % n_fb):
        raise ValueError(f"balanced mode needs height ({H}) a multiple of "
                         f"tile_h*n_fb ({params.tile_h}*{n_fb})")


def render_frame_sharded(scene: Dict, uniforms: Dict, params: RenderParams,
                         mesh: DeviceMesh,
                         vertex_shader: Optional[Callable] = None,
                         fragment_shader: Optional[Callable] = None,
                         balanced=False, fold: Optional[Callable] = None):
    """The frame rendered over `mesh` (make_mesh), called by every rank of
    it with the same arguments; returns the whole (color (H, W, 4), depth
    (H, W)) on every rank's device, equal to render_frame's frame.

    scene: a packed scene that went through shard_scene_triangles(scene,
    n_tri) (numpy, or tensors already on the rank's device).
    params.height must divide by the "fb" size.  balanced: False
    (contiguous bands), True or "rows" (an equal number of tile rows a
    rank, chosen by occupancy), or "tiles" (an equal number of tiles);
    both need binned=True, and "rows" a height that divides into tile
    rows by the "fb" size.  kbuffer > 1 needs n_tri == 1 and contiguous
    or "rows" bands (the latter LESS_EQUAL with tile_h <= 32).  ssaa and
    the post chain wrap the gathered frame; shade_rate shades at full
    rate and the stats flags return nothing, as JAX's sharded frame.
    fold: K1's fold on the tile routes (tile_raster.tile_fold_plain for
    the plain twin)."""
    from softwarerenderer_tpu_torch.engine import renderer
    vertex_shader = vertex_shader or renderer.scene_vertex_shader
    fragment_shader = fragment_shader or renderer.scene_fragment_shader
    dev = mesh_device(mesh)

    def again(u, p):
        return render_frame_sharded(scene, u, p, mesh, vertex_shader,
                                    fragment_shader, balanced, fold)

    if params.ssaa > 1:
        return renderer.supersampled(lambda hi: again(uniforms, hi), params,
                                     dev)
    chain = renderer.enabled_post_fx(params, uniforms)
    if chain:
        return renderer.post_chained(again, uniforms, params, chain, dev)

    mode = {False: None, True: "rows"}.get(balanced, balanced)
    n_fb, n_tri = mesh.shape
    _check(params, mode, n_fb, n_tri)
    params = params.replace(shade_rate=1, kbuffer_stats=False,
                            active_cap_stats=False)
    fb_idx, tri_idx = mesh_coordinate(mesh)
    full = scene_to_torch(scene, dev)
    t_pad = full["indices"].shape[0]
    shard = tri_shard(full, tri_idx, n_tri)
    f = renderer.frame_setup(shard, uniforms, params, vertex_shader,
                             fragment_shader)
    tris = f["tris"]
    H, W = params.height, params.width
    tile = _on_tile_route(params, mode)

    occ = None
    if mode is not None:
        occ = (row_occupancy(tris, H, W, params.tile_h) if mode == "rows"
               else tile_occupancy(tris, H, W, params.tile_h, params.tile_w))
        occ = collectives.all_reduce(occ, dist.ReduceOp.SUM,
                                     mesh.get_group("tri"))
    band = _Band(params, n_fb, fb_idx, mode, occ, dev)
    pb = params.replace(height=band.height, width=band.width)
    fb_c = f["uniforms"]["clear_color"].expand(band.height, band.width, 4)
    fb_d = torch.full((band.height, band.width), raster.DEPTH_CLEAR,
                      dtype=F32, device=dev)
    args = (tris, fragment_shader, f["uniforms"], pb, fb_c, fb_d)
    if params.kbuffer > 1:
        if params.depth_test == DepthTest.LESS_EQUAL:
            out = tile_raster.render_tile_kbuffer(
                *args, per_tri_extra=f["per_tri"], fold=fold,
                band=_tile_band(tris, params, band))
        else:
            out = kbuffer.render_binned_kbuffer(
                *args, per_tri_extra=f["per_tri"],
                row_offset=band.row_offset)
    elif n_tri == 1 and tile:
        out = tile_raster.render_tile(*args, per_tri_extra=f["per_tri"],
                                      fold=fold,
                                      band=_tile_band(tris, params, band))
    else:
        out = _shard_band(f, fragment_shader, params, pb, fb_c, fb_d, band,
                          tile, fold, tri_idx, n_tri, t_pad,
                          mesh.get_group("tri"))
    color, depth = out[:2]
    bands = collectives.all_gather(torch.cat([color, depth[..., None]], -1),
                                   mesh.get_group("fb"))
    frame = band.assemble(bands, H, W)
    return frame[..., :4], frame[..., 4]


def _on_tile_route(params: RenderParams, mode) -> bool:
    """True when a band takes K1's tile route: the single-device frame's
    (renderer.tile_route), and for a balanced band a tile row of at most
    32 rows, K1's tiling."""
    from softwarerenderer_tpu_torch.engine import renderer
    return renderer.tile_route(params.replace(kbuffer=1)) \
        and (mode is None or params.tile_h <= 32)


def _tile_band(tris: Dict, params: RenderParams, band: _Band) -> Dict:
    """tile_raster.prepare's band arguments: the band's origin map and bins
    at K1's tiles (at most 32 rows)."""
    th = min(params.tile_h, 32)
    return dict(origin=band.origin(th), bins=band.bins(tris, params, th))


def _band_visibility(tris: Dict, params: RenderParams, pb: RenderParams,
                    band: _Band, fb_depth: torch.Tensor):
    """The deferred route's visibility pass over a band: K5 (LESS_EQUAL) or
    binning.fold_binned (another monotone test) through the band's tile
    origin map or, unbinned (contiguous bands only, _check), the brute
    force at the band's row offset, each seeded with fb_depth.  params:
    the frame's; pb: the band's.  Returns (best_d, best_i) of the band."""
    h, w = pb.height, pb.width
    if not params.binned:
        return raster.visibility_brute_force(tris, pb, init_depth=fb_depth,
                                             row_offset=band.row_offset)
    th, tw = params.tile_h, params.tile_w
    bins = band.bins(tris, params, th)
    fbd = torch.nn.functional.pad(
        fb_depth, (0, cdiv(w, tw) * tw - w, 0, cdiv(h, th) * th - h))
    args = (fbd.contiguous(), raster.setup_rows(tris), bins["order"],
            bins["n_global"], bins["sorted_tri"], bins["starts"],
            bins["counts"])
    kw = dict(tile_h=th, tile_w=tw, origin=band.origin(th))
    if params.depth_test == DepthTest.LESS_EQUAL:
        best_d, best_i = vis_fold.vis_fold(*args, **kw)
    else:
        best_d, best_i = binning.fold_binned(*args, **kw,
                                             mode=params.depth_test)
    return best_d[:h, :w], best_i[:h, :w]


def _shard_band(f: Dict, fragment_shader: Callable, params: RenderParams,
                pb: RenderParams, fb_c, fb_d, band: _Band, tile: bool, fold,
                tri_idx: int, n_tri: int, t_pad: int, group):
    """A band of a triangle shard (or of the deferred route): the local
    winners (K1's fold, or _band_visibility), their lexicographic
    all-reduce over "tri" when the triangles are sharded, this shard's
    pixels shaded, and the masked sum over "tri"."""
    tris, u, per_tri = f["tris"], f["uniforms"], f["per_tri"]
    h, w = pb.height, pb.width
    if tile:
        ctx = tile_raster._prepare_for(tris, fragment_shader, pb, fb_d,
                                       per_tri, _tile_band(tris, params, band))
        fargs, fkw = tile_raster.fold_inputs(ctx)
        gbuf, best_d, best_i = (fold or tile_raster.tile_fold)(*fargs, **fkw)
        best_d, best_i = best_d[:h, :w], best_i[:h, :w]
    else:
        best_d, best_i = _band_visibility(tris, params, pb, band, fb_d)
    covered = best_i != raster.NO_TRI
    local_best, dstar = best_i, best_d
    if n_tri > 1:
        t_local = t_pad // n_tri
        offset = tri_idx * 2 * t_local
        covered, dstar, istar = _lex_allreduce(
            best_d, torch.where(covered, best_i + offset, raster.NO_TRI),
            covered, params.depth_test, 2 * t_pad, group)
        covered = covered & (istar >= offset) & (istar < offset + 2 * t_local)
        local_best = torch.where(covered, istar - offset, raster.NO_TRI)
    if tile:
        color = fragment_shader(
            tile_raster.frag_from_planes(ctx, gbuf[:, :h, :w]), u)
        shaded = covered & (color[..., 3] > 0)
        color_s = torch.where(shaded[..., None],
                              raster.blend(color, fb_c, params.blend_mode),
                              fb_c)
        depth_s = torch.where(shaded, dstar, fb_d)
    else:
        color_s, depth_s = raster.shade_deferred(
            tris, dstar, local_best, fragment_shader, u, pb, fb_c, fb_d,
            per_tri, coords=band.coords())
    if n_tri == 1:
        return color_s, depth_s
    # Exactly one shard owns each covered pixel, so the masked sum is its
    # value; a discarded fragment leaves the background, as the deferred
    # route does.
    mine = covered[..., None]
    part = torch.cat([torch.where(mine, color_s, 0.0),
                      torch.where(mine, depth_s[..., None], 0.0),
                      mine.to(F32)], -1)
    total = collectives.all_reduce(part, dist.ReduceOp.SUM, group)
    written = total[..., 5] > 0
    return (torch.where(written[..., None], total[..., :4], fb_c),
            torch.where(written, total[..., 4], fb_d))
