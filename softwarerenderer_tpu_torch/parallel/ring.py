"""Ring-pass rendering: triangle shards rotate around the ranks, each band
stays.

Counterpart of ``softwarerenderer_tpu/parallel/ring.py``.  Each rank of a
("shard",) mesh (``make_ring_mesh``) owns a band of framebuffer rows AND
1/n of the triangles (``sharding.shard_scene_triangles``); the shards
cycle around the ring (``collectives.ring_shift``: one batch of isend /
irecv a step, JAX's ``lax.ppermute``) while every rank folds each arriving
shard into its band, so a rank holds O(T / n) triangles at a time.

Two passes, as JAX's:
  1. visibility: each arriving shard's set-up rows and bboxes are binned
     at the band's rows and folded from the clear seed by K5
     (``vis_fold.vis_fold``; ``binning.fold_binned`` for the other
     monotone depth tests), then merged into the band's running (depth,
     global index) by the fold's own keys (``raster.fold_keys``).  The
     fold is order-independent, so the merge is exact.
  2. resolve: the payload rows (``tile_raster.pack_payload``) rotate
     again and each band gathers its winners' rows from the shard that
     owns them, where JAX accumulates one-hot matmuls (a TPU shape).

Then K1's resolve (``tile_raster.resolve_rows``) interpolates every
pixel's winner, the fragment shader runs band-locally and the bands are
gathered.  Order-dependent depth tests are refused, as JAX refuses them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from softwarerenderer_tpu_torch.config import DepthTest, RenderParams
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import binning, raster, tile_raster
from softwarerenderer_tpu_torch.ops import vis_fold
from softwarerenderer_tpu_torch.ops.binning import cdiv
from softwarerenderer_tpu_torch.parallel import collectives
from softwarerenderer_tpu_torch.parallel.sharding import (mesh_device,
                                                          tri_shard)

F32 = torch.float32
AXIS = "shard"


def make_ring_mesh(n: int, device=None) -> DeviceMesh:
    """A ("shard",) DeviceMesh over ranks 0 .. n - 1 (every rank calls it;
    devices as sharding.make_mesh)."""
    from softwarerenderer_tpu_torch.parallel.sharding import make_mesh
    mesh = make_mesh(n, 1, device=device)
    return DeviceMesh(mesh.device_type, torch.arange(n),
                      mesh_dim_names=(AXIS,))


def _fold_shard(setup, bbox_valid, params: RenderParams, fbd, row_offset,
                origin):
    """(best_d, best_i) of one shard over the band's padded seed fbd: its
    set-up rows binned at the band's rows and folded through the band's
    tile origin map, local ids."""
    th, tw = params.tile_h, params.tile_w
    bins = binning.bin_triangles(
        {"bbox": bbox_valid[:, :4], "valid": bbox_valid[:, 4] > 0}, params,
        th, tw, params.span_cap, row_offset)
    args = (fbd, setup, bins["order"], bins["n_global"], bins["sorted_tri"],
            bins["starts"], bins["counts"])
    kw = dict(tile_h=th, tile_w=tw, origin=origin)
    if params.depth_test == DepthTest.LESS_EQUAL:
        return vis_fold.vis_fold(*args, **kw)
    return binning.fold_binned(*args, **kw, mode=params.depth_test)


def render_frame_ring(scene: Dict, uniforms: Dict, params: RenderParams,
                      mesh: DeviceMesh,
                      vertex_shader: Optional[Callable] = None,
                      fragment_shader: Optional[Callable] = None):
    """The ring-pass frame over `mesh` (make_ring_mesh), called by every
    rank with the same arguments; scene padded by
    shard_scene_triangles(scene, n).  Returns the whole (color (H, W, 4),
    depth (H, W)) on every rank, equal to render_frame's frame; H must
    divide by n.  ssaa wraps it as render_frame's; the post chain is not
    applied (JAX's ring frame has none)."""
    from softwarerenderer_tpu_torch.engine import renderer
    vertex_shader = vertex_shader or renderer.scene_vertex_shader
    fragment_shader = fragment_shader or renderer.scene_fragment_shader
    mode = params.depth_test
    if mode not in (DepthTest.LESS_EQUAL, DepthTest.LESS, DepthTest.GREATER,
                    DepthTest.GREATER_EQUAL, DepthTest.ALWAYS,
                    DepthTest.DISABLED):
        raise NotImplementedError("order-dependent depth tests need the "
                                  "forward path")
    dev = mesh_device(mesh)
    if params.ssaa > 1:
        return renderer.supersampled(lambda hi: render_frame_ring(
            scene, uniforms, hi, mesh, vertex_shader, fragment_shader),
            params, dev)
    n = mesh.size()
    H, W = params.height, params.width
    if H % n:
        raise ValueError(f"height {H} not divisible by ring size {n}")
    group = mesh.get_group(AXIS)
    i = mesh.get_local_rank(AXIS)
    full = scene_to_torch(scene, dev)
    t_pad = full["indices"].shape[0]
    stride = 2 * (t_pad // n)         # each shard's global-index window
    params = params.replace(shade_rate=1, kbuffer=1, kbuffer_stats=False,
                            active_cap_stats=False)
    f = renderer.frame_setup(tri_shard(full, i, n), uniforms, params,
                             vertex_shader, fragment_shader)
    tris, u = f["tris"], f["uniforms"]
    h = H // n
    row_offset = i * h
    pb = params.replace(height=h)
    fb_c = u["clear_color"].expand(h, W, 4)
    fb_d = torch.full((h, W), raster.DEPTH_CLEAR, dtype=F32, device=dev)
    th, tw = params.tile_h, params.tile_w
    fbd = torch.nn.functional.pad(
        fb_d, (0, cdiv(W, tw) * tw - W, 0, cdiv(h, th) * th - h)).contiguous()
    origin = binning.band_origin(cdiv(h, th), cdiv(W, tw), th, tw,
                                 row_offset, dev)

    # Pass 1: visibility, every shard folded into the band.
    state = [raster.setup_rows(tris), torch.cat(
        [tris["bbox"].to(torch.int32),
         tris["valid"].to(torch.int32)[:, None]], 1)]
    run_d, run_i = fb_d, torch.full((h, W), raster.NO_TRI, dtype=torch.long,
                                    device=dev)
    run_key = torch.full((h, W), raster.NEVER, dtype=torch.long, device=dev)
    for k in range(n):
        src = (i - k) % n
        bd, bi = _fold_shard(*state, pb, fbd, row_offset, origin)
        bd, bi = bd[:h, :W], bi[:h, :W].long()
        g = torch.where(bi >= 0, bi + src * stride, raster.NO_TRI)
        key = torch.where(bi >= 0, raster.fold_keys(bd, g, mode),
                          raster.NEVER)
        take = key > run_key
        run_key = torch.maximum(key, run_key)
        run_d = torch.where(take, bd, run_d)
        run_i = torch.where(take, g, run_i)
        if k < n - 1:
            state = collectives.ring_shift(state, group)
    covered = run_i != raster.NO_TRI

    # Pass 2: each band takes its winners' payload rows from their shard.
    gb_keep = getattr(fragment_shader, "varyings", None)
    pack = tile_raster.pack_payload(
        tris, f["per_tri"], None if gb_keep is None else frozenset(gb_keep))
    payload = pack["payload"]
    n_slots = payload.shape[0]
    flat = run_i.reshape(-1)
    rows = torch.zeros((h * W, payload.shape[1]), dtype=F32, device=dev)
    for k in range(n):
        lo = ((i - k) % n) * stride
        sel = (flat >= lo) & (flat < lo + stride)
        rows = torch.where(sel[:, None],
                           payload[(flat - lo).clamp(0, n_slots - 1)], rows)
        if k < n - 1:
            payload, = collectives.ring_shift([payload], group)

    px, py = binning.band_coords(origin, h, W, th, tw)
    planes = tile_raster.resolve_rows(
        rows, covered.reshape(-1), pack["plan"], pack["kp"], pack["kpi"],
        pack["sl_screen"], pack["sl_ia"], pack["clip_w_off"], px[0], py[0])
    color = fragment_shader(
        tile_raster.frag_from_planes(pack, planes.reshape(-1, h, W)), u)
    color, depth = raster.write(color, covered & (color[..., 3] > 0), run_d,
                                params, fb_c, fb_d)
    bands = collectives.all_gather(torch.cat([color, depth[..., None]], -1),
                                   group)
    frame = bands.reshape(H, W, 5)
    return frame[..., :4], frame[..., 4]
