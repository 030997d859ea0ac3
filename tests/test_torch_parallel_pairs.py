"""The port's multi-device layer on two gloo ranks, and the tile origin map
of K1, K2 and K5's plain twins.

softwarerenderer_tpu_torch.parallel runs one process a rank on
torch.distributed.  A module fixture starts two ranks once through the
port's own bootstrap (tests/torch_parallel_ranks.py: spawn, gloo, one
intra-op thread) and every case below reads what they rendered: the
sharded frames on the (2, 1) and (1, 2) meshes, the ring at n = 2 and the
ray-traced bands with and without clusters, each equal on both ranks and
equal to the port's single-device frame on every value; the meshes also
within the raster limits of the JAX package's render_frame_sharded on the
same mesh shape of its virtual CPU mesh.  Without processes, the twins of
K1 (opaque and peel) and K5 with a band's tile origin map equal the whole
frame's twin at the same screen pixels, for a contiguous band at a row
offset, a permuted tile-row map and a tile map.
"""

import functools

import numpy as np
import pytest
import torch

import torch_parallel_jax as tj
import torch_parallel_ranks as ranks
from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import frame_setup
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import binning, raster, tile_raster
from softwarerenderer_tpu_torch.ops import vis_fold
from softwarerenderer_tpu_torch.parallel import multihost, sharding

N = 2


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """The two ranks' results, and the JAX package's frame of every case
    (or the exception it raised), rendered in this process while the
    ranks run."""
    out_dir = str(tmp_path_factory.mktemp("ranks2"))
    procs = ranks.start_group(N, out_dir)
    try:
        want = {}
        for name in ranks.CASES[N]:
            try:
                want[name] = tj.jax_frame(name)
            except Exception as e:        # reported by its own test
                want[name] = e
    finally:
        out = ranks.join_group(procs, out_dir)
    return out, want


@pytest.fixture(scope="module")
def group(rendered):
    out = rendered[0]
    errors = [r["error"] for r in out if r["error"]]
    assert not errors, "\n".join(errors)
    return out


def jax_want(rendered, name):
    want = rendered[1][name]
    if isinstance(want, Exception):
        raise want
    return want


def case_result(group, name):
    frames = [r["frames"][name] for r in group]
    refs = [r["refs"][name] for r in group if name in r["refs"]]
    return frames, refs


@pytest.mark.parametrize("name", list(ranks.CASES[N]))
def test_two_rank_frame_equals_single_device(group, name):
    """Every rank holds the whole frame, equal on every value to the port's
    single-device frame (render_frame, or render_frame_raytraced for the
    ray-traced bands), and the frame draws something."""
    frames, refs = case_result(group, name)
    assert len(refs) == 1
    for c, d in frames:
        np.testing.assert_array_equal(c, refs[0][0])
        np.testing.assert_array_equal(d, refs[0][1])
    c, d = frames[0]
    assert (d > raster.DEPTH_CLEAR).mean() > 0.2
    assert np.isfinite(c).all()


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_two_rank_frame_matches_jax_sharded(group, rendered, shape):
    """The port's sharded frame against the JAX package's
    render_frame_sharded on the same (fb, tri) mesh shape, same packed
    scene: within the raster limits (XLA contracts edge functions into
    FMAs; the port rounds every operation)."""
    name = f"mesh_{shape[0]}x{shape[1]}"
    tj.close(name, case_result(group, name)[0][0], jax_want(rendered, name))


@pytest.mark.parametrize("name", [c for c in ranks.CASES[N]
                                  if not c.startswith("mesh_")])
def test_two_rank_frame_matches_jax(group, rendered, name):
    """The ring at n = 2 and the ray-traced bands on two ranks against
    JAX's render_frame_ring and render_frame_raytraced_sharded on a mesh
    of the same shape, within the case's limits
    (torch_parallel_jax.close)."""
    tj.close(name, case_result(group, name)[0][0], jax_want(rendered, name))


def test_bootstrap_without_env_and_mesh_without_group(monkeypatch):
    """initialize_from_env does nothing and returns False without
    SRT_COORD (JAX's contract), and a mesh needs an initialised process
    group."""
    monkeypatch.delenv("SRT_COORD", raising=False)
    assert multihost.initialize_from_env(device="cpu") is False
    with pytest.raises(RuntimeError, match="initialise torch.distributed"):
        sharding.make_mesh(1, 1, device="cpu")


# --- the tile origin map of the twins, no processes -----------------------

TH, TW = 8, 64
FRAME = RenderParams(ranks.W, ranks.H, tile_h=TH, tile_w=TW)


@functools.lru_cache(maxsize=None)
def frame_inputs():
    """The small scene's set-up triangles and extras at 128x96, and the
    whole frame's K1 inputs and twin outputs at 8x64 tiles, with a second
    (peel) pass."""
    from softwarerenderer_tpu_torch.engine import scene_fragment_shader
    f = frame_setup(scene_to_torch(ranks.small_scene(), "cpu"),
                    ranks.small_uniforms(), FRAME)
    keep = frozenset(scene_fragment_shader.varyings)
    ctx = tile_raster.prepare(f["tris"], FRAME, f["fb_depth"], f["per_tri"],
                              keep)
    args, kw = tile_raster.fold_inputs(ctx)
    first = tile_raster.tile_fold_plain(*args, **kw)
    peel = tile_raster.tile_fold_plain(*args, **kw, prev_d=first[1],
                                       prev_i=first[2])
    return f, keep, first, peel


def layout(kind):
    """(band params, prepare's band arguments but the bins, and the band's
    row offset or full-frame tile ids) of a band: contiguous at a row
    offset that is not a multiple of the tile height, a permuted set of
    tile rows, or a set of single tiles."""
    ntx = binning.cdiv(ranks.W, TW)
    if kind == "band":
        ro, h = 20, 40
        origin = binning.band_origin(binning.cdiv(h, TH), ntx, TH, TW, ro,
                                     torch.device("cpu"))
        return FRAME.replace(height=h), dict(origin=origin, row_offset=ro)
    if kind == "rows":
        rows = torch.tensor([5, 0, 9, 2])
        tiles = (rows[:, None] * ntx + torch.arange(ntx)).reshape(-1)
        pb = FRAME.replace(height=len(rows) * TH)
    else:
        tiles = torch.tensor([7, 0, 13, 3, 22])
        pb = FRAME.replace(height=len(tiles) * TH, width=TW)
    return pb, dict(origin=binning.tile_origins(tiles, ntx, TH, TW),
                    tiles=tiles)


def screen_of(pb, band):
    """Each stored pixel's screen (y, x), flat over the padded band, and
    whether it is one of the band's own pixels (not tile padding) on the
    screen."""
    hp = binning.cdiv(pb.height, TH) * TH
    wp = binning.cdiv(pb.width, TW) * TW
    px, py = binning.pixel_coords(hp, wp, TH, TW, "cpu", band["origin"])
    px, py = px.long(), py.long()
    stored = (torch.arange(hp)[:, None] < pb.height) \
        & (torch.arange(wp)[None, :] < pb.width)
    return py, px, (py < ranks.H) & (px < ranks.W) & stored.reshape(-1)


def at_screen(full, py, px, on):
    """The whole frame's padded map `full` (..., Hp, Wp) at the stored
    pixels' screen positions (0 off the screen)."""
    out = full[..., py.clamp(max=full.shape[-2] - 1),
               px.clamp(max=full.shape[-1] - 1)]
    return torch.where(on, out, torch.zeros((), dtype=out.dtype))


@pytest.mark.parametrize("kernel", ["K1", "K2", "K5"])
@pytest.mark.parametrize("kind", ["band", "rows", "tiles"])
def test_origin_map_twin_equals_whole_frame(kind, kernel):
    """A band's fold through the tile origin map equals the whole frame's
    fold at the same screen pixels: K1's twin (winners, depths and the
    interpolated G-buffer), K2's twin seeded with the whole frame's first
    pass at those pixels, and K5's twin.  Bins come from the band's rows
    (binning at the row offset) or from the whole frame gathered at the
    band's tiles (binning.bin_tiles)."""
    f, keep, first, peel = frame_inputs()
    pb, band = layout(kind)
    tiles, ro = band.pop("tiles", None), band.pop("row_offset", None)
    if tiles is not None:
        band["bins"] = binning.bin_tiles(f["tris"], FRAME, TH, TW,
                                         FRAME.span_cap, tiles)
    else:
        band["bins"] = binning.bin_triangles(f["tris"], pb, TH, TW,
                                             FRAME.span_cap, ro)
    py, px, on = screen_of(pb, band)
    fb = torch.full((pb.height, pb.width), raster.DEPTH_CLEAR)
    ctx = tile_raster.prepare(f["tris"], pb, fb, f["per_tri"], keep, **band)
    args, kw = tile_raster.fold_inputs(ctx)
    hp, wp = ctx["Hp"], ctx["Wp"]
    if kernel == "K5":
        got = vis_fold.visibility_fold_plain(
            *args[:7], tile_h=TH, tile_w=TW, origin=band["origin"])
        want = (first[1], first[2])
    elif kernel == "K1":
        got = tile_raster.tile_fold_plain(*args, **kw)
        want = first
    else:
        prev_d = torch.where(on, at_screen(first[1], py, px, on),
                             raster.DEPTH_CLEAR).reshape(hp, wp)
        prev_i = torch.where(on, at_screen(first[2], py, px, on),
                             -1).reshape(hp, wp)
        got = tile_raster.tile_fold_plain(*args, **kw, prev_d=prev_d,
                                          prev_i=prev_i)
        want = peel
    assert int((want[-1] >= 0).sum()) > (50 if kernel == "K2" else 500)
    for g, w in zip(got, want):
        g = g.reshape(*g.shape[:-2], -1)[..., on]
        assert torch.equal(g, at_screen(w, py, px, on)[..., on])
    if kernel == "K5" and kind == "band":
        # The deferred route's row offset folds through the same map.
        alt = vis_fold.visibility_fold(f["tris"], pb.replace(
            tile_h=TH, tile_w=TW), init_depth=fb, row_offset=ro,
            fold=vis_fold.visibility_fold_plain)
        assert all(torch.equal(a, b[:pb.height, :pb.width])
                   for a, b in zip(alt, got))
