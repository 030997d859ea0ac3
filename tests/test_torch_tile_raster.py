"""The port's plain tile fold (tile_raster.tile_fold_plain, the twin of the
CUDA kernel) against the JAX tile kernel run in interpret mode
(pallas_tile._prepare_ctx + _run_pass), on the same set-up triangles,
per-triangle extras and framebuffer depth."""

import jax
import numpy as np
import pytest
import torch

from softwarerenderer_tpu import CullMode, RenderParams
from softwarerenderer_tpu.engine import renderer as jr
from softwarerenderer_tpu.models import primitives
from softwarerenderer_tpu.models import scene as scene_mod
from softwarerenderer_tpu.ops import geometry as jgeom
from softwarerenderer_tpu.ops import pallas_tile
from softwarerenderer_tpu.ops import texture as tex_np
from softwarerenderer_tpu.ops.raster import DEPTH_CLEAR
from softwarerenderer_tpu.utils import mathlib as ml
from softwarerenderer_tpu_torch.ops import tile_raster

KEEP = frozenset(jr.scene_fragment_shader.varyings)


def _smoke():
    """chip_smoke.py, the script at the repository's root."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


def cubes_scene():
    checker = np.asarray(tex_np.checkerboard(16, 4)["data"])
    insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                    ml.translation([0, -1, 0]),
                                    texture=checker)]
    rng = np.random.default_rng(0)
    for _ in range(11):
        pos = rng.uniform(-4, 4, 3).astype(np.float32)
        pos[1] = rng.uniform(-0.5, 1.5)
        insts.append(scene_mod.MeshInstance(primitives.cube(0.5),
                                            ml.translation(pos),
                                            texture=checker))
    return scene_mod.build_scene_buffers(insts), np.float32([0, 0.5, 3.0])


def soup_scene():
    checker = np.asarray(tex_np.checkerboard(16, 4)["data"])
    soup = primitives.random_triangle_soup(400, seed=3)
    return (scene_mod.build_scene_buffers(
        [scene_mod.MeshInstance(soup, texture=checker)]),
        np.float32([0, 0, 0]))


def prepared(scene, cam, params, keep):
    """JAX-built triangles and extras as numpy arrays.  With keep=None every
    varying is kept and a 2-wide "data." varying is added, so the plan has
    all five kinds: pc, pw, pw3, bary and v0."""
    w, h = params.width, params.height
    u = jr.default_frame_uniforms(w, h)
    u["camera_position"] = cam
    view, proj = jr.camera_matrices(u, w, h, xp=np)
    u.update(model=scene["mesh_matrices"][scene["vert_mesh_id"]],
             view=np.asarray(view), projection=np.asarray(proj))
    vin = {k: scene[k] for k in ("position", "uv", "normal", "color")}
    tris = jax.jit(lambda vin, idx, u: jgeom.build_triangles(
        jr.scene_vertex_shader, vin, idx, u, width=w, height=h,
        cull_mode=params.cull_mode, near_clip=u["near_clip"],
        keep_varyings=keep))(vin, scene["indices"], u)
    tris = jax.tree_util.tree_map(np.asarray, tris)
    if keep is None:
        tris["attrs"]["data.pair"] = tris["attrs"]["uv"] * np.float32(3.0)
    tid2 = np.repeat(scene["tri_texture_id"], 2)
    extra = {"tex_oy": scene["atlas_offsets"][tid2, 0],
             "tex_ox": scene["atlas_offsets"][tid2, 1],
             "tex_h": scene["atlas_sizes"][tid2, 0],
             "tex_w": scene["atlas_sizes"][tid2, 1]}
    return tris, extra


SMALL = RenderParams(width=136, height=92, tile_h=16, span_cap=6)
CASES = {
    # (scene, params, varyings kept, fb depth, GLOB_RESIDENT override)
    "cubes": (cubes_scene, SMALL, KEEP, "clear", None),
    # Every varying, on a scene the near plane does not clip: interpolating
    # the unpruned clip x/y and screen_coords of a clipped floor cancels
    # vertex values ~30x the result, and XLA's contraction then differs
    # by up to 3.7e-5 absolute (PERF.md).
    "soup_all_varyings": (soup_scene, SMALL, None, "clear", None),
    "cubes_fb_depth": (cubes_scene, SMALL, KEEP, "random", None),
    # span_cap=1 sends most triangles global; a resident cap of 32 makes
    # the JAX kernel stream the rest through its tail loop.
    "global_tail": (cubes_scene, SMALL.replace(span_cap=1,
                                               cull_mode=CullMode.NONE),
                    KEEP, "clear", 32),
    "soup_32x128": (soup_scene, RenderParams(width=256, height=96), KEEP,
                    "clear", None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_fold_matches_jax_kernel(case, monkeypatch):
    make, params, keep, fb, resident = CASES[case]
    if resident is not None:
        monkeypatch.setattr(pallas_tile, "GLOB_RESIDENT", resident)
    scene, cam = make()
    tris, extra = prepared(scene, cam, params, keep)
    h, w = params.height, params.width
    if fb == "clear":
        fbd = np.full((h, w), DEPTH_CLEAR, np.float32)
    else:
        # a previous depth buffer in the scene's depth range: some
        # fragments win against it, some lose
        fbd = np.random.default_rng(7).uniform(
            -0.995, -0.975, (h, w)).astype(np.float32)

    ctx = pallas_tile._prepare_ctx(tris, params, fbd, extra, 0, gb_keep=keep)
    jg, jd, ji = map(np.asarray, pallas_tile._run_pass(ctx, interpret=True,
                                                       raw=True))
    if resident is not None:
        assert int(ctx["n_global"][0]) > resident

    tt = {k: torch.tensor(tris[k]) for k in ("screen", "depth", "inv_area",
                                              "valid", "bbox")}
    tt["attrs"] = {k: torch.tensor(v) for k, v in tris["attrs"].items()}
    tctx = tile_raster.prepare(tt, params, torch.tensor(fbd),
                               {k: torch.tensor(v) for k, v in extra.items()},
                               keep)
    assert tctx["gb_slices"] == ctx["gb_slices"]
    assert tctx["plan"] == ctx["interp_plan"]
    if keep is None:
        assert {k for k, _, _ in tctx["plan"]} == set(tile_raster.KINDS)
    args, kwargs = tile_raster.fold_inputs(tctx)
    gbuf, best_d, best_i = (t.numpy() for t in
                            tile_raster.tile_fold_plain(*args, **kwargs))

    # XLA on the CPU contracts multiply-adds into FMAs inside the
    # interpret run; the port rounds every operation once, as the CUDA
    # kernel does (-fmad=false).  A contracted edge function near an edge
    # can flip a borderline pixel and moves depth and interpolants by a
    # few ulps relative (measured: 2.9e-6 in depth, 3.4e-6 in clip z).
    same = best_i == ji
    assert (ji >= 0).mean() > 0.01
    assert same.mean() >= 0.999
    np.testing.assert_allclose(best_d[same], jd[same], rtol=1e-5, atol=0)
    kpi = tctx["kpi"]
    assert not jg[kpi:].any()          # the JAX kernel's 8-row padding
    np.testing.assert_allclose(np.where(same, gbuf, 0),
                               np.where(same, jg[:kpi], 0), rtol=1e-5,
                               atol=1e-5)


def test_plain_fold_tie_goes_to_later_triangle():
    """Two copies of one triangle tie on every pixel at depth -0.5: the
    later id wins; a nearer framebuffer depth keeps the pixel (id -1) and
    an equal one loses to the triangle (ids start above -1)."""
    tile_h, tile_w = 2, 4
    s = [0.0, 0.0, 8.0, 0.0, 0.0, 8.0]         # covers the whole tile
    setup = torch.tensor([s + [-0.5, -0.5, -0.5, 1.0 / 64.0]] * 2)
    fbd = torch.full((tile_h, tile_w), -0.75)
    fbd[0, 0] = 0.0
    fbd[0, 1] = -0.5
    ids = torch.tensor([0, 1], dtype=torch.int32)
    payload = torch.zeros((2, 3 * 4))
    plan = (("v0", 0, 0),)
    args = (fbd, setup, ids, torch.tensor([0], dtype=torch.int32), ids,
            torch.tensor([0], dtype=torch.int32),
            torch.tensor([2], dtype=torch.int32), payload, plan)
    kw = dict(tile_h=tile_h, tile_w=tile_w, kp=4, kpi=1, sl_screen=1,
              sl_ia=3, clip_w_off=0)
    _, best_d, best_i = tile_raster.tile_fold_plain(*args, **kw)
    assert best_i[0, 0] == -1 and best_d[0, 0] == 0.0
    assert (best_i.reshape(-1)[1:] == 1).all()
    assert (best_d.reshape(-1)[1:] == -0.5).all()


def test_plain_fold_edge_depths_match_chip_smoke_expectation():
    """The edge case chip_smoke.py runs through the CUDA kernel on the card
    (depth ties, NaN and -inf depths, -0.0 against a +0.0 framebuffer, a
    global and two segments) gives the expected winners in the plain twin,
    so a failure there is the kernel's and not the expectation's."""
    args, kwargs, want_i, want_d = _smoke().edge_case_inputs("cpu")
    gbuf, best_d, best_i = tile_raster.tile_fold(*args, **kwargs)
    assert torch.equal(best_i, want_i)
    assert (best_d == want_d).all()
    assert torch.equal(gbuf[0], torch.where(want_i >= 0, want_i, 0).float())


def _jax_and_port_ctx(params, keep=KEEP):
    """The cubes scene's JAX-built triangles, prepared by both packages, on
    a clear framebuffer: (JAX ctx, port ctx)."""
    scene, cam = cubes_scene()
    tris, extra = prepared(scene, cam, params, keep)
    fbd = np.full((params.height, params.width), DEPTH_CLEAR, np.float32)
    ctx = pallas_tile._prepare_ctx(tris, params, fbd, extra, 0, gb_keep=keep)
    tt = {k: torch.tensor(tris[k]) for k in ("screen", "depth", "inv_area",
                                              "valid", "bbox")}
    tt["attrs"] = {k: torch.tensor(v) for k, v in tris["attrs"].items()}
    tctx = tile_raster.prepare(tt, params, torch.tensor(fbd),
                               {k: torch.tensor(v) for k, v in extra.items()},
                               keep)
    return ctx, tctx


# Culling off: the cubes' back faces and the floor behind them give most
# covered pixels two or more layers to peel.
PEEL = SMALL.replace(cull_mode=CullMode.NONE)


@pytest.mark.parametrize("peel_pass", [1, 2])
def test_plain_peel_matches_jax_kernel(peel_pass):
    """K2's plain twin (tile_fold_plain with prev maps) against the JAX
    kernel's peel mode in interpret mode: both get the same prepared
    triangles and the same prev maps, the JAX kernel's previous pass."""
    ctx, tctx = _jax_and_port_ctx(PEEL)
    args, kwargs = tile_raster.fold_inputs(tctx)
    _, jd, ji = pallas_tile._run_pass(ctx, interpret=True, raw=True)
    for _ in range(peel_pass):
        prev_d, prev_i = jd, ji
        jg, jd, ji = pallas_tile._run_pass(
            ctx, True, prev_d, prev_i.astype(np.float32), raw=True)
    jg, jd, ji = map(np.asarray, (jg, jd, ji))
    gbuf, best_d, best_i = (t.numpy() for t in tile_raster.tile_fold_plain(
        *args, **kwargs, prev_d=torch.tensor(np.asarray(prev_d)),
        prev_i=torch.tensor(np.asarray(prev_i))))
    # test_plain_fold_matches_jax_kernel's tolerance, for its reason: XLA
    # on the CPU contracts the interpret run's multiply-adds.
    same = best_i == ji
    assert (ji >= 0).mean() > 0.01
    assert same.mean() >= 0.999
    np.testing.assert_allclose(best_d[same], jd[same], rtol=1e-5, atol=0)
    np.testing.assert_allclose(np.where(same, gbuf, 0),
                               np.where(same, jg[:tctx["kpi"]], 0),
                               rtol=1e-5, atol=1e-5)


def test_plain_kdeep_matches_jax_kernel():
    """K3's plain twin against the JAX K-deep kernel in interpret mode, on
    the same prepared triangles, every layer: winners, depths (-inf in
    empty slots in both) and the shader's inputs built from each layer's
    G-buffer, at test_plain_fold_matches_jax_kernel's tolerance."""
    K = 3
    params = PEEL.replace(kbuffer=K)
    ctx, tctx = _jax_and_port_ctx(params)
    frags, jd, ji = pallas_tile._run_pass_kdeep(ctx, K, interpret=True)
    jd, ji = np.asarray(jd), np.asarray(ji)
    args, kwargs = tile_raster.fold_inputs(tctx)
    gbuf, best_d, best_i = tile_raster.tile_fold_kdeep_plain(*args, **kwargs,
                                                             K=K)
    best_d, best_i = best_d.numpy(), best_i.numpy()
    assert (ji[1] >= 0).mean() > 0.01          # a second layer exists
    assert ((best_i < 0) == (best_d == -np.inf)).all()
    h, w, kpi = params.height, params.width, tctx["kpi"]
    for s in range(K):
        same = best_i[s] == ji[s]
        assert same.mean() >= 0.999
        np.testing.assert_allclose(best_d[s][same], jd[s][same], rtol=1e-5,
                                   atol=0)
        frag = tile_raster.frag_from_planes(
            tctx, gbuf[s * kpi:(s + 1) * kpi, :h, :w])
        on = same[:h, :w]
        for name in ("color", "uv"):
            np.testing.assert_allclose(
                frag[name].numpy()[on], np.asarray(frags[s][name])[on],
                rtol=1e-5, atol=1e-5, err_msg=f"layer {s} {name}")
        np.testing.assert_allclose(
            frag["data"]["world_normal"].numpy()[on],
            np.asarray(frags[s]["data"]["world_normal"])[on], rtol=1e-5,
            atol=1e-5)
        for name, v in frag["tri"].items():
            np.testing.assert_array_equal(
                v.numpy()[on], np.asarray(frags[s]["tri"][name])[on])


def test_plain_peel_edge_case_matches_chip_smoke_expectation():
    """The peel edge case chip_smoke.py runs through K2 on the card (a tie
    at the previous winner's depth with ids below, equal to and above it,
    -0.0 against +0.0, a tile with no eligible pixel) gives the expected
    winners in the plain twin."""
    args, kwargs, want_i, want_d = _smoke().peel_edge_case_inputs("cpu")
    gbuf, best_d, best_i = tile_raster.tile_fold(*args, **kwargs)
    assert torch.equal(best_i, want_i)
    assert torch.equal(best_d, want_d)       # -0.0 == +0.0, as the fold
    assert torch.equal(gbuf[0], torch.where(want_i >= 0, want_i, 0).float())


# prev_d values of the dead-pixel rule's test: finite depths either side of
# the scene's, the clear depth, both infinities, NaN and both zeros.
PREV_DEPTHS = [-0.9, -0.5, -0.25, 0.5, float(DEPTH_CLEAR), float("-inf"),
               float("inf"), float("nan"), 0.0, -0.0]


@pytest.mark.parametrize("seed", range(4))
def test_dead_pixels_get_clear_outputs(seed):
    """tile_raster.dead_pixels is the kernel's rule for the pixels a peel
    pass need not fold.  On random prev maps (finite depths, DEPTH_CLEAR,
    +-inf, NaN, +-0.0; prev_i of -1, 0 and larger) over random triangles
    that cover a 2-tile frame, tile_fold_plain gives every pixel the rule
    calls dead its framebuffer depth, -1 and a zero G-buffer; and the rule
    calls dead exactly the pixels with no previous winner whose depth is
    not above the clear depth."""
    rng = np.random.default_rng(seed)
    h, w, n = 4, 16, 6
    s = [-64.0, -64.0, 192.0, -64.0, -64.0, 192.0]      # covers the frame
    depths = rng.choice([-0.75, -0.5, -0.25, 0.0, 0.25], size=n)
    setup = torch.tensor([s + [d, d, d, 1.0 / 65536.0] for d in depths],
                         dtype=torch.float32)
    kp = 5
    payload = torch.tensor(
        [[float(t) + 1.0, sx, sy, 1.0 / 65536.0, 1.0] for t in range(n)
         for sx, sy in zip(s[0::2], s[1::2])]).reshape(n, 3 * kp)
    i32 = torch.int32
    ids = torch.arange(n, dtype=i32)
    fbd = torch.tensor(rng.uniform(-1.0, -0.6, (h, w)).astype(np.float32))
    prev_d = torch.tensor(rng.choice(PREV_DEPTHS, size=(h, w))
                          .astype(np.float32))
    prev_i = torch.tensor(rng.choice([-1, -1, 0, 3, n - 1], size=(h, w))
                          .astype(np.int32))
    prev_i[0, 0] = prev_i[0, 8] = 0            # both tiles run
    args = (fbd, setup, ids, torch.tensor([2], dtype=i32),
            torch.cat([ids[2:], ids[2:]]), torch.tensor([0, n - 2], dtype=i32),
            torch.tensor([n - 2, n - 2], dtype=i32), payload,
            (("v0", 0, 0), ("bary", 0, 0)))
    kw = dict(tile_h=4, tile_w=8, kp=kp, kpi=4, sl_screen=1, sl_ia=3,
              clip_w_off=4)
    dead = tile_raster.dead_pixels(prev_d, prev_i)
    want = (prev_i < 0) & (torch.isnan(prev_d)
                           | (prev_d <= float(DEPTH_CLEAR)))
    assert torch.equal(dead, want)
    assert dead.any() and not dead.all()
    gbuf, best_d, best_i = tile_raster.tile_fold_plain(
        *args, **kw, prev_d=prev_d, prev_i=prev_i)
    assert (best_i[dead] == -1).all()
    assert torch.equal(best_d[dead], fbd[dead])
    assert not gbuf[:, dead].any()
    assert (best_i[~dead] >= 0).any()          # live pixels do admit


@pytest.mark.parametrize("counts", [
    [], [7], [0, 0, 0, 0], [5, 5, 5], [3, 0, 9, 9, 1, 0, 9, 2],
    list(np.random.default_rng(5).integers(0, 40, 510))],
    ids=["empty", "one", "zeros", "equal", "ties", "ragged510"])
def test_tile_order_is_a_stable_descending_permutation(counts):
    c = torch.tensor(counts, dtype=torch.int32)
    order = tile_raster.tile_order(c)
    assert order.dtype == torch.int64 and order.device == c.device
    assert order.shape == c.shape
    assert sorted(order.tolist()) == list(range(len(counts)))
    got = [(counts[t], t) for t in order.tolist()]
    assert got == sorted(got, key=lambda ct: (-ct[0], ct[1]))


def test_split_tile_peel_edge_case_matches_expectation_and_jax_kernel():
    """The split-tile peel edge case chip_smoke.py runs through K2 on the
    card (a 32x128 tile whose only previous winner is in its last 1,024
    pixels, live pixels without one in its first two blocks, a dead pixel,
    a tile skipped whole) gives the expected winners in the plain twin,
    and the JAX peel kernel in interpret mode gives them too on the same
    triangles, framebuffer and prev maps."""
    args, kwargs, want_i, want_d = _smoke().split_tile_peel_inputs("cpu")
    gbuf, best_d, best_i = tile_raster.tile_fold(*args, **kwargs)
    assert torch.equal(best_i, want_i)
    assert torch.equal(best_d, want_d)
    assert torch.equal(gbuf[0], torch.where(want_i >= 0, want_i, 0).float())
    dead = tile_raster.dead_pixels(kwargs["prev_d"], kwargs["prev_i"])
    assert dead[3, 7] and not dead[2, 5] and not dead[4, 137]

    fbd, setup = args[0].numpy(), args[1].numpy()
    n = setup.shape[0]
    h, w = fbd.shape
    tris = {
        "screen": setup[:, :6].reshape(n, 3, 2),
        "depth": setup[:, 6:9],
        "inv_area": setup[:, 9],
        "valid": np.ones(n, bool),
        "bbox": np.tile(np.int32([0, 0, w - 1, h - 1]), (n, 1)),
        "attrs": {"clip_position": np.ones((n, 3, 4), np.float32)},
    }
    params = RenderParams(width=w, height=h)
    ctx = pallas_tile._prepare_ctx(tris, params, fbd, None, 0)
    # the same lists as the smoke's: no globals, both triangles in both
    # tiles
    assert int(ctx["n_global"][0]) == int(args[3][0]) == 0
    assert np.asarray(ctx["counts"]).tolist() == args[6].tolist()
    assert (ctx["tile_h"], ctx["tile_w"]) == (kwargs["tile_h"],
                                              kwargs["tile_w"])
    _, jd, ji = pallas_tile._run_pass(
        ctx, True, kwargs["prev_d"].numpy(),
        kwargs["prev_i"].numpy().astype(np.float32), raw=True)
    np.testing.assert_array_equal(np.asarray(ji), want_i.numpy())
    np.testing.assert_allclose(np.asarray(jd), want_d.numpy(), rtol=1e-5,
                               atol=0)


@pytest.mark.parametrize("tiling", [(8, 64), (24, 128)])
def test_plain_fold_is_the_same_frame_at_other_tilings(tiling):
    """The kernel takes any tile_h x tile_w (a tile smaller than a block
    of 1,024 pixels, one of three blocks); the twin at such a tiling gives
    the 32x128 frame's winners and depths on the unpadded frame, pass 0
    and a peel pass."""
    scene, cam = soup_scene()
    base = RenderParams(width=256, height=96, cull_mode=CullMode.NONE)
    out = {}
    for name, params in (("base", base),
                         ("other", base.replace(tile_h=tiling[0],
                                                tile_w=tiling[1]))):
        tris, extra = prepared(scene, cam, params, KEEP)
        tt = {k: torch.tensor(tris[k]) for k in ("screen", "depth",
                                                  "inv_area", "valid",
                                                  "bbox")}
        tt["attrs"] = {k: torch.tensor(v) for k, v in tris["attrs"].items()}
        fbd = torch.full((params.height, params.width), float(DEPTH_CLEAR))
        tctx = tile_raster.prepare(
            tt, params, fbd, {k: torch.tensor(v) for k, v in extra.items()},
            KEEP)
        args, kwargs = tile_raster.fold_inputs(tctx)
        g0, d0, i0 = tile_raster.tile_fold_plain(*args, **kwargs)
        g1, d1, i1 = tile_raster.tile_fold_plain(*args, **kwargs, prev_d=d0,
                                                 prev_i=i0)
        h, w = params.height, params.width
        out[name] = [t[..., :h, :w] for t in (g0, d0, i0, g1, d1, i1)]
        if name == "other":
            assert (kwargs["tile_h"], kwargs["tile_w"]) == tiling
    assert (out["base"][2] >= 0).float().mean() > 0.05
    assert (out["base"][5] >= 0).float().mean() > 0.01
    for a, b in zip(out["base"], out["other"]):
        assert torch.equal(a, b)
