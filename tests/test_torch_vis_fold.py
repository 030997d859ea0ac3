"""K5, the visibility fold of the deferred route: the port's plain twin
(vis_fold.visibility_fold_plain, behind visibility_fold on CPU tensors)
against the JAX kernel in interpret mode and the JAX binned fold, against
the port's binned fold and the tile kernel's twin, and on the edge cases
chip_smoke.py runs through the CUDA kernel."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from softwarerenderer_tpu import RenderParams
from softwarerenderer_tpu import shaders as jsh
from softwarerenderer_tpu.models import primitives
from softwarerenderer_tpu.ops import binning as jbinning
from softwarerenderer_tpu.ops import geometry as jgeom
from softwarerenderer_tpu.ops import pallas_raster
from softwarerenderer_tpu.utils import mathlib as ml
from softwarerenderer_tpu_torch.config import CullMode, DepthTest
from softwarerenderer_tpu_torch.ops import binning, tile_raster, vis_fold
from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import vis_fold_edge_cases  # noqa: E402

# tests/test_pallas_raster.py's frame and tiling.
W, H = 200, 150
PARAMS = RenderParams(width=W, height=H, cull_mode=0, tile_h=16,
                      tile_w=128, span_cap=6, tile_group=4, chunk=32)


def scene_mesh(name):
    """The three meshes of tests/test_pallas_raster.py:46-58."""
    if name == "soup":
        return primitives.random_triangle_soup(120, seed=4)
    if name == "nearclip":
        return primitives.random_triangle_soup(50, seed=5,
                                               z_range=(-4.0, 1.0))
    return primitives.plane(40.0, y=-1.5)      # spans > span_cap: global


def jax_tris(mesh, width=W, height=H):
    """JAX's build_triangles output for the mesh, as numpy arrays."""
    vin = jsh.make_vertex_input(mesh["position"], mesh["uv"],
                                mesh["normal"], mesh["color"])
    u = {"model": np.eye(4, dtype=np.float32),
         "view": ml.look_at(np.float32([0, 0, 3]), [0, 0, 0], [0, 1, 0]),
         "projection": ml.perspective_fov(np.deg2rad(60.0), width / height,
                                          0.1, 100.0),
         "near_clip": np.float32(0.1)}
    tris = jax.jit(lambda v, i, u: jgeom.build_triangles(
        jsh.default_vertex_shader, v, i, u, width=width, height=height,
        cull_mode=0))(vin, mesh["indices"], u)
    return jax.tree_util.tree_map(np.asarray, tris)


def to_torch(tris):
    out = {k: torch.tensor(tris[k]) for k in ("screen", "depth", "inv_area",
                                               "valid", "bbox")}
    out["attrs"] = {k: torch.tensor(v) for k, v in tris["attrs"].items()}
    return out


SCENES = ["soup", "nearclip", "global_plane"]
# Absolute depth bound of each scene where the winners agree with JAX's,
# about twice the largest difference measured (against both JAX folds:
# soup 1.13e-6, nearclip 1.97e-6, global_plane 5.07e-6).  JAX's own bar
# between two of its runs is 1e-6 (tests/test_pallas_raster.py:56-58);
# XLA on the CPU contracts the edge functions' multiply-adds into FMAs in
# both of those, the port rounds every operation once as the CUDA kernel
# does, and where an edge function cancels large products the two differ
# by tens of ulps (most on the global plane, whose near-clipped corners
# lie far off screen).
DEPTH_ATOL = {"soup": 2e-6, "nearclip": 3e-6, "global_plane": 1e-5}


@pytest.mark.parametrize("scene", SCENES)
def test_fold_twin_matches_jax_kernel(scene):
    """The winners to JAX's own bar for its K5 against its binned fold
    (tests/test_pallas_raster.py:56-58: equal on > 99.9 % of pixels; equal
    on every pixel, measured), on the same triangles; the depth where they
    agree within the scene's DEPTH_ATOL."""
    tris = jax_tris(scene_mesh(scene))
    jd, ji = map(np.asarray, jax.jit(lambda t: pallas_raster.
                                     make_pallas_visibility(interpret=True)(
                                         t, PARAMS, 32))(tris))
    bd, bi = map(np.asarray, jax.jit(lambda t: jbinning.
                                     make_binned_visibility(
                                         tile_h=16, tile_w=128, span_cap=6,
                                         tile_group=4)(t, PARAMS, 32))(tris))
    d, i = (t.numpy() for t in vis_fold.visibility_fold(to_torch(tris),
                                                       PARAMS))
    assert (i >= 0).mean() > 0.05
    for want_d, want_i in ((jd, ji), (bd, bi)):
        same = i == want_i
        assert same.mean() > 0.999
        np.testing.assert_allclose(d[same], want_d[same], rtol=0,
                                   atol=DEPTH_ATOL[scene])


@pytest.mark.parametrize("scene", SCENES)
def test_fold_twin_equals_binned_fold_and_tile_twin(scene):
    """On the same triangles and seed, the K5 twin, the port's binned fold
    and K1's twin (its own tiles, tile_h capped at 32) give the same
    winners, and the same depth bit for bit: all evaluate one expression
    per fragment and fold (depth, id) keys."""
    tris = to_torch(jax_tris(scene_mesh(scene)))
    d, i = vis_fold.visibility_fold(tris, PARAMS)
    bd, bi = binning.visibility_binned(tris, PARAMS, tile_h=16, tile_w=128,
                                       span_cap=6)
    fbd = torch.full((H, W), DEPTH_CLEAR)
    ctx = tile_raster.prepare(tris, PARAMS.replace(tile_h=32), fbd, None,
                              frozenset(("color",)))
    args, kwargs = tile_raster.fold_inputs(ctx)
    _, kd, ki = tile_raster.tile_fold_plain(*args, **kwargs)
    for want_d, want_i in ((bd, bi), (kd[:H, :W], ki[:H, :W])):
        assert torch.equal(i, want_i)
        assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))


@pytest.mark.parametrize("case", range(5))
def test_fold_edge_cases(case):
    """chip_smoke.py's K5 edge cases (a -inf seed and a NaN fragment, ties
    at the seed and between the lists, -0.0 against +0.0, row_offset 4,
    tile_h 64, an empty frame) give the expected winners and depths, bit
    for bit, in the twin, so a failure on the card is the kernel's."""
    name, args, kwargs, want_i, want_d = vis_fold_edge_cases("cpu")[case]
    d, i = vis_fold.vis_fold(*args, **kwargs)
    assert torch.equal(i, want_i), name
    assert torch.equal(d.view(torch.int32), want_d.view(torch.int32)), name


def test_fold_row_offset_matches_jax():
    """A band of 48 rows at screen row 64: the port's bins and fold against
    JAX's K5 (interpret) on the same band, at the soup's bar above."""
    tris = jax_tris(scene_mesh("soup"))
    band = PARAMS.replace(height=48)
    jd, ji = map(np.asarray, jax.jit(lambda t: pallas_raster.
                                     visibility_pallas(t, band, 32,
                                                       row_offset=64,
                                                       interpret=True))(tris))
    d, i = (t.numpy() for t in vis_fold.visibility_fold(
        to_torch(tris), band, row_offset=64))
    full_d, full_i = vis_fold.visibility_fold(to_torch(tris), PARAMS)
    assert (i >= 0).mean() > 0.05
    same = i == ji
    assert same.mean() > 0.999
    np.testing.assert_allclose(d[same], jd[same], rtol=0,
                               atol=DEPTH_ATOL["soup"])
    # and it is the full frame's rows 64..111
    assert np.array_equal(i, full_i[64:112].numpy())


def test_fold_rejects_other_depth_tests():
    tris = to_torch(jax_tris(primitives.random_triangle_soup(8, seed=1)))
    for mode in DepthTest:
        if mode != DepthTest.LESS_EQUAL:
            with pytest.raises(NotImplementedError):
                vis_fold.visibility_fold(tris, PARAMS.replace(depth_test=mode))


def test_fold_has_no_fallback_for_other_devices():
    """vis_fold runs the twin only for CPU tensors."""
    fbd = torch.empty((2, 4), device="meta")
    i = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        vis_fold.vis_fold(fbd, torch.empty((1, 10), device="meta"), i, i, i,
                          i, i, tile_h=2, tile_w=4)


def test_nan_depth_of_a_valid_slot():
    """build_triangles can emit a NaN fragment depth for a valid, binned
    slot: a near-clipped triangle whose clip coordinates reach 1e13 gets
    screen corners past 1e19, its area overflows to inf, so 1/area is 0
    and the weight of an inf edge function is inf x 0 = NaN, on every
    pixel of this frame.  The fold never lets such a fragment win: every
    pixel keeps the seed."""
    from softwarerenderer_tpu_torch.ops import geometry, raster

    def vs(v, u):
        return {"clip_position": v["clip"], "color": v["color"]}

    clip = torch.tensor([
        [61725827072.0, -2529175797760.0, 1057972289536.0, 3.40064616e-07],
        [19801005096960.0, 163173466112.0, -17273471369216.0,
         1.36281139e-10],
        [56528.671875, -40011.9453125, -58036.6640625, -0.75488543]])
    params = RenderParams(width=16, height=8, tile_h=8, tile_w=8,
                          span_cap=6)
    tris = geometry.build_triangles(
        vs, {"clip": clip, "color": torch.ones(3, 4)},
        torch.arange(3).reshape(1, 3), {"near_clip": torch.tensor(0.1)},
        width=16, height=8, cull_mode=CullMode.NONE)
    assert bool(tris["valid"][0]) and torch.isinf(tris["area"][0])
    px, py = raster.pixel_grid(8, 16, "cpu")
    inside, d = raster.fragments(raster.setup_rows(tris)[:1], px, py)
    assert bool((inside & torch.isnan(d)).all())
    best_d, best_i = vis_fold.visibility_fold(tris, params)
    assert bool((best_i == -1).all()) and bool((best_d == DEPTH_CLEAR).all())
