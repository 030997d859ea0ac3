"""Engine's frames of a scene with LOD levels run at the scene's LOD bound:
the masked-in input triangles are compacted to lod.suggested_geom_cap
(one level a mesh) before the geometry, in the span frame.geom_cap, when
the caller sets no geom_cap.  On the CPU: at cameras that fill the bound
exactly, mix the levels and cull every sphere, Engine's frame equals
render_frame's uncapped frame on every value; the bound is the host
scene's; the span runs once a render on an LOD scene and never on a
scene without levels; an explicit geom_cap still wins, overflow and
counter included; active_cap_stats reports the keys it reports without
the bound."""

import numpy as np
import pytest
import torch

from softwarerenderer_tpu_torch import scenes
from softwarerenderer_tpu_torch.config import RenderParams
from softwarerenderer_tpu_torch.engine import Engine, render_frame
from softwarerenderer_tpu_torch.engine import renderer
from softwarerenderer_tpu_torch.models import primitives
from softwarerenderer_tpu_torch.models.scene import (MeshInstance,
                                                     build_scene_buffers)
from softwarerenderer_tpu_torch.ops import culling, lod
from softwarerenderer_tpu_torch.utils import mathlib as ml
from softwarerenderer_tpu_torch.utils import profiling

W, H = 160, 120
GRID = (4, 3)               # spheres across, rows deep
# Level 0 of the sphere: the most triangles of its three levels.
LEVEL0_TRIS = 560

# Cameras (position, fov in degrees) and what each does to the crowd.
CAMERAS = {
    # every sphere in view and at level 0: the masked-in triangles are
    # exactly the bound
    "level0": ((0.0, 0.0, 4.0), 20.0),
    # the near row at level 0, the others at levels 1 and 2, some culled
    "mixed": ((0.0, 0.0, -2.0), 90.0),
    # the crowd behind the camera
    "culled": ((0.0, 0.0, -20.0), 90.0),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its frames are many small
    ops, which torch's default pool slows down when the suite's workers
    share the cores (tests/test_torch_dust2.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_totals():
    profiling.reset_span_totals()
    yield
    profiling.reset_span_totals()


@pytest.fixture(scope="module")
def crowd():
    """A small LOD crowd: 4 x 3 spheres (560, 355 and 99 triangles at
    levels 0-2) with thresholds at 14 and 7 pixels, in submission order
    left to right, near row first."""
    mesh = lod.add_lods(primitives.uv_sphere(0.45, rings=14, sectors=20),
                        cells=(8, 4), px=(14.0, 7.0))
    return build_scene_buffers([
        MeshInstance(mesh, ml.translation([(gx - 1.5) * 1.2, 0.0,
                                           -3.0 - gz * 1.5]))
        for gz in range(GRID[1]) for gx in range(GRID[0])])


@pytest.fixture(scope="module")
def engine(crowd):
    return Engine(crowd, RenderParams(W, H), device="cpu")


def camera(eng, name):
    pos, fov = CAMERAS[name]
    u = dict(eng.uniforms)
    u["camera_position"] = np.float32(pos)
    u["fov_degrees"] = np.float32(fov)
    return u


def ints(stats):
    return {k: int(v) for k, v in stats.items()}


def masked_in(eng, u):
    """The frame's masked-in input triangles: its meshes in the frustum,
    at their active LOD level (engine.frame_setup's mask)."""
    sc = eng.scene
    du = renderer.device_uniforms(u, W, H, "cpu")
    visible = culling.spheres_in_frustum(
        sc["bounds_center"], sc["bounds_radius"], sc["mesh_matrices"],
        ml.transform(du["view"], du["projection"]))
    return int((visible[sc["tri_mesh_id"].long()]
                & lod.lod_tri_mask(sc, du, H)).sum())


@pytest.mark.parametrize("cam", sorted(CAMERAS))
def test_engine_lod_frame_equals_uncapped_frame(engine, cam):
    u = camera(engine, cam)
    bound = engine.frame_params().geom_cap
    n = masked_in(engine, u)
    if cam == "level0":
        assert n == bound
    elif cam == "mixed":
        assert 0 < n < bound
    else:
        assert n == 0
    color, depth = engine.render(u)
    ref_color, ref_depth = render_frame(engine.scene, u, engine.params)
    np.testing.assert_array_equal(color.numpy(), ref_color.numpy())
    np.testing.assert_array_equal(depth.numpy(), ref_depth.numpy())


def test_bound_is_the_host_scenes_suggested_geom_cap(crowd, engine):
    bound = lod.suggested_geom_cap(crowd)
    assert bound == GRID[0] * GRID[1] * LEVEL0_TRIS
    assert bound < crowd["indices"].shape[0]
    assert engine.frame_params().geom_cap == bound
    assert engine.params.geom_cap == 0           # the caller's, as given
    shared = Engine(engine.scene, RenderParams(W, H), device="cpu")
    assert shared.frame_params().geom_cap == bound


@pytest.mark.parametrize("which", ("lod_crowd", "bench"))
def test_geom_cap_span_calls_per_render(crowd, which):
    sc = crowd if which == "lod_crowd" else scenes.bench_scene()
    eng = Engine(sc, RenderParams(64, 48), device="cpu")
    if which == "bench":
        assert "tri_lod_level" not in sc
        assert eng.frame_params() is eng.params
    with profiling.recording():
        for _ in range(2):
            eng.render()
    totals = profiling.span_totals()
    assert totals["engine.render"]["calls"] == 2
    calls = totals.get("frame.geom_cap", {"calls": 0})["calls"]
    assert calls == (2 if which == "lod_crowd" else 0)


def test_explicit_geom_cap_below_bound_drops_last_submitted(crowd, engine):
    """A geom_cap of one level-0 sphere keeps the first-submitted sphere
    alone, as test_torch_caps.py's overflow test keeps the first plane."""
    u = camera(engine, "level0")
    p = RenderParams(W, H, geom_cap=LEVEL0_TRIS, active_cap_stats=True)
    eng = Engine(engine.scene, p, device="cpu")
    assert eng.frame_params() is eng.params
    color, depth, stats = eng.render(u)
    first = np.zeros(GRID[0] * GRID[1], bool)
    first[0] = True
    ref_color, ref_depth = render_frame(
        engine.scene, {**u, "mesh_visible": first}, RenderParams(W, H))
    np.testing.assert_array_equal(color.numpy(), ref_color.numpy())
    np.testing.assert_array_equal(depth.numpy(), ref_depth.numpy())
    assert int(stats["geom_cap_overflow"]) == \
        lod.suggested_geom_cap(crowd) - LEVEL0_TRIS
    full, _ = render_frame(engine.scene, u, RenderParams(W, H))
    assert not torch.equal(color, full)


@pytest.mark.parametrize("caps", ({}, {"active_cap": 2048},
                                  {"geom_cap": 4096}),
                         ids=("no_caps", "active_cap", "geom_cap"))
def test_active_cap_stats_keys_unchanged(engine, caps):
    """Engine's stats are render_frame's with the caller's params: the
    same keys and counts, and no counter for the LOD bound."""
    u = camera(engine, "mixed")
    p = RenderParams(W, H, active_cap_stats=True, **caps)
    got = ints(Engine(engine.scene, p, device="cpu").render(u)[2])
    want = ints(render_frame(engine.scene, u, p)[2])
    assert got == want
    assert ("geom_cap_overflow" in got) == ("geom_cap" in caps)
