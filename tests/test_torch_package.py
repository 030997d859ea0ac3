"""Package rules of softwarerenderer_tpu_torch: no JAX import, scene
conversion, no CPU fallback for CUDA, and refusal of what it does not
implement."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from softwarerenderer_tpu import BlendMode, DebugMode, DepthTest
from softwarerenderer_tpu.models import primitives
from softwarerenderer_tpu.models import scene as scene_mod
from softwarerenderer_tpu.ops import texture as tex_np
from softwarerenderer_tpu.utils import mathlib as ml
from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import Engine, render_frame
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import tile_raster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_scene():
    checker = np.asarray(tex_np.checkerboard(16, 4)["data"])
    return scene_mod.build_scene_buffers([
        scene_mod.MeshInstance(primitives.cube(1.0),
                               ml.translation([0, 0, -3]), texture=checker),
        scene_mod.MeshInstance(primitives.random_triangle_soup(40, seed=2),
                               texture=checker)])


_IMPORTS = {
    "package": """
import importlib, pkgutil
import softwarerenderer_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
""",
    "chip_smoke": "import chip_smoke\n",
}

_RENDER_AND_CHECK = """
import functools, sys
from softwarerenderer_tpu_torch import RenderParams, scenes
from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.ops.raytrace import render_frame_raytraced
for fn in (None, functools.partial(render_frame_raytraced, cluster_cap=24)):
    eng = Engine(scenes.bench_scene(), RenderParams(64, 48), device="cpu",
                 frame_fn=fn)
    rgb = eng.present(scenes.camera_uniforms(eng.uniforms, 0))
    assert rgb.shape == (48, 64, 3), rgb.shape
bad = [m for m in sys.modules
       if m in ("jax", "jaxlib", "bench", "scripts", "softwarerenderer_tpu")
       or m.startswith(("jax.", "jaxlib.", "scripts.",
                        "softwarerenderer_tpu."))]
assert not bad, bad
print("ok")
"""


@pytest.mark.parametrize("what", sorted(_IMPORTS))
def test_port_never_imports_jax(what):
    """Import every module of the port (or chip_smoke.py), render a raster
    and a ray-traced CPU frame of the port's own bench scene, and find
    neither JAX, nor bench or scripts, nor any module of the JAX package
    (``softwarerenderer_tpu_torch`` itself only shares its prefix)."""
    code = _IMPORTS[what] + _RENDER_AND_CHECK
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_render_params_match_jax():
    """The port's copy of config.py: RenderParams' field names and
    defaults, and every enum's names and values, equal to the source."""
    import dataclasses
    from softwarerenderer_tpu import config as jax_config
    from softwarerenderer_tpu_torch import config

    def fields(cls):
        return [(f.name, f.default, f.default_factory)
                for f in dataclasses.fields(cls)]

    assert fields(config.RenderParams) == fields(jax_config.RenderParams)
    assert config.RenderParams(64, 48) == config.RenderParams(64, 48).replace()
    for name in ("DepthTest", "BlendMode", "CullMode", "DebugMode"):
        got, want = getattr(config, name), getattr(jax_config, name)
        assert [(m.name, int(m)) for m in got] == \
            [(m.name, int(m)) for m in want], name
        assert all(getattr(got, m.name) == m for m in want)


def _host_modules(port: bool):
    """(primitives, scene, texture, mathlib): the port's host layer or the
    JAX package's."""
    if port:
        from softwarerenderer_tpu_torch.models import primitives as p
        from softwarerenderer_tpu_torch.models import scene as s
        from softwarerenderer_tpu_torch.ops import texture as t
        from softwarerenderer_tpu_torch.utils import mathlib as m
    else:
        from softwarerenderer_tpu.models import primitives as p
        from softwarerenderer_tpu.models import scene as s
        from softwarerenderer_tpu.ops import texture as t
        from softwarerenderer_tpu.utils import mathlib as m
    return p, s, t, m


def _package_scene(p, s, t, m):
    """small_scene above."""
    checker = np.asarray(t.checkerboard(16, 4)["data"])
    return [s.MeshInstance(p.cube(1.0), m.translation([0, 0, -3]),
                           texture=checker),
            s.MeshInstance(p.random_triangle_soup(40, seed=2),
                           texture=checker)]


def _raytrace_scene(p, s, t, m):
    """tests/test_torch_raytrace.py's frame scene, with a rotated, scaled
    cube (its _mesh_scene) added."""
    checker = np.asarray(t.checkerboard(16, 4)["data"])
    rot = (m.matrix_from_yaw_pitch_roll(0.5, 0.3, 0.1)
           @ np.diag(np.float32([1.5, 0.7, 1.2, 1.0]))
           @ m.translation([0.2, 0.1, -3.0])).astype(np.float32)
    return [s.MeshInstance(p.cube(1.0), m.translation([0.0, 0.0, -3.0]),
                           texture=checker),
            s.MeshInstance(p.plane(20.0), m.translation([0.0, -1.0, 0.0])),
            s.MeshInstance(p.cube(1.0), rot, texture=checker)]


def _kbuffer_scene(p, s, t, m):
    """tests/test_torch_kbuffer.py's kind of scene: a glass cube in front
    of a textured one, vertex colors with alpha, a sphere."""
    checker = np.asarray(t.checkerboard(32, 4)["data"])
    glass = np.zeros((8, 8, 4), np.float32)
    glass[...] = (0.3, 0.5, 1.0, 0.45)
    pane = dict(p.plane(1.6))
    pane["color"] = np.full((pane["position"].shape[0], 4), 0.5, np.float32)
    return [s.MeshInstance(p.cube(1.0), m.translation([0, 0, -4]),
                           texture=checker),
            s.MeshInstance(p.cube(1.4), m.translation([0, 0, -2.2]),
                           texture=glass),
            s.MeshInstance(pane, m.matrix_from_yaw_pitch_roll(
                0.0, np.pi / 2, 0.0) @ m.translation([0, 1, 1])),
            s.MeshInstance(p.uv_sphere(0.7, rings=10, sectors=16),
                           m.translation([1.4, 0.3, -4]))]


def _assert_same_scene(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("build", [_package_scene, _raytrace_scene,
                                   _kbuffer_scene],
                         ids=["package", "raytrace", "kbuffer"])
def test_build_scene_buffers_match_jax(build):
    """The port's models.scene, models.primitives, texture.checkerboard and
    numpy mathlib give the packed scene the JAX package's give, key for
    key, dtype for dtype and value for value."""
    got = _host_modules(True)[1].build_scene_buffers(
        build(*_host_modules(True)))
    want = _host_modules(False)[1].build_scene_buffers(
        build(*_host_modules(False)))
    _assert_same_scene(got, want)


def test_bench_scene_matches_bench():
    import bench
    from softwarerenderer_tpu_torch import scenes
    assert not os.path.exists(bench.DUST2)
    _assert_same_scene(scenes.bench_scene(), bench.build_scene())


@pytest.mark.parametrize("n", [1, 2])
def test_golden_config_matches_bench(n):
    import bench
    from scripts.make_goldens import GOLDEN_SIZES
    from softwarerenderer_tpu.models import scene as scene_mod
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.models.scene import build_scene_buffers
    assert scenes.GOLDEN_SIZES[n] == GOLDEN_SIZES[n]
    _assert_same_scene(
        build_scene_buffers(scenes.golden_config(n)),
        scene_mod.build_scene_buffers(bench.config_workload(n)[0]))


def _translucent_source(p, s, t, m):
    """scripts/profile_translucent.py:52-63's six glass panes over the
    bench soup (bench.build_scene's fallback) in place of Dust2."""
    tex = np.asarray(t.checkerboard(
        64, 8, (0.8, 0.75, 0.6, 1.0), (0.55, 0.5, 0.4, 1.0))["data"])
    insts = [s.MeshInstance(p.random_triangle_soup(9061, seed=0),
                            texture=tex)]
    rng = np.random.default_rng(3)
    for i in range(6):
        pane = dict(p.plane(1.6))
        col = np.ones((pane["position"].shape[0], 4), np.float32)
        col[:, 3] = 0.5
        col[:, :3] = rng.uniform(0.4, 1.0, 3)
        pane["color"] = col
        mat = (m.matrix_from_yaw_pitch_roll(0.0, np.pi / 2, 0.0)
               @ m.translation([-3.0 + 1.4 * i, 2.0, 2.0 + 0.4 * (i % 3)])
               ).astype(np.float32)
        insts.append(s.MeshInstance(pane, mat))
    return insts


def _kbuffer_golden_source(p, s, t, m):
    """scripts/make_goldens.py:render_feature("kbuffer")'s instances."""
    checker = np.asarray(t.checkerboard(32, 4)["data"])
    glass = np.zeros((8, 8, 4), np.float32)
    glass[...] = (0.3, 0.5, 1.0, 0.45)
    return [s.MeshInstance(p.plane(20.0), m.translation([0, -1, 0]),
                           texture=checker),
            s.MeshInstance(p.cube(1.0), m.translation([0, 0, -4]),
                           texture=checker),
            s.MeshInstance(p.cube(1.4), m.translation([0, 0, -2.2]),
                           texture=glass)]


@pytest.mark.parametrize("which", ["translucent", "kbuffer_golden"])
def test_kbuffer_scenes_match_their_sources(which):
    from softwarerenderer_tpu import CullMode as JaxCullMode
    from softwarerenderer_tpu.models import scene as scene_mod
    from softwarerenderer_tpu_torch import scenes
    if which == "translucent":
        got = scenes.translucent_scene()
        source = _translucent_source
    else:
        got, params, u = scenes.kbuffer_golden_frame()
        assert (params.width, params.height, params.kbuffer,
                params.cull_mode) == (320, 240, 4, JaxCullMode.BACK)
        np.testing.assert_array_equal(u["camera_position"],
                                      np.float32([0, 0.8, 2.0]))
        source = _kbuffer_golden_source
    _assert_same_scene(got, scene_mod.build_scene_buffers(
        source(*_host_modules(False))))


@pytest.mark.parametrize("frame", [0, 29])
def test_camera_uniforms_match_bench(frame):
    import bench
    from softwarerenderer_tpu.engine.renderer import default_frame_uniforms
    from softwarerenderer_tpu_torch import scenes
    base = default_frame_uniforms(64, 48)
    got = scenes.camera_uniforms(base, frame)
    want = bench.camera_uniforms(base, frame)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_scene_to_torch_round_trips_every_key():
    scene = small_scene()
    got = scene_to_torch(scene, "cpu")
    assert sorted(got) == sorted(scene)
    for k, v in scene.items():
        t = got[k]
        assert t.dtype == torch.from_numpy(np.zeros(0, v.dtype)).dtype, k
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), v, err_msg=k)
    assert got["atlas_data"].dtype == torch.uint8
    assert got["indices"].dtype == torch.int32
    assert got["position"].dtype == torch.float32


def test_engine_cuda_without_a_card_raises(monkeypatch):
    """device="cuda" with no CUDA device raises; it never renders on the
    CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(small_scene(), RenderParams(64, 48), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(small_scene(), RenderParams(64, 48))      # the default


def test_tile_fold_has_no_fallback_for_other_devices():
    """The wrappers run the plain versions only for CPU tensors."""
    fbd = torch.empty((32, 128), device="meta")
    i = torch.empty(1, dtype=torch.int32, device="meta")
    args = (fbd, fbd, i, i, i, i, i, fbd, (("v0", 0, 0),))
    kw = dict(tile_h=32, tile_w=128, kp=4, kpi=1, sl_screen=0, sl_ia=2,
              clip_w_off=3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tile_raster.tile_fold(*args, **kw)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tile_raster.tile_fold(*args, **kw, prev_d=fbd, prev_i=fbd)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tile_raster.tile_fold_kdeep(*args, **kw, K=4)


@pytest.mark.parametrize("K", [0, tile_raster.MAX_KDEEP + 1])
def test_tile_fold_kdeep_rejects_k_out_of_range(K):
    fbd = torch.zeros((2, 4))
    i = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match=f"K <= {tile_raster.MAX_KDEEP}"):
        tile_raster.tile_fold_kdeep(fbd, torch.zeros((1, 10)), i, i, i, i,
                                    i, torch.zeros((1, 12)), (("v0", 0, 0),),
                                    K=K, tile_h=2, tile_w=4, kp=4, kpi=1,
                                    sl_screen=0, sl_ia=2, clip_w_off=3)


def test_tile_fold_needs_both_prev_maps():
    fbd = torch.zeros((2, 4))
    i = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        tile_raster.tile_fold(fbd, torch.zeros((1, 10)), i, i, i, i, i,
                              torch.zeros((1, 12)), (("v0", 0, 0),),
                              tile_h=2, tile_w=4, kp=4, kpi=1, sl_screen=0,
                              sl_ia=2, clip_w_off=3, prev_d=fbd)


@pytest.mark.parametrize("plan,kpi,match", [
    ((("pc", 0, 4),), 3, "kpi"),          # writes 4 channels into 3
    ((("pw3", 2, 5),), 3, "outside"),     # columns 2..4 of a 4-column row
    ((("rgb", 0, 1),), 3, "kind"),
])
def test_tile_fold_rejects_a_bad_plan(plan, kpi, match):
    fbd = torch.zeros((2, 4))
    i = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        tile_raster.tile_fold(fbd, torch.zeros((1, 10)), i, i, i, i, i,
                              torch.zeros((1, 12)), plan, tile_h=2,
                              tile_w=4, kp=4, kpi=kpi, sl_screen=0,
                              sl_ia=2, clip_w_off=3)


@pytest.mark.parametrize("field,value", [
    ("ssaa", 2), ("ssao", True), ("bloom", True), ("tonemap", "aces"),
    ("fxaa", True), ("kbuffer", 4), ("debug_mode", DebugMode.WIREFRAME),
    ("deferred", False), ("binned", False),
    ("depth_test", DepthTest.GREATER), ("active_cap", 1000),
    ("geom_cap", 1000), ("pair_cap", 1000), ("global_cap", 512),
    ("use_mipmaps", True), ("shade_rate", 2), ("active_cap_stats", True),
])
def test_unsupported_params_raise(field, value):
    # kbuffer > 1 renders on its LESS_EQUAL route; with any other depth
    # test it is still refused.
    also = {"kbuffer": {"depth_test": DepthTest.GREATER}}.get(field, {})
    params = RenderParams(64, 48).replace(**{field: value}, **also)
    with pytest.raises(NotImplementedError, match=field):
        Engine(small_scene(), params, device="cpu")


@pytest.mark.parametrize("kbuffer", [0, 1])
def test_kbuffer_stats_without_kbuffer_raises(kbuffer):
    """As in JAX's render_frame: the stats dict is the K-buffer's."""
    params = RenderParams(64, 48, kbuffer=kbuffer, kbuffer_stats=True)
    with pytest.raises(ValueError, match="kbuffer_stats needs kbuffer > 1"):
        Engine(small_scene(), params, device="cpu")


@pytest.mark.parametrize("key", ["tangent", "skin_joints", "anim_positions",
                                 "morph_vert_index", "particle_vert_index",
                                 "tri_lod_level"])
def test_unsupported_scene_keys_raise(key):
    scene = dict(small_scene())
    scene[key] = np.zeros(3, np.float32)
    with pytest.raises(NotImplementedError, match=key):
        Engine(scene, RenderParams(64, 48), device="cpu")


def test_sky_panorama_uniform_raises():
    eng = Engine(small_scene(), RenderParams(64, 48), device="cpu")
    u = dict(eng.uniforms, sky_panorama=np.zeros((4, 8, 4), np.float32))
    with pytest.raises(NotImplementedError, match="sky_panorama"):
        render_frame(eng.scene, u, eng.params)


@pytest.mark.parametrize("mode", list(BlendMode))
def test_blend_modes_render(mode):
    """Blend mode is a supported field: every mode renders a finite frame
    (opaque winners over the clear color)."""
    eng = Engine(small_scene(), RenderParams(64, 48, blend_mode=mode),
                 device="cpu")
    color, depth = eng.render()
    assert torch.isfinite(color).all() and (depth > -3e38).any()
