"""Package rules of softwarerenderer_tpu_torch: no JAX import, scene
conversion, no CPU fallback for CUDA, and refusal of what it does not
implement."""

import functools
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
    "examples": """
import importlib
from softwarerenderer_tpu_torch.examples import DEMOS
for name in DEMOS:
    importlib.import_module("softwarerenderer_tpu_torch.examples." + name)
from softwarerenderer_tpu_torch import shaders
from softwarerenderer_tpu_torch.models.scene import Camera
from softwarerenderer_tpu_torch.ops import binning, rt_accel, texture
from softwarerenderer_tpu_torch.utils import hostmath, mathlib, profiling
assert Camera().view_matrix().shape == (4, 4)
assert shaders.make_vertex_input([[0.0, 0.0, 0.0]])["color"].shape == (1, 4)
assert (texture.sample_atlas_nearest, binning.pair_cap_overflow,
        rt_accel.bundle_pair_count, rt_accel.bundle_survivor_count,
        hostmath.look_at, mathlib.identity, mathlib.scale,
        mathlib.quat_conjugate, profiling.hard_sync, profiling.timed_frames,
        profiling.watchdog, profiling.trace)
""",
}

_RENDER = """
import functools
import torch
# One intra-op thread: the script is thousands of small ops, which a pool
# of one thread a core slows down many times over when the suite's
# workers share the cores.
torch.set_num_threads(1)
from softwarerenderer_tpu_torch import RenderParams, scenes
from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.ops.raytrace import render_frame_raytraced
from softwarerenderer_tpu_torch.config import DebugMode
for fn, kw in ((None, {}), (None, {"use_pallas": False}),
               (None, {"deferred": False}),
               (None, {"debug_mode": DebugMode.DEPTH}),
               (functools.partial(render_frame_raytraced, cluster_cap=24),
                {})):
    eng = Engine(scenes.bench_scene(), RenderParams(64, 48, **kw),
                 device="cpu", frame_fn=fn)
    rgb = eng.present(scenes.camera_uniforms(eng.uniforms, 0))
    assert rgb.shape == (48, 64, 3), rgb.shape
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.models.scene import build_scene_buffers
eng = Engine(build_scene_buffers(scenes.golden_config(3)),
             RenderParams(64, 48), device="cpu", **scenes.golden_shaders(3))
assert eng.present(scenes.golden_uniforms(3, eng.uniforms)).shape == \
    (48, 64, 3)
for name in ("shadows", "point_shadows", "spot_shadows"):
    sc, p, u, fn, _ = scenes.shadow_golden_frame(name)
    c, d = fn(scene_to_torch(sc, "cpu"), u, RenderParams(64, 48))
    assert c.shape == (48, 64, 4), c.shape
import numpy as np
from softwarerenderer_tpu_torch.engine import scene_fragment_shader_bilinear
from softwarerenderer_tpu_torch.ops import lighting, sky
pano = np.random.default_rng(0).uniform(0, 1, (8, 16, 4)).astype(np.float32)
for name in ("mips", "trilinear", "ssaa", "ssao"):
    sc, p, u, shaders = scenes.feature_golden_frame(name)
    p = p.replace(width=32, height=24, ssaa=min(p.ssaa, 2), bloom=True,
                  tonemap="aces", fxaa=True)
    eng = Engine(sc, p, device="cpu", **shaders)
    assert eng.present(dict(u, sky_panorama=pano)).shape == (24, 32, 3)
eng = Engine(scenes.bench_scene(), RenderParams(32, 24), device="cpu",
             fragment_shader=scene_fragment_shader_bilinear)
assert eng.present(eng.uniforms).shape == (24, 32, 3)
eng = Engine(sc, RenderParams(32, 24), device="cpu",
             vertex_shader=lighting.lit_scene_vertex_shader,
             fragment_shader=lighting.pbr_scene_fragment_shader)
u = dict(eng.uniforms, env_irradiance=sky.irradiance_panorama(pano),
         sky_panorama=pano)
assert eng.present(u).shape == (24, 32, 3)
eng = Engine(scenes.bench_scene(), RenderParams(32, 24), device="cpu",
             frame_fn=functools.partial(render_frame_raytraced,
                                        cluster_cap=24, reflections=True))
assert eng.present(dict(eng.uniforms, sky_panorama=pano)).shape == \
    (24, 32, 3)
from softwarerenderer_tpu_torch.engine import (default_frame_uniforms,
                                               render_frame_with_shadows)
from softwarerenderer_tpu_torch.ops import normalmap
counts = dict(tentacles=1, flipbooks=1, morphs=1, particles=4, lods=2)
sc = scenes.animated_scene(**counts)
u = scenes.animated_uniforms(default_frame_uniforms(32, 24), 3,
                             tentacles=1, particles=4)
eng = Engine(sc, RenderParams(32, 24), device="cpu",
             vertex_shader=normalmap.normal_mapped_vertex_shader,
             fragment_shader=normalmap.normal_mapped_fragment_shader)
assert eng.present(u).shape == (24, 32, 3)
c, d = render_frame_with_shadows(scene_to_torch(sc, "cpu"), u,
                                 RenderParams(32, 24), shadow_size=32)
assert c.shape == (24, 32, 4)
from softwarerenderer_tpu_torch import sim
from softwarerenderer_tpu_torch.models.convert import tree_to_torch
from softwarerenderer_tpu_torch.utils import mathlib as ml
bench = scene_to_torch(scenes.bench_scene(), "cpu")
cp = tree_to_torch(sim.default_character_params(), "cpu")
st = sim.initial_character_state(scenes.CONFIG4_START, device="cpu")
u = tree_to_torch(scenes.camera_uniforms(default_frame_uniforms(32, 18)),
                  "cpu")
st, c, d = scenes.coupled_step(st, bench, u, RenderParams(32, 18), cp)
assert c.shape == (18, 32, 4) and st["position"].shape == (1, 3)
world = sim.build_collision_world(bench)
crowd = scenes.crowd_setup(world, 2)
bots = scenes.crowd_step(crowd["state"], crowd, world, cp,
                         sim.default_brain_params())
assert bots["char"]["position"].shape == (2, 3)
import os, tempfile
from softwarerenderer_tpu_torch.apps.dust2 import Dust2Game
os.chdir(tempfile.mkdtemp())       # close() writes hud_layout.json here
game = Dust2Game(width=32, height=24, render_scale=1.0, headless=True,
                 offline=True, seed=1, bots=1, device="cpu")
for _ in range(3):
    game.step(1 / 60)
game.close()
assert game.window.last_frame.shape == (24, 32, 3)
"""

_CHECK = """
import sys
bad = [m for m in sys.modules
       if m in ("jax", "jaxlib", "bench", "scripts", "softwarerenderer_tpu")
       or m.startswith(("jax.", "jaxlib.", "scripts.",
                        "softwarerenderer_tpu."))]
assert not bad, bad
print("ok")
"""


@pytest.mark.parametrize("what", sorted(_IMPORTS))
def test_port_never_imports_jax(what):
    """Import every module of the port (or chip_smoke.py, or each demo of
    softwarerenderer_tpu_torch.examples by name with the rest of the JAX
    API's counterparts, touching each) in a fresh interpreter and find
    neither JAX, nor bench or scripts, nor any module of the JAX package
    (``softwarerenderer_tpu_torch`` itself only shares its prefix).  After
    importing every module, also render a raster
    frame through the tile route, the deferred route (K5's twin), the
    forward route and a debug view, and a ray-traced CPU frame of the
    port's own bench scene, golden config 3's lit frame, the three
    shadowed frames, the four filtering and post-FX feature frames with
    the whole post chain and a sky, a bilinear frame, a PBR frame with
    its environment terms, a ray-traced frame with the sky, and an
    animated, normal-mapped LOD frame and its shadowed frame, bench.py
    config 4's coupled step (character and render), a step of the
    crowd on the bench scene (routing and combat) and three offline,
    headless steps of the Dust2 game with a bot, and check again.  The
    render runs only the package's code, which the package case has all
    imported: after the other cases' imports it could find nothing
    more."""
    code = _IMPORTS[what] + (_RENDER if what == "package" else "") + _CHECK
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


def _animated_scene(p, s, t, m):
    """scenes.animated_instances (cut down) as the instances of `s`: a
    normal-mapped floor, two skinned tentacles, a flip-book, a morphing
    mesh with a weight track, a 16-slot emitter and two LOD meshes, the
    same arrays in either package's dataclasses."""
    import dataclasses
    from softwarerenderer_tpu_torch import scenes
    port = scenes.animated_instances(**ANIMATED_SMALL)
    if s.__name__.startswith("softwarerenderer_tpu_torch"):
        return port

    def as_s(inst):
        # The same arrays (textures by identity, as the packer keys them).
        kw = {f.name: getattr(inst, f.name)
              for f in dataclasses.fields(inst)}
        kw["material"] = s.Material(**dataclasses.asdict(inst.material))
        if inst.skin is not None:
            kw["skin"] = s.Skin(**dataclasses.asdict(inst.skin))
        return s.MeshInstance(**kw)
    return [as_s(inst) for inst in port]


@pytest.mark.parametrize("build", [_package_scene, _raytrace_scene,
                                   _kbuffer_scene, _animated_scene],
                         ids=["package", "raytrace", "kbuffer", "animated"])
def test_build_scene_buffers_match_jax(build):
    """The port's models.scene, models.primitives, texture.checkerboard and
    numpy mathlib give the packed scene the JAX package's give, key for
    key, dtype for dtype and value for value; with skins (their sampled
    bounds), normal maps (tangents), particle slots, flip-books, morph
    targets and LOD levels too."""
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


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_golden_config_matches_bench(n):
    """scenes.golden_config(n) packs to bench.config_workload(n)'s scene,
    golden_uniforms(n) gives its uniforms function's values and
    golden_shaders(n) the port's shaders of the same names."""
    import bench
    from scripts.make_goldens import GOLDEN_SIZES
    from softwarerenderer_tpu.engine.renderer import default_frame_uniforms
    from softwarerenderer_tpu.models import scene as scene_mod
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.models.scene import build_scene_buffers
    assert scenes.GOLDEN_SIZES[n] == GOLDEN_SIZES[n]
    insts, w, h, ufn, ekw = bench.config_workload(n)
    want_scene = scene_mod.build_scene_buffers(insts)
    _assert_same_scene(build_scene_buffers(scenes.golden_config(n)),
                       want_scene)
    if n in scenes.BENCH_SIZES:
        assert scenes.BENCH_SIZES[n] == (w, h)
    base = default_frame_uniforms(64, 48)
    want = dict(base)
    if ufn is not None:
        ufn(want, want_scene)
    _assert_same_scene(scenes.golden_uniforms(n, base), want)
    got_shaders = scenes.golden_shaders(n)
    assert sorted(got_shaders) == sorted(ekw)
    for k, fn in ekw.items():
        assert got_shaders[k].__name__ == fn.__name__
        assert got_shaders[k].__module__ == \
            fn.__module__.replace("softwarerenderer_tpu.",
                                  "softwarerenderer_tpu_torch.")


def _shadow_golden_source(name, p, s, t, m):
    """scripts/make_goldens.py:render_feature(name)'s instances, for the
    three shadowed features."""
    checker = np.asarray(t.checkerboard(32, 4)["data"])
    insts = [s.MeshInstance(p.plane(20.0), m.translation([0, -1, 0]),
                            texture=checker)]
    if name == "shadows":
        insts.append(s.MeshInstance(p.cube(1.0), m.translation([0, 0.2, -4]),
                                    texture=checker))
    elif name == "point_shadows":
        insts += [s.MeshInstance(p.cube(0.8), m.translation([0, 0.6, -4]),
                                 texture=checker),
                  s.MeshInstance(p.uv_sphere(0.5, rings=16, sectors=24),
                                 m.translation([1.8, 0.0, -5]),
                                 texture=checker)]
    else:
        insts.append(s.MeshInstance(p.cube(0.8), m.translation([0, 0.2, -4]),
                                    texture=checker))
    return insts


# make_goldens.render_feature's uniforms over default_frame_uniforms(320,
# 240), beside the camera rotation every shadowed feature shares.
_SHADOW_GOLDEN_UNIFORMS = {
    "shadows": {"camera_position": np.float32([2.5, 2.0, 0.5])},
    "point_shadows": {
        "camera_position": np.float32([2.5, 2.0, -0.5]),
        "point_light_position": np.float32([0.0, 3.0, -4.0]),
        "point_light_color": np.ones(4, np.float32),
        "point_light_range": np.float32(40.0)},
    "spot_shadows": {
        "camera_position": np.float32([2.5, 2.0, -0.5]),
        "spot_position": np.float32([1.5, 3.0, -2.0]),
        "spot_direction": (np.float32([-0.35, -1.0, -0.55])
                           / np.linalg.norm(np.float32([-0.35, -1.0,
                                                        -0.55]))),
        "spot_inner": np.float32(0.35), "spot_outer": np.float32(0.6),
        "spot_color": np.ones(4, np.float32),
        "spot_range": np.float32(40.0)},
}


@pytest.mark.parametrize("name", sorted(_SHADOW_GOLDEN_UNIFORMS))
def test_shadow_golden_frames_match_their_sources(name):
    """scenes.shadow_golden_frame(name): the scene, size, uniforms, frame
    function and map size of make_goldens.render_feature(name)."""
    from softwarerenderer_tpu.engine.renderer import default_frame_uniforms
    from softwarerenderer_tpu.models import scene as scene_mod
    from softwarerenderer_tpu_torch import scenes
    got, params, u, frame_fn, _ = scenes.shadow_golden_frame(name)
    _assert_same_scene(got, scene_mod.build_scene_buffers(
        _shadow_golden_source(name, *_host_modules(False))))
    assert (params.width, params.height) == (320, 240)
    assert params == RenderParams(width=320, height=240)
    want = dict(default_frame_uniforms(320, 240),
                camera_rotation=ml.quat_from_yaw_pitch_roll(
                    np.float32(0.55), np.float32(-0.35), np.float32(0)),
                **_SHADOW_GOLDEN_UNIFORMS[name])
    _assert_same_scene(u, want)
    suffix = {"shadows": "shadows", "point_shadows": "point_shadows",
              "spot_shadows": "spot_shadow"}[name]
    assert frame_fn.func.__name__ == f"render_frame_with_{suffix}"
    assert frame_fn.keywords == {"shadow_size": 256}


def _feature_golden_source(name, p, s, t, m):
    """scripts/make_goldens.py:render_feature(name)'s instances, params
    and uniforms over default_frame_uniforms(320, 240), for feature_mips,
    _trilinear, _ssaa, _ssao and _skinning (its rig from
    examples/skeletal_animation.py on the JAX side)."""
    checker = np.asarray(t.checkerboard(32, 4)["data"])
    u = {}
    if name in ("mips", "trilinear"):
        insts = []
        for zi in range(24):
            strip = p.plane(16.0)
            strip["uv"] = strip["uv"] * np.float32(16.0)
            insts.append(s.MeshInstance(
                strip, m.translation([0, -1, -8.0 - 16.0 * zi]),
                texture=np.asarray(t.checkerboard(64, 32)["data"])))
        params = dict(use_mipmaps=True if name == "mips" else "trilinear")
        u["camera_position"] = np.float32([0, 0.5, 0])
        u["far_clip"] = np.float32(2000.0)
    elif name == "ssaa":
        insts = [s.MeshInstance(p.plane(20.0), m.translation([0, -1, 0]),
                                texture=checker),
                 s.MeshInstance(
                     p.cube(1.0),
                     (m.matrix_from_yaw_pitch_roll(np.float32(0.6), 0.3, 0.0)
                      @ m.translation([0, 0.2, -3.0])).astype(np.float32),
                     texture=checker)]
        params = dict(ssaa=4)
        u["camera_position"] = np.float32([0, 0.6, 1.5])
    elif name == "skinning":
        if s.__name__.startswith("softwarerenderer_tpu_torch"):
            from softwarerenderer_tpu_torch.scenes import (tentacle_mesh,
                                                           tentacle_skin)
        else:
            sys.path.insert(0, os.path.join(REPO, "examples"))
            from skeletal_animation import tentacle_mesh, tentacle_skin
        mesh = tentacle_mesh()
        insts = [s.MeshInstance(mesh, m.translation([0, -1.2, 0]),
                                texture=checker,
                                skin=tentacle_skin(mesh["position"])),
                 s.MeshInstance(p.plane(12.0), m.translation([0, -1.2, 0]),
                                texture=checker)]
        params = {}
        u["camera_position"] = np.float32([0, 0.6, 4.5])
        u["anim_time"] = np.float32(0.6)
    else:
        gray = np.asarray(t.checkerboard(
            32, 4, (0.85, 0.85, 0.85, 1.0), (0.7, 0.7, 0.7, 1.0))["data"])
        insts = [s.MeshInstance(p.plane(20.0), m.translation([0, -1, 0]),
                                texture=gray),
                 s.MeshInstance(p.cube(1.4), m.translation([-0.9, -0.3, -4.0]),
                                texture=gray),
                 s.MeshInstance(p.cube(0.9), m.translation([1.1, -0.55, -3.2]),
                                texture=gray)]
        params = dict(ssao=True)
        u["camera_position"] = np.float32([0, 0.8, 0.0])
        u["camera_rotation"] = np.asarray(
            m.quat_from_axis_angle([1.0, 0, 0], -0.25), np.float32)
    return insts, params, u


@pytest.mark.parametrize("name", ["mips", "trilinear", "ssaa", "ssao",
                                  "skinning"])
def test_feature_golden_frames_match_their_sources(name):
    """scenes.feature_golden_frame(name): the scene, params, uniforms and
    shader of make_goldens.render_feature(name)."""
    from softwarerenderer_tpu.engine.renderer import default_frame_uniforms
    from softwarerenderer_tpu.models import scene as scene_mod
    from softwarerenderer_tpu_torch import scenes
    got, params, u, shaders = scenes.feature_golden_frame(name)
    insts, want_params, want_u = _feature_golden_source(
        name, *_host_modules(False))
    _assert_same_scene(got, scene_mod.build_scene_buffers(insts))
    assert params == RenderParams(width=320, height=240, **want_params)
    _assert_same_scene(u, dict(default_frame_uniforms(320, 240), **want_u))
    want_shader = {"trilinear": "scene_fragment_shader_trilinear"}.get(name)
    assert [f.__name__ for f in shaders.values()] == \
        ([want_shader] if want_shader else [])


def test_irradiance_panorama_matches_jax():
    """The port's copy of sky.irradiance_panorama (host numpy) gives the
    JAX package's map, value for value, on a uniform, a half and a seeded
    f32 panorama, a seeded u8 one and another output size."""
    from softwarerenderer_tpu.ops import sky as jax_sky
    from softwarerenderer_tpu_torch.ops import sky
    rng = np.random.default_rng(3)
    half = np.zeros((32, 64, 4), np.float32)
    half[:16] = [1, 0, 0, 1]
    for pano, out_h in ((np.full((16, 32, 4), 0.5, np.float32), 16),
                        (half, 16),
                        (rng.uniform(0, 1, (40, 90, 4)).astype(np.float32), 8),
                        (rng.integers(0, 256, (20, 30, 4)).astype(np.uint8),
                         16)):
        got = sky.irradiance_panorama(pano, out_h)
        want = jax_sky.irradiance_panorama(pano, out_h)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_quat_from_axis_angle_matches_jax():
    from softwarerenderer_tpu_torch.utils import mathlib as port_ml
    for axis, angle in (([1.0, 0, 0], -0.25), ([0.3, 0.5, -0.2], 2.0)):
        np.testing.assert_array_equal(port_ml.quat_from_axis_angle(axis,
                                                                   angle),
                                      ml.quat_from_axis_angle(axis, angle))


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


# Fields refused until the image-quality features were ported; their
# frames are held against JAX in tests/test_torch_post_fx.py and
# tests/test_torch_texture_filtering.py.
PORTED_PARAMS = ("ssaa", "ssao", "bloom", "tonemap", "fxaa", "use_mipmaps")
# Fields refused until the capacity caps and shade_rate were ported
# (tests/test_torch_caps.py holds them against JAX at length).
CAP_PARAMS = ("active_cap", "geom_cap", "pair_cap", "global_cap",
              "shade_rate", "active_cap_stats")
# PERF.md section 2's D5 share: pixels where XLA's contracted edge
# functions flip an edge pixel.
D5_SHARE = 5e-3


@pytest.mark.parametrize("field,value", [
    ("ssaa", 2), ("ssao", True), ("bloom", True), ("tonemap", "aces"),
    ("fxaa", True), ("active_cap", 1000),
    ("geom_cap", 1000), ("pair_cap", 1000), ("global_cap", 512),
    ("use_mipmaps", True), ("shade_rate", 2), ("active_cap_stats", True),
])
def test_unsupported_params_raise(field, value):
    """The name and cases are kept from when these fields raised
    NotImplementedError.  Each renders now, through Engine.  The
    image-quality fields (PORTED_PARAMS) change the package scene's frame
    (bloom with its threshold lowered to 0.3, which the scene's lit
    colors pass).  The caps (CAP_PARAMS), which all hold on this scene,
    leave the frame as it is uncapped on every pixel; active_cap_stats
    adds JAX's counters; shade_rate=2 keeps the full-rate frame's anchor
    rows; and each frame is JAX's for the same params (its Pallas route
    in interpret mode, the route that honours global_cap and shade_rate)
    within the D5 share."""
    from softwarerenderer_tpu_torch.engine import default_frame_uniforms
    params = RenderParams(64, 48).replace(**{field: value})
    u = dict(default_frame_uniforms(64, 48), bloom_threshold=np.float32(0.3))
    out = Engine(small_scene(), params, device="cpu").render(u)
    base, base_d = Engine(small_scene(), RenderParams(64, 48),
                          device="cpu").render(u)
    c, d = out[:2]
    assert c.shape == base.shape and d.shape == (48, 64)
    assert torch.isfinite(c).all()
    if field not in CAP_PARAMS:
        assert float((c - base).abs().max()) > 0.05
        return
    import jax
    from softwarerenderer_tpu import RenderParams as JaxRenderParams
    from softwarerenderer_tpu.engine import renderer as jr
    jout = jax.jit(functools.partial(jr.render_frame, params=JaxRenderParams(
        64, 48, pallas_interpret=True).replace(**{field: value})))(
            small_scene(), u)
    if field == "shade_rate":
        assert torch.equal(c[::2], base[::2])
        assert torch.equal(d[::2], base_d[::2])
    else:
        assert torch.equal(c, base) and torch.equal(d, base_d)
    assert len(out) == len(jout) == (3 if field == "active_cap_stats" else 2)
    if len(out) == 3:
        assert {k: int(v) for k, v in out[2].items()} == \
            {k: int(v) for k, v in jout[2].items()}
    jc, jd = np.asarray(jout[0]), np.asarray(jout[1])
    assert (np.abs(d.numpy() - jd) > 1e-5).mean() <= D5_SHARE
    assert (np.abs(c.numpy() - jc).max(-1) > 1e-5).mean() <= D5_SHARE


@pytest.mark.parametrize("field,value", [
    ("debug_mode", DebugMode.WIREFRAME), ("deferred", False),
    ("binned", False), ("depth_test", DepthTest.GREATER),
    ("debug_mode", DebugMode.OVERDRAW)])
def test_once_refused_params_render_and_match_jax(field, value):
    """Fields the port refused until the deferred route existed now render
    through Engine and match JAX's render_frame on the package scene (the
    camera inside the soup, so near-clipped triangles): at most PERF.md
    section 2's D5 share, 0.5 %, of the pixels differ by > 1e-5, where
    XLA's contracted edge functions flip an edge pixel.  GREATER starts
    from a MaxValue depth buffer, without which it draws nothing."""
    import functools
    import jax
    from softwarerenderer_tpu.engine import renderer as jr
    params = RenderParams(64, 48).replace(**{field: value})
    u = jr.default_frame_uniforms(64, 48)
    fb = None
    if value == DepthTest.GREATER:
        fb = (np.broadcast_to(u["clear_color"], (48, 64, 4)).copy(),
              np.full((48, 64), np.finfo(np.float32).max, np.float32))
    scene = small_scene()
    jc, jd = map(np.asarray, jax.jit(functools.partial(
        jr.render_frame, params=params))(scene, u, fb=fb))
    c, d = (t.numpy() for t in Engine(scene, params, device="cpu").render(
        u, fb=fb))
    assert np.isfinite(c).all()
    assert (np.abs(c - jc).max(-1) > 1e-5).mean() <= 5e-3
    assert (np.abs(d - jd) > 1e-5).mean() <= 5e-3
    assert (np.abs(c - u["clear_color"]).max(-1) > 1e-3).mean() > 0.02


def test_kbuffer_with_another_depth_test_still_raises():
    """The name is kept from when a K-buffer under a depth test other than
    LESS_EQUAL was refused.  It no longer raises: Engine takes it and
    render_frame sends it to the K-slot route (ops.kbuffer), whose frame
    it returns (held against JAX in tests/test_torch_kbuffer_modes.py)."""
    from softwarerenderer_tpu_torch.engine import (frame_setup,
                                                   scene_fragment_shader)
    from softwarerenderer_tpu_torch.ops import kbuffer
    params = RenderParams(64, 48, kbuffer=4, depth_test=DepthTest.LESS,
                          cull_mode=0)
    eng = Engine(small_scene(), params, device="cpu")
    u = dict(eng.uniforms)
    c, d = eng.render(u)
    f = frame_setup(eng.scene, u, params)
    kc, kd = kbuffer.render_binned_kbuffer(
        f["tris"], scene_fragment_shader, f["uniforms"], params,
        f["fb_color"], f["fb_depth"], per_tri_extra=f["per_tri"])
    assert torch.equal(c, kc) and torch.equal(d, kd)
    assert (d != d[0, 0]).float().mean() > 0.02


@pytest.mark.parametrize("kbuffer", [0, 1])
def test_kbuffer_stats_without_kbuffer_raises(kbuffer):
    """As in JAX's render_frame: the stats dict is the K-buffer's."""
    params = RenderParams(64, 48, kbuffer=kbuffer, kbuffer_stats=True)
    with pytest.raises(ValueError, match="kbuffer_stats needs kbuffer > 1"):
        Engine(small_scene(), params, device="cpu")


# The cut-down animated scene of scenes.animated_instances: every scene key
# the port once refused.  Its frames against JAX's jitted frame at 96x72
# with the normal-mapped shaders: pixels off by > 1e-5 in color (measured
# 0.29-0.32 % over the six frames) and in depth (0.19-0.27 %), edge pixels
# that XLA's contracted edge functions and skinning sums flip (PERF.md D5).
ANIMATED_SMALL = dict(tentacles=2, flipbooks=1, morphs=1, particles=16,
                      lods=2)
ANIMATED_SIZE = (96, 72)
ANIMATED_COLOR_OFF_MAX = 7e-3
ANIMATED_DEPTH_OFF_MAX = 6e-3


@functools.lru_cache(maxsize=None)
def _animated():
    """(scene, normal-mapped shaders, jitted JAX frame function)."""
    import jax
    from softwarerenderer_tpu import RenderParams as JaxRenderParams
    from softwarerenderer_tpu.engine import renderer as jr
    from softwarerenderer_tpu.ops import normalmap as jnm
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.ops import normalmap
    w, h = ANIMATED_SIZE
    fn = jax.jit(functools.partial(
        jr.render_frame, params=JaxRenderParams(width=w, height=h),
        vertex_shader=jnm.normal_mapped_vertex_shader,
        fragment_shader=jnm.normal_mapped_fragment_shader))
    shaders = dict(vertex_shader=normalmap.normal_mapped_vertex_shader,
                   fragment_shader=normalmap.normal_mapped_fragment_shader)
    return scenes.animated_scene(**ANIMATED_SMALL), shaders, fn


def _animated_uniforms(i, **extra):
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.engine import default_frame_uniforms
    return dict(scenes.animated_uniforms(
        default_frame_uniforms(*ANIMATED_SIZE), i,
        tentacles=ANIMATED_SMALL["tentacles"],
        particles=ANIMATED_SMALL["particles"]), **extra)


# Each key's frame, and the uniforms that change what that key draws.
_KEY_FRAMES = {
    "tangent": (0, {}),
    "anim_positions": (7, {"anim_frame": np.int32(2)}),
    "morph_vert_index": (13, {"morph_weights": np.float32([[1.5, -1.0]])}),
    "skin_joints": (24, {"anim_time": np.float32([0.9, 0.4])}),
    "particle_vert_index": (35, {"particle_size": np.zeros(16, np.float32)}),
    "tri_lod_level": (48, {}),
}


@pytest.mark.parametrize("key", list(_KEY_FRAMES))
def test_unsupported_scene_keys_raise(key):
    """The name and cases are kept from when these scene keys were
    refused.  Each renders now: the cut-down animated scene (which holds
    every key) through Engine with the normal-mapped shaders, at the
    key's frame of animated_uniforms, within the stated share of JAX's
    jitted frame; and the key's uniforms (the LOD mask's frame height)
    change what it draws."""
    from softwarerenderer_tpu_torch.engine import renderer
    from softwarerenderer_tpu_torch.ops import lod
    sc, shaders, jax_fn = _animated()
    assert key in sc
    i, other = _KEY_FRAMES[key]
    u = _animated_uniforms(i)
    eng = Engine(sc, RenderParams(*ANIMATED_SIZE), device="cpu", **shaders)
    c, d = (x.numpy() for x in eng.render(u))
    jc, jd = map(np.asarray, jax_fn(sc, u))
    assert np.isfinite(c).all() and (d > -3e38).mean() > 0.3
    assert (np.abs(c - jc).max(-1) > 1e-5).mean() <= ANIMATED_COLOR_OFF_MAX
    assert (np.abs(d - jd) > 1e-5).mean() <= ANIMATED_DEPTH_OFF_MAX
    if key == "tangent":
        c2, _ = Engine(sc, RenderParams(*ANIMATED_SIZE),
                       device="cpu").render(u)
    elif key == "tri_lod_level":
        du = renderer.device_uniforms(u, *ANIMATED_SIZE, "cpu")
        assert not torch.equal(lod.lod_tri_mask(eng.scene, du, 72),
                               lod.lod_tri_mask(eng.scene, du, 1080))
        return
    else:
        c2, _ = eng.render(dict(u, **other))
    assert np.abs(c2.numpy() - c).max() > 0.05


@pytest.fixture
def one_thread():
    """One intra-op thread for a test of many small ops (the shadowed
    frames' light passes): with the suite's workers sharing the cores,
    torch's default pool makes them several times slower
    (tests/test_torch_dust2.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("field,value", [
    ("active_cap", 1000), ("active_cap_stats", True), ("geom_cap", 1000),
    ("pair_cap", 1000), ("global_cap", 512), ("shade_rate", 2)])
def test_remaining_params_raise_by_name(field, value, one_thread):
    """The name and cases are kept from when the capacity caps and
    shade_rate were the port's last refusals.  Each renders now, through
    Engine, render_frame and each shadowed frame, on a scene that holds
    every once-refused scene key.  A cap that holds (its counter 0)
    leaves each frame as it is without the cap, on every pixel;
    geom_cap=1000, below the frame's masked-in triangles, drops the last
    ones and changes the frame; active_cap_stats adds a third value and
    leaves the frame; shade_rate=2 keeps each frame's anchor rows.
    pair_cap caps the light passes' pair tables too, as JAX's does: 1000
    pairs hold for the main pass and not for the 512 and 256 maps, so a
    shadowed frame equals the uncapped one when its light passes fold
    uncapped, and the directional map under the cap is JAX's.
    render_frame's frame with the normal-mapped shaders is JAX's for the
    same params under the animated frame's limits, with JAX's counters
    (JAX's CPU route ignores global_cap, which holds here; shade_rate is
    held against JAX's Pallas route on smaller scenes, in
    test_unsupported_params_raise and tests/test_torch_caps.py)."""
    import jax
    from softwarerenderer_tpu import RenderParams as JaxRenderParams
    from softwarerenderer_tpu.engine import renderer as jr
    from softwarerenderer_tpu.ops import normalmap as jnm
    from softwarerenderer_tpu.ops import shadows as js
    from softwarerenderer_tpu_torch.engine import renderer
    from softwarerenderer_tpu_torch.ops import shadows
    sc, shaders, _ = _animated()
    base_p = RenderParams(*ANIMATED_SIZE)
    params = base_p.replace(**{field: value})
    st = scene_to_torch(sc, "cpu")
    u = _animated_uniforms(
        0, point_light_position=np.float32([0.0, 3.0, -4.0]),
        point_light_color=np.ones(4, np.float32),
        spot_position=np.float32([1.5, 3.0, -2.0]),
        spot_direction=np.float32([0.0, -1.0, 0.0]),
        spot_inner=np.float32(0.35), spot_outer=np.float32(0.6),
        spot_color=np.ones(4, np.float32))

    def light_fold_uncapped(tris, sp):
        return shadows.light_pass_visibility(sp, tris["screen"].device)(
            tris, sp.replace(pair_cap=0))
    shadow_kw = {"visibility_fn": light_fold_uncapped} \
        if field == "pair_cap" else {}
    calls = [lambda p, **kw: Engine(sc, p, device="cpu").render(u),
             lambda p, **kw: render_frame(st, u, p),
             lambda p, **kw: renderer.render_frame_with_shadows(st, u, p,
                                                                **kw),
             lambda p, **kw: renderer.render_frame_with_point_shadows(
                 st, u, p, **kw),
             lambda p, **kw: renderer.render_frame_with_spot_shadow(
                 st, u, p, **kw)]
    stats = render_frame(st, u, params.replace(active_cap_stats=True))[2]
    dropped = sum(int(v) for k, v in stats.items() if k.endswith("overflow"))
    assert (dropped > 0) == (field == "geom_cap")
    for call in calls:
        out, (bc, bd) = call(params, **shadow_kw), call(base_p)
        assert len(out) == (3 if field == "active_cap_stats" else 2)
        if field == "shade_rate":
            assert torch.equal(out[0][::2], bc[::2])
        elif dropped:
            assert not torch.equal(out[0], bc)
        else:
            assert torch.equal(out[0], bc) and torch.equal(out[1], bd)
    if field == "pair_cap":
        center, radius = shadows.scene_bounds(st)
        view, proj, _ = shadows.directional_light_camera(
            u["light_direction"], center, radius)
        got = shadows.render_shadow_depth(st, u, view, proj, 512, params)
        full = shadows.render_shadow_depth(st, u, view, proj, 512, base_p)
        assert not torch.equal(got, full)
        want = np.asarray(jax.jit(functools.partial(
            js.render_shadow_depth, shadow_size=512,
            params=JaxRenderParams(*ANIMATED_SIZE, pair_cap=value)))(
                sc, u, view.numpy(), proj.numpy()))
        assert (np.abs(got.numpy() - want) > 1e-5).mean() \
            <= ANIMATED_DEPTH_OFF_MAX
    if field == "shade_rate":
        return
    jp = JaxRenderParams(*ANIMATED_SIZE, active_cap_stats=True).replace(
        **{field: value})
    jc, jd, jstats = jax.jit(functools.partial(
        jr.render_frame, params=jp,
        vertex_shader=jnm.normal_mapped_vertex_shader,
        fragment_shader=jnm.normal_mapped_fragment_shader))(sc, u)
    sp = params.replace(active_cap_stats=True)
    c, d, got = render_frame(st, u, sp, **shaders)
    got = {k: int(v) for k, v in got.items()}
    want = {k: int(v) for k, v in jstats.items()}
    assert got.keys() == want.keys()
    assert all(got[k] == want[k] for k in got if k != "live_pairs")
    # live_pairs: JAX's count of the port's set-up triangles exactly; of
    # JAX's own, less the pairs of the mesh's degenerate slots (two equal
    # vertices), whose area is 0 here and 1e-7 under XLA's contracted
    # edge function, which makes them valid there (PARITY.md D5).
    from softwarerenderer_tpu.ops import binning as jbin
    tris = renderer.frame_setup(st, u, sp, **shaders)["tris"]
    assert got["live_pairs"] == int(jbin.live_pair_count(
        {k: tris[k].numpy() for k in ("bbox", "valid")}, jp))
    assert 0 <= want["live_pairs"] - got["live_pairs"] \
        <= 0.02 * want["live_pairs"]
    c, d = c.numpy(), d.numpy()
    assert (np.abs(c - np.asarray(jc)).max(-1) > 1e-5).mean() \
        <= ANIMATED_COLOR_OFF_MAX
    assert (np.abs(d - np.asarray(jd)) > 1e-5).mean() \
        <= ANIMATED_DEPTH_OFF_MAX
    renderer.check_supported(RenderParams(*ANIMATED_SIZE), u)


def test_sky_panorama_uniform_raises():
    """The name is kept from when a sky panorama was refused.  It renders
    now: every pixel the frame leaves at clear depth shows the panorama (a
    uniform green here) instead of the clear color; covered pixels and
    depth are as without it."""
    from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR
    eng = Engine(small_scene(), RenderParams(64, 48), device="cpu")
    pano = np.zeros((4, 8, 4), np.float32)
    pano[..., 1] = pano[..., 3] = 1.0
    c0, d0 = render_frame(eng.scene, eng.uniforms, eng.params)
    c, d = render_frame(eng.scene, dict(eng.uniforms, sky_panorama=pano),
                        eng.params)
    clear = d0 == DEPTH_CLEAR
    assert 0.05 < clear.float().mean() < 0.95
    assert torch.equal(d, d0) and torch.equal(c[~clear], c0[~clear])
    np.testing.assert_allclose(c[clear].numpy(),
                               np.broadcast_to(pano[0, 0], (int(clear.sum()),
                                                            4)), atol=1e-6)


# JAX's frame of the unpacked-channel shader, shared by the cases of
# test_unpacked_tri_extras_channel_raises.
_UNPACKED_JAX = {}


@pytest.mark.parametrize("through", ["Engine", "render_frame"])
def test_unpacked_tri_extras_channel_raises(through):
    """The name is kept from when the port refused the shader.  A fragment
    shader whose tri_extras names a per-triangle channel that frame_setup
    does not pack (mat_metallic on a scene without materials) renders as in
    JAX, which drops the name (softwarerenderer_tpu/engine/renderer.py:
    611-613): on the tile route and the deferred route, equal to JAX's
    frame within PERF.md section 2's D5 share (JAX's CPU backend resolves
    both routes through one binned program).  A shader that reads the
    channel fails with a KeyError in both packages alike (JAX's while
    tracing the frame)."""
    import jax
    from softwarerenderer_tpu import RenderParams as JaxRenderParams
    from softwarerenderer_tpu.engine import renderer as jr
    from softwarerenderer_tpu_torch.engine import renderer

    def names_metallic(frag, uniforms):
        return renderer.scene_fragment_shader(frag, uniforms)

    def j_names_metallic(frag, uniforms, xp):
        return jr.scene_fragment_shader(frag, uniforms, xp)

    def reads_metallic(frag, uniforms, xp=None):
        return frag["color"] * frag["tri"]["mat_metallic"][..., None]

    for fn, base in ((names_metallic, renderer.scene_fragment_shader),
                     (j_names_metallic, jr.scene_fragment_shader)):
        fn.varyings = base.varyings
        fn.tri_extras = tuple(base.tri_extras) + ("mat_metallic",)
    reads_metallic.varyings = ("color",)
    reads_metallic.tri_extras = ("tex_oy", "mat_metallic")
    scene = small_scene()
    for use_pallas in (True, False):
        params = RenderParams(64, 48, use_pallas=use_pallas)
        if through == "Engine":
            eng = Engine(scene, params, fragment_shader=names_metallic,
                         device="cpu")
            c, d = eng.render()
        else:
            eng = Engine(scene, params, device="cpu")
            c, d = render_frame(eng.scene, eng.uniforms, params,
                                fragment_shader=names_metallic)
        if not _UNPACKED_JAX:
            _UNPACKED_JAX["frame"] = tuple(np.asarray(x) for x in jax.jit(
                functools.partial(jr.render_frame,
                                  params=JaxRenderParams(64, 48),
                                  fragment_shader=j_names_metallic))(
                scene, eng.uniforms))
        jc, jd = _UNPACKED_JAX["frame"]
        assert torch.isfinite(c).all() and (d > -3e38).any()
        assert (np.abs(c.numpy() - jc).max(-1) > 1e-5).mean() <= D5_SHARE
        assert (np.abs(d.numpy() - jd) > 1e-5).mean() <= D5_SHARE
        with pytest.raises(KeyError, match="mat_metallic"):
            render_frame(eng.scene, eng.uniforms, params,
                         fragment_shader=reads_metallic)
    with pytest.raises(KeyError, match="mat_metallic"):
        jax.eval_shape(functools.partial(
            jr.render_frame, params=JaxRenderParams(64, 48),
            fragment_shader=reads_metallic), scene, eng.uniforms)


@pytest.mark.parametrize("mode", list(BlendMode))
def test_blend_modes_render(mode):
    """Blend mode is a supported field: every mode renders a finite frame
    (opaque winners over the clear color)."""
    eng = Engine(small_scene(), RenderParams(64, 48, blend_mode=mode),
                 device="cpu")
    color, depth = eng.render()
    assert torch.isfinite(color).all() and (depth > -3e38).any()
