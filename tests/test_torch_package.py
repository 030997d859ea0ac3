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


def test_port_never_imports_jax():
    """Import every module of the port and chip_smoke.py, render a CPU
    frame, and find neither JAX nor a JAX module of the JAX package."""
    code = """
import importlib, pkgutil, sys
import softwarerenderer_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
import bench
from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import Engine
eng = Engine(bench.build_scene(), RenderParams(64, 48), device="cpu")
rgb = eng.present(bench.camera_uniforms(eng.uniforms, 0))
assert rgb.shape == (48, 64, 3), rgb.shape
# the shared host layer (bench.build_scene's checkerboard included) is
# numpy-only; every other ops/engine/parallel/sim module imports jax
host = {"softwarerenderer_tpu.ops", "softwarerenderer_tpu.ops.texture"}
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
       or (m.startswith(tuple("softwarerenderer_tpu." + p for p in
                              ("ops", "engine", "parallel", "sim")))
           and m not in host)]
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


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
