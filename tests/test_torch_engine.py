"""Whole frame: the port's Engine on the CPU against the JAX render_frame on
its XLA fused path, same packed scene, same uniforms."""

import functools

import jax
import numpy as np
import pytest

from softwarerenderer_tpu import RenderParams
from softwarerenderer_tpu.engine import renderer as jr
from softwarerenderer_tpu.models import primitives
from softwarerenderer_tpu.models import scene as scene_mod
from softwarerenderer_tpu.ops import texture as tex_np
from softwarerenderer_tpu.utils import mathlib as ml
from softwarerenderer_tpu_torch.engine import Engine


def cubes_scene():
    """The plane and 11 cubes of tests/test_pallas_raster.py."""
    checker = np.asarray(tex_np.checkerboard(16, 4)["data"])
    insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                    ml.translation([0, -1, 0]),
                                    texture=checker),
             scene_mod.MeshInstance(primitives.cube(0.8),
                                    ml.translation([0, 0, -3]),
                                    texture=checker)]
    rng = np.random.default_rng(0)
    for _ in range(10):
        pos = rng.uniform(-4, 4, 3).astype(np.float32)
        pos[1] = rng.uniform(-0.5, 1.5)
        insts.append(scene_mod.MeshInstance(primitives.cube(0.5),
                                            ml.translation(pos),
                                            texture=checker))
    return scene_mod.build_scene_buffers(insts)


def soup_scene():
    checker = np.asarray(tex_np.checkerboard(
        64, 8, (0.8, 0.75, 0.6, 1.0), (0.55, 0.5, 0.4, 1.0))["data"])
    soup = primitives.random_triangle_soup(2000, seed=0)
    return scene_mod.build_scene_buffers(
        [scene_mod.MeshInstance(soup, texture=checker)])


SIMPLE = RenderParams(width=136, height=92, tile_h=16, span_cap=6)

# (scene, params, camera position, allowed fraction of differing pixels in
# depth, in color).  The simple scene is expected to match everywhere.  The
# soup allows the PARITY.md D5 share of boundary pixels, where XLA's FMA
# contraction can flip an edge or a depth tie.  The JAX tests' own camera
# (0, 0.5, 3) puts pixel centres exactly on texel edges of the floor's
# checker (row 69 lies on v = 0.5: camera height over distance is 0.5, the
# tangent of that row's angle), so one ulp of contraction picks the other
# texel there: depth stays exact, and 0.54 % of the colors differ.
CASES = {
    "cubes_136x92": (cubes_scene, SIMPLE, np.float32([0.03, 0.52, 3.07]),
                     1e-3, 1e-3),
    "cubes_136x92_texel_aligned": (cubes_scene, SIMPLE,
                                   np.float32([0, 0.5, 3.0]), 1e-3, 1e-2),
    "soup_320x240": (soup_scene, RenderParams(width=320, height=240),
                     np.float32([0, 0, 0]), 5e-3, 5e-3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax_render_frame(case):
    make, params, cam, allowed_d, allowed_c = CASES[case]
    scene = make()
    u = jr.default_frame_uniforms(params.width, params.height)
    u["camera_position"] = cam
    jc, jd = map(np.asarray, jax.jit(functools.partial(
        jr.render_frame, params=params.replace(use_pallas=False)))(scene, u))

    eng = Engine(scene, params, device="cpu")
    c, d = (t.numpy() for t in eng.render(u))
    assert c.shape == jc.shape and d.shape == jd.shape
    assert np.isfinite(c).all() and np.isfinite(d).all()
    assert (np.abs(d - jd) > 1e-5).mean() <= allowed_d
    assert (np.abs(c - jc).max(-1) > 1e-5).mean() <= allowed_c
    # the frame is not empty: most pixels are covered
    assert (d > -3e38).mean() > 0.3
    rgb = eng.present(u)
    assert rgb.dtype == np.uint8 and rgb.shape == (params.height,
                                                    params.width, 3)


@pytest.mark.parametrize("name", ["default_fragment_shader",
                                  "flat_color_fragment_shader",
                                  "textured_fragment_shader"])
def test_engine_takes_the_shaders_as_arguments(name):
    """A fragment shader other than the scene's renders through the port's
    Engine (and so render_frame) and matches JAX's render_frame with the
    JAX shader of the same name; the texture the shaders sample is a
    uniform, moved to the device with the rest."""
    from softwarerenderer_tpu import shaders as jsh
    from softwarerenderer_tpu_torch import shaders as tsh
    make, params, cam, allowed_d, allowed_c = CASES["cubes_136x92"]
    scene = make()
    u = jr.default_frame_uniforms(params.width, params.height)
    u["camera_position"] = cam
    # a texture unlike the scene's atlas, so each shader's image differs
    # from the scene shader's
    u["texture"] = tex_np.checkerboard(8, 2, (1.0, 0.2, 0.2, 1.0),
                                       (0.2, 0.2, 1.0, 1.0))
    jc, jd = map(np.asarray, jax.jit(functools.partial(
        jr.render_frame, params=params.replace(use_pallas=False),
        vertex_shader=jsh.default_vertex_shader,
        fragment_shader=getattr(jsh, name)))(scene, u))
    eng = Engine(scene, params, vertex_shader=tsh.default_vertex_shader,
                 fragment_shader=getattr(tsh, name), device="cpu")
    c, d = (t.numpy() for t in eng.render(u))
    assert (np.abs(d - jd) > 1e-5).mean() <= allowed_d
    assert (np.abs(c - jc).max(-1) > 1e-5).mean() <= allowed_c
    # the shader did render: not the scene shader's image
    sc, _ = (t.numpy() for t in Engine(scene, params, device="cpu").render(u))
    assert (np.abs(c - sc).max(-1) > 1e-3).mean() > 0.1
