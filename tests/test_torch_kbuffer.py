"""The port's K-buffer frames (render_frame with kbuffer > 1, the depth peel
through tile_fold's two modes, and the single-pass K-deep route) against
JAX's render_frame on the scenes of tests/test_kbuffer.py, through the
CPU twins.  JAX's XLA K-slot fold is the reference here;
test_torch_kbuffer_interpret.py holds some of the scenes against JAX's
peel kernel in interpret mode."""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from softwarerenderer_tpu import BlendMode, CullMode, RenderParams
from softwarerenderer_tpu import shaders as jsh
from softwarerenderer_tpu.engine import renderer as jr
from softwarerenderer_tpu.models import scene as scene_mod
from softwarerenderer_tpu_torch import shaders as tsh
from softwarerenderer_tpu_torch.engine import renderer as tr
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import tile_raster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 96, 80
PARAMS = RenderParams(width=W, height=H, cull_mode=CullMode.NONE,
                      tile_h=16, tile_w=128, span_cap=4, kbuffer=4)
# The JAX tests look from (0, 0, 3), and from there each quad's diagonal
# runs exactly through pixel centres.  One ulp of screen position (XLA
# contracts the viewport transform into FMAs, the port does not) then
# decides whether both triangles of a quad cover such a pixel, and a
# translucent quad is blended twice where they do (measured: 21 of 7,680
# pixels of the two-layer scene).  Off that alignment both agree exactly.
CAM = np.float32([0.03, 0.02, 3.07])


def facing_quad(z, color, x0=-1.0, x1=1.0, y0=-1.0, y1=1.0):
    """tests/test_kbuffer.py's camera-facing quad at view depth z."""
    pos = np.asarray([[x0, y0, z], [x1, y0, z], [x1, y1, z], [x0, y1, z]],
                     np.float32)
    return {"position": pos,
            "uv": np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
            "normal": np.tile(np.float32([0, 0, 1]), (4, 1)),
            "color": np.tile(np.asarray(color, np.float32), (4, 1)),
            "indices": np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)}


def engine_quad(z, color, s=1.0):
    """tests/test_kbuffer.py's _engine_quad."""
    pos = np.asarray([[-s, -s, z], [s, -s, z], [-s, s, z], [s, s, z]],
                     np.float32)
    return {"position": pos, "uv": np.zeros((4, 2), np.float32),
            "normal": np.tile(np.float32([0, 0, 1]), (4, 1)),
            "color": np.tile(np.asarray(color, np.float32), (4, 1)),
            "indices": np.asarray([[0, 1, 2], [2, 1, 3]], np.int32)}


def build(quads):
    """The quads in submission order as one packed scene."""
    return scene_mod.build_scene_buffers(
        [scene_mod.MeshInstance(q, np.eye(4, dtype=np.float32))
         for q in quads])


def cutout_jax(frag, uniforms, xp=np):
    """tests/test_kbuffer.py's alpha-cutout: discards a centred UV disc of
    green-dominant surfaces."""
    du = frag["uv"][..., 0] - 0.5
    dv = frag["uv"][..., 1] - 0.5
    color = frag["color"]
    hole = ((du * du + dv * dv) < 0.09) & (color[..., 1] > 0.9)
    alpha = xp.where(hole, xp.float32(0.0), color[..., 3])
    return xp.concatenate([color[..., :3], alpha[..., None]], axis=-1)


def cutout_torch(frag, uniforms):
    du = frag["uv"][..., 0] - 0.5
    dv = frag["uv"][..., 1] - 0.5
    color = frag["color"]
    hole = ((du * du + dv * dv) < 0.09) & (color[..., 1] > 0.9)
    alpha = torch.where(hole, 0.0, color[..., 3])
    return torch.cat([color[..., :3], alpha[..., None]], dim=-1)


cutout_jax.varyings = cutout_torch.varyings = ("color", "uv")

SHADERS = {   # name: (JAX fragment shader, port fragment shader)
    "flat": (jsh.flat_color_fragment_shader,
             tsh.flat_color_fragment_shader),
    "cutout": (cutout_jax, cutout_torch),
    "scene": (jr.scene_fragment_shader, tr.scene_fragment_shader),
}

WALL = [engine_quad(-4.0, (1.0, 0.0, 0.0, 0.5)),        # behind: invisible
        engine_quad(-4.5, (0.0, 1.0, 0.0, 0.5)),        # behind: invisible
        engine_quad(-3.0, (1.0, 1.0, 1.0, 1.0)),        # opaque wall
        engine_quad(-2.0, (0.0, 0.0, 1.0, 0.5), s=0.4)]  # front: blended
SMALL = RenderParams(width=96, height=64, cull_mode=0)

# name: (quads, shader, params, camera)
SCENES = {
    "discard_reveal": ([facing_quad(-4.0, (1.0, 0.2, 0.2, 1.0)),
                        facing_quad(-2.0, (0.2, 1.0, 0.2, 1.0))],
                       "cutout", PARAMS, CAM),
    "two_layer_alpha": ([facing_quad(-5.0, (1.0, 1.0, 1.0, 1.0)),
                         facing_quad(-3.5, (1.0, 0.0, 0.0, 0.5)),
                         facing_quad(-2.0, (0.0, 0.0, 1.0, 0.5), x0=-0.5,
                                     x1=0.5, y0=-0.5, y1=0.5)],
                        "flat", PARAMS, CAM),
    "front_to_back": ([facing_quad(-2.0, (0.0, 0.0, 1.0, 0.5)),
                       facing_quad(-4.0, (1.0, 0.0, 0.0, 1.0))],
                      "flat", PARAMS, CAM),
    "blend_additive": ([facing_quad(-5.0, (0.9, 0.9, 0.9, 1.0)),
                        facing_quad(-3.5, (0.3, 0.1, 0.1, 1.0))],
                       "flat", PARAMS.replace(blend_mode=BlendMode.ADDITIVE),
                       CAM),
    "blend_multiply": ([facing_quad(-5.0, (0.9, 0.9, 0.9, 1.0)),
                        facing_quad(-3.5, (0.3, 0.1, 0.1, 1.0))],
                       "flat", PARAMS.replace(blend_mode=BlendMode.MULTIPLY),
                       CAM),
    # The opaque-wall scenes: the short-circuit stops the peel behind the
    # wall.  The scene shader samples the atlas (a textured scene).
    "short_circuit_k2": (WALL, "scene", SMALL.replace(kbuffer=2),
                         np.float32([0.03, 0.02, 0.07])),
    "short_circuit_k4": (WALL, "scene", SMALL.replace(kbuffer=4),
                         np.float32([0.03, 0.02, 0.07])),
    "opaque_stack": ([engine_quad(-2.0 - 0.5 * i, (0.8, 0.7, 0.6, 1.0))
                      for i in range(3)], "scene", SMALL.replace(kbuffer=2),
                     np.float32([0.03, 0.02, 0.07])),
}
def frame_uniforms(params, cam):
    u = jr.default_frame_uniforms(params.width, params.height)
    u["camera_position"] = cam
    if params.height == H:                     # tests/test_kbuffer.py's lens
        u["fov_degrees"] = np.float32(60.0)
        u["far_clip"] = np.float32(100.0)
    return u


def jax_frame(scene, u, params, shader, pallas):
    return tuple(map(np.asarray, jax.jit(functools.partial(
        jr.render_frame, params=params.replace(use_pallas=pallas,
                                               pallas_interpret=pallas),
        fragment_shader=shader))(scene, u)))


def port_frame(scene, u, params, shader):
    out = tr.render_frame(scene_to_torch(scene, "cpu"), u, params,
                          fragment_shader=shader)
    return tuple(t.numpy() if isinstance(t, torch.Tensor) else t
                 for t in out)


def assert_frame_matches_jax(name, pallas):
    """The port's frame of SCENES[name] against JAX's render_frame on its
    XLA K-slot fold (pallas False) or its peel kernel in interpret mode."""
    quads, shader, params, cam = SCENES[name]
    scene, u = build(quads), frame_uniforms(params, cam)
    jc, jd = jax_frame(scene, u, params, SHADERS[shader][0], pallas)
    c, d = port_frame(scene, u, params, SHADERS[shader][1])
    assert np.isfinite(c).all() and np.isfinite(d).all()
    if shader == "scene":
        # Textured: a texel edge under a pixel centre can go either way
        # under XLA's contraction (PERF.md, the CPU parity notes).
        assert (np.abs(c - jc).max(-1) > 1e-5).mean() <= 1e-3
        assert (np.abs(d - jd) > 1e-5).mean() <= 1e-3
    else:
        # Axis-aligned flat quads off the diagonal alignment: exact.
        np.testing.assert_allclose(c, jc, atol=1e-6, rtol=0)
        np.testing.assert_allclose(d, jd, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_kbuffer_frame_matches_jax_xla(name):
    assert_frame_matches_jax(name, pallas=False)


def test_kbuffer_frame_on_the_jax_tests_camera():
    """From tests/test_kbuffer.py's own camera the quads' diagonals run
    through pixel centres (see CAM): the port still matches the XLA fold
    off those diagonals, within PARITY.md D5's 0.5 % of pixels."""
    quads, _, params, _ = SCENES["two_layer_alpha"]
    scene = build(quads)
    u = frame_uniforms(params, np.float32([0, 0, 3]))
    jc, jd = jax_frame(scene, u, params, SHADERS["flat"][0], False)
    c, d = port_frame(scene, u, params, SHADERS["flat"][1])
    off = np.abs(c - jc).max(-1) > 1e-6
    assert 0 < off.mean() <= 5e-3
    ys, xs = np.nonzero(off)
    # every differing pixel lies on the middle quad's diagonal
    assert len(set((xs + ys).tolist())) == 1
    np.testing.assert_allclose(d, jd, atol=1e-6, rtol=0)


def stats_scene():
    """tests/test_kbuffer.py's overflow-counter scene: three stacked
    translucent quads."""
    return build([
        {"position": np.asarray([[-1, -1, z], [1, -1, z], [-1, 1, z],
                                 [1, 1, z]], np.float32),
         "uv": np.zeros((4, 2), np.float32),
         "normal": np.tile(np.float32([0, 0, 1]), (4, 1)),
         "color": np.tile(np.float32([0.6, 0.3, 0.2, 0.5]), (4, 1)),
         "indices": np.asarray([[0, 1, 2], [2, 1, 3]], np.int32)}
        for z in (-2.0, -2.5, -3.0)])


def test_kbuffer_overflow_counter():
    """kbuffer_stats counts the pixels whose K-th layer holds a fragment:
    within 20 of JAX's XLA fold (borderline edge pixels may differ, as
    between JAX's own two routes), none at K=8."""
    scene = stats_scene()
    u = jr.default_frame_uniforms(96, 64)
    counts = {}
    for k in (2, 4, 8):
        p = RenderParams(width=96, height=64, kbuffer=k, kbuffer_stats=True,
                         cull_mode=0, use_pallas=False)
        _, _, js = jax.jit(lambda s, u, p=p: jr.render_frame(s, u, p))(
            scene, u)
        c, d, stats = port_frame(scene, u, p, tr.scene_fragment_shader)
        counts[k] = int(stats["kbuffer_saturated_px"])
        assert abs(counts[k] - int(js["kbuffer_saturated_px"])) <= 20
    assert counts[2] > 50
    assert 0 < counts[4] < counts[2]
    assert counts[8] == 0


def test_short_circuit_stops_the_peel():
    """An all-opaque stack at K=2 would saturate every covered pixel
    without the short-circuit; with it pass 1 finds no eligible pixel, so
    no peel pass runs, nothing is saturated and the image is the opaque
    route's."""
    quads, _, params, cam = SCENES["opaque_stack"]
    scene, u = build(quads), frame_uniforms(params, cam)
    calls = []

    def fold(*args, **kwargs):
        calls.append("prev_d" in kwargs)
        return tile_raster.tile_fold(*args, **kwargs)

    c, d, stats = tr.render_frame(
        scene_to_torch(scene, "cpu"), u,
        params.replace(kbuffer_stats=True), fold=fold)
    assert calls == [False]
    assert int(stats["kbuffer_saturated_px"]) == 0
    c0, d0 = port_frame(scene, u, params.replace(kbuffer=0),
                        tr.scene_fragment_shader)
    np.testing.assert_allclose(c.numpy(), c0, atol=1e-6, rtol=0)
    np.testing.assert_allclose(d.numpy(), d0, atol=1e-6, rtol=0)


def test_short_circuit_off_matches_on():
    """kbuffer_short_circuit off (the natural peel, every pass live) and
    on render the same image: the skipped work is invisible."""
    scene = build([engine_quad(-3.0, (1.0, 1.0, 1.0, 1.0)),
                   engine_quad(-2.0, (0.0, 0.0, 1.0, 0.5), s=0.4),
                   engine_quad(-4.0, (1.0, 0.0, 0.0, 0.5))])
    params = SMALL.replace(kbuffer=3)
    u = frame_uniforms(params, np.float32([0.03, 0.02, 0.07]))
    passes = {}
    frames = {}
    for sc in (True, False):
        calls = []

        def fold(*args, **kwargs):
            calls.append("prev_d" in kwargs)
            return tile_raster.tile_fold(*args, **kwargs)

        frames[sc] = tr.render_frame(
            scene_to_torch(scene, "cpu"), u,
            params.replace(kbuffer_short_circuit=sc), fold=fold)
        passes[sc] = len(calls)
    assert passes[False] == 3 and passes[True] < 3
    for a, b in zip(frames[True], frames[False]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def _tile_kernel_scene():
    """tests/test_pallas_raster.py's scene for its K-deep test: a floor and
    cubes, with culling off so most pixels have several layers."""
    from softwarerenderer_tpu.models import primitives
    from softwarerenderer_tpu.ops import texture as tex_np
    from softwarerenderer_tpu.utils import mathlib as ml
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


@pytest.mark.parametrize("short_circuit", [False, True])
def test_kdeep_route_matches_peel_route(short_circuit):
    """The single-pass K-deep route equals the peel route bit for bit
    without the short-circuit (the counterpart of
    test_kdeep_kernel_matches_peel), and within PARITY.md's one-blend-ulp
    bound with it (the K-deep fold keeps the layers behind opaque
    winners, whose blend weight 1 - alpha is at most 2^-23)."""
    params = RenderParams(width=136, height=92, tile_h=16, span_cap=6,
                          kbuffer=3, cull_mode=0,
                          kbuffer_short_circuit=short_circuit)
    u = jr.default_frame_uniforms(136, 92)
    u["camera_position"] = np.float32([0, 0.5, 3.0])
    scene = scene_to_torch(_tile_kernel_scene(), "cpu")
    f = tr.frame_setup(scene, u, params)
    kw = dict(per_tri_extra=f["per_tri"], with_stats=True)
    a = (f["tris"], tr.scene_fragment_shader, f["uniforms"], params,
         f["fb_color"], f["fb_depth"])
    c1, d1, s1 = tile_raster.render_tile_kbuffer_single(*a, **kw)
    c2, d2, s2 = tile_raster.render_tile_kbuffer(*a, **kw)
    assert (d1 > -3e38).float().mean() > 0.3
    if short_circuit:
        assert (c1 - c2).abs().max() <= 1e-6
        assert torch.equal(d1, d2)
    else:
        assert torch.equal(c1, c2) and torch.equal(d1, d2)
        assert int(s1["kbuffer_saturated_px"]) \
            == int(s2["kbuffer_saturated_px"]) > 0


def test_kdeep_route_refuses_k_above_its_maximum():
    params = RenderParams(width=32, height=32,
                          kbuffer=tile_raster.MAX_KDEEP + 1)
    with pytest.raises(ValueError, match=str(tile_raster.MAX_KDEEP)):
        tile_raster.render_tile_kbuffer_single(
            {}, tr.scene_fragment_shader, {}, params, None, None)


def kbuffer_golden_scene():
    """scripts/make_goldens.py's feature_kbuffer frame: (scene, params,
    uniforms)."""
    from softwarerenderer_tpu_torch.scenes import kbuffer_golden_frame
    return kbuffer_golden_frame()


def test_golden_feature_kbuffer_torch():
    """feature_kbuffer.png through the port's CPU path, under
    tests/test_goldens.py's rule."""
    from PIL import Image
    scene, params, u = kbuffer_golden_scene()
    golden = np.asarray(Image.open(os.path.join(
        REPO, "tests", "goldens", "feature_kbuffer.png")))
    eng = tr.Engine(scene, params, device="cpu")
    got = eng.present(u)
    assert got.shape == golden.shape
    diff = np.abs(got.astype(np.int32) - golden.astype(np.int32))
    frac_off = float(np.mean(np.any(diff > 2, axis=-1)))
    assert frac_off < 2e-3, f"{frac_off:.4%} pixels off by > 2"

