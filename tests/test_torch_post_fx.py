"""The post chain, supersampling and the sky in the port: ops.ssao,
ops.bloom, ops.tonemap, ops.fxaa and ops.sky against the JAX package's on
the CPU from the same seeded inputs; render_frame's ssaa wrapper and its
post chain as data (enabled_post_fx, callable stages); the sky panorama
on the raster and ray-traced routes.

Functions are held against JAX run op by op (xp=jnp, eager), where XLA
rounds each operation once as the port does.  Whole frames are held
against JAX's jitted render_frame, which contracts multiply-adds into
FMAs, so they count the share of pixels off, each bound about twice the
measured share."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softwarerenderer_tpu import RenderParams as JaxRenderParams
from softwarerenderer_tpu.engine import renderer as jr
from softwarerenderer_tpu.models import primitives
from softwarerenderer_tpu.models import scene as scene_mod
from softwarerenderer_tpu.ops import bloom as jbloom
from softwarerenderer_tpu.ops import fxaa as jfxaa
from softwarerenderer_tpu.ops import sky as jsky
from softwarerenderer_tpu.ops import ssao as jssao
from softwarerenderer_tpu.ops import tonemap as jtonemap
from softwarerenderer_tpu.ops.raster import DEPTH_CLEAR
from softwarerenderer_tpu.ops import texture as tex_np
from softwarerenderer_tpu.utils import mathlib as ml
from softwarerenderer_tpu_torch import RenderParams, scenes
from softwarerenderer_tpu_torch.engine import Engine, render_frame
from softwarerenderer_tpu_torch.ops import (bloom, fxaa, raytrace, sky,
                                            ssao, tonemap)

W, H = 96, 64


def _scene():
    """A floor, a turned cube and a soup of small triangles."""
    checker = np.asarray(tex_np.checkerboard(32, 4)["data"])
    return scene_mod.build_scene_buffers([
        scene_mod.MeshInstance(primitives.plane(20.0),
                               ml.translation([0, -1, 0]), texture=checker),
        scene_mod.MeshInstance(primitives.cube(1.0),
                               ml.matrix_from_yaw_pitch_roll(0.6, 0.3, 0)
                               @ ml.translation([0, 0.2, -3]),
                               texture=checker),
        scene_mod.MeshInstance(primitives.random_triangle_soup(60, seed=3),
                               texture=checker)])


def _uniforms(w=W, h=H):
    """A camera off texel-edge lines (tests/test_torch_goldens.py) that
    sees floor, cube, soup and open sky."""
    u = jr.default_frame_uniforms(w, h)
    u["camera_position"] = np.float32([0.13, 0.61, 1.37])
    u["camera_rotation"] = ml.quat_from_yaw_pitch_roll(
        np.float32(0.07), np.float32(-0.11), np.float32(0))
    return u


def _panorama(dtype, seed=5):
    rng = np.random.default_rng(seed)
    pano = rng.uniform(0, 1, (16, 32, 4)).astype(np.float32)
    return (pano * 255).astype(np.uint8) if dtype == "u8" else pano


def _frame_inputs(seed=0):
    """A seeded overbright color frame and a depth buffer with flat areas,
    ridges, valleys and clear pixels."""
    rng = np.random.default_rng(seed)
    color = rng.uniform(0, 1.6, (H, W, 4)).astype(np.float32)
    color[10:30, 10:50] = 0.4                     # a flat patch
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = -0.95 - 0.04 * np.sin(xx / 5) * np.cos(yy / 7)
    depth += rng.normal(0, 1e-3, depth.shape)
    depth = depth.astype(np.float32)
    depth[:8] = DEPTH_CLEAR
    depth[30:40, 60:70] = -0.6                    # a near box
    return color, depth


def _near_far():
    return ({"near_clip": np.float32(0.1), "far_clip": np.float32(1000.0)},
            {"near_clip": torch.tensor(0.1), "far_clip": torch.tensor(1000.0)})


@pytest.mark.parametrize("stage", ["ssao", "bloom", "reinhard", "aces",
                                   "fxaa"])
def test_post_stage_matches_jax(stage):
    """Each named stage on a seeded overbright frame and depth buffer
    against JAX's op by op: the same operations in the same order, so
    rtol 1e-6 (measured: equal on every value).  FXAA's compares can flip
    on one ulp of luma, which changes a pixel by a whole blend step, so
    its pixels are counted instead: at most 0.1 % may differ (measured
    0)."""
    color, depth = _frame_inputs()
    ju, tu = _near_far()
    ju["exposure"], tu["exposure"] = np.float32(1.7), torch.tensor(1.7)
    c, d = torch.from_numpy(color), torch.from_numpy(depth)
    jc, jd = jnp.asarray(color), jnp.asarray(depth)
    if stage == "ssao":
        got, got_d = ssao.apply_ssao(c, d, tu)
        want, want_d = jssao.apply_ssao(jc, jd, ju, xp=jnp)
        assert torch.equal(got_d, d)
        ao = ssao.compute_ssao(d, tu)
        assert 0 < float(ao.mean()) and float(ao.max()) <= 1
    elif stage == "bloom":
        got = bloom.apply_bloom(c, threshold=0.8, strength=0.7)
        want = jbloom.apply_bloom(jc, threshold=0.8, strength=0.7, xp=jnp)
    elif stage in ("reinhard", "aces"):
        got = tonemap.apply_tonemap(c, stage, tu)
        want = jtonemap.apply_tonemap(jc, stage, ju, xp=jnp)
    else:
        got = fxaa.apply_fxaa(c)
        want = jfxaa.apply_fxaa(jc, xp=jnp)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == color.shape
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[..., 3], color[..., 3])
    if stage == "fxaa":
        diff = np.abs(got - want).max(-1)
        assert (diff > 0).mean() <= 1e-3
        assert (got != color).any()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_linear_view_distance_keeps_clear_depth_finite():
    """Clear depth (-FLT_MAX) maps to far without overflowing to inf on
    the way; covered depths to [near, far], equal to JAX's."""
    ju, tu = _near_far()
    depth = np.float32([DEPTH_CLEAR, -0.5, -1.0, 0.0, -0.999999])
    got = ssao.linear_view_distance(torch.from_numpy(depth),
                                    tu["near_clip"], tu["far_clip"])
    want = jssao.linear_view_distance(jnp.asarray(depth), ju["near_clip"],
                                      ju["far_clip"], xp=jnp)
    assert torch.isfinite(got).all()
    assert float(got[0]) == 1000.0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_shift_replicates_the_edge():
    """The neighbour shift clamps at the border (no wrap), as JAX's
    edge-mode pad and slice."""
    a = torch.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(ssao.shift(a, 1, -2).numpy(),
                                  np.asarray(jssao._shift(jnp.asarray(a),
                                                          1, -2, jnp)))
    np.testing.assert_array_equal(ssao.shift(a, -4, 5).numpy(),
                                  np.asarray(jssao._shift(jnp.asarray(a),
                                                          -4, 5, jnp)))


def _directions(n=5000, seed=3):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:4] = [[0, 1, 0], [0, -1, 0], [0, 0, -1], [0, 0, 1]]   # poles, seam
    return d


@pytest.mark.parametrize("rows", ["u8", "f32"])
def test_sample_panorama_matches_jax(rows):
    """The lat-long lookup of seeded unit directions (the poles and the
    seam among them) on u8 and f32 panoramas against JAX's op by op.
    atan2 and asin are rounded by two libraries: at most 0.1 % of samples
    may differ by more than 1e-6 and none by more than 1e-5 (measured:
    11 % differ at all, 0.02 % by more than 1e-6, at most 1.4e-6 on u8
    and 1.3e-6 on f32)."""
    pano = _panorama(rows)
    d = _directions()
    got = sky.sample_panorama(torch.from_numpy(pano),
                              torch.from_numpy(d)).numpy()
    want = np.asarray(jsky.sample_panorama(jnp.asarray(pano),
                                           jnp.asarray(d), xp=jnp))
    assert got.shape == want.shape == (len(d), 4)
    diff = np.abs(got - want).max(-1)
    assert (diff > 1e-6).mean() <= 1e-3 and diff.max() <= 1e-5


def test_composite_sky_matches_jax():
    """Clear-depth pixels take the panorama along their view ray, covered
    ones keep their color, depth passes through; against JAX's op by op
    (bound as test_sample_panorama_matches_jax's; measured at most
    8.3e-7)."""
    color, depth = _frame_inputs()
    u = dict(_uniforms(), sky_panorama=_panorama("u8"))
    got, got_d = sky.composite_sky(torch.from_numpy(color),
                                   torch.from_numpy(depth), u,
                                   torch.from_numpy(u["sky_panorama"]))
    want, _ = jsky.composite_sky(jnp.asarray(color), jnp.asarray(depth), u,
                                 xp=jnp)
    got, want = got.numpy(), np.asarray(want)
    clear = depth == DEPTH_CLEAR
    np.testing.assert_array_equal(got[~clear], color[~clear])
    assert np.abs(got[clear] - color[clear]).max() > 0.1
    diff = np.abs(got - want).max(-1)
    assert (diff > 1e-6).mean() <= 1e-3 and diff.max() <= 1e-5
    assert torch.equal(got_d, torch.from_numpy(depth))


def _jax_frame(sc, u, params, **kw):
    c, d = jax.jit(functools.partial(jr.render_frame, params=params,
                                     **kw))(sc, u)
    return np.asarray(c), np.asarray(d)


def _off(got, want):
    """(share > 1e-5, share > 1e-3, share > 2/255, max) of the pixels'
    largest channel difference."""
    diff = np.abs(got - want).max(-1)
    return ((diff > 1e-5).mean(), (diff > 1e-3).mean(),
            (diff > 2 / 255).mean(), diff.max())


# Frames against JAX's jitted render_frame: the largest share of pixels
# off by > 1e-5 and the largest difference, about twice the measured
# (measured: ssaa 2 and 3 with fb seeds, no pixel off, at most 2.4e-7;
# the chain 0.85 % by at most 8.9e-4, the same chain at ssaa 2 0.67 % by
# at most 6.7e-4: the sky's atan2 and asin and XLA's FMAs in ACES and
# SSAO).
FRAME_BOUNDS = {"ssaa2": (1e-3, 1e-5), "ssaa3": (1e-3, 1e-5),
                "chain": (0.02, 2e-3), "chain_ssaa2": (0.015, 1.5e-3)}
FRAME_PARAMS = {
    "ssaa2": dict(ssaa=2), "ssaa3": dict(ssaa=3),
    "chain": dict(ssao=True, bloom=True, tonemap="aces", fxaa=True),
    "chain_ssaa2": dict(ssaa=2, ssao=True, bloom=True, tonemap="reinhard",
                        fxaa=True)}


@pytest.mark.parametrize("name", sorted(FRAME_PARAMS))
def test_frame_matches_jax(name):
    """ssaa 2 and 3 (over seeded fb color and depth for ssaa 3) and the
    whole chain (sky, SSAO, bloom, tone mapping, FXAA with an exposure
    uniform), alone and supersampled, through Engine against JAX's jitted
    render_frame; depth equal on every pixel but one in a thousand."""
    sc, u = _scene(), _uniforms()
    fb = None
    if name.startswith("chain"):
        u.update(sky_panorama=_panorama("u8"), exposure=np.float32(1.5))
    if name == "ssaa3":
        rng = np.random.default_rng(1)
        fb = (rng.uniform(0, 1, (H, W, 4)).astype(np.float32),
              np.full((H, W), -1.5, np.float32))
    kw = FRAME_PARAMS[name]
    jc, jd = jax.jit(functools.partial(
        jr.render_frame, params=JaxRenderParams(width=W, height=H, **kw)))(
            sc, u, fb=fb)
    c, d = (t.numpy() for t in Engine(sc, RenderParams(W, H, **kw),
                                      device="cpu").render(u, fb=fb))
    assert c.shape == (H, W, 4) and d.shape == (H, W)
    assert np.isfinite(c).all()
    bound, largest = FRAME_BOUNDS[name]
    share, _, _, biggest = _off(c, np.asarray(jc))
    assert share <= bound and biggest <= largest, (share, biggest)
    assert (np.abs(d - np.asarray(jd)) > 1e-5).mean() <= 1e-3
    assert (d > -3e38).mean() > 0.3


def test_ssaa_box_filters_the_supersampled_frame():
    """ssaa=2 is the frame at 2x in each axis box-filtered down: color the
    mean of each 2x2 block, depth its top-left sample."""
    sc, u = _scene(), _uniforms(48, 32)
    eng = Engine(sc, RenderParams(96, 64), device="cpu")
    hi_c, hi_d = eng.render(u)
    c, d = Engine(sc, RenderParams(48, 32, ssaa=2), device="cpu").render(u)
    np.testing.assert_allclose(
        c.numpy(), hi_c.reshape(32, 2, 48, 2, 4).mean((1, 3)).numpy(),
        rtol=0, atol=1e-7)
    assert torch.equal(d, hi_d[::2, ::2])


def test_post_fx_validation():
    """JAX's ValueErrors (tests/test_engine.py:test_post_fx_validation): an
    unknown post_fx entry, an effect switched on but absent from post_fx,
    and the stats flags with ssaa or post-FX, through render_frame and
    Engine alike."""
    sc, u = _scene(), _uniforms()
    eng = Engine(sc, RenderParams(W, H), device="cpu")
    with pytest.raises(ValueError, match="unknown post_fx"):
        render_frame(eng.scene, u, RenderParams(
            W, H, bloom=True, post_fx=("bloom", "vignette")))
    with pytest.raises(ValueError, match="absent from"):
        render_frame(eng.scene, u, RenderParams(W, H, bloom=True,
                                                post_fx=("tonemap",)))
    with pytest.raises(ValueError, match="absent from"):
        render_frame(eng.scene, dict(u, sky_panorama=_panorama("f32")),
                     RenderParams(W, H, post_fx=("ssao",)))
    with pytest.raises(ValueError, match="unknown post_fx"):
        Engine(sc, RenderParams(W, H, post_fx=("glow",)), device="cpu")
    for p in (RenderParams(W, H, kbuffer=4, kbuffer_stats=True, ssaa=2),
              RenderParams(W, H, kbuffer=4, kbuffer_stats=True, fxaa=True)):
        with pytest.raises(ValueError, match="no ssaa/post-fx"):
            Engine(sc, p, device="cpu")
    with pytest.raises(ValueError, match="active_cap_stats needs no ssaa"):
        Engine(sc, RenderParams(W, H, active_cap_stats=True, ssaa=2),
               device="cpu")


def test_post_fx_user_callable_stage():
    """A callable post_fx entry (tests/test_engine.py's
    test_post_fx_user_callable_stage): it runs at its slot in the order,
    reads the uniforms as device tensors, may return color alone, and
    depth passes through."""
    sc, u = _scene(), _uniforms()
    u["vignette_strength"] = np.float32(0.8)
    seen = {}

    def vignette(color, depth, uniforms):
        seen["strength"] = uniforms["vignette_strength"]
        h, w = color.shape[:2]
        ys = torch.linspace(-1.0, 1.0, h)[:, None]
        xs = torch.linspace(-1.0, 1.0, w)[None, :]
        fade = 1.0 - uniforms["vignette_strength"] * \
            (ys * ys + xs * xs).clamp(0.0, 1.0)
        return color * fade[..., None]              # color-only return

    def half(color, depth, uniforms):
        return color * 0.5, depth

    base = RenderParams(W, H, tonemap="aces")
    chain = ("sky", "ssao", "bloom", "tonemap", "fxaa")
    eng = Engine(sc, base, device="cpu")
    c_plain, d_plain = eng.render(u)
    c_vig, d_vig = render_frame(eng.scene, u,
                                base.replace(post_fx=chain + (vignette,)))
    assert isinstance(seen["strength"], torch.Tensor)
    assert float(seen["strength"]) == pytest.approx(0.8)
    assert c_vig[0, 0, :3].sum() <= c_plain[0, 0, :3].sum()
    assert float((c_vig - c_plain).abs().max()) > 0.01
    assert torch.equal(d_vig, d_plain)
    c_b, _ = render_frame(eng.scene, u, base.replace(
        post_fx=("sky", "ssao", "bloom", half, "tonemap", "fxaa")))
    c_a, _ = render_frame(eng.scene, u, base.replace(post_fx=chain + (half,)))
    assert float((c_b - c_a).abs().max()) > 0.01


def test_post_fx_order_is_configurable():
    """tests/test_engine.py's test_post_fx_order_is_configurable: restating
    the default order changes nothing, bloom after tone mapping differs."""
    sc, u = _scene(), _uniforms()
    u["exposure"] = np.float32(2.0)
    base = RenderParams(W, H, bloom=True, tonemap="aces")
    eng = Engine(sc, base, device="cpu")
    c_default, _ = eng.render(u)
    c_same, _ = render_frame(eng.scene, u, base.replace(
        post_fx=("sky", "ssao", "bloom", "tonemap")))
    assert torch.equal(c_default, c_same)
    c_swapped, _ = render_frame(eng.scene, u, base.replace(
        post_fx=("sky", "ssao", "tonemap", "bloom")))
    assert float((c_swapped - c_default).abs().max()) > 0.01


def test_shadowed_frame_with_ssaa_matches_jax():
    """The directional shadowed golden frame at 64x48 with ssaa=2: the
    shadow function calls render_frame with the caller's params, so the
    supersampling reaches the main pass (the light pass keeps its map
    size).  Against JAX's jitted frame: at most 0.1 % of pixels off by more
    than 1e-5 and none by more than 1e-3 (measured: none off, at most
    1.2e-7), depth at most 0.2 % (measured 0)."""
    from softwarerenderer_tpu.engine.renderer import \
        render_frame_with_shadows as jax_shadows
    from softwarerenderer_tpu_torch.models.convert import scene_to_torch
    sc, _, u, fn, _ = scenes.shadow_golden_frame("shadows")
    u = dict(u, **{k: v for k, v in jr.default_frame_uniforms(64, 48).items()
                   if k not in u})
    jc, jd = jax.jit(functools.partial(
        jax_shadows, params=JaxRenderParams(width=64, height=48, ssaa=2),
        shadow_size=256))(sc, u)
    c, d = fn(scene_to_torch(sc, "cpu"), u, RenderParams(64, 48, ssaa=2))
    c, d = c.numpy(), d.numpy()
    assert c.shape == (48, 64, 4)
    share, share3, _, _ = _off(c, np.asarray(jc))
    assert share <= 1e-3 and share3 == 0, (share, share3)
    assert (np.abs(d - np.asarray(jd)) > 1e-5).mean() <= 2e-3


def _sky_scene():
    """A cube in front of the camera over a floor."""
    checker = np.asarray(tex_np.checkerboard(16, 4)["data"])
    return scene_mod.build_scene_buffers([
        scene_mod.MeshInstance(primitives.cube(1.0),
                               ml.translation([0.0, 0.0, -3.0]),
                               texture=checker),
        scene_mod.MeshInstance(primitives.plane(20.0),
                               ml.translation([0.0, -1.0, 0.0]))])


@pytest.mark.parametrize("cap", [0, 24], ids=["brute", "bundle"])
def test_raytraced_miss_shows_clear_color_and_sky(cap):
    """tests/test_raytrace.py's test_miss_shows_clear_color_and_sky on both
    routes: looking away from the scene every ray misses; the frame is the
    clear color, and with a green panorama it is green."""
    checker = np.asarray(tex_np.checkerboard(16, 4)["data"])
    sc = scene_mod.build_scene_buffers([scene_mod.MeshInstance(
        primitives.cube(1.0), ml.translation([0.0, 0.0, -3.0]),
        texture=checker)])
    eng = Engine(sc, RenderParams(32, 24), device="cpu",
                 frame_fn=functools.partial(raytrace.render_frame_raytraced,
                                            cluster_cap=cap))
    u = dict(eng.uniforms)
    u["camera_rotation"] = np.asarray(
        ml.quat_from_yaw_pitch_roll(np.pi, 0.0, 0.0), np.float32)
    color, depth = eng.render(u)
    assert (depth == DEPTH_CLEAR).all()
    np.testing.assert_allclose(color[0, 0].numpy(), u["clear_color"],
                               atol=1e-6)
    pano = np.zeros((8, 16, 4), np.float32)
    pano[:, :, 1] = 1.0                               # green sky
    color2, _ = eng.render(dict(u, sky_panorama=pano))
    np.testing.assert_allclose(float(color2[0, 0, 1]), 1.0, atol=1e-5)


def test_raytraced_sky_frame_matches_jax():
    """A ray-traced frame with reflections under a seeded panorama: misses
    of the primary rays and of the mirror rays sample the sky.  The port's
    brute and bundle routes against JAX's brute route (jitted): 99 % of
    pixels within 1e-3 (test_torch_raytrace.py's bound; measured 100 %, at
    most 1.6e-6), the same pixels missed, and the two routes equal on
    every pixel."""
    from softwarerenderer_tpu.ops.raytrace import render_frame_raytraced
    sc = _sky_scene()
    w, h = 48, 32
    u = jr.default_frame_uniforms(w, h)
    u["camera_position"] = np.float32([0.3, 0.8, 0.5])
    u["sky_panorama"] = _panorama("u8")
    jc, jd = jax.jit(lambda s, uu: render_frame_raytraced(
        s, uu, JaxRenderParams(width=w, height=h), chunk=256,
        shadows=False, reflections=True))(sc, u)
    jc, jd = np.asarray(jc), np.asarray(jd)
    frames = []
    for cap in (0, 24):
        eng = Engine(sc, RenderParams(w, h), device="cpu",
                     frame_fn=functools.partial(
                         raytrace.render_frame_raytraced, cluster_cap=cap,
                         shadows=False, reflections=True))
        c, d = (t.numpy() for t in eng.render(u))
        frames.append(c)
        miss = d == DEPTH_CLEAR
        assert 0.1 < miss.mean() < 0.9
        assert (np.abs(c - np.asarray(u["clear_color"])).max(-1)[miss]
                > 1e-3).mean() > 0.9                  # the sky, not clear
        assert (np.abs(c - jc).max(-1) < 1e-3).mean() > 0.99
        np.testing.assert_array_equal(miss, jd == DEPTH_CLEAR)
    np.testing.assert_array_equal(frames[0], frames[1])
