"""Shadow maps: the port's ops.shadows and the three shadowed frames of
engine.renderer against the JAX package's on the CPU, on the golden
feature scenes (scenes.shadow_golden_frame) at 96x72 with 64-texel maps.

The light cameras are held against JAX's at an absolute bound; each light
pass's map by texels (coverage) and by depth where both cover, with a
bound per pass about twice the measured difference (XLA contracts the
edge and depth functions of its jitted fold, the port rounds each
operation once); the lit factors on seeded points exactly, except where a
point lies within 1e-6 of the bias; the frames by the share of pixels
off.  A skinned scene (tests/test_shadows.py's arm) casts its pose in
every light pass, held against JAX's frames the same way."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softwarerenderer_tpu import RenderParams as JaxRenderParams
from softwarerenderer_tpu.engine import renderer as jr
from softwarerenderer_tpu.ops import shadows as js
from softwarerenderer_tpu.utils import mathlib as jml
from softwarerenderer_tpu_torch import DepthTest, RenderParams, scenes
from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.engine import renderer
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import binning, lighting, shadows, vis_fold
from softwarerenderer_tpu_torch.utils import mathlib as ml

W, H, S = 96, 72, 64
NAMES = ("shadows", "point_shadows", "spot_shadows")
JAX_FRAME = {"shadows": jr.render_frame_with_shadows,
             "point_shadows": jr.render_frame_with_point_shadows,
             "spot_shadows": jr.render_frame_with_spot_shadow}
PORT_FRAME = {"shadows": renderer.render_frame_with_shadows,
              "point_shadows": renderer.render_frame_with_point_shadows,
              "spot_shadows": renderer.render_frame_with_spot_shadow}
# Light cameras: matrices of entries up to about 30, a few ulps.
CAMERA_ATOL = 1e-5
# Each light pass against JAX's at 64 texels: the share of texels whose
# coverage differs (measured 0, 0.146 % on the worst cube face, 0) and the
# depth bound where both cover (measured 1.8e-7, 3.3e-5, 6.0e-6).
MAP_COVERAGE_MAX = 2e-3
MAP_DEPTH_ATOL = {"shadows": 1e-6, "point_shadows": 7e-5,
                  "spot_shadows": 1.2e-5}
# Frames: pixels off by > 1e-5 in color (measured 0, 0, 0.13 %: the spot
# cone's smoothstep amplifies ulps) and in depth (0, 0.029 %, 0).
FRAME_COLOR_OFF_MAX = 3e-3
FRAME_DEPTH_OFF_MAX = 1e-3


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


@functools.lru_cache(maxsize=None)
def golden(name):
    """(numpy scene, uniforms, its tensors) of a feature frame."""
    sc, _, u, _, _ = scenes.shadow_golden_frame(name)
    return sc, u, scene_to_torch(sc, "cpu")


@functools.lru_cache(maxsize=None)
def jax_frame(name):
    sc, u, _ = golden(name)
    return tuple(map(np.asarray, jax.jit(functools.partial(
        JAX_FRAME[name], params=JaxRenderParams(width=W, height=H),
        shadow_size=S))(sc, u)))


def _jax_bounds(sc):
    """JAX's scene fit (render_frame_with_shadows), eagerly."""
    mm = jnp.asarray(sc["mesh_matrices"])
    wc = jml.transform_point(jnp.asarray(sc["bounds_center"]), mm, xp=jnp)
    rn = jnp.sqrt(jnp.sum(mm[:, :3, :3] ** 2, axis=-1))
    wr = jnp.asarray(sc["bounds_radius"]) * jnp.max(rn, -1)
    center = jnp.mean(wc, axis=0)
    return center, jnp.max(jnp.linalg.norm(wc - center, axis=-1) + wr)


def test_orthographic_matches_jax():
    for args in ((4.4, 4.4, 0.1, 8.0), (30.0, 12.5, 0.05, 300.0)):
        got = ml.orthographic(*map(_t, args)).numpy()
        want = np.asarray(jml.orthographic(*args, xp=jnp))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("camera", ["directional", "point", "spot"])
def test_light_cameras_match_jax(camera):
    """The three light cameras, a light looking straight down (the +X up
    vector) among them."""
    if camera == "directional":
        for d in ((0.5, -1.0, -0.3), (0.01, -1.0, 0.02), (1.0, 0.2, 0.0)):
            got = shadows.directional_light_camera(
                _t(d), _t([0.5, -0.2, -3.0]), _t(7.25))
            want = js.directional_light_camera(
                jnp.asarray(d), jnp.asarray([0.5, -0.2, -3.0]), 7.25)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=0, atol=CAMERA_ATOL)
    elif camera == "point":
        got = shadows.point_light_cameras([0.0, 3.0, -4.0], 0.05, 100.0)
        want = js.point_light_cameras(jnp.asarray([0.0, 3.0, -4.0]), 0.05,
                                      100.0)
        for g, w in zip(got, want):
            assert tuple(g.shape) == (6, 4, 4)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=CAMERA_ATOL)
    else:
        for d in ((-0.35, -1.0, -0.55), (0.0, -1.0, 0.0)):
            got = shadows.spot_light_camera([1.5, 3.0, -2.0], d, 0.6)
            want = js.spot_light_camera(jnp.asarray([1.5, 3.0, -2.0]),
                                        jnp.asarray(d), 0.6)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=0, atol=CAMERA_ATOL)


def test_directional_fit_matches_jax(monkeypatch):
    """render_frame_with_shadows' light camera, fitted to the scene's
    world bounds, against the one JAX's hands its frame (captured)."""
    sc, u, st = golden("shadows")
    captured = {}

    def capture(scene, uu, params, **kw):
        captured.update(uu)
        return None, None

    monkeypatch.setattr(jr, "render_frame", capture)
    monkeypatch.setattr(js, "render_shadow_depth",
                        lambda *a, **k: jnp.zeros((S, S)))
    jr.render_frame_with_shadows(sc, u, JaxRenderParams(width=W, height=H),
                                 shadow_size=S)
    center, radius = shadows.scene_bounds(st)
    jc, jrad = _jax_bounds(sc)
    np.testing.assert_allclose(center.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(float(radius), float(jrad), rtol=1e-6)
    view, proj, _ = shadows.directional_light_camera(
        u["light_direction"], center, radius)
    np.testing.assert_allclose(view.numpy(), captured["shadow_view"],
                               atol=CAMERA_ATOL)
    np.testing.assert_allclose(proj.numpy(), captured["shadow_proj"],
                               atol=CAMERA_ATOL)


def _light_cameras(name):
    """JAX's cameras of a frame's light passes, as numpy (view, proj)."""
    sc, u, _ = golden(name)
    if name == "shadows":
        v, p, _ = js.directional_light_camera(u["light_direction"],
                                              *_jax_bounds(sc))
        return [(np.asarray(v), np.asarray(p))]
    if name == "spot_shadows":
        v, p = js.spot_light_camera(u["spot_position"], u["spot_direction"],
                                    u["spot_outer"])
        return [(np.asarray(v), np.asarray(p))]
    vs, ps = js.point_light_cameras(u["point_light_position"], 0.05, 100.0)
    return [(np.asarray(vs[f]), np.asarray(ps[f])) for f in range(6)]


@functools.lru_cache(maxsize=None)
def jax_maps(name):
    sc, u, _ = golden(name)
    fn = jax.jit(functools.partial(
        js.render_shadow_depth, shadow_size=S,
        params=JaxRenderParams(width=W, height=H)))
    return [np.asarray(fn(sc, u, v, p)) for v, p in _light_cameras(name)]


@pytest.mark.parametrize("name", NAMES)
def test_light_pass_maps_match_jax(name):
    """Each light pass's 64-texel map from JAX's camera, through the
    port's light pass (the binned fold on the CPU) and JAX's."""
    _, u, st = golden(name)
    for (v, p), want in zip(_light_cameras(name), jax_maps(name)):
        got = shadows.render_shadow_depth(st, u, _t(v), _t(p), S,
                                          RenderParams(W, H)).numpy()
        assert got.shape == want.shape == (S, S)
        g_cov, w_cov = got > -3e38, want > -3e38
        assert (g_cov != w_cov).mean() <= MAP_COVERAGE_MAX
        both = g_cov & w_cov
        if both.any():
            assert np.abs(got - want)[both].max() <= MAP_DEPTH_ATOL[name]
    assert any((m > -3e38).mean() > 0.1 for m in jax_maps(name))


def _seeded_points(n=6000, seed=0):
    """World points around the feature scenes' occluders: half on the
    floor (y = -1), half in the box above it."""
    rng = np.random.default_rng(seed)
    wp = rng.uniform(-2.0, 3.0, (n, 3)).astype(np.float32)
    wp[:, 2] -= 6.5
    wp[: n // 2, 1] = -1.0
    wp[n // 2:, 1] = rng.uniform(-1, 3, n - n // 2)
    return wp


@pytest.mark.parametrize("name", ["shadows", "point_shadows"])
def test_shadow_factors_match_jax(name):
    """shadow_factor and point_shadow_factor on seeded points over JAX's
    own maps: equal {0, 1} factors, except at points whose depth lies
    within 1e-6 of the texel's less the bias."""
    sc, u, st = golden(name)
    wp = _seeded_points()
    maps = jax_maps(name)
    cams = _light_cameras(name)
    if name == "shadows":
        uu = {"shadow_map": maps[0], "shadow_view": cams[0][0],
              "shadow_proj": cams[0][1]}
        fn, jfn = shadows.shadow_factor, js.shadow_factor
    else:
        uu = {"point_shadow_map": np.stack(maps),
              "point_shadow_views": np.stack([c[0] for c in cams]),
              "point_shadow_projs": np.stack([c[1] for c in cams]),
              "point_light_position": u["point_light_position"]}
        fn, jfn = shadows.point_shadow_factor, js.point_shadow_factor
    got = fn(_t(wp), {k: _t(v) for k, v in uu.items()}).numpy()
    want = np.asarray(jfn(jnp.asarray(wp),
                          {k: jnp.asarray(v) for k, v in uu.items()},
                          xp=jnp))
    assert set(np.unique(got)) <= {0.0, 1.0}
    assert 0.05 < got.mean() < 0.98            # lit and shadowed points
    differ = np.nonzero(got != want)[0]
    if differ.size and name == "shadows":
        vp = ml.transform(_t(cams[0][0]), _t(cams[0][1]))
        sx, sy, d_f = (x.numpy() for x in shadows._to_light_screen(
            _t(wp[differ]), vp, S))
        d_m = maps[0][sy.astype(np.int32).clip(0, S - 1),
                      sx.astype(np.int32).clip(0, S - 1)]
        margin = d_f.astype(np.float64) - (d_m.astype(np.float64)
                                           - shadows.SHADOW_BIAS)
        assert np.abs(margin).max() <= 1e-6
    else:
        assert differ.size == 0


def test_lookup_casts_after_inside():
    """A NaN or far out-of-range light-space coordinate is lit and never
    indexes outside the map: inside is computed from the floats, the
    index clamped after the cast."""
    smap = torch.full((4, 4), 10.0)                 # everything occludes
    sx = torch.tensor([float("nan"), 3e9, -3e9, 1.5, -0.5])
    sy = torch.tensor([1.0, 1.0, 1.0, float("inf"), 2.0])
    lit = shadows._lookup(smap.reshape(-1), 0, sx, sy,
                          torch.zeros(5), 4, shadows.SHADOW_BIAS)
    assert lit.tolist() == [1.0] * 5
    inside = shadows._lookup(smap.reshape(-1), 0, torch.tensor([1.5]),
                             torch.tensor([2.5]), torch.zeros(1), 4,
                             shadows.SHADOW_BIAS)
    assert inside.tolist() == [0.0]


def _assert_frame_close(name, c, d):
    jc, jd = jax_frame(name)
    assert c.shape == jc.shape == (H, W, 4) and np.isfinite(c).all()
    assert (np.abs(c - jc).max(-1) > 1e-5).mean() <= FRAME_COLOR_OFF_MAX
    assert (np.abs(d - jd) > 1e-5).mean() <= FRAME_DEPTH_OFF_MAX
    assert (d > -3e38).mean() > 0.3


@pytest.mark.parametrize("name", NAMES)
def test_shadowed_frame_matches_jax(name):
    """The frame function called directly, as the goldens call it, with
    the default (lit) shaders."""
    _, u, st = golden(name)
    c, d = PORT_FRAME[name](st, u, RenderParams(W, H), shadow_size=S)
    _assert_frame_close(name, c.numpy(), d.numpy())


@pytest.mark.parametrize("name", NAMES)
def test_shadowed_frame_through_engine(name):
    """The same frame as Engine(frame_fn=...): Engine hands its own
    shaders to the frame function, so the lit ones are named; the frame
    equals the direct call's, and without them the game's shaders draw
    an unshadowed frame (JAX's contract)."""
    sc, u, st = golden(name)
    fn = functools.partial(PORT_FRAME[name], shadow_size=S)
    shaders = scenes.shadow_golden_frame(name)[4]
    assert shaders["vertex_shader"] is lighting.lit_scene_vertex_shader
    assert shaders["fragment_shader"] is {
        "shadows": shadows.shadowed_scene_fragment_shader,
        "point_shadows": shadows.point_shadowed_fragment_shader,
        "spot_shadows": shadows.spot_shadowed_fragment_shader}[name]
    eng = Engine(sc, RenderParams(W, H), device="cpu", frame_fn=fn,
                 **shaders)
    c, d = eng.render(u)
    dc, dd = PORT_FRAME[name](st, u, RenderParams(W, H), shadow_size=S)
    assert torch.equal(c, dc) and torch.equal(d, dd)
    _assert_frame_close(name, c.numpy(), d.numpy())
    game = Engine(sc, RenderParams(W, H), device="cpu", frame_fn=fn)
    gc, _ = game.render(u)
    plain, _ = Engine(sc, RenderParams(W, H), device="cpu").render(u)
    assert torch.equal(gc, plain)


@functools.lru_cache(maxsize=None)
def arm_scene():
    """tests/test_shadows.py's posed-shadow scene: a floor and the
    two-bone arm of tests/test_skinning.py (its child bone turns 90°
    about z over 1 s), packed by the port."""
    from softwarerenderer_tpu_torch.models import primitives
    from softwarerenderer_tpu_torch.models import scene as scene_mod
    from tests.test_skinning import arm_mesh, two_bone_skin
    arm = arm_mesh()
    sc = scene_mod.build_scene_buffers([
        scene_mod.MeshInstance(primitives.plane(20.0),
                               ml.translation([0, -1, 0])),
        scene_mod.MeshInstance(arm, ml.translation([0.0, 0.5, -4.0]),
                               skin=two_bone_skin(arm["position"]))])
    return sc, scene_to_torch(sc, "cpu")


ARM_PARAMS = RenderParams(W, H, cull_mode=0)
# The arm is a strip in the xy plane: the golden point light, straight
# above it at its own z, sees it edge-on on every cube face, so the arm's
# point light stands in front of it.
ARM_LIGHTS = {"point_shadows": {
    "point_light_position": np.float32([0.5, 2.0, -1.0])}}
# The arm's frames against JAX's jitted frames: pixels off by > 1e-5 in
# color (measured 0, 0, 0.072 % under the golden lights at 0.5 s, 0.029 %
# under the overhead light) and in depth (0, 0, 0; 0.029 %).
ARM_COLOR_OFF_MAX = 2e-3
ARM_DEPTH_OFF_MAX = 1e-3


@functools.lru_cache(maxsize=None)
def jax_arm_fn(name):
    return jax.jit(functools.partial(
        JAX_FRAME[name], params=JaxRenderParams(width=W, height=H,
                                                cull_mode=0),
        shadow_size=S))


def _assert_arm_close(name, u, c, d):
    jc, jd = map(np.asarray, jax_arm_fn(name)(arm_scene()[0], u))
    c, d = c.numpy(), d.numpy()
    assert np.isfinite(c).all() and (d > -3e38).mean() > 0.3
    assert (np.abs(c - jc).max(-1) > 1e-5).mean() <= ARM_COLOR_OFF_MAX
    assert (np.abs(d - jd) > 1e-5).mean() <= ARM_DEPTH_OFF_MAX


@pytest.mark.parametrize("name", NAMES)
def test_skinned_scene_raises(name):
    """The name is kept from when a skinned scene was refused.  Each
    shadowed frame renders it now, posed at anim_time 0.5 s under the
    golden frame's lights (ARM_LIGHTS), within the stated share of JAX's
    frame; its light passes draw the pose (the maps of 0 and 1 s
    differ)."""
    _, u, _ = golden(name)
    _, st = arm_scene()
    u = dict(u, anim_time=np.float32(0.5), **ARM_LIGHTS.get(name, {}))
    c, d = PORT_FRAME[name](st, u, ARM_PARAMS, shadow_size=S)
    _assert_arm_close(name, u, c, d)
    fold = shadows.light_pass_visibility(
        shadows.shadow_params(ARM_PARAMS, S), torch.device("cpu"))

    def light_maps(t):
        maps = []

        def vis(tris, sp):
            out = fold(tris, sp)
            maps.append(out[0])
            return out
        PORT_FRAME[name](st, dict(u, anim_time=np.float32(t)), ARM_PARAMS,
                         shadow_size=S, visibility_fn=vis)
        return torch.stack(maps)

    assert not torch.equal(light_maps(0.0), light_maps(1.0))


def test_animated_geometry_casts_posed_shadows():
    """The port's tests/test_shadows.py case: under an overhead light the
    arm's shadow on the floor moves with the anim_time clock (its light
    pass runs the frame's skinning); both poses' frames within the share
    of JAX's."""
    _, st = arm_scene()
    u = renderer.default_frame_uniforms(W, H)
    u["camera_position"] = np.float32([0.0, 2.0, 1.0])
    u["light_direction"] = np.float32([0.0, -1.0, 0.0])

    def shadow_px(t):
        uu = dict(u, anim_time=np.float32(t))
        c, d = renderer.render_frame_with_shadows(st, uu, ARM_PARAMS,
                                                  shadow_size=S)
        _assert_arm_close("shadows", uu, c, d)
        lum = c[..., :3].mean(-1).numpy()
        return lum < 0.55 * float(np.median(lum))

    s0, s1 = shadow_px(0.0), shadow_px(1.0)
    assert s0.sum() > 10, "no shadow at rest pose"
    assert np.any(s0 != s1), "shadow did not move with the skin pose"


def test_light_pass_fold_choice():
    """K5 folds CUDA light passes under LESS_EQUAL; the CPU and the other
    depth tests take the binned fold, tiled no larger than the map."""
    sp = shadows.shadow_params(RenderParams(W, H), S)
    assert (sp.width, sp.height, sp.cull_mode, sp.tile_h, sp.tile_w) == \
        (S, S, 0, 32, 64)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert shadows.light_pass_visibility(sp, cuda) is \
        vis_fold.visibility_fold
    binned_fn = shadows.light_pass_visibility(sp, cpu)
    assert binned_fn is not vis_fold.visibility_fold
    assert binned_fn.__qualname__.startswith(
        binning.make_binned_visibility.__qualname__)
    greater = sp.replace(depth_test=DepthTest.GREATER)
    assert shadows.light_pass_visibility(greater, cuda) is not \
        vis_fold.visibility_fold
