"""Lighting and PBR: the port's ops.lighting, its mat_* per-triangle
channels, PBR's environment terms and the lit frames (golden config 3,
tests/test_pbr.py's scenes) against the JAX package's on the CPU, from the
same seeded inputs.

Functions are held against JAX run op by op (eager), where XLA rounds each
operation once as the port does.  Whole frames are held against JAX's
jitted render_frame, whose fused light sum XLA reorders and contracts
(3.6e-5 relative at most on config 3's lights, against 5e-7 eagerly), so
they count the share of pixels off."""

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
from softwarerenderer_tpu.models.scene import Light, LightType
from softwarerenderer_tpu.ops import lighting as jl
from softwarerenderer_tpu.ops import raster as jraster
from softwarerenderer_tpu.ops import texture as tex_np
from softwarerenderer_tpu.utils import mathlib as ml
from softwarerenderer_tpu_torch import RenderParams, scenes
from softwarerenderer_tpu_torch.engine import Engine, frame_setup
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import lighting

# accumulate_lights and the shaders against JAX eager: a sum of at most 8
# non-negative terms, each rounded as JAX rounds it but summed in another
# order (5.1e-7 relative measured on 20,000 points).
RTOL = 1e-6


def _t(tree):
    """numpy leaves -> CPU tensors (float64 as float32)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(tree)


# One light of each type, then a mix; "off" packs none.
LIGHT_SETS = {
    "directional": [Light(light_type=LightType.DIRECTIONAL,
                          direction=(0.4, -1.0, -0.3),
                          color=(0.8, 0.8, 0.7))],
    "point": [Light(light_type=LightType.POINT, position=(0, 3, -5),
                    color=(4, 1, 1), attenuation_linear=0.3,
                    attenuation_quadratic=0.05)],
    "spot": [Light(light_type=LightType.SPOT, position=(-5, 6, 0),
                   direction=(0.2, -1, 0.1), color=(3, 3, 3),
                   spot_inner=0.4, spot_outer=0.7)],
    "ambient": [Light(light_type=LightType.AMBIENT, color=(0.2, 0.3, 0.4))],
    "off": [],
    "config3": None,
}


def _lights(name):
    return scenes.CONFIG3_LIGHTS if LIGHT_SETS[name] is None \
        else LIGHT_SETS[name]


def _jax_lights(name):
    """The same records as the JAX package's Light type."""
    return [Light(**{f: getattr(l, f) for f in l.__dataclass_fields__})
            for l in _lights(name)]


def test_pack_lights_matches_jax():
    """Array for array, dtype for dtype: config 3's lights, one with a
    zero direction, and more than max_lights (the rest dropped)."""
    extra = [Light(light_type=LightType.POINT, direction=(0.0, 0.0, 0.0),
                   position=(1, 2, 3))] * 6
    for recs in (scenes.CONFIG3_LIGHTS, scenes.CONFIG3_LIGHTS + extra, []):
        got = lighting.pack_lights(recs)
        want = jl.pack_lights([Light(**{f: getattr(l, f) for f in
                                        l.__dataclass_fields__})
                               for l in recs])
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_device_uniforms_keep_each_host_array():
    """The lights and the other host uniforms reach the shaders with their
    values, shapes and dtypes (float64 as float32), though they cross in
    one copy a dtype; tensors pass as they are."""
    from softwarerenderer_tpu_torch.engine.renderer import (
        default_frame_uniforms, device_uniforms)
    u = scenes.golden_uniforms(3, default_frame_uniforms(32, 18))
    u["spot_range"] = 12.5                       # a float64 scalar
    u["shadow_map"] = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    got = device_uniforms(u, 32, 18, "cpu")
    assert got["shadow_map"] is u["shadow_map"]
    for k in (*lighting.pack_lights(scenes.CONFIG3_LIGHTS), "spot_range",
              "light_direction", "fog_end"):
        want = np.asarray(u[k])
        want = want.astype(np.float32) if want.dtype == np.float64 else want
        assert got[k].numpy().dtype == want.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)


def _points(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    wp = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    wp[:, 1] = rng.uniform(-1, 5, n)
    wp[0] = (0, 3, -5)                 # on the point light: dist == 0
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return wp, nrm


@pytest.mark.parametrize("name", sorted(LIGHT_SETS))
def test_accumulate_lights_matches_jax(name):
    wp, nrm = _points()
    packed = lighting.pack_lights(_lights(name))
    got = lighting.accumulate_lights(_t(wp), _t(nrm), _t(packed)).numpy()
    want = np.asarray(jl.accumulate_lights(
        jnp.asarray(wp), jnp.asarray(nrm),
        _j(jl.pack_lights(_jax_lights(name))), jnp))
    assert got.shape == want.shape == (len(wp), 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    if name == "off":
        assert not got.any()
    else:
        assert (got > 0).any()


def _vertex_inputs(seed=1, n=500):
    rng = np.random.default_rng(seed)
    vin = {"position": rng.normal(size=(n, 3)).astype(np.float32) * 3,
           "uv": rng.uniform(0, 1, (n, 2)).astype(np.float32),
           "normal": rng.normal(size=(n, 3)).astype(np.float32),
           "color": rng.uniform(0, 1, (n, 4)).astype(np.float32)}
    model = np.broadcast_to(
        (ml.matrix_from_yaw_pitch_roll(0.3, 0.2, 0.1)
         @ ml.translation([0.5, -1.0, -4.0])).astype(np.float32),
        (n, 4, 4)).copy()
    u = jr.default_frame_uniforms(64, 48)
    view, proj = jr.camera_matrices(u, 64, 48)
    return vin, {"model": model, "view": np.asarray(view),
                 "projection": np.asarray(proj)}


def test_lit_scene_vertex_shader_matches_jax():
    vin, u = _vertex_inputs()
    got = lighting.lit_scene_vertex_shader(_t(vin), _t(u))
    want = jl.lit_scene_vertex_shader(_j(vin), _j(u), jnp)
    flat = [("clip_position",), ("color",), ("uv",), ("normal",),
            ("data", "world_normal"), ("data", "world_position")]
    for path in flat:
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        # the same operations in the same order: equal, or off by the
        # last bit of the normalisation's division
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-7, err_msg=str(path))
    assert got["data"]["world_position"].shape[-1] == 4


def _shader_frag(seed=2, n=3000):
    """A seeded fragment dict over a real atlas, with every tri channel
    the lit shaders read."""
    checker = np.asarray(tex_np.checkerboard(16, 4)["data"])
    sc = scene_mod.build_scene_buffers([scene_mod.MeshInstance(
        primitives.cube(1.0), texture=checker)])
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    frag = {"color": rng.uniform(0, 1, (n, 4)).astype(np.float32),
            "uv": rng.uniform(-1, 2, (n, 2)).astype(np.float32),
            "clip_position": rng.uniform(-5, 120, (n, 4)).astype(np.float32),
            "data": {"world_normal": nrm,
                     "world_position": np.concatenate(
                         [rng.uniform(-10, 10, (n, 3)),
                          np.ones((n, 1))], -1).astype(np.float32)},
            "tri": {"tex_oy": np.full(n, sc["atlas_offsets"][0, 0], np.int32),
                    "tex_ox": np.full(n, sc["atlas_offsets"][0, 1], np.int32),
                    "tex_h": np.full(n, sc["atlas_sizes"][0, 0], np.int32),
                    "tex_w": np.full(n, sc["atlas_sizes"][0, 1], np.int32)}}
    for k in ("mat_m256", "mat_r256", "mat_er256", "mat_eg256", "mat_eb256",
              "mat_br256", "mat_bg256", "mat_bb256"):
        frag["tri"][k] = rng.integers(0, 257, n).astype(np.int32)
    u = jr.default_frame_uniforms(64, 48)
    u.update(jl.pack_lights(_jax_lights("config3")))
    u["camera_position"] = np.float32([0.5, 2.0, 6.0])
    u["atlas_data"] = sc["atlas_data"]
    return frag, u


@pytest.mark.parametrize("shader", ["multi_light", "pbr"])
def test_lit_fragment_shaders_match_jax(shader):
    """The shaders on one seeded fragment dict.  PBR's torch.pow differs
    from XLA's power by ulps, amplified by the specular exponent (up to
    2048): its pixels are counted, none may be off by more than 1e-3."""
    frag, u = _shader_frag()
    fn = {"multi_light": (lighting.multi_light_fragment_shader,
                          jl.multi_light_fragment_shader),
          "pbr": (lighting.pbr_scene_fragment_shader,
                  jl.pbr_scene_fragment_shader)}[shader]
    got = fn[0](_t(frag), _t(u)).numpy()
    want = np.asarray(fn[1](_j(frag), _j(u), jnp))
    assert got.shape == want.shape and np.isfinite(got).all()
    if shader == "multi_light":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    else:
        off = np.abs(got - want) > 1e-5 + RTOL * np.abs(want)
        assert off.any(-1).mean() <= 0.01
        assert np.abs(got - want).max() <= 1e-3
    for k in ("varyings", "tri_extras", "alpha_sources"):
        assert getattr(fn[0], k) == getattr(fn[1], k), k


def _material_scene():
    """Four meshes whose material values sit on and off the 1/256 grid:
    (k + 0.5) / 256 exactly (round half to even), values past the 1020
    clip and below 0."""
    mats = [scene_mod.Material(base_color=(3.5 / 256, 4.5 / 256, 1.0, 1.0),
                               metallic=0.5 / 256, roughness=1.5 / 256,
                               emissive=(2.5 / 256, 255.5 / 256, 0.0)),
            scene_mod.Material(base_color=(0.3, 0.7, 0.999, 1.0),
                               metallic=1.0, roughness=0.15,
                               emissive=(5.0, -0.2, 3.9921875)),
            scene_mod.Material(),
            scene_mod.Material(metallic=127.5 / 256, roughness=0.0,
                               emissive=(1019.5 / 256, 1020.5 / 256, 0.1))]
    return scene_mod.build_scene_buffers([
        scene_mod.MeshInstance(primitives.cube(1.0),
                               ml.translation([1.5 * i - 2, 0, -4]),
                               material=m)
        for i, m in enumerate(mats)])


def test_material_channels_match_jax(monkeypatch):
    """frame_setup's mat_* channels equal JAX render_frame's, as integers,
    the half-to-even and clipped values included."""
    sc = _material_scene()
    params = RenderParams(64, 48, binned=False)
    u = jr.default_frame_uniforms(64, 48)
    captured = {}

    def capture(tris, fs, uu, p, fb_color, fb_depth, per_tri_extra=None,
                chunk=None):
        captured.update(per_tri_extra)
        return fb_color, fb_depth

    monkeypatch.setattr(jraster, "render_deferred", capture)
    jr.render_frame(sc, u, JaxRenderParams(width=64, height=48,
                                           binned=False),
                    vertex_shader=jl.lit_scene_vertex_shader,
                    fragment_shader=jl.pbr_scene_fragment_shader)
    got = frame_setup(scene_to_torch(sc, "cpu"), u, params,
                      lighting.lit_scene_vertex_shader,
                      lighting.pbr_scene_fragment_shader)["per_tri"]
    assert sorted(got) == sorted(captured)
    for k, v in captured.items():
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    m = got["mat_m256"].numpy()
    assert {0, 128, 256} <= set(m.tolist())          # 0.5 -> 0, 127.5 -> 128
    assert got["mat_er256"].numpy().max() == 1020    # the clip
    assert got["mat_eg256"].numpy().min() == 0
    # a shader without the channels gets none of them
    plain = frame_setup(scene_to_torch(sc, "cpu"), u, params)["per_tri"]
    assert not [k for k in plain if k.startswith("mat_")]


def _lit_engine(scene, params, fragment_shader):
    return Engine(scene, params, device="cpu",
                  vertex_shader=lighting.lit_scene_vertex_shader,
                  fragment_shader=fragment_shader)


def test_config3_frame_matches_jax():
    """Golden config 3 (41 meshes, four lights, the lit shaders) at
    160x90 through render_frame, the tile route and the deferred route,
    against JAX's jitted render_frame.  Measured: 0.39 % of pixels off by
    more than 1e-3, where config 3's camera puts floor pixel centres on
    texel edges and one ulp picks the other texel (the game's shader
    shows the same pixels), and 2.4 % more off by at most 2e-4, XLA's
    fused light sum (module docstring); depth 0.056 %."""
    w, h = 160, 90
    sc = scene_mod.build_scene_buffers(scenes.golden_config(3))
    u = scenes.golden_uniforms(3, jr.default_frame_uniforms(w, h))
    jc, jd = map(np.asarray, jax.jit(functools.partial(
        jr.render_frame, params=JaxRenderParams(width=w, height=h,
                                                use_pallas=False),
        vertex_shader=jl.lit_scene_vertex_shader,
        fragment_shader=jl.multi_light_fragment_shader))(sc, u))
    for route in ({}, {"use_pallas": False}):
        eng = _lit_engine(sc, RenderParams(w, h, **route),
                          lighting.multi_light_fragment_shader)
        c, d = (t.numpy() for t in eng.render(u))
        assert np.isfinite(c).all()
        diff = np.abs(c - jc).max(-1)
        assert (diff > 1e-5).mean() <= 0.035, route
        assert (diff > 1e-3).mean() <= 0.005, route
        assert (np.abs(d - jd) > 1e-5).mean() <= 1e-3, route
        assert (d > -3e38).mean() > 0.3


def _pbr_case(name):
    """tests/test_pbr.py's scenes and uniforms: a glossy metal sphere
    under the key light, and an emissive cube with the light off."""
    if name == "metal":
        mesh = primitives.uv_sphere(1.0, rings=24, sectors=48)
        mat = scene_mod.Material(base_color=(0.6, 0.6, 0.6, 1.0),
                                 metallic=1.0, roughness=0.15)
    else:
        mesh = primitives.cube(1.2)
        mat = scene_mod.Material(base_color=(1, 1, 1, 1),
                                 emissive=(0.0, 0.9, 0.0))
    sc = scene_mod.build_scene_buffers([scene_mod.MeshInstance(
        mesh, ml.translation([0, 0, -3.0]), material=mat)])
    u = jr.default_frame_uniforms(160, 120)
    if name == "metal":
        ld = np.float32([0.3, -0.5, -1.0])
        u["light_direction"] = ld / np.linalg.norm(ld)
    else:
        u["light_color"] = np.zeros(4, np.float32)
    u["fog_start"], u["fog_end"] = np.float32(900.0), np.float32(1000.0)
    return sc, u


@pytest.mark.parametrize("name", ["metal", "emissive"])
def test_pbr_frame_matches_jax(name):
    """tests/test_pbr.py's frames at 160x120 against JAX's: at most 0.2 %
    of pixels off by more than 1e-5 and none by more than 1e-3 (measured:
    metal 0.099 %, at most 3.8e-5, torch.pow against XLA's power;
    emissive 0), depth on at most 0.2 % (0.078 % measured: edge pixels)."""
    sc, u = _pbr_case(name)
    jc, jd = map(np.asarray, jax.jit(functools.partial(
        jr.render_frame, params=JaxRenderParams(width=160, height=120,
                                                use_pallas=False),
        vertex_shader=jl.lit_scene_vertex_shader,
        fragment_shader=jl.pbr_scene_fragment_shader))(sc, u))
    eng = _lit_engine(sc, RenderParams(160, 120),
                      lighting.pbr_scene_fragment_shader)
    c, d = (t.numpy() for t in eng.render(u))
    diff = np.abs(c - jc).max(-1)
    assert (diff > 1e-5).mean() <= 2e-3
    assert diff.max() <= 1e-3
    assert (np.abs(d - jd) > 1e-5).mean() <= 2e-3
    covered = d > -3e38
    assert covered.mean() > 0.04
    if name == "emissive":
        assert np.median(c[covered][..., 1]) > 0.8       # the green glow


def _env_maps():
    """tests/test_pbr.py's environment: a red-top, blue-bottom sky and the
    port's irradiance map of a red upper hemisphere."""
    from softwarerenderer_tpu_torch.ops.sky import irradiance_panorama
    pano = np.zeros((32, 64, 4), np.float32)
    pano[:16] = [1, 0, 0, 1]
    pano[16:] = [0, 0, 1, 1]
    red = np.zeros((32, 64, 4), np.float32)
    red[:16] = [1, 0, 0, 1]
    return pano, irradiance_panorama(red)


def test_pbr_shader_environment_terms_match_jax():
    """The PBR shader with env_panorama and env_irradiance on the seeded
    fragment dict against JAX's op by op: the reflection and the normal's
    lookups add atan2 and asin, rounded by two libraries, to torch.pow's
    ulps; the pixels are counted as test_lit_fragment_shaders_match_jax
    counts them (at most 1 % off by more than 1e-5 + 1e-6 relative, none
    by more than 1e-3; measured: none off, at most 2.4e-7)."""
    frag, u = _shader_frag()
    pano, irr = _env_maps()
    u = dict(u, env_panorama=pano, env_irradiance=irr)
    got = lighting.pbr_scene_fragment_shader(_t(frag), _t(u)).numpy()
    want = np.asarray(jl.pbr_scene_fragment_shader(_j(frag), _j(u), jnp))
    bare = lighting.pbr_scene_fragment_shader(
        _t(frag), _t({k: v for k, v in u.items()
                      if not k.startswith("env_")})).numpy()
    assert np.abs(got - bare).max() > 0.1              # the terms add light
    off = np.abs(got - want) > 1e-5 + RTOL * np.abs(want)
    assert off.any(-1).mean() <= 0.01
    assert np.abs(got - want).max() <= 1e-3


@pytest.mark.parametrize("key", ["env_panorama", "env_irradiance"])
def test_pbr_environment_uniforms_raise(key):
    """The name is kept from when these uniforms were refused; the
    environment terms are ported now, so each renders and is held against
    JAX on tests/test_pbr.py's scenes at 96x64 (through Engine, the tile
    route): env_panorama as the metal sphere under the red-top,
    blue-bottom sky, which reaches the shader from sky_panorama through
    the sky stage (test_metal_reflects_sky_panorama); env_irradiance as a
    white dielectric sphere lit only by the irradiance of a red upper
    hemisphere (test_irradiance_ambient_lights_diffuse).  Each keeps the
    JAX test's own checks; against JAX's jitted frame at most 1 % of
    pixels off by more than 1e-5 and none by more than 1e-3, as the PBR
    frames above (measured: none off, at most 1.9e-6 with the panorama
    and 1.8e-7 with the irradiance), depth on at most 0.2 % (measured
    0.05 %: edge pixels)."""
    w, h = 96, 64
    pano, irr = _env_maps()
    if key == "env_panorama":
        mat = scene_mod.Material(base_color=(1, 1, 1, 1.0), metallic=1.0,
                                 roughness=0.05)
    else:
        mat = scene_mod.Material(base_color=(1, 1, 1, 1.0), metallic=0.0,
                                 roughness=1.0)
    sc = scene_mod.build_scene_buffers([scene_mod.MeshInstance(
        primitives.uv_sphere(1.0, rings=24, sectors=48),
        ml.translation([0, 0, -3.0]), material=mat)])
    u = jr.default_frame_uniforms(w, h)
    u["light_color"] = np.zeros(4, np.float32)          # environment only
    u["fog_start"], u["fog_end"] = np.float32(900.0), np.float32(1000.0)
    u2 = dict(u, **({"sky_panorama": pano} if key == "env_panorama"
                    else {"env_irradiance": irr}))
    jc, jd = map(np.asarray, jax.jit(functools.partial(
        jr.render_frame, params=JaxRenderParams(width=w, height=h,
                                                use_pallas=False),
        vertex_shader=jl.lit_scene_vertex_shader,
        fragment_shader=jl.pbr_scene_fragment_shader))(sc, u2))
    eng = _lit_engine(sc, RenderParams(w, h),
                      lighting.pbr_scene_fragment_shader)
    c, d = (t.numpy() for t in eng.render(u2))
    c0, _ = (t.numpy() for t in eng.render(u))
    diff = np.abs(c - jc).max(-1)
    assert (diff > 1e-5).mean() <= 0.01 and diff.max() <= 1e-3
    assert (np.abs(d - jd) > 1e-5).mean() <= 2e-3
    covered = d > -3e38
    assert covered.mean() > 0.04
    if key == "env_panorama":
        assert c0[covered][..., :3].max() < 0.05       # unlit metal: black
        red, blue = c[..., 0] * covered, c[..., 2] * covered
        assert red.max() > 0.5 and blue.max() > 0.5    # both hues mirrored
        ys, _ = np.nonzero(red > 0.5)
        assert ys.mean() < np.nonzero(covered)[0].mean()
        assert (np.abs(c - c0).max(-1)[~covered] > 0.1).mean() > 0.9  # sky
    else:
        ys, xs = np.nonzero(covered)
        top = ys < np.median(ys)
        assert c[ys[top], xs[top], 0].mean() \
            > c[ys[~top], xs[~top], 0].mean() + 0.1    # lit from above, red
        assert c[covered][..., 2].max() < 0.15         # no blue anywhere
