"""Texture filtering in the port: the bilinear samplers, the bilinear and
trilinear scene shaders, frame_setup's per-triangle LOD (use_mipmaps) and
the mip channels riding the tile route's G-buffer, against the JAX
package's on the CPU, from the same seeded inputs.

Functions are held against JAX run op by op (xp=jnp, eager), where XLA
rounds each operation once as the port does.  Whole frames are held
against JAX's jitted render_frame, which contracts multiply-adds into
FMAs, so they count the share of pixels off."""

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
from softwarerenderer_tpu.ops import raster as jraster
from softwarerenderer_tpu.ops import texture as jtex
from softwarerenderer_tpu.utils import mathlib as ml
from softwarerenderer_tpu_torch import RenderParams, scenes
from softwarerenderer_tpu_torch.engine import (Engine, frame_setup,
                                               renderer)
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import texture, tile_raster


def _atlas_scene():
    """Three textures of different sizes packed in one atlas, with mips."""
    rng = np.random.default_rng(7)
    texs = [np.asarray(jtex.checkerboard(32, 4)["data"]),
            rng.uniform(0, 1, (16, 8, 4)).astype(np.float32),
            rng.uniform(0, 1, (5, 12, 4)).astype(np.float32)]
    return scene_mod.build_scene_buffers([
        scene_mod.MeshInstance(primitives.cube(1.0),
                               ml.translation([1.5 * i, 0, -3]), texture=t)
        for i, t in enumerate(texs)])


def _uvs(n=6000, seed=0):
    """Seeded uv over several wraps of both signs, with texel centres,
    texel edges and whole numbers among them."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    uv[:200] = np.round(uv[:200] * 32) / 32          # texel edges of 32
    uv[200:400] = (np.round(uv[200:400] * 32) + 0.5) / 32   # centres
    uv[400:450] = np.round(uv[400:450])              # whole numbers
    return uv


def _region(sc, n, seed=1):
    rng = np.random.default_rng(seed)
    tid = rng.integers(0, sc["atlas_offsets"].shape[0], n).astype(np.int32)
    return (tid, sc["atlas_offsets"][tid, 0], sc["atlas_offsets"][tid, 1],
            sc["atlas_sizes"][tid, 0], sc["atlas_sizes"][tid, 1])


@pytest.mark.parametrize("rows", ["u8", "f32"])
@pytest.mark.parametrize("sampler", ["region", "atlas", "texture"])
def test_bilinear_samplers_match_jax(sampler, rows):
    """sample_atlas_region_bilinear, sample_atlas_bilinear and
    sample_bilinear on u8 rows (the packed atlas) and f32 rows (a
    panorama may be either), uv over several wraps of both signs: the same
    operations in the same order as JAX's, so equal on every value
    (rtol 0; measured 0)."""
    sc = _atlas_scene()
    uv = _uvs()
    atlas = sc["atlas_data"]
    if rows == "f32":
        atlas = (atlas.astype(np.float32) / np.float32(255.0)) ** 2
    tid, oy, ox, h, w = _region(sc, len(uv))
    t = torch.from_numpy
    if sampler == "region":
        got = texture.sample_atlas_region_bilinear(
            t(atlas), t(oy), t(ox), t(h), t(w), t(uv))
        want = jtex.sample_atlas_region_bilinear(
            jnp.asarray(atlas), oy, ox, h, w, jnp.asarray(uv), xp=jnp)
    elif sampler == "atlas":
        got = texture.sample_atlas_bilinear(
            t(atlas), t(sc["atlas_offsets"]), t(sc["atlas_sizes"]), t(tid),
            t(uv))
        want = jtex.sample_atlas_bilinear(
            jnp.asarray(atlas), sc["atlas_offsets"], sc["atlas_sizes"],
            jnp.asarray(tid), jnp.asarray(uv), xp=jnp)
    else:
        data = atlas[:24, :40].astype(np.float32)
        got = texture.sample_bilinear({"data": t(np.array(data))}, t(uv))
        want = jtex.sample_bilinear({"data": jnp.asarray(data)},
                                    jnp.asarray(uv), xp=jnp)
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == (len(uv), 4)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def test_bilinear_region_of_a_pixel_without_a_triangle():
    """A pixel with no triangle carries h = w = 0: the sampler clamps its
    fetch into the atlas (its value is discarded) and never divides by
    zero; a NaN uv fetches inside the atlas too."""
    sc = _atlas_scene()
    atlas = torch.from_numpy(sc["atlas_data"])
    z = torch.zeros(3, dtype=torch.int32)
    uv = torch.tensor([[0.3, 0.7], [float("nan"), 0.5], [-2.5, 9.0]])
    out = texture.sample_atlas_region_bilinear(atlas, z, z, z, z, uv)
    assert out.shape == (3, 4)
    assert torch.isfinite(out[0]).all() and torch.isfinite(out[2]).all()


def _filter_frag(seed=2, n=3000):
    """A seeded fragment dict over a real atlas with mips, every tri
    channel the filtered shaders read."""
    sc = _atlas_scene()
    rng = np.random.default_rng(seed)
    tid = rng.integers(0, sc["atlas_offsets"].shape[0], n)
    mip0 = rng.integers(0, 3, n)
    flat0 = tid * scene_mod.MAX_MIP_LEVELS + mip0
    flat1 = flat0 + 1
    moff = sc["atlas_mip_offsets"].reshape(-1, 2)
    msiz = sc["atlas_mip_sizes"].reshape(-1, 2)
    tri = {"tex_id": tid.astype(np.int32),
           "mip_frac256": rng.integers(0, 256, n).astype(np.int32)}
    for suffix, flat in (("", flat0), ("2", flat1)):
        tri["tex_oy" + suffix] = moff[flat, 0]
        tri["tex_ox" + suffix] = moff[flat, 1]
        tri["tex_h" + suffix] = msiz[flat, 0]
        tri["tex_w" + suffix] = msiz[flat, 1]
    frag = {"color": rng.uniform(0, 1, (n, 4)).astype(np.float32),
            "uv": rng.uniform(-2, 3, (n, 2)).astype(np.float32),
            "clip_position": rng.uniform(-5, 120, (n, 4)).astype(np.float32),
            "data": {"world_normal":
                     rng.normal(size=(n, 3)).astype(np.float32)},
            "tri": tri}
    u = jr.default_frame_uniforms(64, 48)
    u.update(atlas_data=sc["atlas_data"], atlas_offsets=sc["atlas_offsets"],
             atlas_sizes=sc["atlas_sizes"])
    return frag, u


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return torch.from_numpy(np.array(a.astype(np.float32)
                                     if a.dtype == np.float64 else a))


def _j(tree):
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(tree)


@pytest.mark.parametrize("mode", ["bilinear", "trilinear"])
def test_filtered_shaders_match_jax(mode):
    """The bilinear and trilinear scene shaders on one seeded fragment
    dict, and their registries.  The same operations as JAX's in the same
    order; only the fog's division by (fog_end - fog_start) is rounded by
    two libraries: rtol 1e-6 (measured: equal)."""
    frag, u = _filter_frag()
    got = getattr(renderer, f"scene_fragment_shader_{mode}")(_t(frag),
                                                            _t(u))
    jfn = getattr(jr, f"scene_fragment_shader_{mode}")
    want = np.asarray(jfn(_j(frag), _j(u), jnp))
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    for k in ("varyings", "tri_extras", "alpha_sources"):
        assert getattr(renderer, f"scene_fragment_shader_{mode}")\
            .__dict__[k] == getattr(jfn, k), k
    assert set(jfn.tri_extras) <= set(renderer.PACKED_TRI_EXTRAS)


def _lod_scene():
    """The mip goldens' receding strips and a soup of triangles of every
    size and uv scale over two textures."""
    rng = np.random.default_rng(4)
    soup = primitives.random_triangle_soup(300, seed=5)
    soup["uv"] = (soup["uv"] * rng.uniform(0.1, 40, (len(soup["uv"]), 1))
                  ).astype(np.float32)
    small = rng.uniform(0, 1, (8, 16, 4)).astype(np.float32)
    return scene_mod.build_scene_buffers(
        scenes._strips()[:12] + [scene_mod.MeshInstance(soup,
                                                        texture=small)])


# The LOD block's channels.
MIP_KEYS = {True: ("tex_oy", "tex_ox", "tex_h", "tex_w"),
            "trilinear": ("tex_oy", "tex_ox", "tex_h", "tex_w", "tex_oy2",
                          "tex_ox2", "tex_h2", "tex_w2", "mip_frac256")}


@pytest.mark.parametrize("mode", [True, "trilinear"], ids=["mips",
                                                          "trilinear"])
def test_lod_block_matches_jax(mode, monkeypatch):
    """frame_setup's per-slot mip regions (and the trilinear fraction)
    against JAX render_frame's, captured from its deferred route run op by
    op, on every valid clip-fan slot of two views.  log2 may differ by an
    ulp between XLA and torch: a slot may pick the neighbouring mip only
    where lod + 0.5 (lod, for the trilinear pair) lies within 1e-5 of a
    whole number, or its fraction by one step where frac · 256 lies within
    1e-3 of a half; such slots are counted, and none was measured."""
    sc = _lod_scene()
    shader = jr.scene_fragment_shader_trilinear
    captured = {}

    def capture(tris, fs, uu, p, fb_color, fb_depth, per_tri_extra=None,
                chunk=None):
        captured.update(per_tri_extra, valid=tris["valid"],
                        inv_area=tris["inv_area"])
        return fb_color, fb_depth

    monkeypatch.setattr(jraster, "render_deferred", capture)
    n_slots = near = 0
    for pos, yaw in (([0.0, 0.5, 0.0], 0.0), ([0.7, 3.0, 4.0], 0.4)):
        u = jr.default_frame_uniforms(64, 48)
        u["camera_position"] = np.float32(pos)
        u["camera_rotation"] = ml.quat_from_yaw_pitch_roll(
            np.float32(yaw), np.float32(-0.2), np.float32(0))
        u["far_clip"] = np.float32(2000.0)
        captured.clear()
        jr.render_frame(sc, u, JaxRenderParams(
            width=64, height=48, binned=False, use_mipmaps=mode),
            fragment_shader=shader)
        got = frame_setup(scene_to_torch(sc, "cpu"), u,
                          RenderParams(64, 48, binned=False,
                                       use_mipmaps=mode),
                          fragment_shader=renderer.
                          scene_fragment_shader_trilinear)["per_tri"]
        valid = np.asarray(captured["valid"])
        n_slots += int(valid.sum())
        off = np.zeros(valid.shape, bool)
        for k in MIP_KEYS[mode]:
            assert got[k].dtype == torch.int32, k
            off |= got[k].numpy() != np.asarray(captured[k])
        off &= valid
        if off.any():
            tid = sc["tri_texture_id"].repeat(2)
            e = sc["uv"][sc["indices"]]
            cr = np.abs(np.cross(e[:, 1] - e[:, 0], e[:, 2] - e[:, 0]))
            texels = np.prod(sc["atlas_sizes"][tid], -1)
            lod = 0.5 * np.log2(np.maximum(
                np.repeat(cr, 2) * texels
                * np.abs(np.asarray(captured["inv_area"])), 1.0))
            x = lod if mode == "trilinear" else lod + 0.5
            edge = np.abs(x - np.round(x)) < 1e-5
            if mode == "trilinear":
                f = (lod - np.floor(lod)) * 256
                edge |= np.abs(f - np.floor(f) - 0.5) < 1e-3
            assert edge[off].all(), np.nonzero(off & ~edge)
            near += int(off.sum())
        if mode is True:
            assert not [k for k in got if k.endswith("2")]
    assert n_slots > 300
    assert near <= 0.01 * n_slots


def test_lod_block_picks_more_than_one_mip():
    """The receding strips span several mips (the LOD block is exercised,
    not constant at mip 0), and the trilinear pair brackets the mip the
    plain mode picks or its neighbour."""
    sc = scene_mod.build_scene_buffers(scenes._strips())
    u = jr.default_frame_uniforms(64, 48)
    u["camera_position"] = np.float32([0, 0.5, 0])
    u["far_clip"] = np.float32(2000.0)
    st = scene_to_torch(sc, "cpu")
    one = frame_setup(st, u, RenderParams(64, 48, use_mipmaps=True),
                      fragment_shader=renderer.scene_fragment_shader)
    tri = frame_setup(st, u, RenderParams(64, 48, use_mipmaps="trilinear"),
                      fragment_shader=renderer.
                      scene_fragment_shader_trilinear)
    valid = one["tris"]["valid"]
    widths = set(one["per_tri"]["tex_w"][valid].tolist())
    assert len(widths) >= 3, widths
    w0, w1 = tri["per_tri"]["tex_w"][valid], tri["per_tri"]["tex_w2"][valid]
    assert ((w1 == w0) | (w1 * 2 == w0)).all()
    w = one["per_tri"]["tex_w"][valid]
    assert ((w == w0) | (w == w1)).all()


def test_mip_channels_ride_the_gbuffer_exactly():
    """frame_setup's integer extras cross the tile fold's G-buffer as
    float32 channels and come back as int32: exact for values below 2^24.
    Every slot of a trilinear frame is given the atlas's largest offset
    plus size, 2^24 - 1 and 255 in its mip channels; every covered pixel
    of the tile route reads them back unchanged."""
    sc = _lod_scene()
    st = scene_to_torch(sc, "cpu")
    u = jr.default_frame_uniforms(64, 48)
    u["camera_position"] = np.float32([0.0, 0.5, 0.0])
    params = RenderParams(64, 48, use_mipmaps="trilinear")
    shader = renderer.scene_fragment_shader_trilinear
    f = frame_setup(st, u, params, fragment_shader=shader)
    top = int((sc["atlas_mip_offsets"] + sc["atlas_mip_sizes"]).max())
    want = {"tex_oy2": top, "tex_ox2": 2 ** 24 - 1, "mip_frac256": 255,
            "tex_h2": top - 1}
    per_tri = dict(f["per_tri"])
    for k, v in want.items():
        per_tri[k] = torch.full_like(per_tri[k], v)

    seen = {}

    def shade(frag, uniforms):
        seen.update(frag["tri"])
        return torch.ones(frag["tri"]["tex_w"].shape + (4,))

    shade.varyings = ()
    tile_raster.render_tile(f["tris"], shade, f["uniforms"], params,
                            f["fb_color"], f["fb_depth"],
                            per_tri_extra=per_tri)
    covered = seen["tex_w"] > 0
    assert covered.float().mean() > 0.2
    for k, v in want.items():
        assert seen[k].dtype == torch.int32
        assert (seen[k][covered] == v).all(), k


def _strip_view(w, h):
    """The strips from a camera off texel-edge lines: at the goldens'
    camera (height 1.5 over the floor, 90° FOV) whole rows of pixel
    centres sit exactly on texel edges, where one ulp of XLA's contracted
    interpolation picks the texel (tests/test_torch_goldens.py)."""
    sc = scene_mod.build_scene_buffers(scenes._strips())
    u = jr.default_frame_uniforms(w, h)
    u["camera_position"] = np.float32([0.131, 0.537, -0.29])
    u["camera_rotation"] = ml.quat_from_yaw_pitch_roll(
        np.float32(0.043), np.float32(-0.071), np.float32(0))
    u["far_clip"] = np.float32(2000.0)
    return sc, u


# Share of pixels a filtered frame may have off JAX's jitted frame by more
# than 1e-3 and by more than 2/255, about twice the measured shares
# (test_filtered_frames_match_jax).
FRAME_BOUNDS = {"mips": (2e-3, 2e-3), "trilinear": (3e-3, 2e-3),
                "bilinear": (1.2e-2, 1.5e-3)}


@pytest.mark.parametrize("mode", ["mips", "trilinear", "bilinear"])
def test_filtered_frames_match_jax(mode):
    """Whole frames of the receding strips at 96x64 through Engine against
    JAX's jitted render_frame: use_mipmaps=True with the game's shader,
    "trilinear" with the trilinear shader, and the bilinear shader.  XLA
    contracts the interpolation's multiply-adds, which moves uv (up to
    16 here) by an ulp; bilinear filtering turns that into a change of
    the texel weights 64 times larger (64 texels a unit), so these frames
    are held by their share of pixels off (FRAME_BOUNDS).  Measured, off
    by > 1e-5 / > 1e-3 / > 2/255: mips 0 / 0 / 0; trilinear 24.7 % / 0.15
    % / 0 (at most 2.0e-3); bilinear 27.8 % / 0.59 % / 0.065 % (at most
    0.024); depth equal everywhere."""
    w, h = 96, 64
    sc, u = _strip_view(w, h)
    kw = {"mips": {"use_mipmaps": True},
          "trilinear": {"use_mipmaps": "trilinear"}, "bilinear": {}}[mode]
    shader = {"mips": "scene_fragment_shader",
              "trilinear": "scene_fragment_shader_trilinear",
              "bilinear": "scene_fragment_shader_bilinear"}[mode]
    jc, jd = map(np.asarray, jax.jit(functools.partial(
        jr.render_frame, params=JaxRenderParams(width=w, height=h, **kw),
        fragment_shader=getattr(jr, shader)))(sc, u))
    eng = Engine(sc, RenderParams(w, h, **kw), device="cpu",
                 fragment_shader=getattr(renderer, shader))
    c, d = (t.numpy() for t in eng.render(u))
    diff = np.abs(c - jc).max(-1)
    assert np.isfinite(c).all()
    coarse, texel = FRAME_BOUNDS[mode]
    assert (diff > 1e-3).mean() <= coarse
    assert (diff > 2 / 255).mean() <= texel
    assert (np.abs(d - jd) > 1e-5).mean() <= 1e-3
    assert (d > -3e38).mean() > 0.3
