"""The tile route's shading kernel (csrc/tile_shade.cu, ops/tile_shade.py)
against its plain twin, tile_raster.shade_plain.

On the CPU the eager body is what runs: its frames are held against the
JAX package's shading of the tile route (pallas_tile's frag_from_planes,
the scene shader run op by op, the blend and selects), for both scene
shaders, shade_rate 1 and 2, ALPHA and NONE blending, pixels with no
winner, negative, whole and NaN uv and a frame that is not a whole number
of tiles; nothing launches, and the kernel's wrapper refuses what the
kernel does not take.

On the card (marked ``card``; each test skips without one, the check made
in a fixture):

    python -m pytest tests/test_torch_shade_kernel.py -q -m card

the kernel equals the eager body bit for bit on color and depth for both
fetches at 3840 x 2160 and three small or odd sizes, shade_rate 1 and 2,
all four blend modes; it makes no hidden wait
(torch.cuda.set_sync_debug_mode("error")); it launches once per
render_tile of a scene shader, and the frame equals the eager body's; a
shader without the fused form and the K-buffer, deferred and forward
routes launch none."""

import functools

import numpy as np
import pytest
import torch

from softwarerenderer_tpu_torch import RenderParams, scenes, shaders
from softwarerenderer_tpu_torch.config import BlendMode
from softwarerenderer_tpu_torch.engine import Engine, renderer
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import (lighting, normalmap, shadows,
                                            tile_raster, tile_shade)

SHADERS = {"nearest_region": renderer.scene_fragment_shader,
           "trilinear_regions": renderer.scene_fragment_shader_trilinear}
# (H, W): the image-quality cell's supersampled frame, then small and odd
# frames (every height even, for shade_rate 2).
SIZES = ((2160, 3840), (34, 130), (6, 5), (2, 257))
# The atlas's texture regions (oy, ox, h, w), powers of two and not, and
# one texel.
REGIONS = ((0, 0, 32, 32), (32, 0, 16, 8), (32, 8, 5, 12), (40, 24, 7, 3),
           (48, 40, 1, 1), (0, 32, 24, 64))
ATLAS = (64, 96)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.cuda.get_device_name(0)


def _layout(fetch: str):
    """gb_slices and extra_keys as tile_raster.pack_payload lays out the
    scene shaders' G-buffer: clip z, color, the world normal, uv, then the
    triangle channels in sorted order."""
    sl = {"clip_z": (0, 1), "color": (1, 5), "data.world_normal": (5, 8),
          "uv": (8, 10)}
    extra = sorted(tile_shade.TRI_CHANNELS[fetch])
    for j, k in enumerate(extra):
        sl["tri." + k] = (10 + j, 11 + j)
    return sl, extra


@functools.lru_cache(maxsize=8)
def _host_inputs(h: int, w: int, fetch: str, seed: int):
    """Seeded host arrays of one shading pass at h x w, in G-buffers padded
    to whole 32 x 128 tiles: winners (-1 on about a quarter of the pixels,
    whose channels are 0 as the fold writes them), vertex colors with
    alpha 0 on some pixels, uv over several wraps of both signs with
    whole numbers, texel edges, -0.0, inf and NaN among them, regions of
    the atlas (mips of the trilinear fetch beside them), depths across
    the fog, and the atlas with alphas 0, partial and opaque."""
    g = np.random.default_rng(seed)
    hp, wp = -(-h // 32) * 32, -(-w // 128) * 128
    sl, extra = _layout(fetch)
    gbuf = g.random((10 + len(extra), hp, wp), dtype=np.float32) * 4 - 2
    n = h * w
    color = g.uniform(0, 1.2, (n, 4))
    color[g.uniform(size=n) < 0.1, 3] = 0.0
    uv = g.uniform(-3, 3, (n, 2))
    uv[::7] = np.round(uv[::7])
    uv[1::7] = np.round(uv[1::7] * 32) / 32
    uv[2::23] = np.nan
    uv[3::29, 0] = np.inf
    uv[4::31, 1] = -0.0
    normal = g.normal(size=(n, 3))
    z = g.uniform(-5, 130, n)
    reg = np.asarray(REGIONS)[g.integers(0, len(REGIONS), n)]
    tri = {"tex_oy": reg[:, 0], "tex_ox": reg[:, 1], "tex_h": reg[:, 2],
           "tex_w": reg[:, 3]}
    if fetch == "trilinear_regions":
        reg2 = np.asarray(REGIONS)[g.integers(0, len(REGIONS), n)]
        tri.update(tex_oy2=reg2[:, 0], tex_ox2=reg2[:, 1],
                   tex_h2=reg2[:, 2], tex_w2=reg2[:, 3],
                   mip_frac256=g.integers(0, 257, n))
    chans = {"clip_z": z[:, None], "color": color,
             "data.world_normal": normal, "uv": uv}
    chans.update({"tri." + k: v[:, None] for k, v in tri.items()})
    best_i = g.integers(0, 5000, (hp, wp)).astype(np.int32)
    best_i[g.uniform(size=(hp, wp)) < 0.25] = -1
    none = best_i[:h, :w].reshape(-1) < 0
    for k, (lo, hi) in sl.items():
        v = chans[k].astype(np.float32)
        v[none] = 0.0
        gbuf[lo:hi, :h, :w] = v.T.reshape(hi - lo, h, w)
    best_d = g.uniform(-1, 0, (hp, wp)).astype(np.float32)
    atlas = g.integers(0, 256, ATLAS + (4,)).astype(np.uint8)
    atlas[..., 3] = g.choice([0, 128, 255], ATLAS)
    fb_color = g.uniform(0, 1, (h, w, 4)).astype(np.float32)
    fb_depth = g.uniform(-1, 0, (h, w)).astype(np.float32)
    return gbuf, best_i, best_d, atlas, fb_color, fb_depth


def _uniforms(device):
    ld = np.float32([0.5, -1.0, -0.3])
    u = {"light_direction": ld / np.linalg.norm(ld),
         "light_color": np.float32([1.0, 0.9, 0.8, 1.0]),
         "fog_color": np.float32([0.45, 0.64, 0.76, 1.0]),
         "fog_start": np.float32(40.0), "fog_end": np.float32(100.0)}
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in u.items()}


def _inputs(h, w, fetch, device, blend=BlendMode.ALPHA, sr=1, seed=0,
            expanded=True):
    """(ctx, gbuf, best_d, best_i, uniforms, params, fb_color, fb_depth)
    on `device`: _host_inputs' arrays, the lighting and fog uniforms
    staged as tensors, and the clear color expanded over the frame (as
    frame_setup passes it) or a frame of colors."""
    gbuf, best_i, best_d, atlas, fb_c, fb_d = _host_inputs(h, w, fetch, seed)
    t = functools.partial(torch.tensor, device=device)
    sl, extra = _layout(fetch)
    ctx = {"gb_slices": sl, "extra_keys": extra, "H": h, "W": w}
    u = dict(_uniforms(device), atlas_data=t(atlas))
    fb_color = t(fb_c) if not expanded else \
        t([0.1, 0.2, 0.3, 1.0]).expand(h, w, 4)
    params = RenderParams(w, h, blend_mode=blend, shade_rate=sr)
    return (ctx, t(gbuf), t(best_d), t(best_i), u, params, fb_color,
            t(fb_d))


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def _eager_twin(shader):
    """The shader as a user shader with the same registries and no fused
    form: render_tile shades it with the eager body."""
    def twin(frag, uniforms):
        return shader(frag, uniforms)
    for k in ("varyings", "tri_extras", "alpha_sources"):
        setattr(twin, k, getattr(shader, k))
    return twin


def _reset():
    tile_shade.LAUNCHES.update(dict.fromkeys(tile_shade.FETCHES, 0))


# ---------------------------------------------------------------------------
# On the CPU


def test_scene_shaders_declare_their_fused_form():
    """The two scene shaders declare their fetch beside their registries,
    reading what the kernel reads; no other shader declares one."""
    for fetch, shader in SHADERS.items():
        assert shader.tile_shade == fetch
        assert {k for k, _ in tile_shade.VARYINGS} <= set(shader.varyings)
        assert set(tile_shade.TRI_CHANNELS[fetch]) <= set(shader.tri_extras)
    for shader in (renderer.scene_fragment_shader_bilinear,
                   shaders.default_fragment_shader,
                   shaders.flat_color_fragment_shader,
                   lighting.pbr_scene_fragment_shader,
                   lighting.multi_light_fragment_shader,
                   normalmap.normal_mapped_fragment_shader,
                   shadows.shadowed_scene_fragment_shader):
        assert not hasattr(shader, "tile_shade"), shader.__name__


@pytest.mark.parametrize("fetch", list(SHADERS))
def test_planes_of_reads_the_packed_layout(fetch):
    """planes_of gives each channel's plane from the layout the tile route
    packs for the shader (a real frame's ctx), None when one is missing;
    fused_fetch takes the kernel only for a CUDA G-buffer."""
    scene, params, u, _ = scenes.feature_golden_frame("trilinear")
    params = params.replace(width=64, height=48)
    f = renderer.frame_setup(scene_to_torch(scene, "cpu"), u, params,
                             fragment_shader=SHADERS[fetch])
    ctx = tile_raster._prepare_for(f["tris"], SHADERS[fetch], params,
                                   f["fb_depth"], f["per_tri"])
    sl = ctx["gb_slices"]
    planes = tile_shade.planes_of(ctx, fetch)
    want = [sl["color"][0], sl["uv"][0], sl["data.world_normal"][0],
            sl["clip_z"][0]] + [sl["tri." + k][0]
                                for k in tile_shade.TRI_CHANNELS[fetch]]
    assert planes == want and len(set(planes)) == len(planes)
    gbuf = torch.zeros((ctx["kpi"], 2, 2))
    assert tile_shade.fused_fetch(SHADERS[fetch], ctx, gbuf) is None
    for key in ("uv", "tri.tex_w", "clip_z"):
        less = dict(ctx, gb_slices={k: v for k, v in sl.items() if k != key})
        assert tile_shade.planes_of(less, fetch) is None, key
    with pytest.raises(ValueError, match="unknown fetch"):
        tile_shade.planes_of(ctx, "anisotropic")


def test_cpu_frames_launch_no_shade_kernel():
    """On the CPU a scene shader's frame, a shader without the fused form
    and a K-buffer frame run the eager body: the counters stay at 0."""
    _reset()
    for name in ("mips", "trilinear"):
        scene, params, u, kw = scenes.feature_golden_frame(name)
        small = params.replace(width=80, height=60)
        shader = kw.get("fragment_shader", renderer.scene_fragment_shader)
        for p, fs in ((small, shader), (small, _eager_twin(shader)),
                      (small.replace(kbuffer=2), shader)):
            color, _ = Engine(scene, p, device="cpu",
                              fragment_shader=fs).render(u)
            assert color.shape == (60, 80, 4)
    assert tile_shade.LAUNCHES == dict.fromkeys(tile_shade.FETCHES, 0)


def _jax_shade(ctx, gbuf, best_d, best_i, fetch, uniforms, blend, sr,
               fb_color, fb_depth):
    """The JAX package's shading of the tile route (render_tile_pallas
    after its kernel), op by op on the same numpy inputs."""
    import jax.numpy as jnp
    from softwarerenderer_tpu.engine import renderer as jr
    from softwarerenderer_tpu.ops import pallas_tile
    from softwarerenderer_tpu.ops.raster import _blend
    shader = {"nearest_region": jr.scene_fragment_shader,
              "trilinear_regions": jr.scene_fragment_shader_trilinear}[fetch]
    H, W = ctx["H"], ctx["W"]
    ju = {k: jnp.asarray(v.numpy()) for k, v in uniforms.items()}
    g = jnp.asarray(gbuf.numpy())
    color = shader(pallas_tile._frag_from_planes(ctx, g[:, :H:sr, :W]), ju,
                   jnp)
    color = jnp.repeat(color, sr, 0)
    written = (jnp.asarray(best_i.numpy())[:H, :W] >= 0) \
        & (color[..., 3] > 0)
    fb_c, fb_d = jnp.asarray(fb_color.numpy()), jnp.asarray(fb_depth.numpy())
    out_c = jnp.where(written[..., None], _blend(color, fb_c, blend), fb_c)
    out_d = jnp.where(written, jnp.asarray(best_d.numpy())[:H, :W], fb_d)
    return np.asarray(out_c), np.asarray(out_d)


@pytest.mark.parametrize("blend", [BlendMode.ALPHA, BlendMode.NONE],
                         ids=["alpha", "none"])
@pytest.mark.parametrize("sr", [1, 2])
@pytest.mark.parametrize("fetch", list(SHADERS))
def test_cpu_shading_matches_jax(fetch, sr, blend):
    """The eager body on the CPU (render_tile's shading, unchanged) against
    the JAX package's, from the same G-buffer at 18 x 37 (one partial
    tile): the same operations in the same order, so equal up to the
    fog's division, rounded by two libraries (rtol 1e-6, as
    test_torch_texture_filtering holds the shaders; measured equal).
    Pixels with no winner keep the framebuffer; NaN uv never writes."""
    ctx, gbuf, bd, bi, u, params, fb_c, fb_d = _inputs(
        18, 37, fetch, "cpu", blend, sr, seed=sr, expanded=sr == 1)
    got_c, got_d = tile_raster.shade_plain(ctx, gbuf, bd, bi, SHADERS[fetch],
                                           u, params, fb_c, fb_d)
    want_c, want_d = _jax_shade(ctx, gbuf, bd, bi, fetch, u, blend, sr,
                                fb_c, fb_d)
    assert got_c.shape == (18, 37, 4) and got_d.shape == (18, 37)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    none = (bi[:18, :37] < 0).numpy()
    assert none.any() and (~none).any()
    np.testing.assert_array_equal(got_c.numpy()[none],
                                  fb_c.numpy()[none])
    assert (got_d.numpy() != fb_d.numpy()).any()


@pytest.mark.parametrize("case,match", [
    ("cpu", "must be a CUDA tensor"),
    ("fetch", "unknown fetch"),
    ("channel", "lacks a channel"),
    ("shade_rate", "divisible"),
])
def test_wrapper_refuses(case, match):
    """tile_shade.shade takes CUDA tensors only (there is no fallback to
    the eager body inside it), a known fetch, a G-buffer holding its
    channels and a shade_rate dividing the height."""
    ctx, gbuf, bd, bi, u, params, fb_c, fb_d = _inputs(6, 5, "nearest_region",
                                                       "cpu")
    fetch = "nearest_region"
    if case == "fetch":
        fetch = "cubic"
    elif case == "channel":
        ctx = dict(ctx, gb_slices={k: v for k, v in ctx["gb_slices"].items()
                                   if k != "tri.tex_h"})
    elif case == "shade_rate":
        params = params.replace(shade_rate=4)
    _reset()
    with pytest.raises(ValueError, match=match):
        tile_shade.shade(fetch, ctx, gbuf, bd, bi, u, params, fb_c, fb_d)
    assert tile_shade.LAUNCHES == dict.fromkeys(tile_shade.FETCHES, 0)


# ---------------------------------------------------------------------------
# On the card


@pytest.mark.card
@pytest.mark.parametrize("blend", list(BlendMode), ids=lambda b: b.name)
@pytest.mark.parametrize("sr", [1, 2])
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("fetch", list(SHADERS))
def test_kernel_equals_eager_body(card, fetch, size, sr, blend):
    """The kernel's color and depth equal the eager body's bit for bit,
    and the call launches the kernel once; the clear color expanded over
    the frame under NONE and ALPHA, a frame of colors under ADDITIVE and
    MULTIPLY."""
    h, w = size
    args = _inputs(h, w, fetch, "cuda", blend, sr, seed=h + w + sr,
                   expanded=blend in (BlendMode.NONE, BlendMode.ALPHA))
    ctx, gbuf, bd, bi, u, params, fb_c, fb_d = args
    n0 = tile_shade.LAUNCHES[fetch]
    got_c, got_d = tile_shade.shade(fetch, *args)
    assert tile_shade.LAUNCHES[fetch] == n0 + 1
    want_c, want_d = tile_raster.shade_plain(ctx, gbuf, bd, bi,
                                             SHADERS[fetch], u, params, fb_c,
                                             fb_d)
    torch.cuda.synchronize()
    for name, got, want in (("color", got_c, want_c),
                            ("depth", got_d, want_d)):
        assert _bits_equal(got, want), (
            f"{fetch} {h}x{w} sr={sr} {blend.name} {name}: "
            f"{int((got != want).sum())} values differ, max "
            f"{float((got - want).abs().nan_to_num().max()):.3g} [{card}]")
    written = (got_d != fb_d)
    assert written.any() and (~written).any()


@pytest.mark.card
@pytest.mark.parametrize("fetch", list(SHADERS))
def test_kernel_makes_no_hidden_wait(card, fetch):
    """The launch on staged uniforms makes no call that waits for the card
    (sync debug mode "error")."""
    args = _inputs(34, 130, fetch, "cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tile_shade.shade(fetch, *args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ctx, gbuf, bd, bi, u, params, fb_c, fb_d = args
    want = tile_raster.shade_plain(ctx, gbuf, bd, bi, SHADERS[fetch], u,
                                   params, fb_c, fb_d)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))


def _golden(fetch):
    scene, params, u, _ = scenes.feature_golden_frame(
        {"nearest_region": "mips", "trilinear_regions": "trilinear"}[fetch])
    return scene, params, u


@pytest.mark.card
@pytest.mark.parametrize("sr", [1, 2])
@pytest.mark.parametrize("fetch", list(SHADERS))
def test_render_tile_launches_once(card, fetch, sr):
    """A frame of the feature goldens through Engine on the card (320 x
    240, the tile route) launches the kernel once per render_tile and
    equals the frame of the same shader without its fused form."""
    scene, params, u = _golden(fetch)
    params = params.replace(shade_rate=sr)
    frames = []
    for fs in (SHADERS[fetch], _eager_twin(SHADERS[fetch])):
        eng = Engine(scene, params, device="cuda", fragment_shader=fs)
        n0 = dict(tile_shade.LAUNCHES)
        frames.append(eng.render(u))
        torch.cuda.synchronize()
        n = {k: tile_shade.LAUNCHES[k] - n0[k] for k in n0}
        want = dict.fromkeys(tile_shade.FETCHES, 0)
        if fs is SHADERS[fetch]:
            want[fetch] = 1
        assert n == want
    (c, d), (ec, ed) = frames
    assert _bits_equal(c, ec) and _bits_equal(d, ed)
    assert (d > -3e38).float().mean() > 0.2


@pytest.mark.card
@pytest.mark.parametrize("route", ["kbuffer", "deferred", "forward"])
def test_other_routes_launch_none(card, route):
    """The K-buffer, deferred and forward routes shade with the eager body
    whatever the shader declares: no shade kernel launches."""
    scene, params, u = _golden("trilinear_regions")
    params = {"kbuffer": params.replace(kbuffer=2),
              "deferred": params.replace(use_pallas=False),
              "forward": params.replace(deferred=False)}[route]
    eng = Engine(scene, params, device="cuda",
                 fragment_shader=renderer.scene_fragment_shader_trilinear)
    n0 = dict(tile_shade.LAUNCHES)
    color, _ = eng.render(u)
    torch.cuda.synchronize()
    assert tile_shade.LAUNCHES == n0
    assert torch.isfinite(color).all()
