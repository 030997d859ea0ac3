"""The deferred route and the debug views: the port's render_deferred (K5's
twin, the binned fold and the brute force), render_wireframe_deferred,
ops.debugviz and render_frame's new routes against the JAX package on the
same numpy inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softwarerenderer_tpu import shaders as jsh
from softwarerenderer_tpu.config import (BlendMode, CullMode, DebugMode,
                                         DepthTest)
from softwarerenderer_tpu.engine import renderer as jr
from softwarerenderer_tpu.models import primitives
from softwarerenderer_tpu.models import scene as scene_mod
from softwarerenderer_tpu.ops import debugviz as jdebug
from softwarerenderer_tpu.ops import geometry as jgeom
from softwarerenderer_tpu.ops import raster as jraster
from softwarerenderer_tpu.ops import texture as tex_np
from softwarerenderer_tpu.utils import mathlib as ml
from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch import shaders as tsh
from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.ops import debugviz, raster, vis_fold

W, H = 64, 48
CLEAR = np.asarray([0.2, 0.3, 0.4, 1.0], np.float32)
FLT_MAX = np.finfo(np.float32).max
MONOTONE = [DepthTest.LESS_EQUAL, DepthTest.LESS, DepthTest.GREATER,
            DepthTest.GREATER_EQUAL, DepthTest.ALWAYS, DepthTest.DISABLED]


def soup_tris(n=30, seed=7, width=W, height=H):
    """JAX-built triangles of tests/test_device_raster.py's depth-mode soup
    (default shaders, camera at (0, 0, 3)) as numpy arrays, and their
    uniforms."""
    mesh = primitives.random_triangle_soup(n, seed=seed)
    vin = jsh.make_vertex_input(mesh["position"], mesh["uv"],
                                mesh["normal"], mesh["color"])
    u = {"model": np.eye(4, dtype=np.float32),
         "view": ml.look_at(np.float32([0, 0, 3]), [0, 0, 0], [0, 1, 0]),
         "projection": ml.perspective_fov(np.deg2rad(60.0), width / height,
                                          0.1, 100.0),
         "near_clip": np.float32(0.1)}
    tris = jax.jit(lambda v, i, u: jgeom.build_triangles(
        jsh.default_vertex_shader, v, i, u, width=width, height=height,
        cull_mode=CullMode.NONE))(vin, mesh["indices"], u)
    return jax.tree_util.tree_map(np.asarray, tris), u


def to_torch(tris):
    out = {k: torch.tensor(tris[k]) for k in ("screen", "depth", "inv_area",
                                               "valid", "bbox")}
    out["attrs"] = {k: torch.tensor(v) for k, v in tris["attrs"].items()}
    return out


def seed_depth(mode):
    """tests/test_device_raster.py:127-157's seeds: GREATER_* need a
    MaxValue-cleared buffer to draw anything."""
    fill = FLT_MAX if mode in (DepthTest.GREATER, DepthTest.GREATER_EQUAL) \
        else np.finfo(np.float32).min
    return np.full((H, W), fill, np.float32)


def assert_frames_close(c, d, jc, jd, max_frac):
    """At most max_frac of the pixels differ by > 1e-5 in color or depth;
    the frame is not empty."""
    assert np.isfinite(c).all()
    assert (np.abs(c - jc).max(-1) > 1e-5).mean() <= max_frac
    assert (np.abs(d - jd) > 1e-5).mean() <= max_frac


# Simple scenes: PERF.md section 2's raster bound for simple scenes.  XLA
# on the CPU contracts the edge functions into FMAs and the port does not,
# so a pixel on an edge or at a depth tie may flip; none is expected here.
SIMPLE_FRAC = 1e-3
# Lines: a pixel centre 0.5 px from a line decides by one rounding of
# dist_sq, which XLA contracts and the port does not (PERF.md section 2's
# D5 bound, 0.5 %).
WIRE_FRAC = 5e-3


@pytest.mark.parametrize("binned", [True, False], ids=["binned", "brute"])
@pytest.mark.parametrize("mode", MONOTONE, ids=lambda m: m.name)
def test_render_deferred_matches_jax(mode, binned):
    """render_deferred through the default visibility pass of each route
    (binned: K5's twin for LESS_EQUAL, the binned fold otherwise; brute)
    against JAX's on the same triangles and seed."""
    tris, u = soup_tris()
    params = RenderParams(width=W, height=H, depth_test=mode, binned=binned,
                          cull_mode=CullMode.NONE, tile_h=16, tile_w=32,
                          span_cap=4)
    fbd = seed_depth(mode)
    fbc = np.broadcast_to(CLEAR, (H, W, 4))
    jc, jd = map(np.asarray, jax.jit(lambda t, c, d: jraster.render_deferred(
        t, jsh.flat_color_fragment_shader, u, params, c, d))(tris, fbc, fbd))
    c, d = raster.render_deferred(to_torch(tris),
                                  tsh.flat_color_fragment_shader, u, params,
                                  torch.tensor(fbc), torch.tensor(fbd))
    assert_frames_close(c.numpy(), d.numpy(), jc, jd, SIMPLE_FRAC)
    assert (np.abs(jc - CLEAR).max(-1) > 1e-3).mean() > 0.05     # drew


@pytest.mark.parametrize("mode", MONOTONE, ids=lambda m: m.name)
def test_binned_and_brute_visibility_agree(mode):
    """The port's binned fold and brute force give the same winners and
    depths bit for bit (one expression per fragment, one key order), and
    JAX's brute force the same winners on > 99.9 % of pixels."""
    tris, _ = soup_tris()
    params = RenderParams(width=W, height=H, depth_test=mode, tile_h=16,
                          tile_w=32, span_cap=4)
    seed = torch.tensor(seed_depth(mode))
    tt = to_torch(tris)
    visibility = raster.default_visibility(params)
    bd, bi = visibility(tt, params, init_depth=seed)
    fd, fi = raster.visibility_brute_force(tt, params, init_depth=seed)
    assert torch.equal(bi, fi)
    assert torch.equal(bd.view(torch.int32), fd.view(torch.int32))
    _, ji = jax.jit(lambda t, s: jraster.visibility_brute_force(
        t, params, 32, init_depth=s))(tris, seed.numpy())
    assert (bi.numpy() == np.asarray(ji)).mean() > 0.999
    assert (bi >= 0).any()


@pytest.mark.parametrize("row_offset,col_offset", [(0, 20), (12, 5)])
def test_brute_force_offsets_match_jax(row_offset, col_offset):
    """A (24, 32) block of the frame at screen (row_offset, col_offset):
    the port's brute force against JAX's with the same offsets, and equal
    to that block of the port's full frame."""
    tris, _ = soup_tris()
    block = RenderParams(width=32, height=24)
    tt = to_torch(tris)
    d, i = raster.visibility_brute_force(tt, block, row_offset=row_offset,
                                         col_offset=col_offset)
    jd, ji = map(np.asarray, jax.jit(lambda t: jraster.visibility_brute_force(
        t, block, 32, row_offset=row_offset, col_offset=col_offset))(tris))
    full_d, full_i = raster.visibility_brute_force(
        tt, RenderParams(width=W, height=H))
    rows = slice(row_offset, row_offset + 24)
    cols = slice(col_offset, col_offset + 32)
    assert torch.equal(i, full_i[rows, cols])
    assert torch.equal(d, full_d[rows, cols])
    assert (i >= 0).float().mean() > 0.05
    same = i.numpy() == ji
    assert same.mean() > 0.999
    # Depth where the winners agree: the soup's bound against JAX
    # (tests/test_torch_vis_fold.py DEPTH_ATOL, XLA's FMA contraction).
    np.testing.assert_allclose(d.numpy()[same], jd[same], rtol=0, atol=2e-6)


@pytest.mark.parametrize("binned", [True, False], ids=["binned", "brute"])
def test_render_deferred_band_matches_jax(binned):
    """render_deferred over a band of 24 rows at screen row 16 (the
    visibility pass and interpolate_at_pixels both offset) against JAX's,
    and against those rows of the port's full frame."""
    tris, u = soup_tris()
    params = RenderParams(width=W, height=24, binned=binned,
                          cull_mode=CullMode.NONE, tile_h=16, tile_w=32,
                          span_cap=4)
    fbd = seed_depth(DepthTest.LESS_EQUAL)[:24]
    fbc = np.broadcast_to(CLEAR, (24, W, 4))
    jc, jd = map(np.asarray, jax.jit(lambda t, c, d: jraster.render_deferred(
        t, jsh.flat_color_fragment_shader, u, params, c, d, row_offset=16))(
            tris, fbc, fbd))
    c, d = raster.render_deferred(to_torch(tris),
                                  tsh.flat_color_fragment_shader, u, params,
                                  torch.tensor(fbc), torch.tensor(fbd),
                                  row_offset=16)
    assert_frames_close(c.numpy(), d.numpy(), jc, jd, SIMPLE_FRAC)
    full_c, full_d = raster.render_deferred(
        to_torch(tris), tsh.flat_color_fragment_shader, u,
        params.replace(height=H), torch.tensor(CLEAR).expand(H, W, 4),
        torch.tensor(seed_depth(DepthTest.LESS_EQUAL)))
    assert torch.equal(c, full_c[16:40]) and torch.equal(d, full_d[16:40])
    assert (np.abs(jc - CLEAR).max(-1) > 1e-3).mean() > 0.05     # drew


def test_default_visibility_routes():
    p = RenderParams(width=W, height=H)
    assert raster.default_visibility(p) is vis_fold.visibility_fold
    assert raster.default_visibility(p.replace(binned=False)) \
        is raster.visibility_brute_force
    assert raster.default_visibility(p.replace(
        depth_test=DepthTest.LESS)) not in (vis_fold.visibility_fold,
                                            raster.visibility_brute_force)
    with pytest.raises(NotImplementedError):
        raster.visibility_brute_force(
            to_torch(soup_tris(4)[0]), p.replace(depth_test=DepthTest.EQUAL))


@pytest.mark.parametrize("mode", [DepthTest.LESS_EQUAL, DepthTest.GREATER,
                                  DepthTest.DISABLED], ids=lambda m: m.name)
def test_wireframe_deferred_matches_jax(mode):
    """The deferred wireframe (DrawLine's quirks) against JAX's on the same
    triangles: the edge-winner fold and the (1-t, t, 0) shade."""
    tris, u = soup_tris(12, seed=9)
    params = RenderParams(width=W, height=H, depth_test=mode,
                          cull_mode=CullMode.NONE,
                          debug_mode=DebugMode.WIREFRAME)
    fbd = seed_depth(mode)
    fbc = np.broadcast_to(CLEAR, (H, W, 4))
    jc, jd = map(np.asarray, jax.jit(
        lambda t, c, d: jraster.render_wireframe_deferred(
            t, jsh.flat_color_fragment_shader, u, params, c, d, chunk=16))(
                tris, fbc, fbd))
    c, d = raster.render_wireframe_deferred(
        to_torch(tris), tsh.flat_color_fragment_shader, u, params,
        torch.tensor(fbc), torch.tensor(fbd))
    assert_frames_close(c.numpy(), d.numpy(), jc, jd, WIRE_FRAC)
    assert (np.abs(c.numpy() - CLEAR).max(-1) > 1e-3).mean() > 0.02


# ---- debug views: tests/test_debugviz.py's expectations ----------------

def _clip_soup(tris_xyz):
    """test_debugviz.py's _tri_soup: CCW triangles given in clip space
    (w = 1), through the port's geometry."""
    from softwarerenderer_tpu_torch.ops import geometry
    t = torch.tensor(tris_xyz, dtype=torch.float32)
    n = t.shape[0]
    vin = {"position": t.reshape(-1, 3), "color": torch.ones(n * 3, 4)}

    def vs(v, u):
        pos = v["position"]
        return {"clip_position": torch.cat(
            [pos, torch.ones_like(pos[:, :1])], -1), "color": v["color"]}

    return geometry.build_triangles(
        vs, vin, torch.arange(n * 3).reshape(n, 3),
        {"near_clip": torch.tensor(0.01)}, width=W, height=H,
        cull_mode=CullMode.NONE)


def test_overdraw_counts_exact():
    half = [[[-1.0, -1.0, 0.0], [0.0, -1.0, 0.0], [-1.0, 1.0, 0.0]],
            [[-1.0, -1.0, 0.2], [0.0, -1.0, 0.2], [-1.0, 1.0, 0.2]]]
    count = debugviz.overdraw_count(_clip_soup(half),
                                    RenderParams(width=W, height=H))
    assert count.shape == (H, W) and count.dtype == torch.int32
    assert count.max() == 2
    assert (count[:, W * 3 // 4:] == 0).all()
    assert (count == 2).sum() > 50


def test_overdraw_ramp_matches_jax():
    """The ramp (jnp.interp written out) equals JAX's, and is monotone as
    test_debugviz.py states."""
    counts = np.asarray([[0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16]], np.int32)
    for sat in (1, 3, 8):
        rgb = debugviz.overdraw_to_color(torch.tensor(counts), sat).numpy()
        want = np.asarray(jdebug.overdraw_to_color(jnp.asarray(counts), sat))
        np.testing.assert_allclose(rgb, want, rtol=1e-6, atol=1e-7)
    rgb = debugviz.overdraw_to_color(torch.tensor([[0, 1, 4, 8, 16]]),
                                     saturate=8)[0]
    assert (rgb[0, :3] == 0).all()
    assert rgb[1, 2] > rgb[3, 2] and rgb[3, 0] > rgb[1, 0]
    assert torch.equal(rgb[3], rgb[4])


def test_depth_view_matches_jax():
    depth = np.full((4, 4), np.finfo(np.float32).min, np.float32)
    depth[1, 1] = 0.2
    depth[2, 2] = 0.9
    depth[3, 0] = 0.5
    img = debugviz.depth_view(torch.tensor(depth)).numpy()
    assert img[2, 2, 0] > img[1, 1, 0] and img[0, 0, 0] == 0.0
    np.testing.assert_array_equal(
        img, np.asarray(jdebug.depth_view(jnp.asarray(depth))))
    empty = np.full((2, 2), np.finfo(np.float32).min, np.float32)
    np.testing.assert_array_equal(
        debugviz.depth_view(torch.tensor(empty)).numpy(),
        np.asarray(jdebug.depth_view(jnp.asarray(empty))))


def test_engine_overdraw_and_depth_modes():
    """test_debugviz.py's engine case: the OVERDRAW counts, the DEPTH view
    and its buffer, which is the frame's own depth plane."""
    sc = scene_mod.build_scene_buffers(
        [scene_mod.MeshInstance(primitives.cube(1.0),
                                ml.translation([0.0, 0.0, -3.0]))])
    base = RenderParams(width=W, height=H)
    color, counts = Engine(sc, base.replace(debug_mode=DebugMode.OVERDRAW),
                           device="cpu").render()
    assert counts.max() >= 1 and counts.min() == 0
    assert (color[counts == 0][:, :3] == 0).all()
    dcolor, ddepth = Engine(sc, base.replace(debug_mode=DebugMode.DEPTH),
                            device="cpu").render()
    covered = ddepth != raster.DEPTH_CLEAR
    assert covered.any() and not covered.all()
    assert (dcolor[~covered][:, 0] == 0).all()
    assert dcolor[covered][:, 0].max() > 0.5
    _, depth = Engine(sc, base, device="cpu").render()
    assert torch.equal(ddepth, depth)


# ---- render_frame's new routes against JAX's render_frame ---------------

def cubes_scene():
    """A floor and four textured cubes: 50 triangles."""
    checker = np.asarray(tex_np.checkerboard(16, 4)["data"])
    insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                    ml.translation([0, -1, 0]),
                                    texture=checker)]
    rng = np.random.default_rng(0)
    for _ in range(4):
        pos = rng.uniform(-3, 3, 3).astype(np.float32)
        pos[1] = rng.uniform(-0.5, 1.0)
        pos[2] -= 2.0
        insts.append(scene_mod.MeshInstance(primitives.cube(0.8),
                                            ml.translation(pos),
                                            texture=checker))
    return scene_mod.build_scene_buffers(insts)


# A camera that puts no pixel centre on the floor's diagonal (which at
# tests/test_torch_engine.py's (0.03, 0.52, 3.07) passes exactly through 8
# centres of this frame: the reference, and the port, put such a pixel in
# both triangles, XLA's contracted edge functions can put it in neither)
# nor on a texel edge.
CAMERA = np.float32([0.13, 0.47, 2.91])


def frame_uniforms(width=W, height=H):
    u = jr.default_frame_uniforms(width, height)
    u["camera_position"] = CAMERA
    return u


def jax_and_port_frames(params, fb=None, jax_fb=None, scene=None):
    """(port color, depth), (JAX color, depth) of render_frame on the same
    packed scene and uniforms, over the framebuffer seed fb (jax_fb for
    JAX, when given), as numpy."""
    scene = cubes_scene() if scene is None else scene
    u = frame_uniforms(params.width, params.height)
    jc, jd = map(np.asarray, jax.jit(functools.partial(
        jr.render_frame, params=params))(scene, u,
                                          fb=fb if jax_fb is None else jax_fb))
    c, d = Engine(scene, params, device="cpu").render(u, fb=fb)
    return (c.numpy(), d.numpy()), (jc, jd)


ROUTES = {
    # name: (RenderParams fields, framebuffer seed, allowed fraction)
    "use_pallas_false": (dict(use_pallas=False), None, SIMPLE_FRAC),
    "less": (dict(depth_test=DepthTest.LESS), None, SIMPLE_FRAC),
    "greater_max_seed": (dict(depth_test=DepthTest.GREATER), "max",
                         SIMPLE_FRAC),
    "greater_equal_max_seed": (dict(depth_test=DepthTest.GREATER_EQUAL),
                               "max", SIMPLE_FRAC),
    "always": (dict(depth_test=DepthTest.ALWAYS), None, SIMPLE_FRAC),
    "disabled": (dict(depth_test=DepthTest.DISABLED), None, SIMPLE_FRAC),
    # additive, so that a pass over the frame changes its colors
    "equal_over_a_frame": (dict(depth_test=DepthTest.EQUAL,
                                blend_mode=BlendMode.ADDITIVE), "frame",
                           SIMPLE_FRAC),
    "not_equal_over_a_frame": (dict(depth_test=DepthTest.NOT_EQUAL,
                                    blend_mode=BlendMode.ADDITIVE), "frame",
                               SIMPLE_FRAC),
    "overdraw": (dict(debug_mode=DebugMode.OVERDRAW), None, SIMPLE_FRAC),
    "depth_view": (dict(debug_mode=DebugMode.DEPTH), None, SIMPLE_FRAC),
    "wireframe_forward": (dict(debug_mode=DebugMode.WIREFRAME,
                               deferred=False), None, WIRE_FRAC),
}


def own_forward_frame(port: bool):
    """A LESS_EQUAL frame of the scene through the forward route of the
    port or of JAX, as numpy: EQUAL / NOT_EQUAL then compare each
    fragment's depth with the one its own package wrote (XLA's contraction
    moves JAX's depths by more than EPSILON near the diagonal)."""
    params = RenderParams(width=W, height=H, deferred=False)
    if port:
        out = Engine(cubes_scene(), params, device="cpu").render(
            frame_uniforms())
    else:
        out = jax.jit(functools.partial(jr.render_frame, params=params))(
            cubes_scene(), frame_uniforms())
    return tuple(np.array(x) for x in out)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_render_frame_route_matches_jax(route):
    """Each render_frame route the port once refused, against JAX's
    render_frame (on the CPU its non-Pallas routes: the fused binned fold
    for LESS_EQUAL, the binned fold, forward and debug views)."""
    fields, seed, frac = ROUTES[route]
    params = RenderParams(width=W, height=H, **fields)
    clear = np.broadcast_to(frame_uniforms()["clear_color"], (H, W, 4))
    fb = jax_fb = None
    if seed == "max":
        fb = (clear.copy(), np.full((H, W), FLT_MAX, np.float32))
    elif seed == "frame":
        fb, jax_fb = own_forward_frame(True), own_forward_frame(False)
    (c, d), (jc, jd) = jax_and_port_frames(params, fb, jax_fb)
    assert c.shape == jc.shape and d.shape == jd.shape
    if route == "depth_view":
        # The gray ramp spans the frame's covered depths, so one extra
        # covered pixel rescales every color: compare the ramp of each
        # package's own depth plane, and the depth planes.
        np.testing.assert_array_equal(
            c, debugviz.depth_view(torch.tensor(d)).numpy())
        np.testing.assert_allclose(
            jc, debugviz.depth_view(torch.tensor(jd)).numpy(), rtol=1e-6,
            atol=1e-6)
        c, jc = d[..., None], jd[..., None]
    assert_frames_close(c, d, jc, jd, frac)
    base = clear if fb is None else fb[0]
    assert (np.abs(jc - base).max(-1) > 1e-3).mean() > 0.02    # drew
