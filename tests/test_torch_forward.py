"""The exact forward route (ops.forward.render_forward) against JAX's on
the same numpy triangles: the order-dependent depth tests, ordered
blending, a discard that reveals a farther triangle, the wireframe, as in
tests/test_forward.py, at 64x48 with a few dozen triangles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softwarerenderer_tpu import shaders as jsh
from softwarerenderer_tpu.config import (BlendMode, CullMode, DebugMode,
                                         DepthTest)
from softwarerenderer_tpu.models import primitives
from softwarerenderer_tpu.ops import forward as jforward
from softwarerenderer_tpu.ops import geometry as jgeom
from softwarerenderer_tpu.utils import mathlib as ml
from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch import shaders as tsh
from softwarerenderer_tpu_torch.ops import forward

W, H = 64, 48
CLEAR = np.asarray([0.1, 0.1, 0.15, 1.0], np.float32)
FLT_MAX = np.finfo(np.float32).max
FLT_MIN = np.finfo(np.float32).min


def translucent_soup(n, seed):
    mesh = primitives.random_triangle_soup(n, seed=seed)
    mesh["color"] = mesh["color"].copy()
    mesh["color"][:, 3] = 0.5
    return mesh


def discard_pair():
    """tests/test_forward.py's discard case: a near triangle with alpha 0
    over a green far one."""
    pos = np.float32([[-1, -1, -3], [1, -1, -3], [0, 1, -3],
                      [-1, -1, -5], [1, -1, -5], [0, 1, -5]])
    return {"position": pos, "uv": np.zeros((6, 2), np.float32),
            "normal": np.tile(np.float32([0, 0, 1]), (6, 1)),
            "color": np.float32([[1, 0, 0, 0]] * 3 + [[0, 1, 0, 1]] * 3),
            "indices": np.int32([[0, 1, 2], [3, 4, 5]])}


def jax_tris(mesh):
    """JAX-built triangles of the mesh (tests/test_forward.py's camera) as
    numpy, and the uniforms."""
    vin = jsh.make_vertex_input(mesh["position"], mesh["uv"],
                                mesh["normal"], mesh["color"])
    u = {"model": np.eye(4, dtype=np.float32),
         "view": ml.look_at(np.float32([0, 0, 3]), [0, 0, 0], [0, 1, 0]),
         "projection": ml.perspective_fov(np.deg2rad(60.0), W / H, 0.1,
                                          100.0),
         "near_clip": np.float32(0.1)}
    tris = jax.jit(lambda v, i, u: jgeom.build_triangles(
        jsh.default_vertex_shader, v, i, u, width=W, height=H,
        cull_mode=CullMode.NONE))(vin, mesh["indices"], u)
    return jax.tree_util.tree_map(np.asarray, tris), u


def to_torch(tris):
    out = {k: torch.tensor(tris[k]) for k in ("screen", "depth", "inv_area",
                                               "valid", "bbox")}
    out["attrs"] = {k: torch.tensor(v) for k, v in tris["attrs"].items()}
    return out


def both(tris, u, params, fb_depth, jax_fb_depth=None):
    """(port color, depth), (JAX color, depth) of render_forward over the
    CLEAR color and the given depth seed (jax_fb_depth for JAX)."""
    fbc = np.broadcast_to(CLEAR, (H, W, 4))
    jd0 = fb_depth if jax_fb_depth is None else jax_fb_depth
    jc, jd = jax.jit(lambda t, c, d: jforward.render_forward(
        t, jsh.flat_color_fragment_shader, u, params, c, d))(tris, fbc, jd0)
    c, d = forward.render_forward(to_torch(tris),
                                  tsh.flat_color_fragment_shader, u, params,
                                  torch.tensor(fbc), torch.tensor(fb_depth))
    return (c.numpy(), d.numpy()), (np.asarray(jc), np.asarray(jd))


CASES = {
    # name: (mesh, RenderParams fields, depth seed)
    "ordered_alpha": (lambda: translucent_soup(25, 13),
                      dict(blend_mode=BlendMode.ALPHA,
                           depth_test=DepthTest.ALWAYS), "clear"),
    "additive": (lambda: translucent_soup(15, 5),
                 dict(blend_mode=BlendMode.ADDITIVE,
                      depth_test=DepthTest.ALWAYS), "clear"),
    "multiply": (lambda: translucent_soup(15, 5),
                 dict(blend_mode=BlendMode.MULTIPLY,
                      depth_test=DepthTest.ALWAYS), "clear"),
    "greater_max_seed": (lambda: primitives.random_triangle_soup(20, seed=4),
                         dict(depth_test=DepthTest.GREATER), "max"),
    "disabled": (lambda: translucent_soup(15, 5),
                 dict(depth_test=DepthTest.DISABLED), "clear"),
    "equal_over_own_frame": (lambda: primitives.random_triangle_soup(
        60, seed=2), dict(blend_mode=BlendMode.ADDITIVE,
                          depth_test=DepthTest.EQUAL), "frame"),
    "not_equal_over_own_frame": (lambda: primitives.random_triangle_soup(
        60, seed=2), dict(blend_mode=BlendMode.ADDITIVE,
                          depth_test=DepthTest.NOT_EQUAL), "frame"),
    "discard_reveals": (discard_pair, {}, "clear"),
    "wireframe": (lambda: primitives.random_triangle_soup(12, seed=9),
                  dict(debug_mode=DebugMode.WIREFRAME), "clear"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case):
    """Color within 2e-5 (tests/test_forward.py's bound against the
    golden) on all but 0.1 % of the pixels (PERF.md section 2's simple
    scenes; 0.5 % for lines, where a centre 0.5 px from a line decides by
    one rounding of dist_sq, which XLA contracts and the port does not),
    and depth within 1e-5 likewise."""
    make, fields, seed = CASES[case]
    tris, u = jax_tris(make())
    params = RenderParams(width=W, height=H, cull_mode=CullMode.NONE,
                          **fields)
    fbd = np.full((H, W), {"max": FLT_MAX}.get(seed, FLT_MIN), np.float32)
    jfbd = None
    if seed == "frame":
        # EQUAL / NOT_EQUAL over each package's own LESS_EQUAL pass of the
        # same triangles, so each fragment meets the depth its own
        # arithmetic wrote (XLA's contraction moves JAX's by more than
        # EPSILON at some pixels).
        first = RenderParams(width=W, height=H, cull_mode=CullMode.NONE)
        (_, fbd), (_, jfbd) = both(tris, u, first, fbd)
    (c, d), (jc, jd) = both(tris, u, params, fbd, jfbd)
    frac = 5e-3 if case == "wireframe" else 1e-3
    assert np.isfinite(c).all()
    assert (np.abs(c - jc).max(-1) > 2e-5).mean() <= frac
    assert (np.abs(d - jd) > 1e-5).mean() <= frac
    assert (np.abs(jc - CLEAR).max(-1) > 1e-3).mean() > 0.01     # drew
    if case == "discard_reveals":
        assert c[H // 2, W // 2, 1] > 0.5          # the green far triangle


def test_forward_equals_deferred_on_opaque():
    """On an opaque LESS_EQUAL scene the sequential route and the deferred
    route give the same frame: the forward route's bbox windows hold every
    covered pixel, and its depth test keeps the same winners."""
    from softwarerenderer_tpu_torch.ops import raster
    tris, u = jax_tris(primitives.random_triangle_soup(20, seed=4))
    params = RenderParams(width=W, height=H, cull_mode=CullMode.NONE,
                          tile_h=16, tile_w=32)
    fbc = torch.tensor(np.broadcast_to(CLEAR, (H, W, 4)))
    fbd = torch.full((H, W), FLT_MIN)
    fc, fd = forward.render_forward(to_torch(tris),
                                    tsh.flat_color_fragment_shader, u,
                                    params, fbc, fbd)
    dc, dd = raster.render_deferred(to_torch(tris),
                                    tsh.flat_color_fragment_shader, u,
                                    params, fbc, fbd)
    assert torch.equal(fd, dd)
    assert torch.equal(fc, dc)


def test_depth_passes_table():
    """The reference's inverted comparison table, EQUAL's EPSILON
    included, equal to JAX's row for row."""
    new = np.float32([0.5, 0.5, 0.5, 0.5 + 5e-7, 0.5 + 2e-6, -0.0])
    old = np.float32([0.5, 0.25, 0.75, 0.5, 0.5, 0.0])
    for mode in DepthTest:
        got = forward._depth_passes(mode, torch.tensor(new),
                                    torch.tensor(old)).numpy()
        want = np.asarray(jforward._depth_passes(mode, jnp.asarray(new),
                                                 jnp.asarray(old)))
        np.testing.assert_array_equal(got, want, err_msg=mode.name)
