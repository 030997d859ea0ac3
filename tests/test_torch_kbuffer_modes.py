"""The K-slot K-buffer (ops.kbuffer.render_binned_kbuffer), the port's
route for a binned K-buffer under LESS, GREATER, GREATER_EQUAL, ALWAYS and
DISABLED, against JAX's ops/kbuffer.render_binned_kbuffer on the CPU:
through render_frame and called directly on the same triangles, with K
below the layer count, the saturation count, the worst-depth exclusion
and the one chosen difference (a NaN fragment).  The scenes and the
off-alignment camera are tests/test_torch_kbuffer.py's; off that
alignment both packages agree to atol 1e-6 in color and depth."""

import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

from softwarerenderer_tpu import BlendMode, DepthTest
from softwarerenderer_tpu import shaders as jsh
from softwarerenderer_tpu.engine import renderer as jr
from softwarerenderer_tpu.ops import geometry as jgeom
from softwarerenderer_tpu.ops import kbuffer as jkb
from softwarerenderer_tpu.utils import mathlib as ml
from softwarerenderer_tpu_torch import shaders as tsh
from softwarerenderer_tpu_torch.engine import renderer as tr
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import kbuffer, tile_raster

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_kbuffer import (CAM, PARAMS, build, facing_quad,  # noqa: E402
                                frame_uniforms)

MODES = [DepthTest.LESS, DepthTest.GREATER, DepthTest.GREATER_EQUAL,
         DepthTest.ALWAYS, DepthTest.DISABLED]
FMAX = np.finfo(np.float32).max
# Five translucent quads, submitted neither near to far nor far to near,
# so that ranking the slots by depth and by index keep different layers.
STACK_Z = [-3.0, -2.0, -4.0, -2.5, -3.5]
STACK = [facing_quad(z, c, x0=-1.0 + 0.1 * i, x1=1.0 - 0.05 * i)
         for i, (z, c) in enumerate(zip(STACK_Z, [
             (1.0, 0.0, 0.0, 0.5), (0.0, 1.0, 0.0, 0.5), (0.0, 0.0, 1.0, 0.5),
             (1.0, 1.0, 0.0, 0.5), (0.0, 1.0, 1.0, 0.5)]))]
K2 = PARAMS.replace(kbuffer=2, use_pallas=False)
H, W = K2.height, K2.width
CENTRE = (H // 2, W // 2)


def seed(mode):
    """The framebuffer a frame under `mode` starts from: cleared, or a
    MaxValue depth buffer for GREATER and GREATER_EQUAL, which draw
    nothing over the cleared one."""
    if mode not in (DepthTest.GREATER, DepthTest.GREATER_EQUAL):
        return None
    return (np.zeros((H, W, 4), np.float32),
            np.full((H, W), FMAX, np.float32))


def assert_close(port, want):
    for a, b in zip(port, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6,
                                   rtol=0)


# ---------------------------------------------------------------- frames

@functools.lru_cache(maxsize=None)
def jax_frame(params, mode):
    """JAX's render_frame of STACK under `mode`."""
    params = params.replace(depth_test=mode)
    return tuple(map(np.asarray, jax.jit(functools.partial(
        jr.render_frame, params=params,
        fragment_shader=jsh.flat_color_fragment_shader))(
            build(STACK), frame_uniforms(params, CAM), fb=seed(mode))))


def port_frame(quads, params, mode):
    params = params.replace(depth_test=mode)
    out = tr.render_frame(scene_to_torch(build(quads), "cpu"),
                          frame_uniforms(params, CAM), params,
                          fragment_shader=tsh.flat_color_fragment_shader,
                          fb=seed(mode))
    return tuple(t.numpy() if isinstance(t, torch.Tensor) else t for t in out)


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_frame_matches_jax(mode):
    """render_frame with K = 2 over the five-layer stack, ALPHA blending:
    the port's K-slot route against JAX's."""
    c, d = port_frame(STACK, K2, mode)
    assert_close((c, d), jax_frame(K2, mode))
    assert (np.abs(c - c[0, 0]).max(-1) > 0).sum() > 500


@pytest.mark.parametrize("blend", [BlendMode.ADDITIVE, BlendMode.MULTIPLY],
                         ids=lambda b: b.name)
def test_blend_modes_match_jax(blend):
    params = K2.replace(blend_mode=blend, kbuffer=3)
    assert_close(port_frame(STACK, params, DepthTest.LESS),
                 jax_frame(params, DepthTest.LESS))


def test_unbinned_kbuffer_renders_as_jax():
    """binned=False ignores kbuffer and renders the deferred brute route,
    as JAX's render_frame does."""
    params = K2.replace(binned=False)
    c, d = port_frame(STACK, params, DepthTest.GREATER)
    assert_close((c, d), jax_frame(params, DepthTest.GREATER))
    single = port_frame(STACK, params.replace(kbuffer=0), DepthTest.GREATER)
    assert np.array_equal(c, single[0]) and np.array_equal(d, single[1])


def test_always_ranks_slots_by_depth():
    """Under ALWAYS the K slots hold the K nearest layers (LESS_EQUAL's
    rank, as JAX's code has it), not the K last submitted: with K = 2 the
    frame is that of the two nearest quads alone, replayed in submission
    order, and not that of the last two."""
    c, d = port_frame(STACK, K2, DepthTest.ALWAYS)
    nearest = sorted(range(5), key=lambda i: STACK_Z[i])[-2:]
    near = port_frame([STACK[i] for i in sorted(nearest)], K2,
                      DepthTest.ALWAYS)
    last = port_frame(STACK[3:], K2, DepthTest.ALWAYS)
    assert np.array_equal(c[CENTRE], near[0][CENTRE])
    assert d[CENTRE] == near[1][CENTRE] != last[1][CENTRE]
    # K = 5 keeps every layer, and the last submitted then draws last.
    c5, d5 = port_frame(STACK, K2.replace(kbuffer=5), DepthTest.ALWAYS)
    assert d5[CENTRE] == last[1][CENTRE]


def test_less_equal_kslot_route_equals_peel_route():
    """Called directly under LESS_EQUAL, the K-slot route renders what the
    peel route renders with the short-circuit off, saturation count
    included."""
    params = K2.replace(kbuffer=3, kbuffer_short_circuit=False)
    f = tr.frame_setup(scene_to_torch(build(STACK), "cpu"),
                       frame_uniforms(params, CAM), params,
                       fragment_shader=tsh.flat_color_fragment_shader)
    args = (f["tris"], tsh.flat_color_fragment_shader, f["uniforms"],
            params, f["fb_color"], f["fb_depth"])
    c1, d1, s1 = kbuffer.render_binned_kbuffer(
        *args, per_tri_extra=f["per_tri"], with_stats=True)
    c2, d2, s2 = tile_raster.render_tile_kbuffer(
        *args, per_tri_extra=f["per_tri"], with_stats=True)
    assert torch.equal(c1, c2) and torch.equal(d1, d2)
    assert int(s1["kbuffer_saturated_px"]) \
        == int(s2["kbuffer_saturated_px"]) > 0


# ----------------------------------------------------------- direct calls

def stack_tris(quads):
    """JAX's build_triangles output for the quads as one mesh, from CAM
    with tests/test_kbuffer.py's lens, as numpy arrays."""
    mesh = {k: np.concatenate([q[k] for q in quads]) for k in
            ("position", "uv", "normal", "color")}
    mesh["indices"] = np.concatenate(
        [q["indices"] + 4 * i for i, q in enumerate(quads)])
    vin = jsh.make_vertex_input(mesh["position"], mesh["uv"],
                                mesh["normal"], mesh["color"])
    u = {"model": np.eye(4, dtype=np.float32),
         "view": ml.look_at(CAM, CAM + np.float32([0, 0, -1]), [0, 1, 0]),
         "projection": ml.perspective_fov(np.deg2rad(60.0), W / H, 0.1,
                                          100.0),
         "near_clip": np.float32(0.1)}
    tris = jax.jit(lambda v, i, u: jgeom.build_triangles(
        jsh.default_vertex_shader, v, i, u, width=W, height=H,
        cull_mode=0))(vin, mesh["indices"], u)
    return jax.tree_util.tree_map(np.array, tris)


def to_torch(tris):
    out = {k: torch.tensor(tris[k]) for k in ("screen", "depth", "inv_area",
                                               "valid", "bbox")}
    out["attrs"] = {k: torch.tensor(v) for k, v in tris["attrs"].items()}
    return out


def direct_fb(mode):
    fb = seed(mode)
    if fb is None:
        fb = (np.zeros((H, W, 4), np.float32),
              np.full((H, W), -FMAX, np.float32))
    return fb


def jax_direct(tris, params, with_stats=False):
    fb = direct_fb(params.depth_test)
    return jax.jit(lambda t, c, d: jkb.render_binned_kbuffer(
        t, jsh.flat_color_fragment_shader, {}, params, c, d,
        with_stats=with_stats))(tris, *fb)


def port_direct(tris, params, with_stats=False):
    fb = direct_fb(params.depth_test)
    return kbuffer.render_binned_kbuffer(
        to_torch(tris), tsh.flat_color_fragment_shader, {}, params,
        *map(torch.tensor, fb), with_stats=with_stats)


@functools.lru_cache(maxsize=None)
def tris_of(name):
    """Triangles of the direct calls: the stack, the stack behind a
    screen-filling global quad (slots 20-23) and the stack with a
    coincident quad in front of it (slots 0-3)."""
    if name == "stack":
        return stack_tris(STACK)
    if name == "global":
        return stack_tris(STACK + [facing_quad(
            -6.0, (0.5, 0.5, 0.5, 0.5), -20.0, 20.0, -20.0, 20.0)])
    return stack_tris([facing_quad(-1.5, (1.0, 0.0, 1.0, 0.5))] + STACK)


def with_depth(tris, slots, value):
    out = dict(tris, depth=tris["depth"].copy(),
               valid=tris["valid"].copy())
    out["depth"][slots] = value
    return out


def without(tris, slots):
    out = dict(tris, valid=tris["valid"].copy())
    out["valid"][slots] = False
    return out


@pytest.mark.parametrize("mode", MODES, ids=lambda m: m.name)
def test_direct_call_matches_jax(mode):
    """render_binned_kbuffer on JAX's own triangles, K = 3 of five layers:
    the frame and kbuffer_saturated_px equal JAX's."""
    tris = tris_of("stack")
    params = K2.replace(kbuffer=3, depth_test=mode)
    jc, jd, js = jax_direct(tris, params, with_stats=True)
    c, d, s = port_direct(tris, params, with_stats=True)
    assert_close((c, d), (jc, jd))
    assert int(s["kbuffer_saturated_px"]) == int(js["kbuffer_saturated_px"])
    assert int(s["kbuffer_saturated_px"]) > 100
    # As deep as the stack, nothing is dropped and nothing saturates.
    _, _, s6 = port_direct(tris, params.replace(kbuffer=6), with_stats=True)
    assert int(s6["kbuffer_saturated_px"]) == 0


@pytest.mark.parametrize("mode,worst", [
    (DepthTest.ALWAYS, -np.inf), (DepthTest.GREATER_EQUAL, np.inf)],
    ids=["ALWAYS_-inf", "GREATER_EQUAL_+inf"])
def test_worst_depth_never_takes_a_slot(mode, worst):
    """A screen-filling quad at the rank's worst depth (-inf where the
    largest depth ranks first, +inf where the smallest does) takes no
    slot, as in JAX: the frame is the one without it.  A fragment's depth
    is the corners' depths times weights of 1/area's sign, so the corners
    take worst times that sign."""
    tris = tris_of("global")
    sign = np.sign(tris["inv_area"][20:24])[:, None]
    tris = with_depth(tris, slice(20, 24), worst * sign)
    params = K2.replace(depth_test=mode)
    c, d = port_direct(tris, params)
    assert_close((c, d), jax_direct(tris, params))
    assert_close((c, d), port_direct(without(tris, slice(20, 24)), params))


def test_nan_fragment_never_takes_a_slot():
    """The chosen difference from JAX: a quad whose depth is NaN, in front
    of the stack and in the same binned chunk, takes no slot in the port,
    which renders the stack as if the quad were absent.  JAX's chunked max
    lets the NaN void the whole chunk at every pixel the quad covers, so
    the framebuffer shows through there."""
    tris = with_depth(tris_of("nan"), slice(0, 4), np.nan)
    params = K2.replace(depth_test=DepthTest.LESS)
    c, d = (t.numpy() for t in port_direct(tris, params))
    want = port_direct(without(tris, slice(0, 4)), params)
    assert np.array_equal(c, want[0].numpy())
    assert np.array_equal(d, want[1].numpy())
    # The port's centre pixel: the two nearest layers (z = -2.0 green,
    # then z = -2.5 yellow, ranked by LESS) replayed over black in
    # submission order; the later, farther yellow fails LESS.
    np.testing.assert_allclose(c[CENTRE], [0.0, 0.5, 0.0, 0.25], atol=1e-7)
    jc, jd = map(np.asarray, jax_direct(tris, params))
    covered = c.max(-1) > 0
    assert covered.sum() > 500
    assert (jc[covered] == 0).all() and (jd[covered] == -FMAX).all()
