"""The capacity caps and shade_rate of the port (RenderParams.active_cap,
geom_cap, pair_cap, global_cap, active_cap_stats and shade_rate) against
the JAX package on the CPU.

At caps that hold, the port's frame equals its uncapped frame on every
pixel; every counter of active_cap_stats equals JAX's as an integer; an
overflowing cap drops the same slots as JAX's, so the overflowed frame is
held against JAX's overflowed frame under tests/test_torch_engine.py's
limits (a small share of edge pixels where XLA's contracted edge
functions flip a pixel).  Which port route honours which cap: active_cap
and geom_cap act in frame_setup, before every route; pair_cap wherever
binning.bin_triangles runs (the tile routes K1, K2 and K3, the deferred
route's K5 fold and its binned twins, the K-slot K-buffer, the light
passes); global_cap on the tile routes only (tile_raster.prepare), as in
JAX, where it acts on the Pallas routes only, so JAX's side of a
global_cap frame runs with pallas_interpret=True.  shade_rate renders on
the opaque tile route only (JAX's Pallas route, again in interpret mode
here)."""

import functools

import jax
import numpy as np
import pytest
import torch

from softwarerenderer_tpu import CullMode, RenderParams
from softwarerenderer_tpu.engine import renderer as jr
from softwarerenderer_tpu.models import primitives
from softwarerenderer_tpu.models import scene as scene_mod
from softwarerenderer_tpu.ops import binning as jbin
from softwarerenderer_tpu.ops import lod
from softwarerenderer_tpu.ops import texture as tex_np
from softwarerenderer_tpu.utils import mathlib as ml
from softwarerenderer_tpu_torch.config import DepthTest
from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.engine import renderer as tr
from softwarerenderer_tpu_torch.ops import binning as tbin

W, H = 160, 120
# tests/test_torch_engine.py's limits: the share of pixels whose depth,
# or whose colour in some channel, differs from JAX's by more than 1e-5.
SPHERE_OFF_MAX = 1e-3
SOUP_OFF_MAX = 5e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its frames are many small
    ops, which torch's default pool slows down when the suite's workers
    share the cores (tests/test_torch_dust2.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def sphere_scene(textured: bool = False):
    """tests/test_lod.py's LOD sphere (two of them, textured, for the
    mip case)."""
    base = primitives.uv_sphere(0.8, rings=12, sectors=18)
    mesh = lod.add_lods(base, cells=(6, 3), px=(40.0, 15.0))
    if not textured:
        return scene_mod.build_scene_buffers(
            [scene_mod.MeshInstance(mesh, ml.translation([0.0, 0.0, -1.5]))])
    checker = np.asarray(tex_np.checkerboard(64, 8)["data"])
    return scene_mod.build_scene_buffers([scene_mod.MeshInstance(
        mesh, ml.translation([dx, 0.0, -2.5]), texture=checker)
        for dx in (-1.2, 1.2)])


def sphere_uniforms(z: float = 0.5):
    u = jr.default_frame_uniforms(W, H)
    u["camera_position"] = np.float32([0.0, 0.0, z])    # the mid level
    return u


def plane_colored(rgba):
    """An xy-facing two-triangle quad with a flat vertex colour."""
    pos = np.float32([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]])
    return {"name": "quad", "position": pos,
            "uv": np.zeros((4, 2), np.float32),
            "normal": np.tile(np.float32([[0, 0, 1]]), (4, 1)),
            "color": np.tile(np.float32(rgba), (4, 1)),
            "indices": np.int32([[0, 2, 1], [0, 3, 2]]),
            "bounds_center": np.zeros(3, np.float32), "bounds_radius": 1.5}


def stacked_planes(green: bool = True):
    """A red plane behind (submitted first) and, with `green`, a green one
    in front (submitted second)."""
    insts = [scene_mod.MeshInstance(dict(plane_colored([1, 0, 0, 1])),
                                    ml.translation([0.0, 0.0, -3.0]))]
    if green:
        insts.append(scene_mod.MeshInstance(
            dict(plane_colored([0, 1, 0, 1])),
            ml.translation([0.0, 0.0, -2.0])))
    return scene_mod.build_scene_buffers(insts)


def soup_scene():
    soup = primitives.random_triangle_soup(2000, seed=0)
    return scene_mod.build_scene_buffers([scene_mod.MeshInstance(soup)])


def jax_frame(scene, u, params):
    out = jax.jit(functools.partial(jr.render_frame, params=params))(scene, u)
    return tuple(np.asarray(x) for x in out[:2]) + tuple(
        {k: int(v) for k, v in out[2].items()} for _ in out[2:3])


def port_frame(scene, u, params):
    out = Engine(scene, params, device="cpu").render(u)
    return tuple(x.numpy() for x in out[:2]) + tuple(
        {k: int(v) for k, v in out[2].items()} for _ in out[2:3])


def assert_equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def assert_near_jax(got, want, off_max=SPHERE_OFF_MAX):
    c, d = got[:2]
    jc, jd = want[:2]
    assert c.shape == jc.shape and np.isfinite(c).all()
    assert (np.abs(d - jd) > 1e-5).mean() <= off_max
    assert (np.abs(c - jc).max(-1) > 1e-5).mean() <= off_max


# ---- active_cap ------------------------------------------------------------

def test_active_cap_exact_with_suggested_bound():
    """At lod.suggested_active_cap the compacted frame is the uncompacted
    one on every pixel, and JAX's compacted frame within the limits."""
    scene, u = sphere_scene(), sphere_uniforms()
    cap = lod.suggested_active_cap(scene)
    assert cap < 2 * scene["tri_mesh_id"].shape[0]
    p = RenderParams(width=W, height=H)
    capped = port_frame(scene, u, p.replace(active_cap=cap))
    assert_equal(capped, port_frame(scene, u, p))
    assert_near_jax(capped, jax_frame(scene, u, p.replace(active_cap=cap)))


def test_active_cap_overflow_drops_last_submitted():
    """A cap of 2 slots keeps the red plane's two triangles and drops the
    green one submitted after it: the red-only scene's frame, as in
    JAX."""
    p = RenderParams(width=W, height=H, cull_mode=CullMode.NONE)
    u = jr.default_frame_uniforms(W, H)
    full = port_frame(stacked_planes(), u, p)
    red = port_frame(stacked_planes(False), u, p)
    assert np.abs(full[0] - red[0]).max() > 0.1
    capped = port_frame(stacked_planes(), u, p.replace(active_cap=2))
    assert_equal(capped, red)
    assert_near_jax(capped, jax_frame(stacked_planes(), u,
                                      p.replace(active_cap=2)))


# ---- active_cap_stats --------------------------------------------------------

STATS_CASES = {
    # every cap at its sound or measured bound: each counter 0
    "fitting": dict(active_cap="suggested", geom_cap="suggested_geom",
                    pair_cap=4096, global_cap=256),
    # every cap starved: each counter the dropped count (global_cap's 256
    # floor is above this frame's globals: its counter stays 0)
    "starved": dict(active_cap=16, geom_cap=150, pair_cap=8, global_cap=1),
    # measurement mode: live_pairs and live_globals only
    "measure": dict(),
}


@pytest.mark.parametrize("case", sorted(STATS_CASES))
def test_active_cap_stats_match_jax(case):
    """The stats dict has JAX's keys and JAX's integers, at span_cap 1 so
    the frame has globals to count."""
    scene, u = sphere_scene(), sphere_uniforms()
    kw = {k: {"suggested": lod.suggested_active_cap(scene),
              "suggested_geom": lod.suggested_geom_cap(scene)}.get(v, v)
          for k, v in STATS_CASES[case].items()}
    p = RenderParams(width=W, height=H, span_cap=1, active_cap_stats=True,
                     **kw)
    got, want = port_frame(scene, u, p)[2], jax_frame(scene, u, p)[2]
    assert got == want
    assert got["live_pairs"] > 0
    over = {k: v for k, v in got.items() if k.endswith("_overflow")}
    assert len(over) == len(kw)
    if case == "starved":
        assert got["global_cap_overflow"] == 0
        assert all(v > 0 for k, v in over.items() if k != "global_cap_"
                   "overflow")
    else:
        assert got["live_globals"] > 0 and not any(over.values())


def test_active_cap_stats_refused_with_ssaa_or_post_fx():
    """As in JAX: the stats are a third return value the ssaa and post-FX
    wrappers do not pass on."""
    scene, u = sphere_scene(), sphere_uniforms()
    for kw in (dict(ssaa=2), dict(fxaa=True, post_fx=("fxaa",))):
        p = RenderParams(width=W, height=H, active_cap_stats=True, **kw)
        with pytest.raises(ValueError, match="active_cap_stats"):
            jr.render_frame(scene, u, p)
        with pytest.raises(ValueError, match="active_cap_stats"):
            Engine(scene, p, device="cpu").render(u)


# ---- pair_cap and global_cap ---------------------------------------------------

def _soup_tris(w, h, n, seed):
    """Set-up triangles of a random soup from the JAX geometry stage
    (tests/test_torch_binning.py's), as numpy."""
    from softwarerenderer_tpu.ops import geometry as jgeom
    soup = primitives.random_triangle_soup(n, seed=seed)
    scene = scene_mod.build_scene_buffers([scene_mod.MeshInstance(soup)])
    u = jr.default_frame_uniforms(w, h)
    view, proj = jr.camera_matrices(u, w, h, xp=np)
    u.update(model=scene["mesh_matrices"][scene["vert_mesh_id"]],
             view=np.asarray(view), projection=np.asarray(proj))
    vin = {k: scene[k] for k in ("position", "uv", "normal", "color")}
    tris = jax.jit(lambda vin, idx, u: jgeom.build_triangles(
        jr.scene_vertex_shader, vin, idx, u, width=w, height=h,
        cull_mode=CullMode.NONE, near_clip=u["near_clip"]))(
            vin, scene["indices"], u)
    return {k: np.asarray(tris[k]) for k in ("bbox", "valid")}


@pytest.mark.parametrize("pair_cap", ["fits", "starved", "off"])
def test_bin_triangles_pair_cap_matches_jax(pair_cap):
    """The compacted pair table (sorted ids, starts, counts, order) equals
    JAX's, whether the live pairs fit, overflow (the last-submitted
    pairs dropped) or the cap reaches the full table (off); so do the
    live pair and global counts and the overflow."""
    w, h, tile_h, tile_w, span_cap = 200, 150, 16, 64, 4
    tris = _soup_tris(w, h, 200, seed=4)
    p = RenderParams(width=w, height=h, tile_h=tile_h, tile_w=tile_w,
                     span_cap=span_cap)
    live = int(jbin.live_pair_count(tris, p))
    cap = {"fits": -(-live // 128) * 128 + 128, "starved": live // 2,
           "off": 200 * 2 * span_cap}[pair_cap]
    p = p.replace(pair_cap=cap)
    ref = jbin.bin_triangles(tris, p, tile_h, tile_w, span_cap)
    tt = {k: torch.tensor(v) for k, v in tris.items()}
    got = tbin.bin_triangles(tt, p, tile_h, tile_w, span_cap)
    for k in ("order", "sorted_tri", "starts", "counts", "n_global"):
        np.testing.assert_array_equal(got[k].numpy().reshape(-1),
                                      np.asarray(ref[k]).reshape(-1),
                                      err_msg=k)
    assert int(tbin.live_pair_count(tt, p)) == live
    assert int(tbin.global_count(tt, p)) == int(jbin.global_count(tris, p))
    assert int(got["counts"].sum()) == min(live, cap)


def test_pair_cap_frames():
    """A pair_cap that holds renders the uncapped frame on every pixel; a
    starved one drops the last-submitted pairs as JAX's does (JAX's CPU
    route bins through the same bin_triangles).  (Closer, at z = -0.5,
    the pole's degenerate triangles have area 0 here and 1e-5 under
    XLA's contracted edge function, which makes them valid there and
    changes JAX's live pair count.)"""
    scene, u = sphere_scene(), sphere_uniforms(0.0)
    p = RenderParams(width=W, height=H, active_cap_stats=True)
    base = port_frame(scene, u, p)
    live = base[2]["live_pairs"]
    fits = port_frame(scene, u, p.replace(pair_cap=-(-live // 128) * 128))
    assert_equal(fits, base)
    assert fits[2]["pair_cap_overflow"] == 0
    starved = p.replace(pair_cap=live // 2)
    got, want = port_frame(scene, u, starved), jax_frame(scene, u, starved)
    assert got[2] == want[2] and got[2]["pair_cap_overflow"] == live - live // 2
    assert np.abs(got[0] - base[0]).max() > 0.1
    assert_near_jax(got, want)


def test_global_cap_frames_against_jax_interpret():
    """global_cap on the soup with span_cap 1 (hundreds of globals): a cap
    above the global count renders the uncapped frame on every pixel; the
    256 floor, below it, drops the last-submitted globals as JAX's
    Pallas route does (in interpret mode), with the same counters."""
    scene = soup_scene()
    u = jr.default_frame_uniforms(128, 96)
    p = RenderParams(width=128, height=96, tile_h=16, span_cap=1,
                     active_cap_stats=True)
    base = port_frame(scene, u, p)
    n_glob = base[2]["live_globals"]
    assert n_glob > 300
    fits = port_frame(scene, u, p.replace(global_cap=n_glob + 1))
    assert_equal(fits, base)
    assert fits[2]["global_cap_overflow"] == 0
    low = p.replace(global_cap=1)        # the GLOB_RESIDENT floor: 256
    got = port_frame(scene, u, low)
    want = jax_frame(scene, u, low.replace(pallas_interpret=True))
    assert got[2] == want[2] and got[2]["global_cap_overflow"] == n_glob - 256
    assert np.abs(got[0] - base[0]).max() > 0.1
    assert_near_jax(got, want, SOUP_OFF_MAX)


# ---- geom_cap ----------------------------------------------------------------

def test_geom_cap_exact_with_suggested_bound():
    """At lod.suggested_geom_cap the frame is the uncapped one on every
    pixel, alone and with active_cap, and JAX's within the limits."""
    scene, u = sphere_scene(), sphere_uniforms()
    gcap = lod.suggested_geom_cap(scene)
    assert gcap < scene["tri_mesh_id"].shape[0]
    p = RenderParams(width=W, height=H)
    base = port_frame(scene, u, p)
    p1 = p.replace(geom_cap=gcap)
    assert_equal(port_frame(scene, u, p1), base)
    p2 = p1.replace(active_cap=lod.suggested_active_cap(scene))
    got = port_frame(scene, u, p2)
    assert_equal(got, base)
    assert_near_jax(got, jax_frame(scene, u, p2))


def test_geom_cap_overflow_drops_last_submitted():
    """A 2-triangle geom_cap keeps the red plane, submitted first."""
    p = RenderParams(width=W, height=H, cull_mode=CullMode.NONE)
    u = jr.default_frame_uniforms(W, H)
    capped = port_frame(stacked_planes(), u, p.replace(geom_cap=2))
    assert_equal(capped, port_frame(stacked_planes(False), u, p))
    assert_near_jax(capped, jax_frame(stacked_planes(), u,
                                      p.replace(geom_cap=2)))


def test_geom_cap_with_mipmaps_and_texture():
    """geom_cap re-routes every per-triangle consumer (texture ids, the
    mips' uv cross products): a textured, mipped LOD scene renders its
    uncapped frame, and JAX's within the limits."""
    scene = sphere_scene(textured=True)
    u = jr.default_frame_uniforms(W, H)
    p = RenderParams(width=W, height=H, use_mipmaps=True)
    p1 = p.replace(geom_cap=lod.suggested_geom_cap(scene))
    got = port_frame(scene, u, p1)
    assert_equal(got, port_frame(scene, u, p))
    assert_near_jax(got, jax_frame(scene, u, p1))


# ---- the caps on each route -------------------------------------------------------

ROUTES = {
    "deferred": dict(use_pallas=False),
    "kbuffer_peel": dict(kbuffer=2, cull_mode=CullMode.NONE),
    "kslot": dict(kbuffer=2, cull_mode=CullMode.NONE,
                  depth_test=DepthTest.LESS),
    "forward": dict(deferred=False),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_caps_on_each_route(route):
    """active_cap, geom_cap and pair_cap at their bounds leave each other
    route's frame as it was uncapped, and the capped frame is JAX's for
    the same params within the limits, with equal counters."""
    scene, u = sphere_scene(), sphere_uniforms()
    p = RenderParams(width=W, height=H, **ROUTES[route])
    base = port_frame(scene, u, p)
    pc = p.replace(active_cap=lod.suggested_active_cap(scene),
                   geom_cap=lod.suggested_geom_cap(scene), pair_cap=2048,
                   active_cap_stats=True)
    got, want = port_frame(scene, u, pc), jax_frame(scene, u, pc)
    assert_equal(got, base)
    assert got[2] == want[2] and not any(
        v for k, v in got[2].items() if k.endswith("_overflow"))
    assert_near_jax(got, want)


# ---- shade_rate ----------------------------------------------------------------

def test_shade_rate_anchor_rows_and_jax():
    """shade_rate=2: the fold stays at full resolution and every second
    row is shaded; those anchor rows equal the full-rate frame's, a pixel
    of the rows between that is drawn, below a drawn anchor, repeats the
    anchor's colour, and the frame is JAX's Pallas route's (in interpret
    mode) within the limits."""
    scene, u = sphere_scene(textured=True), jr.default_frame_uniforms(W, H)
    p = RenderParams(width=W, height=H)
    full = port_frame(scene, u, p)
    half = port_frame(scene, u, p.replace(shade_rate=2))
    np.testing.assert_array_equal(half[0][::2], full[0][::2])
    drawn = half[1] > -3e38              # not DEPTH_CLEAR
    both = drawn[::2] & drawn[1::2]
    assert both.mean() > 0.1
    np.testing.assert_array_equal(half[0][1::2][both], half[0][::2][both])
    assert np.abs(half[0] - full[0]).max() > 0.01
    # Against JAX on the untextured sphere: on the checker, the 0.05 % of
    # pixels where XLA's contraction picks the neighbouring texel at full
    # rate are each repeated down a second row.
    scene, u = sphere_scene(), sphere_uniforms()
    p = p.replace(shade_rate=2, pallas_interpret=True)
    assert_near_jax(port_frame(scene, u, p), jax_frame(scene, u, p))


@pytest.mark.parametrize("kw", [dict(kbuffer=2), dict(use_pallas=False),
                                dict(height=119)],
                         ids=["kbuffer", "deferred", "height"])
def test_shade_rate_errors_match_jax(kw):
    """shade_rate > 1 off the opaque tile route, under the K-buffer, or
    with a height it does not divide is JAX's ValueError."""
    scene, u = sphere_scene(), sphere_uniforms()
    p = RenderParams(width=W, height=H, shade_rate=2, pallas_interpret=True,
                     **{k: v for k, v in kw.items() if k != "height"})
    if "height" in kw:
        p = p.replace(height=kw["height"])
    with pytest.raises(ValueError, match="shade_rate"):
        jax_frame(scene, u, p)
    with pytest.raises(ValueError, match="shade_rate"):
        port_frame(scene, u, p)
    tr.check_supported(p.replace(shade_rate=1))


# ---- the LOD crowd ----------------------------------------------------------------

def test_lod_crowd_scene_matches_profile_lod():
    """scenes.lod_crowd_scene packs to the scene of scripts/profile_lod.py's
    own build_instances (the JAX package's primitives, LODs and packer),
    key for key and value for value; its camera is the script's."""
    import ast
    import os
    from softwarerenderer_tpu_torch import scenes
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "profile_lod.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "build_instances")
    ns = {"np": np}
    exec(compile(ast.Module([fn], type_ignores=[]), path, "exec"), ns)
    want = scene_mod.build_scene_buffers(ns["build_instances"](True))
    got = scenes.lod_crowd_scene()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    assert got["indices"].shape[0] == 584064
    u = scenes.lod_crowd_uniforms(jr.default_frame_uniforms(64, 36), 3)
    np.testing.assert_array_equal(u["camera_position"],
                                  np.float32([0.0, 0.3, 2.0]))
    assert (float(u["far_clip"]), float(u["fog_start"]),
            float(u["fog_end"])) == (200.0, 150.0, 220.0)
    assert u["fov_degrees"] == np.float32(90.0 + 0.01 * 3)
