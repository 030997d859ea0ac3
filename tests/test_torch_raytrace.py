"""The ray-traced frame of softwarerenderer_tpu_torch against the JAX
package on the CPU: the collision world and raycast_batch, the Morton
clusters, K4's plain twin behind the bundle casts, the shadow hash, and
whole frames on both routes.

Tolerances, each with its reason:
  * winners (hit, tri, coverage of the port's own routes) are exact: both
    packages evaluate the same Möller–Trumbore expressions;
  * floats of the world and the casts at rtol 3e-6, atol 1e-5
    (tests/test_rt_accel.py:_assert_same): JAX runs op by op here, but
    ``jnp.sum`` over the 3 components may add in another order;
  * whole frames at the JAX tests' own limits (tests/test_rt_accel.py:
    166-300): XLA contracts multiply-adds inside ``jit`` and PyTorch does
    not, and ``cos``/``sin`` differ by ulps between the libraries, so a few
    edge pixels flip: coverage on under 0.2 % of pixels, depth at atol
    1e-5 elsewhere, colors under 1e-3 on over 99 % of pixels.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from softwarerenderer_tpu import RenderParams as JaxRenderParams
from softwarerenderer_tpu.engine.renderer import default_frame_uniforms
from softwarerenderer_tpu.models import primitives
from softwarerenderer_tpu.models import scene as scene_mod
from softwarerenderer_tpu.ops import rt_accel as jax_accel
from softwarerenderer_tpu.ops import rt_pallas
from softwarerenderer_tpu.ops import sky as jax_sky
from softwarerenderer_tpu.ops import texture as tex_np
from softwarerenderer_tpu.ops.raster import DEPTH_CLEAR
from softwarerenderer_tpu.ops.raytrace import (
    render_frame_raytraced as jax_raytraced)
from softwarerenderer_tpu.utils import mathlib as jml
from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import raytrace, rt_accel, rt_sweep, sky

jrc = importlib.import_module("softwarerenderer_tpu.sim.raycast")
rc = importlib.import_module("softwarerenderer_tpu_torch.sim.raycast")

RTOL, ATOL = 3e-6, 1e-5
BIG = np.finfo(np.float32).max


def _soup_scene(n, seed=0):
    """tests/test_rt_accel.py:_soup_world's scene: n random triangles in a
    20^3 box."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    v = base[:, None, :] + rng.uniform(-0.8, 0.8, (n, 3, 3)).astype(
        np.float32)
    return {
        "mesh_matrices": np.eye(4, dtype=np.float32)[None],
        "vert_mesh_id": np.zeros((3 * n,), np.int32),
        "position": v.reshape(-1, 3),
        "normal": np.tile(np.asarray([[0, 1, 0]], np.float32), (3 * n, 1)),
        "indices": np.arange(3 * n, dtype=np.int32).reshape(n, 3),
        "tri_mesh_id": np.zeros((n,), np.int32),
    }


def _mesh_scene():
    """A rotated, scaled cube and a ground plane, as a packed scene."""
    checker = np.asarray(tex_np.checkerboard(16, 4)["data"])
    m = (jml.matrix_from_yaw_pitch_roll(0.5, 0.3, 0.1)
         @ np.diag(np.float32([1.5, 0.7, 1.2, 1.0]))
         @ jml.translation([0.2, 0.1, -3.0])).astype(np.float32)
    return scene_mod.build_scene_buffers([
        scene_mod.MeshInstance(primitives.cube(1.0), m, texture=checker),
        scene_mod.MeshInstance(primitives.plane(20.0),
                               jml.translation([0.0, -1.0, 0.0]))])


def _torch_scene(scene):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in scene.items()}


def _close(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got == BIG, want == BIG, err_msg=err_msg)
    fin = want != BIG
    np.testing.assert_allclose(np.where(fin, got, 0), np.where(fin, want, 0),
                               rtol=RTOL, atol=ATOL, err_msg=err_msg)


def _worlds(scene):
    return (rc.build_collision_world(_torch_scene(scene)),
            jrc.build_collision_world(scene))


@pytest.mark.parametrize("which", ["soup", "meshes"])
def test_build_collision_world_matches_jax(which):
    scene = _soup_scene(97) if which == "soup" else _mesh_scene()
    got, want = _worlds(scene)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].numpy(), want[k], k)
    np.testing.assert_array_equal(got["tri_mesh_id"].numpy(),
                                  want["tri_mesh_id"])


def _coherent_rays(m=64, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32) + [-12, 0, 0]
    d = (np.asarray([1.0, 0.0, 0.0], np.float32)
         + rng.uniform(-0.2, 0.2, (m, 3)).astype(np.float32))
    return o.astype(np.float32), d.astype(np.float32)


def _same_hits(got, want, keys=("distance", "point", "normal")):
    """hit and tri equal; float leaves close.  Barycentrics are compared on
    hits only: a miss's u, v are Möller–Trumbore's on triangle 0, far out
    of [0, 1], where XLA's contracted multiply-adds move them by more."""
    hit = np.asarray(want["hit"])
    np.testing.assert_array_equal(np.asarray(got["hit"]), hit)
    np.testing.assert_array_equal(np.asarray(got["tri"]),
                                  np.asarray(want["tri"]))
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if k in ("u", "v"):
            g, w = g[hit], w[hit]
        _close(g, w, k)


@pytest.mark.parametrize("face_mask", [0, 1, 2, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_raycast_batch_matches_jax(face_mask, masked):
    scene = _soup_scene(403)
    world, jworld = _worlds(scene)
    o, d = _coherent_rays()
    tmask = None
    if masked:
        tmask = np.random.default_rng(3).uniform(size=403) < 0.6
    got = rc.raycast_batch(torch.from_numpy(o), torch.from_numpy(d), world,
                           face_mask=face_mask,
                           tri_mask=None if tmask is None
                           else torch.from_numpy(tmask))
    want = jrc.raycast_batch(o, d, jworld, face_mask=face_mask,
                             tri_mask=tmask)
    assert set(got) == set(want)
    _same_hits({k: v.numpy() for k, v in got.items()}, want)
    if face_mask == rc.FACE_MASK_IGNORE_BACKFACES | \
            rc.FACE_MASK_IGNORE_FRONTFACES:
        assert not got["hit"].any()
    else:
        assert got["hit"].any() and not got["hit"].all()


def test_raycast_batch_chunks_and_duplicate_tie(monkeypatch):
    """Two identical triangles: the lower id wins, masked the other; the
    answer does not depend on the chunking of the rays."""
    tri = np.asarray([[0, 0, 0], [2, 0, 0], [0, 2, 0]], np.float32)
    scene = {
        "mesh_matrices": np.eye(4, dtype=np.float32)[None],
        "vert_mesh_id": np.zeros((6,), np.int32),
        "position": np.concatenate([tri, tri]),
        "normal": np.tile(np.asarray([[0, 0, 1]], np.float32), (6, 1)),
        "indices": np.asarray([[0, 1, 2], [3, 4, 5]], np.int32),
        "tri_mesh_id": np.zeros((2,), np.int32),
    }
    world, _ = _worlds(scene)
    o = torch.tensor([[0.4, 0.4, 5.0], [0.3, 0.6, 2.0], [5.0, 5.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]] * 3)
    whole = rc.raycast_batch(o, d, world, face_mask=0)
    assert whole["hit"].tolist() == [True, True, False]
    assert whole["tri"].tolist()[:2] == [0, 0]
    monkeypatch.setattr(rc, "CPU_BLOCK", 2)          # one ray per chunk
    chunked = rc.raycast_batch(o, d, world, face_mask=0)
    for k in whole:
        assert torch.equal(whole[k], chunked[k]), k
    masked = rc.raycast_batch(o, d, world, face_mask=0,
                              tri_mask=torch.tensor([False, True]))
    assert masked["tri"].tolist()[:2] == [1, 1]


@pytest.mark.parametrize("group", [16, 128])
def test_build_rt_accel_matches_jax(group):
    world, jworld = _worlds(_soup_scene(403))
    got = rt_accel.build_rt_accel(world, group=group)
    want = jax_accel.build_rt_accel(jworld, group=group)
    assert (got["group"], got["n_clusters"]) == (want["group"],
                                                 want["n_clusters"])
    np.testing.assert_array_equal(got["perm"].numpy(), want["perm"])
    np.testing.assert_array_equal(got["slot_ok"].numpy(), want["slot_ok"])
    for k in ("v0", "e1", "e2", "cl_lo", "cl_hi"):
        _close(got[k].numpy(), want[k], k)


def test_bundles_alive_entry_matches_jax_and_drops_nan_bundles():
    world, jworld = _worlds(_soup_scene(403))
    accel = rt_accel.build_rt_accel(world, group=16)
    jaccel = jax_accel.build_rt_accel(jworld, group=16)
    rng = np.random.default_rng(4)
    o = np.repeat(rng.uniform(-0.5, 0.5, (4, 1, 3)).astype(np.float32)
                  + [-12, 0, 0], 32, axis=1)
    d = (np.asarray([1.0, 0, 0], np.float32)
         + rng.uniform(-0.25, 0.25, (4, 32, 3))).astype(np.float32)
    o[3] = np.nan                                   # an all-miss bundle
    d = np.asarray(jml.safe_normalize(d), np.float32)
    alive, t0 = rt_accel._bundles_alive_entry(
        torch.from_numpy(o), torch.from_numpy(d), accel, accel["slot_ok"])
    jalive, jt0 = jax_accel._bundles_alive_entry(o, d, jaccel,
                                                 jaccel["slot_ok"])
    np.testing.assert_array_equal(alive.numpy(), jalive)
    live = np.asarray(jalive)
    _close(t0.numpy()[live], np.asarray(jt0)[live], "t0")
    assert alive[:3].sum() > 0 and int(alive[3].sum()) == 0


def _sweep_inputs():
    world, jworld = _worlds(_soup_scene(1403))
    rng = np.random.default_rng(2)
    B, R = 5, 128
    o = np.repeat(rng.uniform(-0.5, 0.5, (B, 1, 3)).astype(np.float32)
                  + [-12, 0, 0], R, axis=1)
    o += rng.uniform(-0.3, 0.3, (B, R, 3)).astype(np.float32)
    d = np.asarray([1.0, 0, 0], np.float32) \
        + rng.uniform(-0.25, 0.25, (B, R, 3)).astype(np.float32)
    return world, jworld, o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def sweep_inputs():
    return _sweep_inputs()


_TMASK = np.arange(1403) < 900


@pytest.mark.parametrize("kw", [
    dict(capb=16), dict(capb=1), dict(capb=None),
    dict(capb=16, face_mask=jrc.FACE_MASK_IGNORE_BACKFACES),
    dict(capb=16, tri_mask=True)], ids=["capb16", "capb1_overflow",
                                        "capb_none", "backfaces",
                                        "tri_mask"])
def test_bundle_casts_match_jax_kernel(kw, sweep_inputs):
    """K4's twin behind raycast_bundles_nearest/any against JAX's Pallas
    wrappers in interpret mode (tests/test_rt_accel.py:215-256's cases)."""
    world, jworld, o, d = sweep_inputs
    accel = rt_sweep.build_rt_accel_pl(world)
    jaccel = rt_pallas.build_rt_accel_pl(jworld)
    kw = dict(kw)
    tkw = dict(kw)
    if kw.pop("tri_mask", False):
        kw["tri_mask"] = jnp.asarray(_TMASK)
        tkw["tri_mask"] = torch.from_numpy(_TMASK)
    got = rt_sweep.raycast_bundles_nearest(
        torch.from_numpy(o), torch.from_numpy(d), world, accel, **tkw)
    got_any = rt_sweep.raycast_bundles_any(
        torch.from_numpy(o), torch.from_numpy(d), world, accel, **tkw)
    want = jax.jit(lambda o, d: rt_pallas.raycast_bundles_nearest_pl(
        o, d, jworld, jaccel, interpret=True, **kw))(o, d)
    want_any = jax.jit(lambda o, d: rt_pallas.raycast_bundles_any_pl(
        o, d, jworld, jaccel, interpret=True, **kw))(o, d)
    _same_hits({k: v.numpy() for k, v in got.items()}, want,
               keys=("distance", "point", "normal", "u", "v"))
    np.testing.assert_array_equal(got_any["hit"].numpy(), want_any["hit"])
    for res, ref in ((got, want), (got_any, want_any)):
        assert int(res["n_pairs"]) == int(ref["n_pairs"])
        assert bool(res["overflow"]) == bool(ref["overflow"])
    assert bool(got["overflow"]) == (kw["capb"] == 1)
    assert got["hit"].any()


def test_plain_sweep_counts_every_listed_cluster(sweep_inputs):
    """rt_sweep on the CPU runs the twin, which sweeps every listed cluster
    (the swept count equals the survivor count); a count above capb is cut
    to capb, and sweeping every cluster finds nothing the culled list
    missed (culling is conservative)."""
    world = sweep_inputs[0]
    accel = rt_sweep.build_rt_accel_pl(world)
    # Narrow beams, so that culling drops some clusters of every bundle.
    rng = np.random.default_rng(2)
    o = np.repeat(rng.uniform(-3, 3, (5, 1, 3)) + [-12, 0, 0], 128, axis=1)
    d = np.asarray([1.0, 0, 0]) + rng.uniform(-0.02, 0.02, (5, 128, 3))
    (_, _, rays, stream, lists, counts, t0q,
     _) = rt_sweep._prep(torch.tensor(o, dtype=torch.float32),
                         torch.tensor(d, dtype=torch.float32), accel,
                         accel["slot_ok"], None)
    assert 0 < int(counts.amax()) < lists.shape[1]
    swept = torch.zeros_like(counts)
    t, g = rt_sweep.rt_sweep(rays, stream, lists, counts, t0q,
                             any_hit=False, face_mask=0, swept=swept)
    assert torch.equal(swept, counts)
    every = torch.full_like(counts, lists.shape[1] + 5)
    t2, g2 = rt_sweep.rt_sweep_plain(rays, stream, lists, every, t0q,
                                     any_hit=False, face_mask=0)
    assert torch.equal(t2.view(torch.int32), t.view(torch.int32))
    assert torch.equal(g2, g)


def test_k4_edge_cases_on_the_twin():
    """chip_smoke's K4 edge cases (ties, tri_mask, +0.0 and -0.0, det at
    EPSILON, face masks, NaN-origin bundles with no survivor, the winner in
    the last cluster, coplanar triangles across clusters, a NaN ray among
    healthy ones) hold for the plain twin on the CPU."""
    assert chip_smoke.check_k4_edge_cases("cpu") == 13


def test_sweep_has_no_fallback_for_other_devices():
    rays = torch.empty((1, 6, 4), device="meta")
    stream = torch.empty((11, 128), device="meta")
    i = torch.empty((1, 1), dtype=torch.int32, device="meta")
    c = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rt_sweep.rt_sweep(rays, stream, i, c, i, any_hit=False, face_mask=0)


def _jax_shadow_hash(ray_id, s):
    """ops/raytrace.py:318-321 verbatim (JAX's int32 arithmetic)."""
    hh = ray_id * jnp.int32(-1640531535) + jnp.int32(40503 * (s + 1))
    hh = hh ^ (hh >> 13)
    hh = hh * jnp.int32(-1028477387)
    return hh ^ (hh >> 16)


@pytest.mark.parametrize("s", [0, 3])
def test_shadow_hash_matches_jax(s):
    """Every wrap of the multiply and every arithmetic shift: ids from 0
    past 2^31 / 1640531535 up to a 4K frame's, and near int32's top."""
    ids = np.concatenate([np.arange(0, 70_000, dtype=np.int32),
                          np.arange(0, 8_294_400, 97, dtype=np.int32),
                          np.arange(2 ** 31 - 5000, 2 ** 31 - 1,
                                    dtype=np.int64).astype(np.int32)])
    got = raytrace.shadow_hash(torch.from_numpy(ids), s).numpy()
    want = np.asarray(_jax_shadow_hash(jnp.asarray(ids), s))
    np.testing.assert_array_equal(got, want)


def test_pixel_ray_directions_match_jax():
    u = default_frame_uniforms(70, 46)
    u["camera_rotation"] = np.asarray(
        jml.quat_from_yaw_pitch_roll(0.4, -0.2, 0.05), np.float32)
    u["fov_degrees"] = np.float32(75.0)
    got = sky.pixel_ray_directions(u, 70, 46, "cpu").numpy()
    want = np.asarray(jax_sky.pixel_ray_directions(u, 70, 46, xp=jnp))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def _frame_scene():
    """The cube and ground of tests/test_rt_accel.py:166-300."""
    checker = np.asarray(tex_np.checkerboard(16, 4)["data"])
    return scene_mod.build_scene_buffers([
        scene_mod.MeshInstance(primitives.cube(1.0),
                               jml.translation([0.0, 0.0, -3.0]),
                               texture=checker),
        scene_mod.MeshInstance(primitives.plane(20.0),
                               jml.translation([0.0, -1.0, 0.0]))])


def _jax_frame(sc, u, W, H, kw, bundles):
    params = JaxRenderParams(width=W, height=H, pallas_interpret=bundles)
    extra = dict(cluster_cap=8) if bundles else {}
    c, d = jax.jit(lambda s, uu: jax_raytraced(s, uu, params, chunk=256,
                                               **kw, **extra))(sc, u)
    return np.asarray(c), np.asarray(d)


def _assert_frames_close(got, want, msg):
    (c, d), (jc, jd) = got, want
    flip = (d == DEPTH_CLEAR) != (jd == DEPTH_CLEAR)
    assert flip.mean() < 2e-3, (msg, flip.mean())
    cov = (jd != DEPTH_CLEAR) & ~flip
    assert cov.sum() > 0.3 * cov.size, msg
    np.testing.assert_allclose(d[cov], jd[cov], rtol=0, atol=1e-5,
                               err_msg=msg)
    diff = np.abs(c - jc).max(-1)
    assert (diff < 1e-3).mean() > 0.99, (msg, diff.max())


@pytest.mark.parametrize("kw", [
    {"shadows": True}, {"shadows": True, "shadow_samples": 2},
    {"shadows": False, "reflections": True}],
    ids=["hard", "soft2", "reflections"])
def test_raytraced_frame_matches_jax(kw):
    """70x46 (not a multiple of the 32x32 bundles): both routes of the port
    against JAX's (its bundle route through the Pallas kernel in interpret
    mode), and the port's two routes equal on every pixel."""
    sc = _frame_scene()
    W, H = 70, 46
    u = default_frame_uniforms(W, H)
    u["camera_position"] = np.asarray([0.0, 0.5, 1.0], np.float32)
    if kw.get("shadow_samples"):
        u["rt_light_radius"] = np.float32(0.3)
    ts = scene_to_torch(sc, "cpu")
    frames = {}
    for cap in (0, 24):
        c, d = raytrace.render_frame_raytraced(ts, u, RenderParams(W, H),
                                               cluster_cap=cap, **kw)
        frames[cap] = (c.numpy(), d.numpy())
        _assert_frames_close(frames[cap], _jax_frame(sc, u, W, H, kw,
                                                     bool(cap)),
                             f"{kw} cluster_cap={cap}")
    for a, b in zip(frames[0], frames[24]):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_raytraced_mesh_visible_matches_jax():
    """64x48 with the cube hidden through uniforms["mesh_visible"]: the
    ground shows through where the cube stood, on both routes."""
    sc = _frame_scene()
    W, H = 64, 48
    u = default_frame_uniforms(W, H)
    u["camera_position"] = np.asarray([0.0, 0.5, 1.0], np.float32)
    u["mesh_visible"] = np.asarray([False, True])
    ts = scene_to_torch(sc, "cpu")
    shown = raytrace.render_frame_raytraced(ts, dict(u, mesh_visible=np.asarray(
        [True, True])), RenderParams(W, H), cluster_cap=24)
    for cap in (0, 24):
        c, d = raytrace.render_frame_raytraced(ts, u, RenderParams(W, H),
                                               cluster_cap=cap)
        _assert_frames_close((c.numpy(), d.numpy()),
                             _jax_frame(sc, u, W, H, {}, bool(cap)),
                             f"mesh_visible cluster_cap={cap}")
        assert (d != shown[1]).float().mean() > 0.01


def test_engine_frame_fn_renders_raytraced_frame():
    """Engine(frame_fn=...) renders and presents through the ray tracer;
    with a sky panorama (refused on this route until the sky was ported)
    the misses show it and the hits are unchanged."""
    sc = _frame_scene()
    fn = functools.partial(raytrace.render_frame_raytraced, cluster_cap=24)
    eng = Engine(sc, RenderParams(64, 48), device="cpu", frame_fn=fn)
    u = dict(eng.uniforms, camera_position=np.float32([0.0, 0.5, 1.0]))
    color, depth = eng.render(u)
    want = raytrace.render_frame_raytraced(eng.scene, u, eng.params,
                                           cluster_cap=24)
    assert torch.equal(color, want[0]) and torch.equal(depth, want[1])
    rgb = eng.present(u)
    assert rgb.shape == (48, 64, 3) and rgb.dtype == np.uint8
    pano = np.zeros((4, 8, 4), np.float32)
    pano[..., 1] = pano[..., 3] = 1.0
    sky_c, sky_d = eng.render(dict(u, sky_panorama=pano))
    miss = depth == DEPTH_CLEAR
    assert torch.equal(sky_d, depth) and 0 < miss.float().mean() < 1
    assert torch.equal(sky_c[~miss], color[~miss])
    assert torch.allclose(sky_c[miss], torch.from_numpy(pano[0, 0]))


# ---- the sweep wrapper's own Python: bundle order, launch arguments -------

def test_bundle_order_longest_first_stable_empty_last():
    """bundle_order is a permutation of the bundles, longest survivor list
    first, equal counts in bundle order, the bundles that list nothing
    last; it stays on the counts' device and reads nothing back (it runs on
    a meta tensor, which has no data to read)."""
    counts = torch.tensor([0, 3, 7, 0, 3, 1, 7, 0], dtype=torch.int32)
    order = rt_sweep.bundle_order(counts)
    assert order.dtype == torch.int64 and order.device == counts.device
    assert order.tolist() == [2, 6, 1, 4, 5, 0, 3, 7]
    assert sorted(order.tolist()) == list(range(8))
    assert int((counts[order][-3:] != 0).sum()) == 0
    meta = rt_sweep.bundle_order(torch.empty(5, dtype=torch.int32,
                                             device="meta"))
    assert meta.device.type == "meta" and meta.shape == (5,)


def _prepped(sweep_inputs):
    world, _, o, d = sweep_inputs
    accel = rt_sweep.build_rt_accel_pl(world)
    prep = rt_sweep._prep(torch.from_numpy(o), torch.from_numpy(d), accel,
                          accel["slot_ok"], None)
    return accel, prep[2:7]


@pytest.mark.parametrize("order", ["reversed", "plain", "raises"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_sweep_on_cpu_equals_twin_whatever_the_order(order, any_hit,
                                                    sweep_inputs,
                                                    monkeypatch):
    """On CPU tensors rt_sweep's results are rt_sweep_plain's whatever
    order the wrapper would hand the kernel, with or without the clusters'
    boxes; `tested` counts every listed cluster once per part."""
    accel, args = _prepped(sweep_inputs)

    def raises(counts):
        raise AssertionError("the twin takes no bundle order")

    monkeypatch.setattr(rt_sweep, "bundle_order", {
        "reversed": lambda c: torch.arange(c.numel() - 1, -1, -1),
        "plain": lambda c: torch.arange(c.numel()),
        "raises": raises}[order])
    want_t, want_g = rt_sweep.rt_sweep_plain(*args, any_hit=any_hit,
                                             face_mask=0)
    tested = torch.zeros_like(args[3])
    t, g = rt_sweep.rt_sweep(*args, any_hit=any_hit, face_mask=0,
                             boxes=(accel["cl_lo"], accel["cl_hi"]),
                             tested=tested)
    assert torch.equal(t.view(torch.int32), want_t.view(torch.int32))
    assert torch.equal(g, want_g)
    R = args[0].shape[2]
    assert torch.equal(tested, args[3] * -(-R // rt_sweep.PART_RAYS))


def test_sweep_launch_args_pass_the_order_and_the_boxes(sweep_inputs):
    """What the wrapper hands the kernel: the bundle order it computed, the
    boxes' pointers (or none), fresh outputs, zeroed counters for `swept`
    (one per group of GROUP_RAYS rays) and `tested`."""
    accel, args = _prepped(sweep_inputs)
    B, _, R = args[0].shape
    boxes = (accel["cl_lo"], accel["cl_hi"])
    swept = torch.zeros(B, dtype=torch.int32)
    tested = torch.zeros(B, dtype=torch.int32)
    (out_t, out_g), call, (order, groups, counted) = \
        rt_sweep.sweep_launch_args(*args, any_hit=True, face_mask=2,
                                   swept=swept, boxes=boxes, tested=tested)
    assert torch.equal(order, rt_sweep.bundle_order(args[3]))
    assert call[:5] == tuple(a.data_ptr() for a in args)
    assert call[5] == order.data_ptr()
    assert call[6:8] == tuple(b.data_ptr() for b in boxes)
    assert call[8:12] == (out_t.data_ptr(), out_g.data_ptr(),
                          groups.data_ptr(), counted.data_ptr())
    assert call[12:] == (B, R, args[1].shape[1], args[2].shape[1], 1, 2)
    assert out_t.shape == out_g.shape == (B, R)
    assert groups.shape == (B, 1) and int(groups.abs().sum()) == 0
    assert int(counted.abs().sum()) == 0
    _, call, (_, groups, counted) = rt_sweep.sweep_launch_args(
        *args, any_hit=False, face_mask=0)
    assert call[6:8] == (None, None) and call[10:12] == (None, None)
    assert groups is None and counted is None and call[16] == 0


@pytest.mark.parametrize("what", ["boxes shape", "boxes dtype", "swept shape",
                                  "tested dtype", "lists dtype",
                                  "rays not contiguous", "stream width"])
def test_sweep_launch_args_reject(what, sweep_inputs):
    """The wrapper raises on what the kernel does not take."""
    accel, args = _prepped(sweep_inputs)
    rays, stream, lists, counts, t0q = args
    B = rays.shape[0]
    lo, hi = accel["cl_lo"], accel["cl_hi"]
    kw = dict(any_hit=False, face_mask=0)
    if what == "boxes shape":
        kw["boxes"] = (lo[:-1], hi)
    elif what == "boxes dtype":
        kw["boxes"] = (lo.double(), hi)
    elif what == "swept shape":
        kw["swept"] = torch.zeros(B + 1, dtype=torch.int32)
    elif what == "tested dtype":
        kw["tested"] = torch.zeros(B, dtype=torch.int64)
    elif what == "lists dtype":
        lists = lists.long()
    elif what == "rays not contiguous":
        rays = rays.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        stream = stream[:, :-1].contiguous()
    with pytest.raises(ValueError):
        rt_sweep.sweep_launch_args(rays, stream, lists, counts, t0q, **kw)


@pytest.fixture(scope="module")
def sweep_study_casts():
    """utils.sweep_study on the CPU: both casts of a 96x64 ray-traced
    frame of the bench scene from the bench view."""
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.utils import sweep_study
    params = RenderParams(96, 64)
    eng = Engine(scenes.bench_scene(), params, device="cpu")
    calls, accel = sweep_study.capture_casts(
        eng, scenes.camera_uniforms(eng.uniforms, 0), params, 24)
    return [sweep_study.study_cast(a, kw, accel) for a, kw in calls]


@pytest.mark.parametrize("cast", [0, 1], ids=["primary", "shadow"])
def test_part_skipping_rules_drop_no_passing_sweep(cast, sweep_study_casts):
    """The rules by which a part of a bundle skips a cluster in
    csrc/rt_sweep.cu, in their PyTorch form (rt_accel's slab test on the
    part's own bounds, the entry time against every ray's best hit, the
    stop once the part's rays are done), never drop a (part, cluster) pair
    in which a ray's result would change (for the slab test: in which a
    ray passes at all), at any part size; and they do drop pairs."""
    study = sweep_study_casts[cast]
    assert study["mode"] == ("any_hit" if cast else "nearest")
    for name, row in study["layouts"].items():
        assert row["wrong_done"] == 0, name
        assert row["wrong_slab"] == 0, name
        assert row.get("wrong_entry", 0) == 0, name
        assert 0 < row["left_that_pass"] <= row["part_sweeps"] \
            - row["no_ray_passes"], name
        assert row["left_after_slab"] < row["part_sweeps"], name
