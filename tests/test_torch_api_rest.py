"""The JAX package's remaining public API on the port, against JAX on the
CPU: Camera, make_vertex_input / VARYING_KEYS, the atlas sampler by
texture id, mathlib's identity / scale / quat_conjugate and hostmath's
look_at, binning.pair_cap_overflow, rt_accel's two bundle counters, the
profiling helpers (trace, annotate, hard_sync, timed_frames, the
watchdog) and the packages' re-exports.

Tolerances: the host math, the sampler and the integer counters are
exact (the same float32 operations in the same order, integer results);
hard_sync's probe is a float32 sum that jnp.sum and torch.sum add in
different orders, so rtol 1e-6.
"""

import glob
import importlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softwarerenderer_tpu import CullMode
from softwarerenderer_tpu import RenderParams as JaxRenderParams
from softwarerenderer_tpu import shaders as jshaders
from softwarerenderer_tpu.engine import renderer as jr
from softwarerenderer_tpu.models import primitives as jprim
from softwarerenderer_tpu.models import scene as jscene
from softwarerenderer_tpu.ops import binning as jbin
from softwarerenderer_tpu.ops import geometry as jgeom
from softwarerenderer_tpu.ops import rt_accel as jaccel
from softwarerenderer_tpu.ops import texture as jtex
from softwarerenderer_tpu.utils import mathlib as jml
from softwarerenderer_tpu.utils import profiling as jprof
from softwarerenderer_tpu_torch import RenderParams, scenes, shaders
from softwarerenderer_tpu_torch.models import scene as tscene
from softwarerenderer_tpu_torch.ops import binning as tbin
from softwarerenderer_tpu_torch.ops import rt_accel as taccel
from softwarerenderer_tpu_torch.ops import sky
from softwarerenderer_tpu_torch.ops import texture as ttex
from softwarerenderer_tpu_torch.utils import hostmath
from softwarerenderer_tpu_torch.utils import mathlib as tml
from softwarerenderer_tpu_torch.utils import profiling as tprof

jrc = importlib.import_module("softwarerenderer_tpu.sim.raycast")
trc = importlib.import_module("softwarerenderer_tpu_torch.sim.raycast")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = np.float32
RNG = np.random.default_rng(18)


def assert_same(got, want, msg=""):
    """Equal dtype, shape and bits (NaN where NaN)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (msg, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=msg)


# ---------------------------------------------------------------------------
# Camera and the host math
# ---------------------------------------------------------------------------

def _rotations(n=8):
    q = RNG.normal(size=(n, 4)).astype(F32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = jml.QUAT_IDENTITY                     # the default camera's
    q[1] = jml.quat_from_yaw_pitch_roll(F32(0.0), F32(np.pi / 2), F32(0.0))
    return q


@pytest.mark.parametrize("i", range(8))
def test_camera_methods_equal_jax(i):
    """Camera's front, right, up, view_matrix and euler_degrees equal the
    JAX class's (numpy path) bit for bit at 8 rotations (the identity, a
    pitch of 90 degrees, six drawn)."""
    rot = _rotations()[i]
    pos = RNG.uniform(-20, 20, 3).astype(F32)
    got = tscene.Camera(position=pos, rotation=rot)
    want = jscene.Camera(position=pos, rotation=rot)
    for name in ("front", "right", "up", "view_matrix", "euler_degrees"):
        assert_same(getattr(got, name)(), getattr(want, name)(), name)


def test_camera_defaults_equal_jax():
    got, want = tscene.Camera(), jscene.Camera()
    assert_same(got.position, want.position)
    assert_same(got.rotation, want.rotation)
    assert got.sensitivity == want.sensitivity == 0.1
    assert_same(got.view_matrix(), want.view_matrix())
    # The default rotation is a copy, not the shared constant.
    got.rotation[0] = 1.0
    assert tml.QUAT_IDENTITY[0] == 0.0


def test_identity_scale_conjugate_look_at_equal_jax():
    """mathlib's identity, scale (uniform and per-axis), quat_conjugate
    (one and a batch) and hostmath's look_at equal JAX's numpy path."""
    assert_same(tml.identity(), jml.identity())
    for s in (0.12, F32(2.5), [0.5, 2.0, 3.0], np.float64([1, -1, 0.25])):
        assert_same(tml.scale(s), jml.scale(s), str(s))
    assert hostmath.scale is tml.scale
    q = _rotations()
    assert_same(tml.quat_conjugate(q[2]), jml.quat_conjugate(q[2]))
    assert_same(tml.quat_conjugate(q), jml.quat_conjugate(q))
    for k in range(4):
        eye, target = RNG.uniform(-5, 5, (2, 3)).astype(F32)
        up = [0.0, 1.0, 0.0] if k % 2 else RNG.normal(size=3).astype(F32)
        assert_same(hostmath.look_at(eye, target, up),
                    jml.look_at(eye, target, up), f"look_at {k}")


@pytest.mark.parametrize("mask", range(8))
def test_make_vertex_input_equals_jax(mask):
    """make_vertex_input with and without each of uv, normal and color:
    the same keys, float32 arrays, values; VARYING_KEYS equal."""
    n = 7
    pos = RNG.normal(size=(n, 3))                 # float64 in, float32 out
    kw = {}
    if mask & 1:
        kw["uv"] = RNG.uniform(size=(n, 2))
    if mask & 2:
        kw["normal"] = RNG.normal(size=(n, 3)).astype(F32)
    if mask & 4:
        kw["color"] = RNG.uniform(size=(n, 4)).astype(F32)
    got = shaders.make_vertex_input(pos, **kw)
    want = jshaders.make_vertex_input(pos, **kw)
    assert list(got) == list(want)
    for k in want:
        assert_same(got[k], want[k], k)
    assert shaders.VARYING_KEYS == jshaders.VARYING_KEYS


# ---------------------------------------------------------------------------
# The atlas sampler by texture id
# ---------------------------------------------------------------------------

def _atlas():
    """A packed scene's RGBA8 atlas and tables (four textures of three
    sizes), and the same atlas as float32."""
    texs = [np.asarray(jtex.checkerboard(16, 4)["data"]),
            RNG.uniform(size=(8, 24, 4)).astype(F32),
            np.asarray(jtex.checkerboard(32, 8, (1, 0, 0, 1),
                                         (0, 0, 1, 1))["data"]),
            RNG.uniform(size=(5, 7, 4)).astype(F32)]
    sc = jscene.build_scene_buffers([
        jscene.MeshInstance(jprim.cube(1.0), texture=t) for t in texs])
    atlas = np.asarray(sc["atlas_data"])
    assert atlas.dtype == np.uint8
    return (atlas, atlas.astype(F32) / F32(255.0) + F32(0.001),
            np.asarray(sc["atlas_offsets"], np.int32),
            np.asarray(sc["atlas_sizes"], np.int32))


def _uvs(sizes, tex_id):
    """uv below 0, above 1, in range and on texel edges (k / size, also
    shifted by whole periods)."""
    n = tex_id.shape[0]
    h = sizes[tex_id, 0].astype(F32)
    w = sizes[tex_id, 1].astype(F32)
    k = RNG.integers(0, 64, (n, 2)).astype(F32)
    edge = np.stack([k[:, 0] / w, k[:, 1] / h], -1)
    wraps = RNG.integers(-3, 4, (n, 2)).astype(F32)
    uv = np.concatenate([
        RNG.uniform(-3.0, 0.0, (n, 2)), RNG.uniform(1.0, 4.0, (n, 2)),
        RNG.uniform(0.0, 1.0, (n, 2)), edge, edge + wraps,
        -edge]).astype(F32)
    return uv, np.tile(tex_id, 6)


@pytest.mark.parametrize("kind", ["rgba8", "float"])
def test_sample_atlas_nearest_equals_jax(kind):
    """sample_atlas_nearest against JAX's numpy path and its jnp path
    (the one-hot region lookup), bit for bit.  The jnp path runs op by
    op: under jit XLA turns bytes / 255 into a multiply by the
    reciprocal, an ulp off the reference's division on 126 of the 256
    byte values."""
    atlas8, atlasf, offsets, sizes = _atlas()
    atlas = atlas8 if kind == "rgba8" else atlasf
    uv, tid = _uvs(sizes, RNG.integers(0, len(sizes), 400).astype(np.int32))
    got = ttex.sample_atlas_nearest(
        torch.from_numpy(atlas), torch.from_numpy(offsets),
        torch.from_numpy(sizes), torch.from_numpy(tid),
        torch.from_numpy(uv)).numpy()
    want_np = jtex.sample_atlas_nearest(atlas, offsets, sizes, tid, uv)
    want_jnp = jtex.sample_atlas_nearest(
        jnp.asarray(atlas), offsets, sizes, jnp.asarray(tid),
        jnp.asarray(uv), xp=jnp)
    assert_same(got, want_np, "numpy path")
    assert_same(got, np.asarray(want_jnp), "jnp path")


# ---------------------------------------------------------------------------
# pair_cap_overflow on the bench scene
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench_tris():
    """The bench scene's triangles at 320x180 from JAX's geometry stage
    (bench camera), fed to both packages alike."""
    w, h = 320, 180
    sc = scenes.bench_scene()
    u = scenes.camera_uniforms(jr.default_frame_uniforms(w, h), 0)
    view, proj = jr.camera_matrices(u, w, h, xp=np)
    u.update(model=sc["mesh_matrices"][sc["vert_mesh_id"]],
             view=np.asarray(view), projection=np.asarray(proj))
    vin = {k: sc[k] for k in ("position", "uv", "normal", "color")}
    tris = jax.jit(lambda vin, idx, u: jgeom.build_triangles(
        jr.scene_vertex_shader, vin, idx, u, width=w, height=h,
        cull_mode=CullMode.BACK, near_clip=u["near_clip"]))(
            vin, sc["indices"], u)
    return w, h, {k: np.asarray(tris[k]) for k in ("bbox", "valid")}


@pytest.mark.parametrize("tiling", ["params", "args", "row_offset"])
def test_pair_cap_overflow_equals_jax(bench_tris, tiling):
    """pair_cap_overflow with pair_cap below and above the live pairs (and
    off), at params' tiling, with tile_h / tile_w / span_cap arguments
    replacing them, and for a band at a row offset: JAX's integers."""
    w, h, tris = bench_tris
    tt = {k: torch.from_numpy(v) for k, v in tris.items()}
    kw = {"params": {}, "args": dict(tile_h=16, tile_w=64, span_cap=4),
          "row_offset": dict(row_offset=60)}[tiling]
    p = RenderParams(w, h, tile_h=32, tile_w=128, span_cap=8)
    jp = JaxRenderParams(w, h, tile_h=32, tile_w=128, span_cap=8)
    live = int(jbin.live_pair_count(tris, jp, **kw))
    assert int(tbin.live_pair_count(tt, p, **kw)) == live > 100
    for cap in (0, live // 3, live - 1, live, live + 1000):
        got = tbin.pair_cap_overflow(tt, p.replace(pair_cap=cap), **kw)
        want = jbin.pair_cap_overflow(tris, jp.replace(pair_cap=cap), **kw)
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == int(want) == (max(0, live - cap) if cap else live)
    assert int(tbin.global_count(tt, p, **kw)) == int(
        jbin.global_count(tris, jp, **kw))


# ---------------------------------------------------------------------------
# The bundle counters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frame_bundles():
    """A 64x64 frame of a cube over a plane (camera at the origin) as
    bundles of 32x32 primary rays, plus jittered secondary bundles off the
    plane, and both packages' worlds and Morton accels."""
    sc = jscene.build_scene_buffers([
        jscene.MeshInstance(jprim.uv_sphere(0.8, rings=12, sectors=24),
                            jml.translation([0.3, 0.0, -3.0])),
        jscene.MeshInstance(jprim.cube(1.0), jml.translation([-1.2, 0.5,
                                                              -4.0])),
        jscene.MeshInstance(jprim.plane(20.0),
                            jml.translation([0.0, -1.0, 0.0]))])
    u = jr.default_frame_uniforms(64, 64)
    dirs = sky.pixel_ray_directions(u, 64, 64, device="cpu").numpy()
    d = dirs.reshape(2, 32, 2, 32, 3).transpose(0, 2, 1, 3, 4) \
        .reshape(4, 1024, 3)
    o = np.zeros_like(d)
    o2 = (RNG.uniform(-2, 2, (4, 1, 3)) + RNG.uniform(
        -0.2, 0.2, (4, 1024, 3))).astype(F32) + F32([0, -0.9, -3])
    d2 = (F32([0.3, 1.0, -0.2]) + RNG.uniform(-0.3, 0.3, (4, 1024, 3))) \
        .astype(F32)
    o, d = np.concatenate([o, o2]), np.concatenate([d, d2])
    tsc = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in sc.items()}
    world, jworld = trc.build_collision_world(tsc), \
        jrc.build_collision_world(sc)
    return (o.astype(F32), d.astype(F32), world, jworld,
            taccel.build_rt_accel(world, group=64),
            jaccel.build_rt_accel(jworld, group=64),
            np.asarray(sc["tri_mesh_id"]) != 0)


@pytest.mark.parametrize("masked", [False, True])
def test_bundle_counters_equal_jax(frame_bundles, masked):
    """bundle_pair_count over the batch and bundle_survivor_count of each
    bundle equal JAX's integers, with and without a tri_mask (here: the
    sphere's triangles dropped, so its clusters die)."""
    o, d, world, jworld, accel, jacc, keep = frame_bundles
    tm = keep if masked else None
    got = taccel.bundle_pair_count(o, d, world, accel, tri_mask=tm)
    want = jaccel.bundle_pair_count(o, d, jworld, jacc, tri_mask=tm)
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(want) > 0
    per = [int(taccel.bundle_survivor_count(o[b], d[b], world, accel,
                                            tri_mask=tm))
           for b in range(o.shape[0])]
    jper = [int(jaccel.bundle_survivor_count(o[b], d[b], jworld, jacc,
                                             tri_mask=tm))
            for b in range(o.shape[0])]
    assert per == jper
    if masked:
        assert int(got) < int(taccel.bundle_pair_count(o, d, world, accel))


def test_bundle_pair_count_is_the_sweeps_listed_pairs(frame_bundles):
    """On the sweep's own accel (128-slot clusters) the counter is the
    n_pairs its nearest cast lists (the same slab test, after the same
    normalization)."""
    from softwarerenderer_tpu_torch.ops import rt_sweep
    o, d, world, _, _, _, keep = frame_bundles
    accel = rt_sweep.build_rt_accel_pl(world)
    for tm in (None, torch.from_numpy(keep)):
        res = rt_sweep.raycast_bundles_any(
            torch.from_numpy(o), torch.from_numpy(d), world, accel,
            tri_mask=tm)
        assert int(taccel.bundle_pair_count(o, d, world, accel,
                                            tri_mask=tm)) \
            == int(res["n_pairs"])


# ---------------------------------------------------------------------------
# Profiling helpers
# ---------------------------------------------------------------------------

def _tree(xp):
    """A nested dict / tuple / list of float, integer and bool leaves."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(64, 33)).astype(F32) * 1e3
    b = rng.integers(-1000, 1000, (17,)).astype(np.int32)
    c = rng.uniform(size=(3, 4, 5)).astype(F32)
    m = rng.uniform(size=9) > 0.5
    arr = torch.from_numpy if xp is torch else jnp.asarray
    return {"z": (arr(a), [arr(b), {"c": arr(c)}]), "a": arr(m),
            "n": None}


def test_hard_sync_equals_jax_probe():
    """hard_sync over nested dicts, tuples and lists returns JAX's probe
    on the same arrays (rtol 1e-6: summation order), with and without
    the watchdog, and 0.0 for a tree without tensors."""
    want = jprof.hard_sync(_tree(jnp))
    got = tprof.hard_sync(_tree(torch))
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(tprof.hard_sync(_tree(torch), timeout_s=30),
                               want, rtol=1e-6)
    assert tprof.hard_sync({"x": None, "y": [1, 2]}) == 0.0
    assert issubclass(tprof.DeviceSyncTimeout, RuntimeError)


def test_timed_frames_calls_and_time():
    """timed_frames calls step_fn with 0 .. warmup + n - 1 in order and
    returns a positive time a frame."""
    seen = []

    def step(i):
        seen.append(i)
        return {"x": torch.full((8,), float(i))}

    dt = tprof.timed_frames(step, 5, warmup=3, timeout_s=30)
    assert seen == list(range(8)) and dt > 0
    seen.clear()
    assert tprof.timed_frames(step, 2) > 0 and seen == [0, 1, 2, 3]


_WATCHDOG = """
import sys, time
from softwarerenderer_tpu_torch.utils import profiling
if sys.argv[1] == "fire":
    profiling.arm_watchdog("stuck stage", 0.2)
    time.sleep(30)
else:
    with profiling.watchdog("quick stage", 0.5):
        pass
    time.sleep(1.0)
print("done")
"""


@pytest.mark.parametrize("mode", ["fire", "cancel"])
def test_watchdog_exits_42_with_dump(mode):
    """An armed watchdog that runs out dumps the threads with its
    "[watchdog]" line and exits 42; one cancelled in time does not."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _WATCHDOG, mode],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=REPO)
    if mode == "fire":
        assert out.returncode == 42, out.stderr
        assert "[watchdog] stage 'stuck stage'" in out.stderr
        assert "Thread" in out.stderr and "done" not in out.stdout
    else:
        assert out.returncode == 0, out.stderr
        assert "[watchdog]" not in out.stderr and "done" in out.stdout


def test_trace_writes_annotated_chrome_trace(tmp_path):
    """trace yields its directory and writes a Chrome trace there that
    holds an annotate span and the ops under it."""
    with tprof.trace(str(tmp_path / "t")) as d:
        with tprof.annotate("srt.test_span"):
            torch.ones(64).cumsum(0)
    assert d == str(tmp_path / "t")
    files = glob.glob(os.path.join(d, "*.json"))
    assert len(files) == 1
    names = [e.get("name") for e in json.load(open(files[0]))["traceEvents"]]
    assert "srt.test_span" in names


def test_packages_reexport_like_jax():
    """ops, utils and models re-export the modules JAX's __init__s do."""
    import softwarerenderer_tpu_torch.models as m
    import softwarerenderer_tpu_torch.ops as o
    import softwarerenderer_tpu_torch.utils as u
    assert m.scene.Camera is tscene.Camera and m.primitives.cube
    assert o.texture.sample_atlas_nearest is ttex.sample_atlas_nearest
    assert u.mathlib.identity is tml.identity
