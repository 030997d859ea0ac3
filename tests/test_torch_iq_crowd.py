"""The image-quality frame on the textured LOD crowd (the benchmark's
lodcrowd-iq-1080p configuration, cut to a test's size) against the plain
reference in portbench/reference: the whole frame through Engine.render
(ssaa 2, trilinear mips and shader, sky, SSAO, bloom, ACES, FXAA), each
stage alone on seeded inputs, the frame.post and frame.ssaa spans, and the
reference's independence from JAX and from the port.

The reference rounds each operation once in the renderer's order, so the
stages agree to a few ulps and the frames on every byte; the frames are
held to the cell's own limits, the stages to 1e-6 (the mip chain to one
RGBA8 level, where the two box averages may round a tie apart)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import post as rpost
from portbench.reference import texture as rtex
from softwarerenderer_tpu_torch.config import RenderParams
from softwarerenderer_tpu_torch.engine import renderer
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.models.scene import (MeshInstance,
                                                     build_scene_buffers)
from softwarerenderer_tpu_torch.ops import (bloom, fxaa, sky, ssao,
                                            texture, tonemap)
from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR
from softwarerenderer_tpu_torch.utils import profiling

CELL = "lodcrowd-iq-1080p.pan"
SWEEP = "lodcrowd-4k.sweep"
# The configuration at a test's size: 4 x 4 spheres, two 64² textures, a
# 32 x 64 sky, 192 x 108 out of a 384 x 216 raster.
SMALL = {"grid": 4, "width": 192, "height": 108,
         "textures": {"count": 2, "size": 64, "lattice": [4, 16, 32]},
         "sky": {"height": 32, "width": 64, "lattice": [4, 8]}}
SEED = 2 ** 33 + 17


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its frames are many small
    ops, which torch's default pool slows down when the suite's workers
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _tf32_restored():
    """The reference turns TF32 off for its whole process: give the two
    flags back to the tests that run after these in the same worker."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


@pytest.fixture(scope="module")
def cell():
    c = harness.cell_of(CELL)
    inputs = c["module"].make_inputs(SEED, SMALL)
    return c, inputs, c["module"].Program(inputs, "cpu")


@pytest.mark.parametrize("k", [0, 300, 600])
def test_frame_matches_the_reference(cell, k):
    c, inputs, prog = cell
    cam = harness.camera_at(c["camera"], k)
    rgb = prog.to_rgb8(prog.render(cam)).numpy()
    ref = c["module"].Reference(inputs, "cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    d = harness.compare(rgb, ref.frame(cam))
    assert rgb.shape == (108, 192, 3)
    assert all(d[m] <= c["limits"][m] for m in harness.CHECKS), d
    color, depth, covered = ref.shaded(cam)
    assert covered.any() and not covered.all()     # spheres and sky


def _atlas_scene(images):
    """Two textured triangles, one a texture, packed by the port."""
    tri = {"position": np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0]]),
           "normal": np.zeros((3, 3), np.float32),
           "color": np.ones((3, 4), np.float32),
           "uv": np.float32([[0.0, 0.0], [0.7, 0.1], [0.2, 0.9]]),
           "indices": np.int32([[0, 1, 2]])}
    return build_scene_buffers([
        MeshInstance(tri, texture=im.astype(np.float32) / np.float32(255.0))
        for im in images])


def _trilinear(rng):
    """The port's mip regions and trilinear fetch (mip_regions and
    scene_fragment_shader_trilinear's samples) against the reference's
    chain, per-slot lod and trilinear fetch, over slots of every lod."""
    cfg = harness.cell_of(CELL)["module"]
    images = [cfg.noise_texture(rng, 64, [4, 16, 32]) for _ in range(2)]
    scene = scene_to_torch(_atlas_scene(images), "cpu")
    n = 4096
    slot = torch.from_numpy(rng.integers(0, 4, n))
    # |1/area| spread so that every level of the 7-level chains is hit
    inv_area = torch.from_numpy(
        (2.0 ** rng.uniform(-14.0, 2.0, 4)).astype(np.float32))
    tid2 = scene["tri_texture_id"].long().repeat_interleave(2)
    reg = renderer.mip_regions(scene, scene["indices"], inv_area, tid2, True)
    uv = torch.from_numpy(rng.uniform(-2.0, 3.0, (n, 2)).astype(np.float32))
    r = {k: v[slot] for k, v in reg.items()}
    atlas = scene["atlas_data"]
    t0 = texture.sample_atlas_region_bilinear(
        atlas, r["tex_oy"], r["tex_ox"], r["tex_h"], r["tex_w"], uv)
    t1 = texture.sample_atlas_region_bilinear(
        atlas, r["tex_oy2"], r["tex_ox2"], r["tex_h2"], r["tex_w2"], uv)
    got = t0 + (t1 - t0) * (r["mip_frac256"].float()[:, None] / 256.0)
    mips = rtex.Mips([rtex.mip_chain(np.full((1, 1, 4), 255, np.uint8),
                                     "cpu")]
                     + [rtex.mip_chain(im, "cpu") for im in images], "cpu")
    tex = torch.tensor([1, 2])[slot // 2]
    lod = rtex.slot_lod(scene["uv"], scene["indices"].long(),
                        torch.arange(4), inv_area,
                        mips.base_texels(torch.tensor([1, 1, 2, 2])))
    want = rtex.trilinear(mips, tex, lod[slot], uv)
    assert len(set(np.floor(lod.numpy()).tolist())) >= 3
    return got, want, 1.0 / 255.0 + 1e-6


def _seeded_frame(rng, h=48, w=80):
    """A colour frame with values past 1 (bloom's bright pass) and a depth
    of three depth layers over open sky, as the raster stores them."""
    color = torch.from_numpy(rng.uniform(0.0, 1.3, (h, w, 4))
                             .astype(np.float32))
    color[..., 3] = 1.0
    layer = rng.integers(0, 4, (h // 8, w // 8)).repeat(8, 0).repeat(8, 1)
    d = torch.from_numpy((-(0.99 + 0.002 * layer)
                          - rng.uniform(0, 1e-4, (h, w))).astype(np.float32))
    covered = torch.from_numpy(layer > 0)
    depth = torch.where(covered, d, torch.full_like(d, DEPTH_CLEAR))
    return color, depth, covered


def _cam():
    from portbench import gen
    return {"rotation": gen.quat_from_yaw_pitch(0.3, -0.1),
            "fov_degrees": np.float32(90.0), "near_clip": np.float32(0.1),
            "far_clip": np.float32(200.0)}


def _stage(name, rng):
    """(the port's stage, the reference's stage, tolerance) on seeded
    inputs."""
    if name == "trilinear":
        return _trilinear(rng)
    color, depth, covered = _seeded_frame(rng)
    cam = _cam()
    u = {"near_clip": torch.tensor(0.1), "far_clip": torch.tensor(200.0)}
    if name == "ssaa_resolve":
        params = RenderParams(40, 24, ssaa=2)
        got = renderer.supersampled(lambda p: (color, depth), params,
                                    "cpu")[0]
        return got, rpost.resolve(color, 2), 1e-6
    if name == "sky":
        pano = torch.from_numpy(rng.integers(0, 256, (32, 64, 4))
                                .astype(np.uint8))
        host = {"camera_rotation": cam["rotation"],
                "fov_degrees": cam["fov_degrees"]}
        got = sky.composite_sky(color, depth, host, pano)[0]
        return got, rpost.sky(color, covered, cam, pano), 1e-6
    if name == "ssao":
        got = ssao.apply_ssao(color, depth, u)[0]
        want = rpost.ssao(color, torch.where(covered, depth, 0.0), covered,
                          cam["near_clip"], cam["far_clip"])
        return got, want, 1e-6
    if name == "bloom":
        return bloom.apply_bloom(color), rpost.bloom(color), 1e-6
    if name == "aces":
        return tonemap.apply_tonemap(color, "aces", {}), rpost.aces(color), \
            1e-6
    return fxaa.apply_fxaa(color), rpost.fxaa(color), 1e-6


@pytest.mark.parametrize("name", ["trilinear", "ssaa_resolve", "sky", "ssao",
                                  "bloom", "aces", "fxaa"])
def test_stage_matches_the_reference(name):
    rng = np.random.default_rng(23)
    got, want, tol = _stage(name, rng)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tol
    if name == "ssao":                              # something darkened
        assert (got[..., :3] < _seeded_frame(np.random.default_rng(23))[0]
                [..., :3]).any()


def _span_calls(name, over, frames=2):
    c = harness.cell_of(name)
    prog = c["module"].Program(c["module"].make_inputs(SEED, over), "cpu")
    profiling.reset_span_totals()
    try:
        with profiling.recording():
            for k in range(frames):
                prog.render(harness.camera_at(c["camera"], 100 * k))
        t = profiling.span_totals()
    finally:
        profiling.reset_span_totals()
    return {s: t.get(s, {}).get("calls", 0)
            for s in ("engine.render", "frame.post", "frame.ssaa")}


def test_post_and_ssaa_spans_run_once_a_render():
    assert _span_calls(CELL, SMALL) == {"engine.render": 2, "frame.post": 2,
                                        "frame.ssaa": 2}
    assert _span_calls(SWEEP, {"grid": 3, "width": 96, "height": 54}) == {
        "engine.render": 2, "frame.post": 0, "frame.ssaa": 0}


def test_post_uniforms_staged_hold_what_a_plain_copy_holds():
    """The post chain's uniforms cross in one staged copy: every key but
    mesh_visible, each with the dtype, shape and values that a copy a
    dtype gives (float64 as float32), tensors and dicts as they are."""
    rng = np.random.default_rng(5)
    u = {"fog_color": rng.random(4), "bloom_strength": 0.7,
         "sky_panorama": rng.integers(0, 256, (4, 8, 4), dtype=np.uint8),
         "flag": np.bool_(True), "count": 3, "mesh_visible": np.ones(2, bool),
         "lights": {"dir": rng.random(3).astype(np.float32)},
         "env": torch.arange(6.0).reshape(2, 3)}
    got = renderer.post_uniforms(u, "cpu")
    want = renderer._upload({k: v for k, v in u.items()
                             if k != "mesh_visible"}, "cpu", "sync.test")
    assert list(got) == [k for k in u if k != "mesh_visible"]
    for k, w in want.items():
        if isinstance(w, dict):
            assert all(torch.equal(got[k][j], w[j]) for j in w)
            continue
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k


def test_reference_imports_neither_jax_nor_the_port():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, json; from portbench.reference import raster, "
            "shade, texture, post; print(json.dumps(sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'softwarerenderer_tpu', 'softwarerenderer_tpu_torch'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_device_uniforms_staged_hold_what_the_plain_upload_holds():
    """A paced frame's uniforms (staged=True: one pinned copy that does
    not wait) equal the plain upload's, key by key, in value and dtype."""
    c = harness.cell_of(CELL)
    u = harness.frame_uniforms(
        renderer.default_frame_uniforms(192, 108),
        harness.camera_at(c["camera"], 250))
    u["env_panorama"] = np.random.default_rng(3).integers(
        0, 256, (4, 8, 4), dtype=np.uint8)
    plain = renderer.device_uniforms(u, 192, 108, "cpu")
    staged = renderer.device_uniforms(u, 192, 108, "cpu", staged=True)
    assert sorted(plain) == sorted(staged)
    for k, v in plain.items():
        assert staged[k].dtype == v.dtype and torch.equal(staged[k], v), k


def test_post_chain_waits_only_where_uniforms_hold_host_values():
    """The chain's wait (sync.post_chain) is for callers whose frames
    wait for the card anyway: uniforms with a host value, at any depth;
    uniforms all on a card (the game's staged ones) keep frames in
    flight."""
    assert renderer._holds_host({"a": torch.zeros(1), "b": {"c": 1.0}})
    assert renderer._holds_host({"a": np.zeros(3)})
    assert not renderer._holds_host({})
