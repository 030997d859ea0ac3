"""The port's multi-device layer on four gloo ranks.

softwarerenderer_tpu_torch.parallel runs one process a rank on
torch.distributed.  A module fixture starts four ranks once through the
port's own bootstrap (tests/torch_parallel_ranks.py: spawn, gloo, one
intra-op thread) and every case below reads what they rendered.  Each
frame is equal on every rank and equal on every value to the port's
single-device frame: the sharded frame on the (4, 1), (2, 2) and (1, 4)
meshes (the last with padded triangle shards) and with bands that do not
start on a tile row, through the deferred route (K5), with balanced rows
and tiles, ssaa, the post chain (FXAA and a user stage), the animated
scene (skinning, morphs, flip-books, particles, LOD), the K-buffer over
contiguous and balanced-row bands, the ring at n = 4, four views, and the
ray-traced bands with and without clusters.  The sharded frames but
those that test_torch_parallel_paths.py renders again are also held
against the JAX package's render_frame_sharded on its virtual CPU mesh
(rendered in this process while the ranks run), the balanced assignment
against JAX's balance checks, and the K-buffer's refusal of triangle
shards against JAX's.
"""

import functools

import numpy as np
import pytest
import torch

import torch_parallel_jax as tj
import torch_parallel_ranks as ranks
from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import frame_setup
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import binning, raster
from softwarerenderer_tpu_torch.parallel import sharding

N = 4
FRAME_CASES = [c for c in ranks.CASES[N] if c != "kbuffer_tri_refused"]
# The frames held against JAX here; tests/test_torch_parallel_paths.py
# holds the others.
JAX_CASES = [c for c in FRAME_CASES if c not in ranks.PATH_CASES]


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """The four ranks' results, and the JAX package's frame of every case
    (or the exception it raised), rendered in this process while the
    ranks run."""
    out_dir = str(tmp_path_factory.mktemp("ranks4"))
    procs = ranks.start_group(N, out_dir)
    try:
        want = {}
        for name in JAX_CASES:
            try:
                want[name] = tj.jax_frame(name)
            except Exception as e:        # reported by its own test
                want[name] = e
    finally:
        out = ranks.join_group(procs, out_dir)
    return out, want


@pytest.fixture(scope="module")
def group(rendered):
    out = rendered[0]
    errors = [r["error"] for r in out if r["error"]]
    assert not errors, "\n".join(errors)
    return out


def jax_want(rendered, name):
    want = rendered[1][name]
    if isinstance(want, Exception):
        raise want
    return want


@pytest.mark.parametrize("name", FRAME_CASES)
def test_four_rank_frame_equals_single_device(group, name):
    """Every rank holds the whole frame, equal on every value to the port's
    single-device frame, and the frame draws something."""
    frames = [r["frames"][name] for r in group]
    refs = [r["refs"][name] for r in group if name in r["refs"]]
    assert len(refs) == 1
    for c, d in frames:
        assert c.shape == refs[0][0].shape
        np.testing.assert_array_equal(c, refs[0][0])
        np.testing.assert_array_equal(d, refs[0][1])
    c, d = frames[0]
    assert (d > raster.DEPTH_CLEAR).mean() > 0.1
    assert np.isfinite(c).all()


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)],
                         ids=["4x1", "2x2", "1x4"])
def test_four_rank_frame_matches_jax_sharded(group, rendered, shape):
    """The port's sharded frame against the JAX package's
    render_frame_sharded on the same mesh shape, same packed scene, within
    torch_parallel_jax.RASTER_OFF_MAX (the single-device frames' share)."""
    name = f"mesh_{shape[0]}x{shape[1]}"
    tj.close(name, group[0]["frames"][name], jax_want(rendered, name))


@pytest.mark.parametrize("name", [c for c in JAX_CASES
                                  if not c.startswith("mesh_")
                                  or c.endswith("ragged")])
def test_four_rank_frame_matches_jax(group, rendered, name):
    """The ragged bands, the deferred route, the balanced frames, ssaa and
    the post chain against the JAX package's render_frame_sharded with the
    same options on the same packed scene and a mesh of the same shape
    (torch_parallel_jax.jax_frame), within the case's limits
    (torch_parallel_jax.close)."""
    tj.close(name, group[0]["frames"][name], jax_want(rendered, name))


def test_kbuffer_refuses_triangle_sharding(group):
    """A K-buffer over triangle shards is refused on every rank, as JAX
    refuses it (its layers would need a K-deep reduce)."""
    for r in group:
        assert "n_tri == 1" in r["frames"]["kbuffer_tri_refused"]


def test_padding_is_masked():
    """shard_scene_triangles pads the triangle list to the shard count and
    masks the pads out; the (1, 4) frame, whose last shard holds pads,
    equals the single-device frame (test_four_rank_frame_equals_single_
    device[mesh_1x4])."""
    scene = ranks.small_scene()
    n = scene["indices"].shape[0]
    padded = sharding.shard_scene_triangles(scene, 4)
    assert n % 4 and padded["indices"].shape[0] % 4 == 0
    assert padded["tri_valid"].sum() == n
    assert not padded["tri_valid"][n:].any()
    assert "tri_seg_starts" not in padded


@functools.lru_cache(maxsize=None)
def heavy_counts():
    """The bottom-heavy scene's binned list lengths at 8x64 tiles (ntx
    wide)."""
    p = RenderParams(*ranks.BALANCED_SIZE, **ranks.PARAMS)
    f = frame_setup(scene_to_torch(ranks.bottom_heavy_scene(), "cpu"),
                    ranks.downward_uniforms(*ranks.BALANCED_SIZE), p)
    bins = binning.bin_triangles(f["tris"], p, p.tile_h, p.tile_w,
                                 p.span_cap)
    return bins["counts"].numpy().astype(float), bins["ntx"]


def spread(loads):
    return (loads.max() - loads.min()) / max(loads.mean(), 1e-9)


def test_balanced_rows_assignment_balances():
    """JAX's balance check on the port's assignment (sharding.lpt_assign,
    which the balanced frame runs on the device): over the bottom-heavy
    scene's per-row fold work, four devices get equal row counts and
    loads that spread at most 0.15 and less than the contiguous bands'."""
    counts, ntx = heavy_counts()
    row_load = counts.reshape(-1, ntx).sum(1)
    owner = sharding.lpt_assign(torch.tensor(row_load), N).numpy()
    per_dev = np.bincount(owner, weights=row_load, minlength=N)
    bands = row_load.reshape(N, -1).sum(1)
    assert (np.bincount(owner, minlength=N) == len(row_load) // N).all()
    assert spread(per_dev) <= 0.15
    assert spread(per_dev) < spread(bands)


def test_balanced_tiles_assignment_balances():
    """JAX's check for balanced="tiles": per-tile assignment spreads no
    more than the per-row one and at most 0.15, with equal tile counts
    (padding tiles, load -1, included)."""
    counts, ntx = heavy_counts()
    pad = -(-len(counts) // N) * N - len(counts)
    owner = sharding.lpt_assign(torch.tensor(np.pad(
        counts, (0, pad), constant_values=-1.0)), N).numpy()
    tile_dev = np.bincount(owner[:len(counts)], weights=counts, minlength=N)
    rows = counts.reshape(-1, ntx).sum(1)
    row_dev = np.bincount(sharding.lpt_assign(torch.tensor(rows), N).numpy(),
                          weights=rows, minlength=N)
    assert (np.bincount(owner, minlength=N) == len(owner) // N).all()
    assert spread(tile_dev) <= spread(row_dev) + 1e-9
    assert spread(tile_dev) <= 0.15


def greedy_reference(occ, n_dev):
    """JAX's assignment loop (softwarerenderer_tpu/parallel/sharding.py's
    assign_step) in numpy: each item's device."""
    cap = len(occ) // n_dev
    order = np.argsort(-occ.astype(np.float32), kind="stable")
    load = np.maximum(occ.astype(np.float32)[order], 0.0)
    loads, cnt = np.zeros(n_dev, np.float32), np.zeros(n_dev, int)
    owner = np.empty(len(occ), int)
    for i, item in enumerate(order):
        k = int(np.argmin(np.where(cnt < cap, loads, np.inf)))
        loads[k] += load[i]
        cnt[k] += 1
        owner[item] = k
    return owner


@pytest.mark.parametrize("seed", range(4))
def test_lpt_assign_matches_greedy_reference(seed):
    """sharding.lpt_assign (on the device, no host read) gives JAX's
    assignment: small integer loads, so ties between items and between
    devices are common, and padding items (load -1) at the end."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n_dev = int(rng.integers(1, 6))
        occ = rng.integers(0, 5, n_dev * int(rng.integers(1, 12))) \
            .astype(np.float32)
        occ[len(occ) - int(rng.integers(0, n_dev)):] = -1.0
        got = sharding.lpt_assign(torch.tensor(occ), n_dev).numpy()
        np.testing.assert_array_equal(got, greedy_reference(occ, n_dev))
