"""Gloo ranks for the multi-device tests of softwarerenderer_tpu_torch.

Not a test module: tests/test_torch_parallel*.py start a group of ranks
once (start_group, join_group), each a process started with the spawn
method (the test process runs JAX's threads) through the port's own
bootstrap
(parallel.multihost.initialize_from_env on device "cpu", so gloo).  Every
rank runs every case of its group on one intra-op thread and saves its
frames; case i's single-device reference is rendered by rank i modulo the
group size, so the references render in parallel.  This module imports
torch and the port only.
"""

from __future__ import annotations

import functools
import os
import socket
import sys
import time
import traceback

import numpy as np
import torch

W, H = 128, 96

PARAMS = dict(tile_h=8, tile_w=64, tile_group=4, chunk=16)
BALANCED_SIZE = (128, 256)
KBUFFER_SIZE = (96, 64)
ANIMATED_SIZE = (96, 72)
RT_CAP = 24


def small_scene():
    """tests/test_parallel.py's scene, packed by the port's host layer: a
    checkered floor and five cubes."""
    from softwarerenderer_tpu_torch.models import primitives
    from softwarerenderer_tpu_torch.models import scene as scene_mod
    from softwarerenderer_tpu_torch.ops import texture as tex
    from softwarerenderer_tpu_torch.utils import mathlib as ml
    checker = np.asarray(tex.checkerboard(16, 4)["data"])
    insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                    ml.translation([0.0, -1.0, 0.0]),
                                    texture=checker)]
    rng = np.random.default_rng(3)
    for _ in range(5):
        pos = rng.uniform(-4, 4, 3).astype(np.float32)
        pos[1] = rng.uniform(-0.5, 1.0)
        pos[2] = rng.uniform(-6, -2)
        insts.append(scene_mod.MeshInstance(primitives.cube(0.8),
                                            ml.translation(pos),
                                            texture=checker))
    return scene_mod.build_scene_buffers(insts)


def small_uniforms(w=W, h=H):
    from softwarerenderer_tpu_torch.engine import default_frame_uniforms
    u = default_frame_uniforms(w, h)
    u["camera_position"] = np.float32([0.0, 0.5, 3.0])
    return u


def bottom_heavy_scene():
    """tests/test_parallel.py's bottom-heavy scene: a floor field of cubes
    in the lower two thirds of the frame, empty sky rows above."""
    from softwarerenderer_tpu_torch.models import primitives
    from softwarerenderer_tpu_torch.models import scene as scene_mod
    from softwarerenderer_tpu_torch.ops import texture as tex
    from softwarerenderer_tpu_torch.utils import mathlib as ml
    checker = np.asarray(tex.checkerboard(16, 4)["data"])
    insts = [scene_mod.MeshInstance(primitives.plane(30.0),
                                    ml.translation([0.0, -1.0, 0.0]),
                                    texture=checker)]
    for zi in range(14):
        for xi in range(8):
            pos = np.float32([-5.25 + 1.5 * xi, -0.7, -0.8 - 0.9 * zi])
            insts.append(scene_mod.MeshInstance(primitives.cube(0.45),
                                                ml.translation(pos),
                                                texture=checker))
    return scene_mod.build_scene_buffers(insts)


def downward_uniforms(w, h):
    from softwarerenderer_tpu_torch.engine import default_frame_uniforms
    from softwarerenderer_tpu_torch.utils import mathlib as ml
    u = default_frame_uniforms(w, h)
    u["camera_position"] = np.float32([0.3, 2.5, 2.0])
    u["camera_rotation"] = ml.quat_from_yaw_pitch_roll(
        np.float32(0.0), np.float32(-0.6), np.float32(0.0))
    return u


def _fxaa_then_dim(color, depth, uniforms):
    """A user post stage: halves the red channel."""
    return color * torch.tensor([0.5, 1.0, 1.0, 1.0], device=color.device)


# --- the cases: name -> (frame on every rank, single-device reference) ----

def _single(scene, u, params, **kw):
    from softwarerenderer_tpu_torch.engine import render_frame
    from softwarerenderer_tpu_torch.models.convert import scene_to_torch
    return render_frame(scene_to_torch(scene, "cpu"), u, params, **kw)[:2]


def _sharded(shape, scene_fn, u_fn, params, balanced=False, shaders=None):
    from softwarerenderer_tpu_torch import parallel

    def frame():
        mesh = parallel.make_mesh(*shape, device="cpu")
        return parallel.render_frame_sharded(
            parallel.shard_scene_triangles(scene_fn(), shape[1]), u_fn(),
            params, mesh, balanced=balanced, **(shaders or {}))

    def ref():
        return _single(scene_fn(), u_fn(), params, **(shaders or {}))
    return frame, ref


def _animated():
    from softwarerenderer_tpu_torch import scenes
    return scenes.animated_scene(tentacles=2, flipbooks=1, morphs=1,
                                 particles=16, lods=2)


def _animated_uniforms():
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.engine import default_frame_uniforms
    return scenes.animated_uniforms(default_frame_uniforms(*ANIMATED_SIZE),
                                    7, tentacles=2, particles=16)


def _animated_shaders():
    from softwarerenderer_tpu_torch.ops import normalmap
    return dict(vertex_shader=normalmap.normal_mapped_vertex_shader,
                fragment_shader=normalmap.normal_mapped_fragment_shader)


def _kbuffer_uniforms():
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.engine import default_frame_uniforms
    return scenes.camera_uniforms(default_frame_uniforms(*KBUFFER_SIZE), 0)


def _translucent():
    from softwarerenderer_tpu_torch import scenes
    return scenes.translucent_scene()


def _ring(n, params):
    from softwarerenderer_tpu_torch import parallel

    def frame():
        mesh = parallel.make_ring_mesh(n, device="cpu")
        return parallel.render_frame_ring(
            parallel.shard_scene_triangles(small_scene(), n),
            small_uniforms(), params, mesh)
    return frame, lambda: _single(small_scene(), small_uniforms(), params)


def _view_overrides(v):
    from softwarerenderer_tpu_torch.utils import mathlib as ml
    return [{"camera_position": np.float32([0.6 * i - 0.9, 0.5, 3.0]),
             "camera_rotation": ml.quat_from_yaw_pitch_roll(
                 np.float32(0.1 * i - 0.15), np.float32(0.0),
                 np.float32(0.0))} for i in range(v)]


def _views(v, params):
    from softwarerenderer_tpu_torch import parallel

    def frame():
        mesh = parallel.make_view_mesh(v, device="cpu")
        return parallel.render_frame_views(
            small_scene(), small_uniforms(), params,
            parallel.stack_views(_view_overrides(v)), mesh)

    def ref():
        frames = [_single(small_scene(), {**small_uniforms(), **ov}, params)
                  for ov in _view_overrides(v)]
        return (torch.stack([c for c, _ in frames]),
                torch.stack([d for _, d in frames]))
    return frame, ref


def _raytraced(n_fb, cap, params):
    """Ray-traced bands of the small scene: soft shadows (two jittered
    samples a pixel, seeded by the global ray ids) and reflections on the
    brute route, hard shadows through the bundles with cluster_cap."""
    from softwarerenderer_tpu_torch import parallel
    from softwarerenderer_tpu_torch.ops.raytrace import render_frame_raytraced
    opts = dict(cluster_cap=cap) if cap else dict(shadow_samples=2,
                                                  reflections=True)

    def u():
        return dict(small_uniforms(), rt_light_radius=np.float32(0.3))

    def frame():
        mesh = parallel.make_mesh(n_fb, 1, device="cpu")
        return parallel.render_frame_raytraced_sharded(
            small_scene(), u(), params, mesh, **opts)

    def ref():
        from softwarerenderer_tpu_torch.models.convert import scene_to_torch
        return render_frame_raytraced(scene_to_torch(small_scene(), "cpu"),
                                      u(), params, **opts)
    return frame, ref


def _kbuffer_tri_refused():
    from softwarerenderer_tpu_torch import RenderParams, parallel
    mesh = parallel.make_mesh(2, 2, device="cpu")
    try:
        parallel.render_frame_sharded(
            parallel.shard_scene_triangles(small_scene(), 2),
            small_uniforms(), RenderParams(W, H, kbuffer=4, **PARAMS), mesh)
    except NotImplementedError as e:
        return str(e)
    return "rendered"


def cases(n: int) -> dict:
    """The cases a group of n ranks runs, by name: (frame, reference) of
    callables, or a callable whose value every rank returns alike."""
    from softwarerenderer_tpu_torch import RenderParams
    p = RenderParams(W, H, **PARAMS)
    if n == 2:
        return {
            "mesh_2x1": _sharded((2, 1), small_scene, small_uniforms, p),
            "mesh_1x2": _sharded((1, 2), small_scene, small_uniforms, p),
            "ring_2": _ring(2, RenderParams(W, H)),
            "raytraced_2": _raytraced(2, 0, RenderParams(W, H)),
            "raytraced_2_cap": _raytraced(2, RT_CAP, RenderParams(W, H)),
        }
    bp = RenderParams(*BALANCED_SIZE, **PARAMS)
    kp = RenderParams(*KBUFFER_SIZE, kbuffer=4, cull_mode=0, tile_h=8,
                      tile_w=32)
    heavy = (bottom_heavy_scene, functools.partial(downward_uniforms,
                                                   *BALANCED_SIZE))
    post = p.replace(fxaa=True, post_fx=("fxaa", _fxaa_then_dim))
    return {
        "mesh_4x1": _sharded((4, 1), small_scene, small_uniforms, p),
        "mesh_2x2": _sharded((2, 2), small_scene, small_uniforms, p),
        "mesh_1x4": _sharded((1, 4), small_scene, small_uniforms, p),
        "mesh_4x1_ragged": _sharded((4, 1), small_scene,
                                    functools.partial(small_uniforms, W, 100),
                                    p.replace(height=100)),
        "deferred_2x2": _sharded((2, 2), small_scene, small_uniforms,
                                 p.replace(use_pallas=False)),
        "balanced_rows": _sharded((4, 1), *heavy, bp, balanced="rows"),
        "balanced_tiles": _sharded((4, 1), *heavy, bp, balanced="tiles"),
        "balanced_rows_2x2": _sharded((2, 2), *heavy, bp, balanced="rows"),
        "ssaa": _sharded((2, 2), small_scene, small_uniforms,
                         p.replace(ssaa=2)),
        "post_fx": _sharded((2, 2), small_scene, small_uniforms, post),
        "animated": _sharded((2, 2), _animated, _animated_uniforms,
                             RenderParams(*ANIMATED_SIZE),
                             shaders=_animated_shaders()),
        "kbuffer_bands": _sharded((4, 1), _translucent, _kbuffer_uniforms,
                                  kp),
        "kbuffer_rows": _sharded((4, 1), _translucent, _kbuffer_uniforms,
                                 kp, balanced="rows"),
        "kbuffer_tri_refused": _kbuffer_tri_refused,
        "ring_4": _ring(4, RenderParams(W, H)),
        "views_4": _views(4, p),
        "raytraced_4": _raytraced(4, 0, RenderParams(W, H)),
        "raytraced_4_cap": _raytraced(4, RT_CAP, RenderParams(W, H)),
    }


def _equal(a, b) -> bool:
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(
            x.shape == y.shape and np.array_equal(x, y)
            for x, y in zip(a, b))
    return a == b


# Each group's case names, for the tests' parameters.
CASES = {n: list(cases(n)) for n in (2, 4)}
# The four-rank cases that tests/test_torch_parallel_paths.py renders again
# to hold against JAX (the costlier JAX frames, in a file of their own so
# that they compile beside the other file's).
PATH_CASES = ("kbuffer_rows", "animated", "kbuffer_bands", "ring_4",
              "views_4", "raytraced_4", "raytraced_4_cap")


def _numpy(out):
    if isinstance(out, tuple):
        return tuple(x.numpy() for x in out)
    return out


def _rank_main(rank: int, n: int, port: int, out_dir: str,
               names=None) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ.update(SRT_COORD=f"localhost:{port}", SRT_NUM_PROCS=str(n),
                      SRT_PROC_ID=str(rank))
    torch.set_num_threads(1)
    result = {"frames": {}, "refs": {}, "error": None, "seconds": {}}
    try:
        from softwarerenderer_tpu_torch.parallel import multihost
        assert multihost.initialize_from_env(device="cpu")
        todo = {k: v for k, v in cases(n).items()
                if names is None or k in names}
        for i, (name, case) in enumerate(todo.items()):
            t0 = time.perf_counter()
            if callable(case):
                result["frames"][name] = case()
                continue
            frame, ref = case
            result["frames"][name] = _numpy(frame())
            if i % n == rank:
                result["refs"][name] = _numpy(ref())
            result["seconds"][name] = time.perf_counter() - t0
    except Exception:                 # reported by the test, not lost
        result["error"] = traceback.format_exc()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_group(n: int, out_dir: str, names=None) -> list:
    """Start n gloo ranks (spawn) that render the cases of cases(n), or
    those of them named in `names`, and write their results to out_dir;
    return their processes (join_group waits for them)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, port, out_dir, names))
             for r in range(n)]
    for p in procs:
        p.start()
    return procs


def join_group(procs: list, out_dir: str) -> list:
    """Wait for start_group's ranks and return each rank's saved result:
    {"frames": case -> value, "refs": case -> reference (the cases this
    rank rendered alone), "error": traceback or None}."""
    for p in procs:
        p.join(timeout=600)
    for p in procs:
        if p.is_alive():
            p.kill()
    out = []
    for r, p in enumerate(procs):
        path = os.path.join(out_dir, f"rank{r}.pt")
        out.append(torch.load(path, weights_only=False)
                   if os.path.exists(path)
                   else {"frames": {}, "refs": {},
                         "error": f"rank {r} exited {p.exitcode}"})
    return out


def run_group(n: int, out_dir: str) -> list:
    """start_group then join_group."""
    return join_group(start_group(n, out_dir), out_dir)


if __name__ == "__main__":
    import tempfile
    n = int(sys.argv[1])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        res = run_group(n, d)
    print(f"{n} ranks in {time.perf_counter() - t0:.1f} s")
    for r, x in enumerate(res):
        if x["error"]:
            print(f"rank {r}:", x["error"])
    refs = {k: v for x in res for k, v in x["refs"].items()}
    for name, got in res[0]["frames"].items():
        same = all(_equal(x["frames"].get(name), got) for x in res)
        want = refs.get(name)
        print(name, [round(x["seconds"].get(name, -1), 2) for x in res],
              "ranks equal" if same else "RANKS DIFFER",
              "" if want is None else
              ("= single" if _equal(got, want) else "!= single"))

