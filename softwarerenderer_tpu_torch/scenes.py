"""The scenes the port is measured and checked on, built from its own
host layer (numpy, no JAX).

  * ``bench_scene`` and ``camera_uniforms``: ``bench.build_scene``'s
    fallback workload (a seeded 9,061-triangle soup with a checkerboard;
    the Dust2 asset is not in the repo) and ``bench.camera_uniforms``;
  * ``golden_config(n)`` and ``GOLDEN_SIZES``: golden configs 1 and 2 of
    ``bench.config_workload`` at ``scripts/make_goldens.py``'s sizes;
  * ``translucent_scene``: the bench soup with six alpha-0.5 glass panes
    (``scripts/profile_translucent.py:52-63``), the K-buffer workload;
  * ``kbuffer_golden_frame``: ``scripts/make_goldens.py``'s
    feature_kbuffer frame.

Each equals its source array for array (tests/test_torch_package.py).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from softwarerenderer_tpu_torch.models import primitives
from softwarerenderer_tpu_torch.models import scene as scene_mod
from softwarerenderer_tpu_torch.ops.texture import checkerboard
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = np.float32

# Golden sizes of configs 1 and 2 (scripts/make_goldens.py:23).
GOLDEN_SIZES = {1: (320, 240), 2: (320, 180)}


def _bench_texture() -> np.ndarray:
    return np.asarray(checkerboard(
        64, 8, (0.8, 0.75, 0.6, 1.0), (0.55, 0.5, 0.4, 1.0))["data"])


def bench_scene() -> Dict[str, np.ndarray]:
    """bench.build_scene() without the Dust2 asset: 9,061 random
    triangles (seed 0) with a sand checkerboard, as a packed scene."""
    return scene_mod.build_scene_buffers([scene_mod.MeshInstance(
        primitives.random_triangle_soup(9061, seed=0),
        texture=_bench_texture())])


def camera_uniforms(uniforms: Dict, frame_idx: int = 0) -> Dict:
    """bench.camera_uniforms: the bench camera at frame `frame_idx`, a
    slow yaw pan from (0, 2.5, 6)."""
    u = dict(uniforms)
    u["camera_position"] = np.float32([0.0, 2.5, 6.0])
    u["camera_rotation"] = ml.quat_from_yaw_pitch_roll(
        np.float32(0.6 + 0.01 * frame_idx), np.float32(-0.15),
        np.float32(0))
    return u


def _obj_round_trip(mesh: Dict) -> Dict:
    """The mesh as bench.config_workload(2) gets it back from an OBJ file
    it writes and io_host.model_loader.load_obj reads: the same text, the
    same parse (vertices in first-use order, v flipped twice), in memory."""
    lines = [f"v {p[0]} {p[1]} {p[2]}" for p in mesh["position"]]
    lines += [f"vt {t[0]} {1.0 - t[1]}" for t in mesh["uv"]]
    lines += [f"vn {n[0]} {n[1]} {n[2]}" for n in mesh["normal"]]
    lines += [f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}"
              for a, b, c in mesh["indices"] + 1]
    positions, uvs, normals = [], [], []
    out_pos, out_uv, out_n, indices = [], [], [], []
    cache: Dict[str, int] = {}

    def corner(spec: str) -> int:
        if spec not in cache:
            vi, ti, ni = (int(x) - 1 for x in spec.split("/"))
            out_pos.append(positions[vi])
            out_uv.append(uvs[ti])
            out_n.append(normals[ni])
            cache[spec] = len(out_pos) - 1
        return cache[spec]

    for line in lines:
        t = line.split()
        if t[0] == "v":
            positions.append(tuple(float(x) for x in t[1:4]))
        elif t[0] == "vt":
            uvs.append((float(t[1]), 1.0 - float(t[2])))
        elif t[0] == "vn":
            normals.append(tuple(float(x) for x in t[1:4]))
        else:
            cs = [corner(s) for s in t[1:]]
            indices.append((cs[0], cs[1], cs[2]))
    pos = np.asarray(out_pos, dtype=F32).reshape(-1, 3)
    center, radius = scene_mod.bounding_sphere(pos)
    return {
        "position": pos,
        "uv": np.asarray(out_uv, dtype=F32).reshape(-1, 2),
        "normal": np.asarray(out_n, dtype=F32).reshape(-1, 3),
        "color": np.ones((pos.shape[0], 4), dtype=F32),
        "indices": np.asarray(indices, dtype=np.int32).reshape(-1, 3),
        "material": scene_mod.Material(),
        "bounds_center": center,
        "bounds_radius": radius,
    }


def golden_config(n: int) -> List[scene_mod.MeshInstance]:
    """The instances of golden config n (1: a textured cube; 2: a
    textured OBJ sphere), as bench.config_workload(n) builds them."""
    checker = np.asarray(checkerboard(64, 8)["data"])
    if n == 1:
        return [scene_mod.MeshInstance(
            primitives.cube(1.5), ml.matrix_from_yaw_pitch_roll(0.5, 0.3, 0)
            @ ml.translation([0, 0, -3]), texture=checker)]
    if n == 2:
        mesh = _obj_round_trip(primitives.uv_sphere(1.0, rings=24,
                                                    sectors=48))
        return [scene_mod.MeshInstance(
            mesh=mesh, model_matrix=ml.translation([0.0, 0.0, -3.0]),
            texture=checker, material=mesh["material"])]
    raise ValueError(f"golden config {n} is not ported (configs 1 and 2 "
                     f"are)")


def translucent_scene() -> Dict[str, np.ndarray]:
    """The bench soup with the six alpha-0.5 glass panes of
    scripts/profile_translucent.py:52-63, as a packed scene."""
    insts = [scene_mod.MeshInstance(
        primitives.random_triangle_soup(9061, seed=0),
        texture=_bench_texture())]
    rng = np.random.default_rng(3)
    for i in range(6):
        pane = dict(primitives.plane(1.6))
        col = np.ones((pane["position"].shape[0], 4), np.float32)
        col[:, 3] = 0.5
        col[:, :3] = rng.uniform(0.4, 1.0, 3)
        pane["color"] = col
        m = (ml.matrix_from_yaw_pitch_roll(0.0, np.pi / 2, 0.0)
             @ ml.translation([-3.0 + 1.4 * i, 2.0, 2.0 + 0.4 * (i % 3)])
             ).astype(np.float32)
        insts.append(scene_mod.MeshInstance(pane, m))
    return scene_mod.build_scene_buffers(insts)


def kbuffer_golden_frame():
    """scripts/make_goldens.py's feature_kbuffer frame: a checkered floor,
    a cube, and a translucent glass cube in front of it, at 320x240 with
    K=4.  Returns (packed scene, RenderParams, uniforms)."""
    from softwarerenderer_tpu_torch.config import CullMode, RenderParams
    from softwarerenderer_tpu_torch.engine import default_frame_uniforms
    checker = np.asarray(checkerboard(32, 4)["data"])
    glass = np.zeros((8, 8, 4), np.float32)
    glass[...] = (0.3, 0.5, 1.0, 0.45)
    insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                    ml.translation([0, -1, 0]),
                                    texture=checker),
             scene_mod.MeshInstance(primitives.cube(1.0),
                                    ml.translation([0, 0, -4]),
                                    texture=checker),
             scene_mod.MeshInstance(primitives.cube(1.4),
                                    ml.translation([0, 0, -2.2]),
                                    texture=glass)]
    params = RenderParams(width=320, height=240, kbuffer=4,
                          cull_mode=CullMode.BACK)
    u = default_frame_uniforms(320, 240)
    u["camera_position"] = np.float32([0, 0.8, 2.0])
    return scene_mod.build_scene_buffers(insts), params, u
