"""The scenes the port is measured and checked on, built from its own
host layer (numpy, no JAX).

  * ``bench_scene`` and ``camera_uniforms``: ``bench.build_scene``'s
    fallback workload (a seeded 9,061-triangle soup with a checkerboard;
    the Dust2 asset is not in the repo) and ``bench.camera_uniforms``;
  * ``golden_config(n)``, ``golden_uniforms(n, u)``, ``golden_shaders(n)``
    and ``GOLDEN_SIZES``: golden configs 1, 2, 3 (41 meshes under four
    lights, the lit shaders) and 5 (1,100 cubes) of
    ``bench.config_workload`` at ``scripts/make_goldens.py``'s sizes, and
    ``BENCH_SIZES``, bench.py's own sizes of configs 3 and 5;
  * ``sky_panorama(seed)``: an RGBA8 equirect sky made from a seed, for
    the image-quality frames;
  * ``translucent_scene``: the bench soup with six alpha-0.5 glass panes
    (``scripts/profile_translucent.py:52-63``), the K-buffer workload;
  * ``kbuffer_golden_frame``, ``wireframe_golden_frame``,
    ``config4_golden_frame``, ``shadow_golden_frame(name)`` and
    ``feature_golden_frame(name)``: ``scripts/make_goldens.py``'s
    feature_kbuffer, feature_wireframe, config4, feature_shadows /
    _point_shadows / _spot_shadows and feature_mips / _trilinear / _ssaa /
    _ssao frames, and feature_skinning's (``tentacle_mesh`` and
    ``tentacle_skin`` are ``examples/skeletal_animation.py``'s rig);
  * ``animated_scene`` (``animated_instances`` packed) and
    ``animated_uniforms(u, i)``: a game-like frame of every per-frame
    vertex update and LOD level (normal-mapped floor, 64 skinned
    tentacles, flip-book, morphing and LOD meshes, a 1,024-slot particle
    emitter), for the card's phase 21;
  * ``coupled_step`` (``config4_physics`` and the frame): bench.py config
    4's physics-coupled step at ``CONFIG4_SIZE``; ``crowd_setup`` and
    ``crowd_step``: a crowd on the bench scene in the dust2 app's shape
    (two spawn centres, floor waypoints, routing, combat);
    ``spark_emitter`` and ``fountain_emitter``: the dust2 app's impact
    sparks and a fountain for the animated scene's slots (phase 22).

Each equals its source array for array (tests/test_torch_package.py).
"""

from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import torch

from softwarerenderer_tpu_torch.models import primitives
from softwarerenderer_tpu_torch.models import scene as scene_mod
from softwarerenderer_tpu_torch.models.scene import Light, LightType
from softwarerenderer_tpu_torch.ops import lighting
from softwarerenderer_tpu_torch.ops.texture import checkerboard
from softwarerenderer_tpu_torch.sim import (agents_step,
                                            build_collision_world,
                                            build_waypoint_graph,
                                            character_step,
                                            default_emitter_params,
                                            initial_agents_state,
                                            scatter_waypoints_on_floor)
from softwarerenderer_tpu_torch.sim.prng import prng_key
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = np.float32

# Golden sizes of configs 1, 2, 3 and 5 (scripts/make_goldens.py:23), and
# bench.py's sizes of configs 3 and 5 (bench.config_workload).
GOLDEN_SIZES = {1: (320, 240), 2: (320, 180), 3: (480, 270), 5: (480, 270)}
BENCH_SIZES = {3: (1920, 1080), 5: (3840, 2160)}
# Config 3's lights: a directional key light, a red and a blue point light
# and a white spot light pointing down.
CONFIG3_LIGHTS = [
    Light(light_type=LightType.DIRECTIONAL, direction=(0.4, -1.0, -0.3),
          color=(0.8, 0.8, 0.7)),
    Light(light_type=LightType.POINT, position=(0, 3, -5), color=(4, 1, 1),
          attenuation_linear=0.3),
    Light(light_type=LightType.POINT, position=(8, 2, 4), color=(1, 1, 5),
          attenuation_quadratic=0.1),
    Light(light_type=LightType.SPOT, position=(-5, 6, 0),
          direction=(0, -1, 0), color=(3, 3, 3), spot_inner=0.4,
          spot_outer=0.7)]


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
    textured OBJ sphere; 3: a floor and 40 cubes (seed 0); 5: 1,100
    turned cubes (seed 1)), as bench.config_workload(n) builds them."""
    checker = np.asarray(checkerboard(64, 8)["data"])
    if n == 3:
        rng = np.random.default_rng(0)
        insts = [scene_mod.MeshInstance(
            primitives.plane(60.0), ml.translation([0, -1, 0]),
            texture=checker)]
        for _ in range(40):
            pos = rng.uniform(-25, 25, 3).astype(np.float32)
            pos[1] = rng.uniform(0, 2)
            insts.append(scene_mod.MeshInstance(
                primitives.cube(1.0), ml.translation(pos), texture=checker))
        return insts
    if n == 5:
        rng = np.random.default_rng(1)
        insts = []
        for _ in range(1100):
            pos = rng.uniform(-40, 40, 3).astype(np.float32)
            pos[1] = rng.uniform(-2, 6)
            insts.append(scene_mod.MeshInstance(
                primitives.cube(1.2),
                (ml.matrix_from_yaw_pitch_roll(
                    float(rng.uniform(0, 3)), 0.0, 0.0)
                 @ ml.translation(pos)).astype(np.float32),
                texture=checker))
        return insts
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
    raise ValueError(f"golden config {n} is not ported (configs 1, 2, 3 "
                     f"and 5 are; config 4's frame is config4_golden_frame)")


def golden_uniforms(n: int, uniforms: Dict) -> Dict:
    """A copy of `uniforms` with golden config n's own (the uniforms
    function of bench.config_workload(n)): config 3's packed lights and
    camera, config 5's camera and far clip."""
    u = dict(uniforms)
    if n == 3:
        u.update(lighting.pack_lights(CONFIG3_LIGHTS))
        u["camera_position"] = np.float32([0, 2, 10])
    elif n == 5:
        u["camera_position"] = np.float32([0, 2, 55])
        u["far_clip"] = np.float32(300.0)
    return u


def golden_shaders(n: int) -> Dict:
    """Golden config n's Engine shaders: config 3's lit pair, else none
    (the game's)."""
    if n == 3:
        return dict(vertex_shader=lighting.lit_scene_vertex_shader,
                    fragment_shader=lighting.multi_light_fragment_shader)
    return {}


def sky_panorama(seed: int = 20, size=(256, 512)) -> np.ndarray:
    """An (h, w, 4) RGBA8 equirect sky made from a seed: a blue gradient
    to the zenith over a darker ground, with low-frequency seeded
    clouds."""
    h, w = size
    rng = np.random.default_rng(seed)
    v = (np.arange(h, dtype=np.float32) + 0.5) / h
    sky = np.stack([0.35 + 0.4 * v, 0.55 + 0.3 * v, 0.95 - 0.1 * v], -1)
    rows = np.where((v < 0.5)[:, None], sky, np.float32([0.3, 0.27, 0.22]))
    coarse = rng.uniform(0, 1, (9, 17)).astype(np.float32)
    clouds = np.stack([np.interp(np.linspace(0, 16, w), np.arange(17), r)
                       for r in coarse])
    clouds = np.stack([np.interp(np.linspace(0, 8, h), np.arange(9), c)
                       for c in clouds.T], 1)
    clouds = np.where((v < 0.5)[:, None], np.clip(clouds - 0.5, 0, 1), 0)
    rgb = np.clip(rows[:, None, :] + clouds[..., None] * 0.8, 0, 1)
    rgba = np.concatenate([rgb, np.ones((h, w, 1), np.float32)], -1)
    return np.round(rgba * 255).astype(np.uint8)


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


def wireframe_golden_frame():
    """scripts/make_goldens.py's feature_wireframe frame: a checkered cube
    and an untextured sphere through DebugMode.WIREFRAME at 320x240.
    Returns (packed scene, RenderParams, uniforms)."""
    from softwarerenderer_tpu_torch.config import DebugMode, RenderParams
    from softwarerenderer_tpu_torch.engine import default_frame_uniforms
    checker = np.asarray(checkerboard(32, 4)["data"])
    insts = [scene_mod.MeshInstance(primitives.cube(1.2),
                                    ml.translation([0, 0, -3]),
                                    texture=checker),
             scene_mod.MeshInstance(
                 primitives.uv_sphere(0.7, rings=10, sectors=16),
                 ml.translation([1.4, 0.3, -4]))]
    params = RenderParams(width=320, height=240,
                          debug_mode=DebugMode.WIREFRAME)
    return (scene_mod.build_scene_buffers(insts), params,
            default_frame_uniforms(320, 240))


def config4_golden_frame():
    """scripts/make_goldens.py's config4 frame, the render half of the
    physics-coupled config: the bench scene through the default route at
    320x180 from the bench camera's frame 0.  Returns (packed scene,
    RenderParams, uniforms)."""
    from softwarerenderer_tpu_torch.config import RenderParams
    from softwarerenderer_tpu_torch.engine import default_frame_uniforms
    return (bench_scene(), RenderParams(width=320, height=180),
            camera_uniforms(default_frame_uniforms(320, 180), 0))


def shadow_golden_frame(name: str):
    """scripts/make_goldens.py's feature frame `name`: "shadows" (a
    directional map over a floor and a cube), "point_shadows" (a cube map
    of a point light over a floor, a cube and a sphere) or "spot_shadows"
    (a spot light's map over a floor and a cube), at 320x240 with
    256-texel maps.  Returns (packed scene, RenderParams, uniforms,
    frame_fn, shaders): frame_fn(scene tensors, uniforms, params) renders
    the frame with its default (lit) shaders, which `shaders` names for
    Engine(frame_fn=..., **shaders) (Engine hands a frame_fn its own)."""
    import functools
    from softwarerenderer_tpu_torch import engine
    from softwarerenderer_tpu_torch.config import RenderParams
    from softwarerenderer_tpu_torch.ops import shadows
    checker = np.asarray(checkerboard(32, 4)["data"])
    insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                    ml.translation([0, -1, 0]),
                                    texture=checker)]
    u = engine.default_frame_uniforms(320, 240)
    u["camera_rotation"] = ml.quat_from_yaw_pitch_roll(
        np.float32(0.55), np.float32(-0.35), np.float32(0))
    if name == "shadows":
        insts.append(scene_mod.MeshInstance(primitives.cube(1.0),
                                            ml.translation([0, 0.2, -4]),
                                            texture=checker))
        u["camera_position"] = np.float32([2.5, 2.0, 0.5])
        fn = engine.render_frame_with_shadows
        fs = shadows.shadowed_scene_fragment_shader
    elif name == "point_shadows":
        insts += [scene_mod.MeshInstance(primitives.cube(0.8),
                                         ml.translation([0, 0.6, -4]),
                                         texture=checker),
                  scene_mod.MeshInstance(
                      primitives.uv_sphere(0.5, rings=16, sectors=24),
                      ml.translation([1.8, 0.0, -5]), texture=checker)]
        u["camera_position"] = np.float32([2.5, 2.0, -0.5])
        u["point_light_position"] = np.float32([0.0, 3.0, -4.0])
        u["point_light_color"] = np.ones(4, np.float32)
        u["point_light_range"] = np.float32(40.0)
        fn = engine.render_frame_with_point_shadows
        fs = shadows.point_shadowed_fragment_shader
    elif name == "spot_shadows":
        insts.append(scene_mod.MeshInstance(primitives.cube(0.8),
                                            ml.translation([0, 0.2, -4]),
                                            texture=checker))
        u["camera_position"] = np.float32([2.5, 2.0, -0.5])
        u["spot_position"] = np.float32([1.5, 3.0, -2.0])
        d = np.float32([-0.35, -1.0, -0.55])
        u["spot_direction"] = d / np.linalg.norm(d)
        u["spot_inner"] = np.float32(0.35)
        u["spot_outer"] = np.float32(0.6)
        u["spot_color"] = np.ones(4, np.float32)
        u["spot_range"] = np.float32(40.0)
        fn = engine.render_frame_with_spot_shadow
        fs = shadows.spot_shadowed_fragment_shader
    else:
        raise ValueError(f"no shadow golden frame {name!r}")
    return (scene_mod.build_scene_buffers(insts),
            RenderParams(width=320, height=240), u,
            functools.partial(fn, shadow_size=256),
            dict(vertex_shader=lighting.lit_scene_vertex_shader,
                 fragment_shader=fs))


def _strips() -> List[scene_mod.MeshInstance]:
    """24 16-unit floor strips receding from the camera, uv × 16 over a
    64-texel 32-cell checkerboard: the mip goldens' scene."""
    insts = []
    for zi in range(24):
        strip = primitives.plane(16.0)
        strip["uv"] = strip["uv"] * np.float32(16.0)
        insts.append(scene_mod.MeshInstance(
            strip, ml.translation([0, -1, -8.0 - 16.0 * zi]),
            texture=np.asarray(checkerboard(64, 32)["data"])))
    return insts


def feature_golden_frame(name: str):
    """scripts/make_goldens.py's feature frame `name` at 320x240: "mips"
    (receding checkered strips, use_mipmaps=True), "trilinear" (the same
    strips, use_mipmaps="trilinear" and the trilinear shader), "ssaa" (a
    floor and a turned cube, ssaa=4), "ssao" (two grey cubes on a floor,
    ssao=True) or "skinning" (a three-bone tentacle over a floor at
    anim_time 0.6 s).  Returns (packed scene, RenderParams, uniforms,
    shaders), shaders the Engine keywords of the frame's shaders."""
    from softwarerenderer_tpu_torch import engine
    from softwarerenderer_tpu_torch.config import RenderParams
    u = engine.default_frame_uniforms(320, 240)
    shaders = {}
    if name in ("mips", "trilinear"):
        insts = _strips()
        params = RenderParams(width=320, height=240, use_mipmaps={
            "mips": True, "trilinear": "trilinear"}[name])
        if name == "trilinear":
            shaders = {"fragment_shader":
                       engine.scene_fragment_shader_trilinear}
        u["camera_position"] = np.float32([0, 0.5, 0])
        u["far_clip"] = np.float32(2000.0)
    elif name == "ssaa":
        checker = np.asarray(checkerboard(32, 4)["data"])
        insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                        ml.translation([0, -1, 0]),
                                        texture=checker),
                 scene_mod.MeshInstance(
                     primitives.cube(1.0),
                     (ml.matrix_from_yaw_pitch_roll(
                         np.float32(0.6), 0.3, 0.0)
                      @ ml.translation([0, 0.2, -3.0])).astype(np.float32),
                     texture=checker)]
        params = RenderParams(width=320, height=240, ssaa=4)
        u["camera_position"] = np.float32([0, 0.6, 1.5])
    elif name == "skinning":
        checker = np.asarray(checkerboard(32, 4)["data"])
        mesh = tentacle_mesh()
        insts = [scene_mod.MeshInstance(mesh, ml.translation([0, -1.2, 0]),
                                        texture=checker,
                                        skin=tentacle_skin(mesh["position"])),
                 scene_mod.MeshInstance(primitives.plane(12.0),
                                        ml.translation([0, -1.2, 0]),
                                        texture=checker)]
        params = RenderParams(width=320, height=240)
        u["camera_position"] = np.float32([0, 0.6, 4.5])
        u["anim_time"] = np.float32(0.6)
    elif name == "ssao":
        gray = np.asarray(checkerboard(
            32, 4, (0.85, 0.85, 0.85, 1.0), (0.7, 0.7, 0.7, 1.0))["data"])
        insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                        ml.translation([0, -1, 0]),
                                        texture=gray),
                 scene_mod.MeshInstance(primitives.cube(1.4),
                                        ml.translation([-0.9, -0.3, -4.0]),
                                        texture=gray),
                 scene_mod.MeshInstance(primitives.cube(0.9),
                                        ml.translation([1.1, -0.55, -3.2]),
                                        texture=gray)]
        params = RenderParams(width=320, height=240, ssao=True)
        u["camera_position"] = np.float32([0, 0.8, 0.0])
        u["camera_rotation"] = np.asarray(
            ml.quat_from_axis_angle([1.0, 0, 0], -0.25), np.float32)
    else:
        raise ValueError(f"no feature golden frame {name!r}")
    return scene_mod.build_scene_buffers(insts), params, u, shaders


def tentacle_mesh(height=3.0, radius=0.25, rings=24, sides=10) -> Dict:
    """A tube along +y, tapering to 40 % of its radius: rings × sides
    vertices (examples/skeletal_animation.py)."""
    ys = np.linspace(0.0, height, rings, dtype=F32)
    ang = np.linspace(0, 2 * np.pi, sides, endpoint=False)
    pos, nrm, uv = [], [], []
    for y in ys:
        taper = 1.0 - 0.6 * (y / height)
        for a in ang:
            pos.append([radius * taper * np.cos(a), y,
                        radius * taper * np.sin(a)])
            nrm.append([np.cos(a), 0.0, np.sin(a)])
            uv.append([a / (2 * np.pi), y / height])
    idx = []
    for r in range(rings - 1):
        for s in range(sides):
            a = r * sides + s
            b = r * sides + (s + 1) % sides
            idx += [[a, a + sides, b], [b, a + sides, b + sides]]
    return {
        "position": np.asarray(pos, F32),
        "normal": np.asarray(nrm, F32),
        "uv": np.asarray(uv, F32),
        "color": np.ones((rings * sides, 4), F32),
        "indices": np.asarray(idx, np.int32),
    }


def tentacle_skin(positions, n_bones=3, height=3.0, fps=24.0,
                  seconds=2.0) -> scene_mod.Skin:
    """A chain of n_bones along +y, each swaying 25° about z with a phase
    lag, smooth weights between adjacent bones
    (examples/skeletal_animation.py)."""
    seg = height / n_bones
    y = positions[:, 1]
    f = np.clip(y / seg, 0.0, n_bones - 1e-4)
    b0 = np.minimum(f.astype(np.int32), n_bones - 1)
    t = f - b0
    smooth = t * t * (3 - 2 * t)
    joints = np.stack([b0, np.minimum(b0 + 1, n_bones - 1),
                       np.zeros_like(b0), np.zeros_like(b0)], -1)
    weights = np.stack([1 - smooth, smooth,
                        np.zeros_like(smooth), np.zeros_like(smooth)], -1)
    weights = weights.astype(F32)

    F = int(fps * seconds)
    times = np.arange(F) / fps
    trans = np.zeros((F, n_bones, 3), F32)
    trans[:, 1:, 1] = seg                      # children sit +seg up
    rot = np.zeros((F, n_bones, 4), F32)
    for j in range(n_bones):
        amp = np.radians(25.0)
        phase = 2 * np.pi * times / seconds - j * 0.9
        ang = amp * np.sin(phase)
        rot[:, j, 2] = np.sin(ang / 2)
        rot[:, j, 3] = np.cos(ang / 2)
    scl = np.ones((F, n_bones, 3), F32)

    inv_bind = np.stack([np.asarray(ml.translation([0, -seg * j, 0]), F32)
                         for j in range(n_bones)])
    return scene_mod.Skin(joints=joints.astype(np.int32), weights=weights,
                          parent=np.asarray([-1] + list(range(n_bones - 1)),
                                            np.int32),
                          inverse_bind=inv_bind, trans=trans, rot=rot,
                          scale=scl, rate=fps)


def bumps_normal_map(res: int = 64, cells: int = 8) -> np.ndarray:
    """A tangent-space normal map of a grid of round bumps: (res, res, 4),
    rgb = normal · 0.5 + 0.5."""
    c = (np.arange(res, dtype=F32) + 0.5) / res * cells
    fx = c - np.floor(c) - 0.5
    dx = np.broadcast_to(-np.sin(2 * np.pi * fx)[None, :] * 0.6, (res, res))
    dy = np.broadcast_to(-np.sin(2 * np.pi * fx)[:, None] * 0.6, (res, res))
    n = np.stack([dx, dy, np.ones((res, res), F32)], -1)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    return np.concatenate([n * 0.5 + 0.5, np.ones((res, res, 1))],
                          -1).astype(F32)


# Phase 21's animated frame: 64 skinned tentacles (one clock a skin), 8
# flip-book meshes, 4 morphing meshes of 2 targets, a 1,024-slot emitter
# and 16 meshes of 2 LOD levels, over a normal-mapped floor.
ANIMATED_TENTACLES = 64
ANIMATED_FLIPBOOKS = 8
ANIMATED_MORPHS = 4
ANIMATED_PARTICLES = 1024
ANIMATED_LODS = 16
# The LOD meshes (unit spheres) switch to level 1 below LOD_PX pixels of
# projected radius; LOD_DISTANCES (along the ground from the camera) put
# half of them at 2.2-3.8 times the threshold and half at 0.56-0.72 times
# it at 1080 rows (every one below it at 180 rows), no level near a switch.
LOD_PX = 24.0
LOD_DISTANCES = (5.5, 7.0, 8.5, 10.0, 31.0, 34.0, 37.0, 40.0)
ANIMATED_CAMERA = (0.0, 2.5, 8.0)


def animated_scene(**counts) -> Dict[str, np.ndarray]:
    """The phase-21 frame's packed scene, animated_instances(**counts)."""
    return scene_mod.build_scene_buffers(animated_instances(**counts))


def animated_instances(tentacles: int = ANIMATED_TENTACLES,
                       flipbooks: int = ANIMATED_FLIPBOOKS,
                       morphs: int = ANIMATED_MORPHS,
                       particles: int = ANIMATED_PARTICLES,
                       lods: int = ANIMATED_LODS
                       ) -> List[scene_mod.MeshInstance]:
    """The phase-21 frame's instances (seeded, rng 21); the counts cut it
    down for the CPU tests (the LOD meshes alternate near and far)."""
    from softwarerenderer_tpu_torch.ops.lod import add_lods
    from softwarerenderer_tpu_torch.sim.particles import (particles_mesh,
                                                          soft_disc_texture)
    rng = np.random.default_rng(21)
    checker = np.asarray(checkerboard(64, 8)["data"])
    floor = dict(primitives.plane(80.0))
    floor["uv"] = floor["uv"] * np.float32(20.0)
    insts = [scene_mod.MeshInstance(
        floor, ml.translation([0, -1.0, -20.0]), texture=checker,
        normal_texture=bumps_normal_map())]
    tentacle = tentacle_mesh()
    for i in range(tentacles):
        x, z = (i % 8) * 1.6 - 5.6, -6.0 - (i // 8) * 1.6
        skin = tentacle_skin(tentacle["position"],
                             seconds=float(rng.uniform(1.5, 2.5)))
        insts.append(scene_mod.MeshInstance(
            tentacle, ml.translation([x, -1.0, z]), texture=checker,
            skin=skin))
    cube = primitives.cube(0.8)
    for i in range(flipbooks):
        frames = np.stack([cube["position"] * np.float32(1.0 + 0.1 * f)
                           + np.float32([0, 0.1 * f, 0])
                           for f in range(4 + i % 3)])
        insts.append(scene_mod.MeshInstance(
            cube, ml.translation([-7.0 + 2.0 * i, 0.0, -3.5]),
            texture=checker, animation_positions=frames))
    sphere = primitives.uv_sphere(0.6, rings=12, sectors=18)
    nv = sphere["position"].shape[0]
    for i in range(morphs):
        dp = np.zeros((2, nv, 3), F32)
        dp[0, :, 1] = sphere["position"][:, 1] * 0.8
        dp[1] = sphere["normal"] * 0.25
        track = rng.uniform(0, 1, (30, 2)).astype(F32)
        insts.append(scene_mod.MeshInstance(
            sphere, ml.translation([-4.5 + 3.0 * i, 1.5, -4.5]),
            texture=checker,
            morph={"pos": dp, "nrm": dp * 0.5, "weights": [0.3, 0.2],
                   "weight_track": track, "rate": 12.0}))
    insts.append(scene_mod.MeshInstance(
        particles_mesh(particles, extent=20.0),
        texture=soft_disc_texture(), particles=particles))
    lod_mesh = add_lods(primitives.uv_sphere(1.0, rings=16, sectors=24),
                        cells=(4,), px=(LOD_PX,))
    cam = ANIMATED_CAMERA
    for i in range(lods):
        d = LOD_DISTANCES[(5 * i) % len(LOD_DISTANCES)]   # near, far, ...
        ang = (-1.0 if i < lods // 2 else 1.0) * 0.55
        insts.append(scene_mod.MeshInstance(
            lod_mesh, ml.translation([cam[0] + d * np.sin(ang), 0.5,
                                      cam[2] - d * np.cos(ang)]),
            texture=checker))
    return insts


def animated_uniforms(uniforms: Dict, i: int, fps: float = 60.0,
                      tentacles: int = ANIMATED_TENTACLES,
                      particles: int = ANIMATED_PARTICLES) -> Dict:
    """Frame i of animated_scene (of the same counts): anim_time i / fps
    (one clock a skin, each skin's offset by 0.05 s), anim_frame i, and
    the emitter's particles on ballistic arcs from a seeded start (rng
    22)."""
    t = np.float32(i / fps)
    rng = np.random.default_rng(22)
    n = particles
    p0 = rng.uniform([-1.0, -0.5, -5.0], [1.0, 0.5, -3.0], (n, 3))
    v0 = rng.uniform([-1.0, 2.0, -1.0], [1.0, 5.0, 1.0], (n, 3))
    age = np.float32(rng.uniform(0.0, 1.0, n)) + t
    g = np.float32([0.0, -4.9, 0.0])
    u = dict(uniforms)
    u["camera_position"] = np.float32(ANIMATED_CAMERA)
    u["camera_rotation"] = ml.quat_from_yaw_pitch_roll(
        np.float32(0.0), np.float32(-0.2), np.float32(0))
    u["anim_time"] = (t + np.float32(0.05)
                      * np.arange(tentacles)).astype(F32)
    u["anim_frame"] = np.int32(i)
    u["particle_centers"] = (p0 + v0 * age[:, None]
                             + g * (age * age)[:, None]).astype(F32)
    u["particle_size"] = np.where(age < 1.5, 0.15, 0.0).astype(F32)
    u["particle_color"] = np.concatenate(
        [np.broadcast_to(np.float32([1.0, 0.7, 0.3]), (n, 3)),
         np.where(age < 1.5, 1.0, 0.0)[:, None]], -1).astype(F32)
    return u


# bench.py config 4 (bench.py:369-406): the physics-coupled step at
# 1280x720, the character from (0, 3, 6) walking (0, 0, -1) at 1/60 s.
CONFIG4_SIZE = (1280, 720)
CONFIG4_START = (0.0, 3.0, 6.0)
CONFIG4_DT = 1.0 / 60.0


@functools.lru_cache(maxsize=None)
def _config4_move(device):
    """Config 4's move input, on `device` once."""
    return torch.tensor([0.0, 0.0, -1.0], dtype=torch.float32,
                        device=device)


def config4_physics(state: Dict, scene: Dict, char_params: Dict) -> Dict:
    """The simulation half of config 4's step: the collision world built
    from the scene inside the step, then character_step with move (0, 0,
    -1), no jump, dt 1/60.  `scene` is on the state's device
    (models.convert.scene_to_torch); char_params as tensors there
    (models.convert.tree_to_torch) keep the step free of host copies."""
    dev = state["position"].device
    world = build_collision_world(scene)
    return character_step(state, _config4_move(dev), False, CONFIG4_DT,
                          world, char_params)


def coupled_step(state: Dict, scene: Dict, uniforms: Dict, params,
                 char_params: Dict, fold=None):
    """bench.py config 4's step (bench.py:384-392): config4_physics, the
    camera at the character's position + cam_offset, and the frame
    through render_frame (`fold` as render_frame's).  Returns (state,
    color, depth).  With the uniforms' values as tensors on the state's
    device (tree_to_torch) the step reads nothing back to the host."""
    from softwarerenderer_tpu_torch.engine import render_frame
    state = config4_physics(state, scene, char_params)
    u = dict(uniforms)
    u["camera_position"] = state["position"][0] + char_params["cam_offset"]
    color, depth = render_frame(scene, u, params, fold=fold)
    return state, color, depth


# The crowd on the bench scene, in the dust2 app's shape
# (apps/dust2.py:372-395): two spawn centres with 16 floor points each,
# routed by build_waypoint_graph, agents spawned around alternate centres
# who target each other by id.  The seeded soup fills x, y in [-2.8, 2.8],
# z in [-6.8, -1.2]; the centres stand over it at y = 3.5 and the floor
# points are dropped within 1.5 m of them (the app's 12 m would miss the
# soup's 5.6 m).
CROWD_CENTRES = ((-1.2, 3.5, -4.0), (1.2, 3.5, -4.0))
CROWD_RADIUS = 1.5
CROWD_POINTS = 16


def crowd_setup(world: Dict, n: int, seed: int = 22) -> Dict:
    """A crowd of n agents on `world` (the bench scene's collision world):
    {"state": initial_agents_state on the world's device, "waypoints" (W,
    3) and "next_hop" (W, W) there, "ids" (n,) int32}.  Spawns jitter
    ±1.5 m around alternate centres and start at random waypoints
    (numpy's default_rng(seed)); the agents' key is prng_key(seed)."""
    dev = world["v0"].device
    wps = scatter_waypoints_on_floor(world, CROWD_CENTRES, CROWD_POINTS,
                                     seed=seed, radius=CROWD_RADIUS)
    hop = build_waypoint_graph(world, wps)
    rng = np.random.default_rng(seed)
    centres = np.asarray(CROWD_CENTRES, F32)[np.arange(n) % 2]
    jitter = rng.uniform(-1.5, 1.5, (n, 2)).astype(F32)
    starts = centres + np.stack([jitter[:, 0], np.zeros(n, F32),
                                 jitter[:, 1]], 1)
    wp0 = rng.integers(0, len(wps), n).astype(np.int32)
    return {"state": initial_agents_state(starts, key=prng_key(seed, dev),
                                          waypoint_idx=wp0, device=dev),
            "waypoints": torch.from_numpy(wps).to(dev),
            "next_hop": torch.from_numpy(hop).to(dev),
            "ids": torch.arange(n, dtype=torch.int32, device=dev)}


def crowd_step(state: Dict, crowd: Dict, world: Dict, char_params: Dict,
               brain: Dict, dt=1.0 / 60.0) -> Dict:
    """One agents_step of the crowd with routing and combat: every agent
    a target, alive, never its own."""
    pos = state["char"]["position"]
    return agents_step(state, dt, crowd["waypoints"], world, char_params,
                       brain, next_hop=crowd["next_hop"], targets=pos,
                       target_ids=crowd["ids"], self_ids=crowd["ids"])


# Phase 22's emitters over animated_scene's floor (y = -1): the dust2
# app's impact sparks (256 slots, apps/dust2.py:633) and a fountain for
# the scene's 1,024 slots that bounces on the floor.
SPARK_SLOTS = 256


def spark_emitter(origin=None, dt: float = 1.0 / 60.0) -> Dict:
    """apps/dust2.py's impact-spark emitter (:766-772): quiet (rate 0);
    given an impact `origin` on an upward floor, that step's burst of 24
    particles at 2 m/s along the normal (:1400, :1612-1616)."""
    em = default_emitter_params()
    em.update(rate=F32(0.0), base_velocity=np.zeros(3, F32),
              spread=F32(2.2), lifetime=np.asarray([0.25, 0.6], F32),
              size=np.asarray([0.05, 0.01], F32),
              color0=np.asarray([1.0, 0.85, 0.4, 1.0], F32),
              color1=np.asarray([1.0, 0.3, 0.05, 0.0], F32))
    if origin is not None:
        n = np.asarray([0.0, 1.0, 0.0], F32)
        em.update(origin=np.asarray(origin, F32) + n * F32(0.02),
                  base_velocity=n * F32(2.0),
                  rate=F32(24.0) / F32(max(dt, 1e-3)))
    return em


def fountain_emitter() -> Dict:
    """A fountain for animated_scene's 1,024 slots: 600 particles/s from
    (0, -1, -4) at 4 m/s up, bouncing on the floor at y = -1 (about 960
    alive at once with the default 1.2-2.0 s lifetimes)."""
    em = default_emitter_params()
    em.update(origin=np.asarray([0.0, -1.0, -4.0], F32),
              base_velocity=np.asarray([0.0, 4.0, 0.0], F32),
              rate=F32(600.0), floor_y=F32(-1.0))
    return em
