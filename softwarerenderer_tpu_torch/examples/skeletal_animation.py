"""Skeletal animation example: a three-bone tentacle waving on the device.

The skeleton, weights and keyframes are built procedurally
(models.scene.Skin); the whole evaluation — keyframe sampling, forward
kinematics, linear-blend skinning — runs in the frame on the device,
driven by the uniforms["anim_time"] clock (ops/skinning.py).  Beyond the
reference, whose only animation is the flip-book frame swap
(ModelLoader.cs:331-348).

    python -m softwarerenderer_tpu_torch.examples.skeletal_animation
        [out_dir] [--device cpu]
"""

import os

import numpy as np
from PIL import Image

from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.examples import cli, demo_device
from softwarerenderer_tpu_torch.models import primitives, scene
from softwarerenderer_tpu_torch.ops import texture
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = np.float32


def tentacle_mesh(height=3.0, radius=0.25, rings=24, sides=10):
    """A capped tube along +y with smooth ring weights."""
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


def tentacle_skin(positions, n_bones=3, height=3.0, fps=24.0, seconds=2.0):
    """Chain of n_bones along +y; each sways about z with a phase lag —
    smooth blend weights between adjacent bones."""
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
    return scene.Skin(joints=joints.astype(np.int32), weights=weights,
                      parent=np.asarray([-1] + list(range(n_bones - 1)),
                                        np.int32),
                      inverse_bind=inv_bind, trans=trans, rot=rot,
                      scale=scl, rate=fps)


def main(out_dir="/tmp/skeletal", device="cuda"):
    device = demo_device(device)
    os.makedirs(out_dir, exist_ok=True)
    mesh = tentacle_mesh()
    skin = tentacle_skin(mesh["position"])
    checker = np.asarray(texture.checkerboard(64, 8)["data"])
    insts = [
        scene.MeshInstance(mesh, ml.translation([0.0, -1.2, 0.0]),
                           texture=checker, skin=skin),
        scene.MeshInstance(primitives.plane(12.0),
                           ml.translation([0.0, -1.2, 0.0]), texture=checker),
    ]
    sc = scene.build_scene_buffers(insts)
    eng = Engine(sc, RenderParams(width=480, height=360), device=device)
    u = eng.uniforms
    u["camera_position"] = np.float32([0.0, 0.6, 4.5])

    frames = []
    for i in range(12):
        u["anim_time"] = F32(i / 6.0)       # 2 s loop in 12 frames
        rgb = eng.present(u)
        Image.fromarray(rgb).save(
            os.path.join(out_dir, f"frame_{i:03d}.png"))
        frames.append(rgb)
    print("wrote 12 frames to", out_dir)
    return frames


if __name__ == "__main__":
    cli(main, str)
