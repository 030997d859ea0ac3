"""Split-screen example: two cameras orbit the same scene, composed
side-by-side in one frame (engine.render_frame_multiview, one tile-kernel
launch a view) — the local-co-op capability the reference's
single-camera loop (Renderer.cs:404-419) can't express.

    python -m softwarerenderer_tpu_torch.examples.split_screen [out_dir]
        [--device cpu]
"""

import os

import numpy as np
from PIL import Image

from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import (default_frame_uniforms,
                                               render_frame_multiview, to_rgb8)
from softwarerenderer_tpu_torch.examples import cli, demo_device
from softwarerenderer_tpu_torch.models import primitives, scene
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import texture
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = np.float32


def arena():
    checker = np.asarray(texture.checkerboard(64, 8)["data"])
    rng = np.random.default_rng(5)
    insts = [scene.MeshInstance(primitives.plane(16.0),
                                ml.translation([0, -1, 0]),
                                texture=checker)]
    for _ in range(10):
        p = rng.uniform(-5, 5, 3).astype(F32)
        p[1] = rng.uniform(-0.5, 1.0)
        insts.append(scene.MeshInstance(
            primitives.cube(rng.uniform(0.5, 1.4)),
            ml.translation(p), texture=checker))
    return scene.build_scene_buffers(insts)


def orbit_view(yaw, pitch, dist=7.0):
    """Orbit camera looking back at the origin (the viewer app's
    parameterization: eye = dist·[cp·sin(yaw), −sin(pitch), cp·cos(yaw)],
    rotation = (yaw, pitch))."""
    cp = np.cos(pitch)
    eye = dist * np.float32([cp * np.sin(yaw), -np.sin(pitch),
                             cp * np.cos(yaw)])
    return {"camera_position": eye,
            "camera_rotation": np.asarray(
                ml.quat_from_yaw_pitch_roll(F32(yaw), F32(pitch),
                                            F32(0.0)), F32)}


def main(out_dir="/tmp/split", device="cuda"):
    device = demo_device(device)
    os.makedirs(out_dir, exist_ok=True)
    sc = scene_to_torch(arena(), device)
    params = RenderParams(width=640, height=240)
    u = default_frame_uniforms(params.width, params.height)

    frames = []
    for i in range(8):
        a = i / 8.0 * 2 * np.pi
        views = (orbit_view(a, -0.25),
                 orbit_view(a + np.pi, -0.4, dist=9.0))
        c, _d = render_frame_multiview(sc, u, params, views)
        rgb = to_rgb8(c).cpu().numpy()
        Image.fromarray(rgb).save(os.path.join(out_dir, f"frame_{i:03d}.png"))
        frames.append(rgb)
    print("wrote 8 split-screen frames to", out_dir)
    return frames


if __name__ == "__main__":
    cli(main, str)
