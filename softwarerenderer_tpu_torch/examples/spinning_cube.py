"""Minimal example: a spinning textured cube rendered headless to PNGs.

    python -m softwarerenderer_tpu_torch.examples.spinning_cube [out_dir]
        [--device cpu]
"""

import os

import numpy as np
import torch
from PIL import Image

from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.examples import cli, demo_device
from softwarerenderer_tpu_torch.models import primitives, scene
from softwarerenderer_tpu_torch.ops import texture
from softwarerenderer_tpu_torch.utils import mathlib as ml


def main(out_dir="/tmp/spinning_cube", device="cuda"):
    device = demo_device(device)

    os.makedirs(out_dir, exist_ok=True)
    checker = np.asarray(texture.checkerboard(64, 8)["data"])
    insts = [scene.MeshInstance(primitives.cube(1.5), texture=checker)]
    sc = scene.build_scene_buffers(insts)

    eng = Engine(sc, RenderParams(width=640, height=480), device=device)
    u = eng.uniforms
    u["camera_position"] = np.float32([0.0, 1.0, 3.5])
    u["camera_rotation"] = np.asarray(
        ml.quat_from_yaw_pitch_roll(0.0, -0.25, 0.0), np.float32)

    frames = []
    for i in range(8):
        angle = i * np.pi / 8
        # per-frame motion = rewrite the engine's mesh-matrix buffer in
        # place (no re-upload of the scene)
        eng.mesh_matrices.copy_(torch.from_numpy(np.asarray(
            ml.matrix_from_yaw_pitch_roll(angle, angle * 0.3, 0.0),
            np.float32)[None]))
        rgb = eng.present(u)
        Image.fromarray(rgb).save(f"{out_dir}/frame_{i:02d}.png")
        frames.append(rgb)
    print(f"wrote 8 frames to {out_dir}")
    return frames


if __name__ == "__main__":
    cli(main, str)
