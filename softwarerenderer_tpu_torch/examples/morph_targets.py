"""Morph-target (blend-shape) example: a face-like blob blending between
a neutral sphere, a "smile" target and a "puff" target on the device.

The delta buffers pack once (models.scene.MeshInstance(morph=...)); per
frame only uniforms["morph_weights"] change, so sweeping the weights
never re-uploads vertex data (ops/morph.py).  Beyond the reference, whose
only animation is the flip-book frame swap (ModelLoader.cs:331-348).

    python -m softwarerenderer_tpu_torch.examples.morph_targets [out_dir]
        [--device cpu]
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


def blob_with_targets(n=18):
    """A UV sphere plus two sculpted targets (delta arrays)."""
    mesh = primitives.uv_sphere(1.0, n, n)
    pos = np.asarray(mesh["position"], F32)
    v = pos.shape[0]
    # target 0 "smile": pull the lower front outward and up
    smile = np.zeros((v, 3), F32)
    low_front = (pos[:, 1] < -0.2) & (pos[:, 2] > 0.2)
    smile[low_front] = (pos[low_front] * np.float32([0.6, 0.0, 0.6])
                        + np.float32([0.0, 0.35, 0.25]))
    # target 1 "puff": inflate along the normal-ish radial direction
    r = np.linalg.norm(pos, axis=1, keepdims=True)
    puff = (pos / np.maximum(r, 1e-6) * 0.45).astype(F32)
    morph = {"pos": np.stack([smile, puff]),
             "nrm": None,
             "weights": np.asarray([0.0, 0.0], F32),
             "weight_track": None, "rate": 30.0}
    return mesh, morph


def main(out_dir="/tmp/morph", device="cuda"):
    device = demo_device(device)
    os.makedirs(out_dir, exist_ok=True)
    mesh, morph = blob_with_targets()
    checker = np.asarray(texture.checkerboard(64, 8)["data"])
    insts = [
        scene.MeshInstance(mesh, np.eye(4, dtype=F32), texture=checker,
                           morph=morph),
        scene.MeshInstance(primitives.plane(10.0),
                           ml.translation([0.0, -1.6, 0.0]),
                           texture=checker),
    ]
    sc = scene.build_scene_buffers(insts)
    eng = Engine(sc, RenderParams(width=480, height=360), device=device)
    u = eng.uniforms
    u["camera_position"] = np.float32([0.0, 0.3, 4.0])

    frames = []
    for i in range(12):
        t = i / 11.0
        # sweep: smile in the first half, puff in the second
        u["morph_weights"] = np.asarray(
            [[min(1.0, 2 * t), max(0.0, 2 * t - 1.0)]], F32)
        rgb = eng.present(u)
        Image.fromarray(rgb).save(
            os.path.join(out_dir, f"frame_{i:03d}.png"))
        frames.append(rgb)
    print("wrote 12 frames to", out_dir)
    return frames


if __name__ == "__main__":
    cli(main, str)
