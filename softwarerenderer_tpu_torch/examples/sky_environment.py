"""Equirectangular sky environment example: procedural sunset panorama
behind a checkered scene (ops/sky.py — beyond the reference's flat
clear color).

    python -m softwarerenderer_tpu_torch.examples.sky_environment [out.png]
        [--device cpu]
"""

import numpy as np
from PIL import Image

from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.examples import cli, demo_device
from softwarerenderer_tpu_torch.models import primitives, scene
from softwarerenderer_tpu_torch.ops import texture
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = np.float32


def sunset_panorama(h=256, w=512):
    """Vertical sunset gradient + a sun disc near the horizon."""
    v = np.linspace(0.0, 1.0, h, dtype=F32)[:, None]
    top = np.asarray([0.15, 0.2, 0.45], F32)
    mid = np.asarray([0.95, 0.55, 0.3], F32)
    bot = np.asarray([0.25, 0.2, 0.25], F32)
    up = np.clip(1.0 - 2.0 * v, 0.0, 1.0)
    dn = np.clip(2.0 * v - 1.0, 0.0, 1.0)
    rgb = (up[..., None] * top + (1 - up - dn)[..., None] * mid
           + dn[..., None] * bot)
    rgb = np.broadcast_to(rgb, (h, w, 3)).copy()
    uu = np.linspace(0.0, 1.0, w, dtype=F32)[None, :]
    sun = np.exp(-(((uu - 0.5) / 0.02) ** 2
                   + ((v - 0.42) / 0.03) ** 2))
    rgb += sun[..., None] * np.asarray([1.0, 0.9, 0.6], F32)
    rgb = np.clip(rgb, 0.0, 1.0)
    return np.concatenate([rgb, np.ones((h, w, 1), F32)], axis=-1)


def main(out="/tmp/sky_environment.png", device="cuda"):
    device = demo_device(device)
    checker = np.asarray(texture.checkerboard(32, 4)["data"])
    insts = [scene.MeshInstance(primitives.plane(30.0),
                                ml.translation([0, -1, 0]),
                                texture=checker),
             scene.MeshInstance(primitives.cube(1.2),
                                ml.translation([0, 0, -4.0]),
                                texture=checker)]
    sc = scene.build_scene_buffers(insts)
    eng = Engine(sc, RenderParams(width=640, height=400, ssaa=2),
                 device=device)
    u = dict(eng.uniforms)
    u["camera_position"] = np.float32([0.0, 0.8, 2.0])
    u["camera_rotation"] = np.asarray(
        ml.quat_from_axis_angle([1.0, 0.0, 0.0], 0.12), F32)
    u["sky_panorama"] = sunset_panorama()
    u["fog_color"] = np.asarray([0.95, 0.55, 0.3, 1.0], F32)
    rgb = eng.present(u)
    Image.fromarray(rgb).save(out)
    print("wrote", out)
    return rgb


if __name__ == "__main__":
    cli(main, str)
