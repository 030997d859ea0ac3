"""Skinned crowd: 8 tentacles, each its own skeleton, animated off ONE
per-skin time vector in a single frame — the crowd pattern (per-instance
clocks, no re-upload).

    python -m softwarerenderer_tpu_torch.examples.skinned_crowd [out.png]
        [--device cpu]
"""

import numpy as np
from PIL import Image

from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.examples import cli, demo_device
from softwarerenderer_tpu_torch.examples.skeletal_animation import (
    tentacle_mesh,
    tentacle_skin,
)
from softwarerenderer_tpu_torch.models import primitives, scene
from softwarerenderer_tpu_torch.ops import texture
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = np.float32


def main(out="/tmp/skinned_crowd.png", device="cuda"):
    device = demo_device(device)
    checker = np.asarray(texture.checkerboard(64, 8)["data"])
    insts = [scene.MeshInstance(primitives.plane(40.0),
                                ml.translation([0.0, -1.2, 0.0]),
                                texture=checker)]
    rng = np.random.default_rng(3)
    n = 8
    for i in range(n):
        mesh = tentacle_mesh(rings=16, sides=8)
        skin = tentacle_skin(mesh["position"])
        pos = np.float32([-6.0 + 1.7 * i, -1.2,
                          -6.0 - 3.0 * rng.random()])
        insts.append(scene.MeshInstance(mesh, ml.translation(pos),
                                        texture=checker, skin=skin))
    sc = scene.build_scene_buffers(insts)

    eng = Engine(sc, RenderParams(width=640, height=360, ssaa=2),
                 device=device)
    u = dict(eng.uniforms)
    u["camera_position"] = np.float32([0.0, 1.5, 4.0])
    # one clock per skin, phase-offset: the whole crowd desynchronizes
    u["anim_time"] = (np.arange(n, dtype=F32) * 0.37) % 2.0

    rgb = eng.present(u)
    Image.fromarray(rgb).save(out)
    print("wrote", out)
    return rgb


if __name__ == "__main__":
    cli(main, str)
