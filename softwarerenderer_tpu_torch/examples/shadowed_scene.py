"""Directional shadow maps: one extra depth-only pass from the light
before the frame (a capability beyond the reference).

    python -m softwarerenderer_tpu_torch.examples.shadowed_scene [out.png]
        [--device cpu]
"""

import numpy as np
from PIL import Image

from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import (default_frame_uniforms,
                                               render_frame_with_shadows,
                                               to_rgb8)
from softwarerenderer_tpu_torch.examples import cli, demo_device
from softwarerenderer_tpu_torch.models import primitives, scene as scene_mod
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import texture as tex_ops
from softwarerenderer_tpu_torch.utils import mathlib as ml


def main(out="shadow_demo.png", device="cuda"):
    device = demo_device(device)

    checker = np.asarray(tex_ops.checkerboard(
        64, 8, (0.85, 0.8, 0.7, 1.0), (0.5, 0.45, 0.4, 1.0))["data"])
    insts = [scene_mod.MeshInstance(primitives.plane(24.0),
                                    ml.translation([0, -1, 0]),
                                    texture=checker)]
    rng = np.random.default_rng(4)
    for _ in range(6):
        pos = rng.uniform(-4, 4, 3).astype(np.float32)
        pos[1] = rng.uniform(-0.4, 1.2)
        pos[2] = rng.uniform(-7, -2)
        insts.append(scene_mod.MeshInstance(
            primitives.cube(float(rng.uniform(0.6, 1.3))),
            ml.translation(pos), texture=checker))
    sc = scene_to_torch(scene_mod.build_scene_buffers(insts), device)

    params = RenderParams(width=640, height=480)
    u = default_frame_uniforms(640, 480)
    u["camera_position"] = np.float32([3.5, 2.5, 1.0])
    u["camera_rotation"] = ml.quat_from_yaw_pitch_roll(
        np.float32(0.6), np.float32(-0.35), np.float32(0))

    color, _ = render_frame_with_shadows(sc, u, params=params,
                                         shadow_size=512)
    rgb = to_rgb8(color).cpu().numpy()
    Image.fromarray(rgb).save(out)
    print(f"wrote {out}")
    return rgb


if __name__ == "__main__":
    cli(main, str)
