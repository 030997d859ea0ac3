"""Example: point-light cube shadows.

Six depth-only passes from the light position (one per cube face) build a
(6, S, S) shadow map before the frame; the fragment shader picks the face
by the dominant axis of (fragment - light) and compares depth
(ops/shadows.py).  The reference imports point lights from scenes but
never consumes them (Light.cs:19-32).

    python -m softwarerenderer_tpu_torch.examples.point_light_shadows
        [--device cpu]
"""

import numpy as np
from PIL import Image

from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import (
    default_frame_uniforms,
    render_frame_with_point_shadows,
    to_rgb8,
)
from softwarerenderer_tpu_torch.examples import cli, demo_device
from softwarerenderer_tpu_torch.models import primitives, scene
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import texture as tex_ops
from softwarerenderer_tpu_torch.utils import mathlib as ml


def main(device="cuda"):
    device = demo_device(device)

    checker = np.asarray(tex_ops.checkerboard(64, 8)["data"])
    insts = [scene.MeshInstance(primitives.plane(20.0),
                                ml.translation([0, -1, 0]),
                                texture=checker),
             scene.MeshInstance(primitives.cube(0.8),
                                ml.translation([0, 0.6, -4]),
                                texture=checker),
             scene.MeshInstance(primitives.uv_sphere(0.5, rings=16,
                                                     sectors=24),
                                ml.translation([1.8, 0.0, -5]),
                                texture=checker)]
    sc = scene_to_torch(scene.build_scene_buffers(insts), device)
    params = RenderParams(width=640, height=480)
    u = default_frame_uniforms(640, 480)
    u["camera_position"] = np.float32([2.5, 2.0, -0.5])
    u["camera_rotation"] = ml.quat_from_yaw_pitch_roll(
        np.float32(0.55), np.float32(-0.35), np.float32(0))
    u["point_light_position"] = np.float32([0.0, 3.0, -4.0])
    u["point_light_color"] = np.ones(4, np.float32)
    u["point_light_range"] = np.float32(40.0)

    color, _depth = render_frame_with_point_shadows(
        sc, u, params=params, shadow_size=256)
    rgb = to_rgb8(color).cpu().numpy()
    Image.fromarray(rgb).save("point_shadows_example.png")
    print("wrote point_shadows_example.png", rgb.shape)
    return rgb


if __name__ == "__main__":
    cli(main)
