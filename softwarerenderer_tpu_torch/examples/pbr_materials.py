"""PBR material sweep: metallic/roughness/emissive driving the
metalness shader (ops/lighting.pbr_scene_fragment_shader) — properties
the reference imports but never shades with (Material.cs:14-22) — with
environment reflections when a sky panorama is present.

    python -m softwarerenderer_tpu_torch.examples.pbr_materials [out.png]
        [--device cpu]
"""

import numpy as np
from PIL import Image

from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import (default_frame_uniforms,
                                               render_frame, to_rgb8)
from softwarerenderer_tpu_torch.examples import cli, demo_device
from softwarerenderer_tpu_torch.examples.sky_environment import (
    sunset_panorama)
from softwarerenderer_tpu_torch.models import primitives, scene as scene_mod
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import texture as tex_ops
from softwarerenderer_tpu_torch.ops.lighting import (
    lit_scene_vertex_shader,
    pbr_scene_fragment_shader,
)
from softwarerenderer_tpu_torch.ops.sky import irradiance_panorama
from softwarerenderer_tpu_torch.utils import mathlib as ml


def main(out="/tmp/pbr_materials.png", device="cuda"):
    device = demo_device(device)
    floor = np.asarray(tex_ops.checkerboard(
        32, 4, (0.75, 0.75, 0.75, 1), (0.6, 0.6, 0.6, 1))["data"])
    insts = [scene_mod.MeshInstance(primitives.plane(30.0),
                                    ml.translation([0, -1.2, 0]),
                                    texture=floor)]
    sweep = [(0.0, 0.8), (0.0, 0.2), (1.0, 0.3), (1.0, 0.05)]
    for i, (m, r) in enumerate(sweep):
        insts.append(scene_mod.MeshInstance(
            primitives.uv_sphere(0.7, rings=32, sectors=64),
            ml.translation([-2.4 + 1.6 * i, -0.3, -4.0]),
            material=scene_mod.Material(base_color=(0.9, 0.8, 0.7, 1.0),
                                        metallic=m, roughness=r)))
    insts.append(scene_mod.MeshInstance(
        primitives.cube(0.8), ml.translation([0, 1.2, -5.0]),
        material=scene_mod.Material(base_color=(0, 0, 0, 1),
                                    emissive=(0.2, 0.9, 0.3))))
    sc = scene_to_torch(scene_mod.build_scene_buffers(insts), device)

    W, H = 640, 400
    u = default_frame_uniforms(W, H)
    ld = np.float32([0.4, -0.6, -1.0])
    u["light_direction"] = ld / np.linalg.norm(ld)
    u["fog_start"], u["fog_end"] = np.float32(900.0), np.float32(1000.0)
    u["camera_position"] = np.float32([0, 0.3, 0.5])
    pano = sunset_panorama()
    u["sky_panorama"] = pano
    # image-based diffuse ambient from the same sky (host-side, once)
    u["env_irradiance"] = irradiance_panorama(pano)
    c, _ = render_frame(sc, u, params=RenderParams(width=W, height=H),
                        vertex_shader=lit_scene_vertex_shader,
                        fragment_shader=pbr_scene_fragment_shader)
    img = to_rgb8(c).cpu().numpy()
    Image.fromarray(img).save(out)
    print("wrote", out)
    return img


if __name__ == "__main__":
    cli(main, str)
