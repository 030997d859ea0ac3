"""Example: order-correct translucency + alpha-cutout via the K-buffer.

Winner-only deferred shading is exact for opaque scenes but wrong when a
discarded fragment should reveal geometry behind it, or when translucent
layers must blend in submission order.  RenderParams(kbuffer=K) keeps the
K best fragments per pixel and replays the reference's sequential
shade-blend over them (Rasterizer.cs:509-523): on the card the tile
kernel's first pass and its peel passes.

    python -m softwarerenderer_tpu_torch.examples.translucency_kbuffer
        [--device cpu]
"""

import numpy as np
from PIL import Image

from softwarerenderer_tpu_torch import CullMode, RenderParams
from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.examples import cli, demo_device
from softwarerenderer_tpu_torch.models import primitives, scene
from softwarerenderer_tpu_torch.ops import texture as tex_ops
from softwarerenderer_tpu_torch.utils import mathlib as ml


def main(device="cuda"):
    device = demo_device(device)

    checker = np.asarray(tex_ops.checkerboard(32, 4)["data"])
    glass_blue = np.zeros((8, 8, 4), np.float32)
    glass_blue[...] = (0.3, 0.5, 1.0, 0.45)
    glass_red = np.zeros((8, 8, 4), np.float32)
    glass_red[...] = (1.0, 0.3, 0.3, 0.4)

    insts = [
        # opaque backdrop
        scene.MeshInstance(primitives.plane(20.0),
                           ml.translation([0, -1, 0]), texture=checker),
        scene.MeshInstance(primitives.cube(1.0),
                           ml.translation([0, 0, -5]), texture=checker),
        # two translucent layers in front, submitted back-to-front
        scene.MeshInstance(primitives.cube(1.6),
                           ml.translation([0.3, 0, -3.4]),
                           texture=glass_red),
        scene.MeshInstance(primitives.cube(1.2),
                           ml.translation([-0.3, 0.1, -2.2]),
                           texture=glass_blue),
    ]
    eng = Engine(scene.build_scene_buffers(insts),
                 RenderParams(width=640, height=480, kbuffer=4,
                              cull_mode=CullMode.BACK), device=device)
    u = dict(eng.uniforms)
    u["camera_position"] = np.float32([0.0, 0.8, 1.5])
    rgb = eng.present(u)
    Image.fromarray(rgb).save("kbuffer_example.png")
    print("wrote kbuffer_example.png", rgb.shape)
    return rgb


if __name__ == "__main__":
    cli(main)
