"""Normal-mapping example: the reference's Gun model with its real
normal map (an asset the reference loads but never samples —
ModelLoader.cs:221-281) rendered with the TBN shader pair, A/B against
the plain shader.  The Gun is looked up under the game's asset directory
($SRT_ASSETS, default ./Assets); without it a procedural bumpy plane
stands in.

    python -m softwarerenderer_tpu_torch.examples.normal_mapping [out_dir]
        [--device cpu]
"""

import os

import numpy as np
from PIL import Image

from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import (default_frame_uniforms,
                                               render_frame,
                                               scene_fragment_shader, to_rgb8)
from softwarerenderer_tpu_torch.examples import cli, demo_device
from softwarerenderer_tpu_torch.io_host import model_loader
from softwarerenderer_tpu_torch.models import primitives, scene as scene_mod
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import normalmap, texture as tex_ops
from softwarerenderer_tpu_torch.utils import mathlib as ml

GUN = os.path.join(os.environ.get("SRT_ASSETS", "Assets"), "Gun",
                   "scene.gltf")


def main(out_dir="/tmp/normal_mapping", device="cuda"):
    device = demo_device(device)
    os.makedirs(out_dir, exist_ok=True)
    if os.path.exists(GUN):
        model = model_loader.load_model(GUN)
        insts = model_loader.model_instances(
            model, (ml.scale(0.12)
                    @ ml.matrix_from_yaw_pitch_roll(-1.0, 0.15, 0.0)
                    @ ml.translation([0.0, -0.35, -1.1])
                    ).astype(np.float32))
    else:   # fallback: procedural bumpy plane
        nm = np.zeros((64, 64, 4), np.float32)
        yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
        ang = np.sin(xx / 4.0) * 0.5
        nm[..., 0] = np.sin(ang) * 0.5 + 0.5
        nm[..., 1] = 0.5
        nm[..., 2] = np.cos(ang) * 0.5 + 0.5
        nm[..., 3] = 1.0
        checker = np.asarray(tex_ops.checkerboard(32, 4)["data"])
        insts = [scene_mod.MeshInstance(
            primitives.plane(4.0), ml.translation([0, -1, -3]),
            texture=checker, normal_texture=nm)]
    sc = scene_to_torch(scene_mod.build_scene_buffers(insts), device)

    W, H = 480, 360
    u = default_frame_uniforms(W, H)
    ld = np.float32([0.8, -0.5, -0.6])
    u["light_direction"] = ld / np.linalg.norm(ld)
    u["fog_start"], u["fog_end"] = np.float32(900.0), np.float32(1000.0)
    params = RenderParams(width=W, height=H, cull_mode=0)

    images = []
    for tag, kw in [
            ("plain", dict(fragment_shader=scene_fragment_shader)),
            ("normal_mapped",
             dict(vertex_shader=normalmap.normal_mapped_vertex_shader,
                  fragment_shader=normalmap.normal_mapped_fragment_shader))]:
        c, _ = render_frame(sc, u, params=params, **kw)
        img = to_rgb8(c).cpu().numpy()
        Image.fromarray(img).save(os.path.join(out_dir, f"{tag}.png"))
        print("wrote", tag)
        images.append(img)
    return images


if __name__ == "__main__":
    cli(main, str)
