"""Example: a custom fragment shader + a custom post-FX stage (the
programmable-pipeline features).

Shaders are plain functions over tensors.  This one renders UV-space
stripes modulated by the world normal, then applies a USER post-FX stage
(a vignette) slotted into params.post_fx, run on the frame's device after
the named stages.

    python -m softwarerenderer_tpu_torch.examples.custom_shader
        [--device cpu]
"""

import numpy as np
import torch
from PIL import Image

from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.examples import cli, demo_device
from softwarerenderer_tpu_torch.models import primitives, scene
from softwarerenderer_tpu_torch.utils import mathlib as ml

# Where main writes its frame (the JAX demo's path).
OUT = "/tmp/custom_shader.png"


def stripes_shader(frag, uniforms):
    """10 UV stripes, lit by the world normal's upness."""
    stripe = torch.sin(frag["uv"][..., 0:1] * 31.4) * 0.5 + 0.5
    up = torch.clamp(frag["data"]["world_normal"][..., 1:2], min=0.2)
    rgb = torch.cat([stripe * up, 0.3 + 0.5 * up, 1.0 - stripe * up], -1)
    return torch.cat([rgb, torch.ones_like(stripe)], -1)


# declare the varyings it reads so the raster payload stays minimal
stripes_shader.varyings = ("uv", "data.world_normal")


def vignette(color, depth, uniforms):
    """User post-FX stage: darken toward the frame corners.  Reads the
    device uniforms (strength is tunable per frame)."""
    h, w = color.shape[:2]
    ys = torch.linspace(-1.0, 1.0, h, device=color.device)[:, None]
    xs = torch.linspace(-1.0, 1.0, w, device=color.device)[None, :]
    fade = 1.0 - uniforms.get("vignette_strength", 0.7) * \
        torch.clamp(ys * ys + xs * xs, 0.0, 1.0)
    return color * fade[..., None], depth


def main(device="cuda"):
    device = demo_device(device)

    sc = scene.build_scene_buffers([
        scene.MeshInstance(primitives.uv_sphere(1.0, rings=24, sectors=48),
                           ml.translation([0.0, 0.0, -3.0])),
        scene.MeshInstance(primitives.plane(10.0),
                           ml.translation([0.0, -1.2, 0.0])),
    ])
    eng = Engine(sc, RenderParams(
        width=640, height=480,
        post_fx=("sky", "ssao", "bloom", "tonemap", "fxaa", vignette)),
        fragment_shader=stripes_shader, device=device)
    eng.uniforms["vignette_strength"] = np.float32(0.7)
    rgb = eng.present()
    Image.fromarray(rgb).save(OUT)
    print(f"wrote {OUT}")
    return rgb


if __name__ == "__main__":
    cli(main)
