"""Render-to-texture example: a security monitor.

A spinning cube sits around the corner; a CCTV pass renders it into a
texture-atlas slot every frame, and the main view shows that feed on a
monitor quad, both passes on the device (engine/rtt.py; the reference
has no offscreen render targets, Texture.cs:70-94).

    python -m softwarerenderer_tpu_torch.examples.render_to_texture
        [out_dir] [--device cpu]
"""

import os

import numpy as np
from PIL import Image

from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import (Engine, RttPass, atlas_id_of,
                                               rtt_slot, to_rgb8)
from softwarerenderer_tpu_torch.examples import cli, demo_device
from softwarerenderer_tpu_torch.models import primitives, scene as scene_mod
from softwarerenderer_tpu_torch.ops import texture as tex_ops
from softwarerenderer_tpu_torch.utils import mathlib as ml


def main(out_dir="/tmp/render_to_texture", device="cuda"):
    device = demo_device(device)
    os.makedirs(out_dir, exist_ok=True)

    # the monitor: a quad facing the main camera, textured by the slot
    monitor = {
        "position": np.asarray([[-1.2, -0.9, 0], [1.2, -0.9, 0],
                                [1.2, 0.9, 0], [-1.2, 0.9, 0]], np.float32),
        "uv": np.asarray([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32),
        "normal": np.tile(np.float32([0, 0, 1]), (4, 1)),
        "color": np.ones((4, 4), np.float32),
        "indices": np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
    }
    feed = rtt_slot(144, 192)            # 4:3 CCTV feed
    checker = np.asarray(tex_ops.checkerboard(32, 4)["data"])
    # flip-book spin: the cube rotates via per-frame vertex stacks
    n_frames = 24
    cube = primitives.cube(1.0)
    spins = np.stack([
        cube["position"] @ ml.matrix_from_yaw_pitch_roll(
            2 * np.pi * f / n_frames, 0.6, 0.0)[:3, :3].astype(np.float32)
        for f in range(n_frames)])
    instances = [
        scene_mod.MeshInstance(monitor, ml.translation([0.0, 0.2, -3.0]),
                               texture=feed),
        scene_mod.MeshInstance(primitives.plane(30.0),
                               ml.translation([0.0, -1.0, 0.0]),
                               texture=checker),
        scene_mod.MeshInstance(cube, ml.translation([60.0, 0.0, -60.0]),
                               animation_positions=spins),
    ]
    sc = scene_mod.build_scene_buffers(instances)
    tid = atlas_id_of(instances, feed)

    W, H = 480, 360
    params = RenderParams(width=W, height=H, cull_mode=0)
    cctv = RttPass(tex_id=tid, uniforms_key="cctv",
                   params=RenderParams(width=192, height=144, cull_mode=0))
    eng = Engine(sc, params, rtt_passes=(cctv,), device=device)

    # the CCTV camera watches the far cube; hide the monitor from its feed
    cu = eng.uniforms["cctv"]
    cu["camera_position"] = np.float32([60.0, 0.5, -56.5])
    cu["clear_color"] = np.float32([0.05, 0.08, 0.05, 1.0])
    cu["mesh_visible"] = np.asarray([False, True, True])
    cu["anim_frame"] = np.int32(0)       # one flip-book slot in the scene
    eng.uniforms["anim_frame"] = np.int32(0)

    images = []
    for f in [0, 6, 12]:
        cu["anim_frame"] = np.int32(f)
        eng.uniforms["anim_frame"] = np.int32(f)
        c, _ = eng.render()
        img = to_rgb8(c).cpu().numpy()
        Image.fromarray(img).save(os.path.join(out_dir, f"frame_{f:02d}.png"))
        print("wrote", f"frame_{f:02d}.png")
        images.append(img)
    return images


if __name__ == "__main__":
    cli(main, str)
