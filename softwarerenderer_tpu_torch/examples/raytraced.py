"""Ray-traced render mode (ops/raytrace.py): primary rays through the
raster's camera model, SOFT shadows from a disc light, and one-bounce
mirror reflections — a ground-truth/quality mode far beyond the
reference (its raycasts are gameplay-only, Physics.cs).  Renders the
same scene twice: rasterized and ray-traced, side by side.

The ray-traced frame casts through the bundle route (``cluster_cap=24``):
on the card the sweep kernel, two nearest casts (primary rays and the
reflection) and one any-hit cast (the eight shadow samples).  The JAX
demo casts every ray against every triangle (``cluster_cap=0``); both
routes give the same hits, so the same image.

    python -m softwarerenderer_tpu_torch.examples.raytraced [out.png]
        [--device cpu]
"""

import functools

import numpy as np
from PIL import Image

from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.examples import cli, demo_device
from softwarerenderer_tpu_torch.models import primitives, scene as scene_mod
from softwarerenderer_tpu_torch.ops import texture as tex_ops
from softwarerenderer_tpu_torch.ops.raytrace import render_frame_raytraced
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = np.float32
# The bundle route's cluster cap (the game's --raytrace default).
CLUSTER_CAP = 24


def main(out="/tmp/raytraced.png", device="cuda"):
    device = demo_device(device)

    checker = np.asarray(tex_ops.checkerboard(
        64, 8, (0.8, 0.78, 0.72, 1), (0.55, 0.53, 0.5, 1))["data"])
    insts = [scene_mod.MeshInstance(primitives.plane(30.0),
                                    ml.translation([0, -1.2, 0]),
                                    texture=checker)]
    for i in range(3):
        insts.append(scene_mod.MeshInstance(
            primitives.uv_sphere(0.55, rings=16, sectors=32),
            ml.translation([-1.8 + 1.8 * i, 0.2 + 0.5 * i, -4.5]),
            material=scene_mod.Material(
                base_color=(0.9, 0.5 + 0.2 * i, 0.4, 1.0))))
    insts.append(scene_mod.MeshInstance(
        primitives.cube(1.0),
        (ml.matrix_from_yaw_pitch_roll(0.7, 0.0, 0.0)
         @ ml.translation([0.0, 1.8, -5.5])).astype(F32)))
    sc = scene_mod.build_scene_buffers(insts)

    W, H = 480, 320
    params = RenderParams(width=W, height=H)
    eng_raster = Engine(sc, params, device=device)
    eng_rt = Engine(eng_raster.scene, params, device=device,
                    frame_fn=functools.partial(
                        render_frame_raytraced, shadow_samples=8,
                        reflections=True, cluster_cap=CLUSTER_CAP))
    u = dict(eng_raster.uniforms)
    u["rt_light_radius"] = np.float32(0.25)   # disc light → penumbrae
    u["rt_reflectivity"] = np.float32(0.3)    # mirror-bounce mix
    u["camera_position"] = np.float32([0.0, 0.8, 0.5])
    ld = np.float32([0.45, -1.0, -0.35])
    u["light_direction"] = ld / np.linalg.norm(ld)
    u["fog_start"], u["fog_end"] = np.float32(900.0), np.float32(1000.0)

    raster = eng_raster.present(u)
    rt = eng_rt.present(u)
    both = np.concatenate([raster, rt], axis=1)
    Image.fromarray(both).save(out)
    print(f"wrote {out}  (left: rasterized; right: ray-traced with "
          "soft shadows + reflections)")
    return both


if __name__ == "__main__":
    cli(main, str)
