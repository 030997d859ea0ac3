"""Mesh LOD: a field of spheres at increasing distance, each rendering
from the index set its projected size selects (ops/lod.py) — full detail
near, vertex-clustered decimations far, chosen per frame from the camera.

    python -m softwarerenderer_tpu_torch.examples.mesh_lod [out.png]
        [--device cpu]

Prints the active-triangle count per camera distance (the work the
binning stage actually sees).
"""

import numpy as np
from PIL import Image

from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.engine.renderer import device_uniforms
from softwarerenderer_tpu_torch.examples import cli, demo_device
from softwarerenderer_tpu_torch.models import primitives, scene
from softwarerenderer_tpu_torch.ops import lod, texture
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = np.float32
W, H = 640, 360


def main(out="/tmp/mesh_lod.png", device="cuda"):
    device = demo_device(device)
    checker = np.asarray(texture.checkerboard(32, 4)["data"])
    base = primitives.uv_sphere(0.8, rings=16, sectors=24)
    mesh = lod.add_lods(base, cells=(8, 4), px=(60.0, 20.0))
    t_full = base["indices"].shape[0]
    print(f"sphere LODs: {t_full} / "
          f"{mesh['lod_indices'][0].shape[0]} / "
          f"{mesh['lod_indices'][1].shape[0]} tris "
          f"(switch below 60 px / 20 px projected radius)")

    rng = np.random.default_rng(4)
    insts = [scene.MeshInstance(primitives.plane(120.0),
                                ml.translation([0.0, -1.0, 0.0]),
                                texture=checker)]
    for i in range(24):
        x = rng.uniform(-14, 14)
        z = -3.0 - 2.2 * i
        insts.append(scene.MeshInstance(
            mesh, ml.translation([x, 0.0, z]), texture=checker))
    sc = scene.build_scene_buffers(insts)

    # Active-slot compaction: without it the binning stage would pay for
    # every packed LOD level; the static bound keeps the frame exact.
    cap = lod.suggested_active_cap(sc)
    eng = Engine(sc, RenderParams(width=W, height=H, active_cap=cap),
                 device=device)
    u = dict(eng.uniforms)
    u["camera_position"] = np.float32([0.0, 1.0, 2.0])

    mask = lod.lod_tri_mask(eng.scene, device_uniforms(u, W, H, device),
                            H).cpu().numpy()
    lvl = np.asarray(sc["tri_lod_level"])
    print(f"active triangles: {int(mask.sum())} of "
          f"{int((lvl == 0).sum())} at full detail "
          f"(levels in use: {sorted(np.unique(lvl[mask]).tolist())}); "
          f"compacting {2 * lvl.shape[0]} packed slots to cap {cap}")

    rgb = eng.present(u)
    Image.fromarray(rgb).save(out)
    print("wrote", out)
    return rgb


if __name__ == "__main__":
    cli(main, str)
