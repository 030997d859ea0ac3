"""Particle fountain: emission, ballistics, floor bounce and
camera-facing billboards — the whole loop (sim step, billboard write,
rasterize) runs on the device each frame (sim/particles.py).

    python -m softwarerenderer_tpu_torch.examples.particle_fountain
        [out.png] [--device cpu]
"""

import numpy as np
from PIL import Image

from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import Engine, to_rgb8
from softwarerenderer_tpu_torch.examples import cli, demo_device
from softwarerenderer_tpu_torch.models import primitives, scene
from softwarerenderer_tpu_torch.models.convert import tree_to_torch
from softwarerenderer_tpu_torch.ops import texture
from softwarerenderer_tpu_torch.sim import particles as P
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = np.float32


def main(out="/tmp/particle_fountain.png", device="cuda"):
    device = demo_device(device)
    n = 512
    checker = np.asarray(texture.checkerboard(64, 8)["data"])
    insts = [
        scene.MeshInstance(primitives.plane(20.0),
                           ml.translation([0.0, -1.0, 0.0]),
                           texture=checker),
        scene.MeshInstance(P.particles_mesh(n, extent=30.0), particles=n,
                           texture=P.soft_disc_texture()),
    ]
    sc = scene.build_scene_buffers(insts)
    eng = Engine(sc, RenderParams(width=640, height=360), device=device)

    em = P.default_emitter_params()
    em["origin"] = np.float32([0.0, -0.9, -5.0])
    em["base_velocity"] = np.float32([0.0, 5.5, 0.0])
    em["spread"] = np.float32(0.9)
    em["rate"] = np.float32(240.0)
    em["floor_y"] = np.float32(-0.95)
    em["size"] = np.float32([0.16, 0.05])
    em = tree_to_torch(em, device)          # the tunables go over once

    u0 = dict(eng.uniforms)
    u0["camera_position"] = np.float32([0.0, 0.6, 1.0])

    def frame(state):
        state = P.particle_step(state, em, 1.0 / 60.0)
        u = dict(u0)
        u.update(P.particle_uniforms(state, em))
        color, _ = eng.render(u)
        return state, color

    state = P.initial_particle_state(n, seed=11, device=device)
    for _ in range(120):          # 2 s: the fountain reaches steady state
        state, color = frame(state)

    rgb = to_rgb8(color).cpu().numpy()
    Image.fromarray(rgb).save(out)
    alive = int((state["lifetime"] > 0).sum())
    print(f"wrote {out} ({alive}/{n} particles alive)")
    return rgb


if __name__ == "__main__":
    cli(main, str)
