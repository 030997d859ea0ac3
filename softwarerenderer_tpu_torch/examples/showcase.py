"""Kitchen-sink showcase: one scene exercising PBR + environment
reflections, sky panorama, particles, post-FX (bloom → tonemap → fxaa),
the device text overlay, and the picture-in-picture inset, every frame on
the device, recorded to an AVI orbit with utils/video.

    python -m softwarerenderer_tpu_torch.examples.showcase [out.avi]
        [frames] [--device cpu]

Every element here is beyond the reference (its frame is one camera,
one hardcoded light, no post-FX, no capture path — Renderer.cs:404-419).
"""

import math

import numpy as np

from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import Engine, render_frame_pip, to_rgb8
from softwarerenderer_tpu_torch.examples import cli, demo_device
from softwarerenderer_tpu_torch.examples.sky_environment import (
    sunset_panorama)
from softwarerenderer_tpu_torch.models import primitives, scene as scene_mod
from softwarerenderer_tpu_torch.models.convert import tree_to_torch
from softwarerenderer_tpu_torch.ops import sky as sky_mod
from softwarerenderer_tpu_torch.ops import text as text_ops
from softwarerenderer_tpu_torch.ops import texture as tex_ops
from softwarerenderer_tpu_torch.ops.lighting import (
    lit_scene_vertex_shader,
    pbr_scene_fragment_shader,
)
from softwarerenderer_tpu_torch.sim import particles as particles_mod
from softwarerenderer_tpu_torch.utils import font as font_mod
from softwarerenderer_tpu_torch.utils import mathlib as ml
from softwarerenderer_tpu_torch.utils.video import AviWriter

F32 = np.float32
N_PARTICLES = 192


def build_scene():
    floor = np.asarray(tex_ops.checkerboard(
        64, 8, (0.72, 0.7, 0.66, 1), (0.5, 0.48, 0.45, 1))["data"])
    insts = [scene_mod.MeshInstance(primitives.plane(40.0),
                                    ml.translation([0, -1.2, 0]),
                                    texture=floor)]
    # PBR sweep: rough clay → mirror metal (reflects the sky panorama).
    for i, (m, r) in enumerate([(0.0, 0.7), (0.5, 0.35), (1.0, 0.05)]):
        insts.append(scene_mod.MeshInstance(
            primitives.uv_sphere(0.7, rings=24, sectors=48),
            ml.translation([-2.0 + 2.0 * i, -0.3, -4.5]),
            material=scene_mod.Material(base_color=(0.9, 0.82, 0.7, 1.0),
                                        metallic=m, roughness=r)))
    # An emissive beacon feeding the bloom bright-pass.
    insts.append(scene_mod.MeshInstance(
        primitives.cube(0.7), ml.translation([0.0, 1.6, -6.5]),
        material=scene_mod.Material(base_color=(0, 0, 0, 1),
                                    emissive=(1.6, 0.5, 2.2))))
    # Particle fountain pool (billboards written on device each frame).
    insts.append(scene_mod.MeshInstance(
        particles_mod.particles_mesh(N_PARTICLES, extent=100.0),
        np.eye(4, dtype=F32),
        texture=particles_mod.soft_disc_texture(16),
        particles=N_PARTICLES))
    return scene_mod.build_scene_buffers(insts)


def orbit_frames(frames=48, device="cuda"):
    """The showcase's orbit of `frames` frames, each yielded as RGB8
    (numpy) as it is rendered: the camera's angle and the HUD's counter
    depend on `frames`, the fountain steps 1/24 s a frame."""
    device = demo_device(device)
    sc = build_scene()
    W, H = 640, 400
    font = font_mod.build_font(14)
    hud_fx = text_ops.text_overlay_fx(font)
    params = RenderParams(
        width=W, height=H, bloom=True, tonemap="aces", fxaa=True,
        post_fx=("sky", "bloom", "tonemap", "fxaa", hud_fx))
    eng = Engine(sc, params,
                 vertex_shader=lit_scene_vertex_shader,
                 fragment_shader=pbr_scene_fragment_shader,
                 frame_fn=render_frame_pip, device=device)

    u = eng.uniforms
    pano = sunset_panorama()
    u["sky_panorama"] = pano
    u["env_irradiance"] = sky_mod.irradiance_panorama(pano)
    ld = np.float32([0.4, -0.55, -1.0])
    u["light_direction"] = ld / np.linalg.norm(ld)
    u["fog_start"], u["fog_end"] = np.float32(900.0), np.float32(1000.0)
    u["exposure"] = np.float32(1.1)

    # Fountain emitter at the scene center.
    em = particles_mod.default_emitter_params()
    em.update(origin=np.float32([0.0, -1.1, -4.5]),
              base_velocity=np.float32([0.0, 3.2, 0.0]),
              rate=np.float32(120.0), spread=np.float32(0.5),
              lifetime=np.float32([1.2, 1.8]),
              size=np.float32([0.06, 0.02]),
              color0=np.float32([0.6, 0.8, 1.0, 1.0]),
              color1=np.float32([0.2, 0.4, 1.0, 0.0]))
    em = tree_to_torch(em, device)          # the tunables go over once
    pstate = particles_mod.initial_particle_state(N_PARTICLES, seed=3,
                                                  device=device)

    def pstep(st, dt):
        st2 = particles_mod.particle_step(st, em, dt)
        return st2, particles_mod.particle_uniforms(st2, em)

    for i in range(frames):
        a = 2 * math.pi * i / frames
        eye = np.float32([4.5 * math.sin(a), 0.6,
                          -4.5 + 4.5 * math.cos(a)])
        rot = ml.quat_from_yaw_pitch_roll(a, -0.12, 0.0)
        u["camera_position"] = eye
        u["camera_rotation"] = np.asarray(rot, F32)
        # PiP inset: the static beacon camera (a security monitor).
        u["pip_view"] = {
            "camera_position": np.float32([0.0, 1.0, 0.5]),
            "camera_rotation": np.asarray(
                ml.quat_from_yaw_pitch_roll(0.0, -0.15, 0.0), F32),
        }
        pstate, pu = pstep(pstate, np.float32(1 / 24))
        u.update(pu)
        u["hud_text"] = text_ops.pack_text(
            [("softwarerenderer_tpu showcase", (6, 6),
              (1.0, 1.0, 1.0, 0.9)),
             (f"frame {i + 1}/{frames}", (6, H - 20),
              (0.6, 1.0, 0.6))],
            max_strings=4, max_chars=32)
        color, _ = eng.render(u)
        yield to_rgb8(color).cpu().numpy()


def main(out="/tmp/showcase.avi", frames=48, device="cuda"):
    device = demo_device(device)
    with AviWriter(out, fps=24.0) as wr:
        for rgb in orbit_frames(frames, device):
            wr.add(rgb)
        n = wr.frames
    print(f"wrote {n} frames to {out}")
    return out


if __name__ == "__main__":
    cli(main, str, int)
