"""lodcrowd-iq-1080p: lodcrowd-4k's 1,024 LOD spheres, each textured, drawn
as the image-quality frame: 1920 x 1080 with ssaa 2 (the raster at 3840 x
2160), trilinear mips and the trilinear shader, the sky, SSAO, bloom, the
ACES tone map and FXAA.  Sizes in lodcrowd-iq-1080p.json beside this file.

Inputs from the seed: each sphere's placement jitter (portbench.gen, as
lodcrowd-4k), the textures (seeded value noise, ``noise_texture``) and the
sky panorama (``sky_panorama``), both generated here (on the card when
there is one) and frozen with the configuration.  Sphere i takes texture i mod count.  The program packs the
textures and their mip chains with ``models.scene.build_scene_buffers``
and draws through ``engine.Engine`` with the panorama in the frame's
uniforms; the plain reference (portbench.reference) draws the same
inputs.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence

import numpy as np
import torch

from portbench import gen, harness
from portbench.reference import post, raster, shade, texture

CONFIG = json.load(open(os.path.join(os.path.dirname(__file__),
                                     "lodcrowd-iq-1080p.json")))


def _device() -> str:
    """Where the generators run: the card when there is one (eleven
    2048² textures of five octaves take seconds on the host), else the
    host.  The two may round a texel apart; the program and the reference
    of a run read the same bytes."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _lattice_image(rng: np.random.Generator, height: int, width: int,
                   lattice: int, channels: int, device) -> torch.Tensor:
    """(height, width, channels) float32 on `device`: a lattice of uniform
    values, `lattice` cells along the longer side, smoothstep-interpolated
    with wrap (so the image tiles), along rows and then along columns."""
    ny = max(1, round(lattice * height / max(height, width)))
    nx = max(1, round(lattice * width / max(height, width)))
    lat = torch.from_numpy(rng.random((ny, nx, channels), dtype=np.float32)
                           ).to(device)

    def axis(size, n):
        x = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) \
            * (n / size) - 0.5
        i0 = torch.floor(x)
        t = x - i0
        t = t * t * (3.0 - 2.0 * t)
        i0 = torch.remainder(i0.long(), n)
        return i0, torch.remainder(i0 + 1, n), t
    y0, y1, ty = axis(height, ny)
    x0, x1, tx = axis(width, nx)
    rows = lat[:, x0] * (1.0 - tx)[None, :, None] \
        + lat[:, x1] * tx[None, :, None]
    return rows[y0] * (1.0 - ty)[:, None, None] \
        + rows[y1] * ty[:, None, None]


def noise_texture(rng: np.random.Generator, size: int,
                  lattice: Sequence[int], device="cpu") -> np.ndarray:
    """(size, size, 4) uint8 opaque texture: value noise of the given
    octaves (amplitude halving from the coarsest) over a seeded hue, so
    that every mip level holds detail of its own; computed on `device`."""
    hue = torch.from_numpy(rng.uniform(0.35, 1.0, 3).astype(np.float32)
                           ).to(device)
    noise = torch.zeros(size, size, 3, device=device)
    amp, total = 1.0, 0.0
    for n in lattice:
        noise += amp * _lattice_image(rng, size, size, n, 3, device)
        total += amp
        amp *= 0.5
    rgb = hue * (0.25 + 0.75 * noise / total)
    rgba = torch.cat([rgb, torch.ones(size, size, 1, device=device)], -1)
    return torch.round(rgba.clamp(0, 1) * 255.0).to(torch.uint8).cpu() \
        .numpy()


def sky_panorama(rng: np.random.Generator, height: int, width: int,
                 lattice: Sequence[int], device="cpu") -> np.ndarray:
    """(height, width, 4) uint8 equirect sky: a blue gradient to the
    zenith over a darker ground, with seeded value-noise clouds above the
    horizon; computed on `device`."""
    v = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) \
        / height
    top = torch.stack([0.35 + 0.4 * v, 0.55 + 0.3 * v, 0.95 - 0.1 * v], -1)
    ground = torch.tensor([0.3, 0.27, 0.22], device=device)
    rows = torch.where((v < 0.5)[:, None], top, ground)
    clouds = sum(_lattice_image(rng, height, width, n, 1, device)[..., 0]
                 * (0.5 ** i) for i, n in enumerate(lattice))
    clouds = clouds / sum(0.5 ** i for i in range(len(lattice)))
    clouds = torch.where((v < 0.5)[:, None], (clouds - 0.45).clamp(0, 1),
                         torch.zeros((), device=device))
    rgb = (rows[:, None, :] + clouds[..., None]).clamp(0, 1)
    rgba = torch.cat([rgb, torch.ones(height, width, 1, device=device)], -1)
    return torch.round(rgba * 255.0).to(torch.uint8).cpu().numpy()


def make_inputs(seed: int, over: Dict = None) -> Dict:
    c = dict(CONFIG, **(over or {}))
    s, lod, tx, sk = c["sphere"], c["lod"], c["textures"], c["sky"]
    mesh = gen.lod_sphere(s["radius"], s["rings"], s["sectors"],
                          lod["cells"], lod["px"])
    offsets = gen.crowd_offsets(seed, c["grid"], c["pitch_x"], c["pitch_z"],
                                c["z0"], c["jitter"], c["y_jitter"])
    dev = _device()
    rng = gen.rng_of(seed, 2)
    textures = [noise_texture(rng, tx["size"], tx["lattice"], dev)
                for _ in range(tx["count"])]
    sky = sky_panorama(gen.rng_of(seed, 3), sk["height"], sk["width"],
                       sk["lattice"], dev)
    return {"config": c, "mesh": mesh, "offsets": offsets,
            "textures": textures, "sky": sky,
            "size": (c["width"], c["height"]),
            "ssaa": int(c["render_params"].get("ssaa", 1))}


class Program:
    """The system under test: the inputs packed and drawn by the port."""

    def __init__(self, inputs: Dict, device):
        from softwarerenderer_tpu_torch.config import RenderParams
        from softwarerenderer_tpu_torch.engine import (
            Engine, scene_fragment_shader_trilinear, to_rgb8)
        from softwarerenderer_tpu_torch.models.scene import (
            MeshInstance, build_scene_buffers)
        c = inputs["config"]
        # The float32 images build_scene_buffers takes, x / 255 as numpy
        # divides, on all of the host's cores.
        images = [torch.from_numpy(t).to(torch.float32).div_(255.0).numpy()
                  for t in inputs["textures"]]
        scene = build_scene_buffers([
            MeshInstance(inputs["mesh"], gen.translation(p),
                         texture=images[i % len(images)])
            for i, p in enumerate(inputs["offsets"])])
        w, h = inputs["size"]
        params = RenderParams(**dict(c["render_params"], width=w, height=h))
        self.engine = Engine(scene, params, device=device,
                             fragment_shader=scene_fragment_shader_trilinear)
        self.sky = inputs["sky"]
        self.to_rgb8 = to_rgb8

    def render(self, cam: Dict) -> torch.Tensor:
        u = harness.frame_uniforms(self.engine.uniforms, cam)
        u["sky_panorama"] = self.sky
        return self.engine.render(u)[0]


class Reference:
    """The plain reference of this configuration on `device` in `dt`."""

    # Covered pixels shaded at once.
    PIXEL_BLOCK = 1 << 21

    def __init__(self, inputs: Dict, device, dt=torch.float32):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.inputs = inputs
        n = len(inputs["textures"])
        self.scene = raster.pack([{"mesh": inputs["mesh"],
                                   "matrix": gen.translation(p),
                                   "texture_id": i % n}
                                  for i, p in enumerate(inputs["offsets"])],
                                 device, dt)
        self.mips = texture.Mips([texture.mip_chain(t, device)
                                  for t in inputs["textures"]], device)
        self.sky = torch.from_numpy(inputs["sky"]).to(device)
        u = dict(inputs["config"]["uniforms"])
        ld = np.asarray(u["light_direction"], np.float32)
        u["light_direction"] = ld / np.linalg.norm(ld)
        self.uniforms = u

    def k1_size(self):
        w, h = self.inputs["size"]
        f = self.inputs["ssaa"]
        return w * f, h * f

    def shaded(self, cam: Dict):
        """The supersampled frame before its post chain: (H, W, 4) colour,
        (H, W) depth and the covered pixels."""
        w, h = self.k1_size()
        sc = self.scene
        r = raster.raster(sc, cam, w, h)
        frag, g = r["frag"], r["geom"]
        lod = texture.slot_lod(sc["uv"], sc["indices"], g["slot"],
                               g["inv_area"],
                               self.mips.base_texels(
                                   sc["tri_tex"][g["slot"] // 2]))
        u = dict(self.uniforms, fog_start=cam["fog_start"],
                 fog_end=cam["fog_end"])
        rgba = []
        for lo in range(0, max(frag["row"].numel(), 1), self.PIXEL_BLOCK):
            part = {k: v[lo:lo + self.PIXEL_BLOCK] for k, v in frag.items()}
            row = part["row"]
            tex = texture.trilinear(self.mips,
                                    sc["tri_tex"][g["slot"][row] // 2],
                                    lod[row], part["uv"])
            rgba.append(shade.game_shader(part, tex, u))
        color = shade.compose(frag, torch.cat(rgba), u["clear_color"], h, w)
        depth, covered = post.winner_depth(g, r["win"])
        return color, depth, covered

    def frame(self, cam: Dict) -> torch.Tensor:
        """(H, W, 3) uint8 frame of a camera: the supersampled frame, its
        post chain in RenderParams' order (sky, SSAO, bloom, tone map,
        FXAA), the box resolve and the RGB8 bytes."""
        color, depth, covered = self.shaded(cam)
        color = post.sky(color, covered, cam, self.sky)
        color = post.ssao(color, depth, covered, cam["near_clip"],
                          cam["far_clip"])
        color = post.fxaa(post.aces(post.bloom(color)))
        return shade.rgb8(post.resolve(color, self.inputs["ssaa"]))

    def counts(self, cam: Dict) -> Dict[str, int]:
        """The raster's work at K1's size (the supersampled frame's)."""
        w, h = self.k1_size()
        return raster.counts(self.scene, cam, w, h)
