"""lodcrowd-4k: a 32 x 32 grid of UV spheres (radius 0.45, 14 rings, 20
sectors) with two decimated LOD levels, at 3840 x 2160 with the game's
shader.  Sizes in lodcrowd-4k.json beside this file.

Inputs from the seed: each sphere's placement jitter.  The benchmark
makes the sphere and its LOD index lists (portbench.gen) and hands them to
the program as the mesh's ``lod_indices`` / ``lod_px``; the program packs
them with ``models.scene.build_scene_buffers`` and draws them through
``engine.Engine``.  The plain reference (portbench.reference) draws the
same inputs.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from portbench import gen, harness
from portbench.reference import raster, shade

CONFIG = json.load(open(os.path.join(os.path.dirname(__file__),
                                     "lodcrowd-4k.json")))


def make_inputs(seed: int, over: Dict = None) -> Dict:
    c = dict(CONFIG, **(over or {}))
    s, lod = c["sphere"], c["lod"]
    mesh = gen.lod_sphere(s["radius"], s["rings"], s["sectors"],
                          lod["cells"], lod["px"])
    offsets = gen.crowd_offsets(seed, c["grid"], c["pitch_x"], c["pitch_z"],
                                c["z0"], c["jitter"], c["y_jitter"])
    return {"config": c, "mesh": mesh, "offsets": offsets,
            "size": (c["width"], c["height"])}


class Program:
    """The system under test: the inputs packed and drawn by the port."""

    def __init__(self, inputs: Dict, device):
        from softwarerenderer_tpu_torch.config import RenderParams
        from softwarerenderer_tpu_torch.engine import Engine, to_rgb8
        from softwarerenderer_tpu_torch.models.scene import (
            MeshInstance, build_scene_buffers)
        c = inputs["config"]
        scene = build_scene_buffers([
            MeshInstance(inputs["mesh"], gen.translation(p))
            for p in inputs["offsets"]])
        w, h = inputs["size"]
        params = RenderParams(**dict(c["render_params"], width=w, height=h))
        self.engine = Engine(scene, params, device=device)
        self.to_rgb8 = to_rgb8

    def render(self, cam: Dict) -> torch.Tensor:
        u = harness.frame_uniforms(self.engine.uniforms, cam)
        return self.engine.render(u)[0]


class Reference:
    """The plain reference of this configuration on `device` in `dt`."""

    def __init__(self, inputs: Dict, device, dt=torch.float32):
        self.inputs = inputs
        self.scene = raster.pack([{"mesh": inputs["mesh"],
                                   "matrix": gen.translation(p)}
                                  for p in inputs["offsets"]], device, dt)
        self.textures = shade.Textures([], device)
        u = dict(inputs["config"]["uniforms"])
        ld = np.asarray(u["light_direction"], np.float32)
        u["light_direction"] = ld / np.linalg.norm(ld)
        self.uniforms = u

    def frame(self, cam: Dict) -> torch.Tensor:
        """(H, W, 3) uint8 frame of a camera."""
        w, h = self.inputs["size"]
        r = raster.raster(self.scene, cam, w, h)
        frag, g = r["frag"], r["geom"]
        tex = shade.nearest(self.textures,
                            self.scene["tri_tex"][g["slot"][frag["row"]]
                                                  // 2], frag["uv"])
        u = dict(self.uniforms, fog_start=cam["fog_start"],
                 fog_end=cam["fog_end"])
        rgba = shade.game_shader(frag, tex, u)
        return shade.rgb8(shade.compose(frag, rgba, u["clear_color"], h, w))

    def counts(self, cam: Dict) -> Dict[str, int]:
        """The raster's work at K1's size (the frame's)."""
        w, h = self.inputs["size"]
        return raster.counts(self.scene, cam, w, h)

    def k1_size(self):
        return self.inputs["size"]
