"""Model viewer on the port: open any supported asset and orbit around it,
the JAX package's ``apps/viewer.py`` in PyTorch on a CUDA card.

    python -m softwarerenderer_tpu_torch.apps.viewer <model> [options]

Formats: glTF/GLB, OBJ, STL, PLY, COLLADA (.dae), binary FBX and 3DS
(``io_host.model_loader``, first-party).  A directory of model files plays
as a flip-book.

Controls (windowed): drag = orbit, W/S or -/= = zoom, F = cycle the debug
views (none, wireframe, overdraw, depth), G = toggle the ray-traced mode,
F3 = debug panel, F12 = screenshot, F10 = export the loaded model as GLB
(format converter), Esc = quit.  --headless renders --frames frames and
writes PNGs.

Each frame is ``Engine.present``: the frame through the tile kernel K1
(``csrc/tile_raster.cu``) on the default route, or with G through
``ops.raytrace.render_frame_raytraced``, whose casts sweep ray bundles
with K4 (``csrc/rt_sweep.cu``: one nearest cast and one any-hit shadow
cast a frame).  The camera is a frame uniform, so orbiting uploads a few
values and rebuilds nothing.  ``--device`` (default ``cuda``) picks the
torch device; the viewer raises without a card, it never renders on the
CPU instead.
"""

from __future__ import annotations

import argparse
import functools
import math
import time
from typing import Optional

import numpy as np
import torch

from softwarerenderer_tpu_torch import DebugMode, RenderParams
from softwarerenderer_tpu_torch.engine import Engine, default_frame_uniforms
from softwarerenderer_tpu_torch.io_host import model_loader
from softwarerenderer_tpu_torch.io_host.ui import Hud
from softwarerenderer_tpu_torch.io_host.window import make_window
from softwarerenderer_tpu_torch.models import scene as scene_mod
from softwarerenderer_tpu_torch.utils import hostmath
from softwarerenderer_tpu_torch.utils.profiling import FrameStats

F32 = np.float32


class Viewer:
    def __init__(self, path: str, width: int = 960, height: int = 720,
                 render_scale: float = 0.5, headless: bool = False,
                 out: Optional[str] = None, lod: bool = False,
                 fallback_checker: bool = True,
                 record: Optional[str] = None, record_fps: float = 30.0,
                 rt_cap=0, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Viewer(device='cuda') needs a CUDA device "
                               "and none is available")
        model = model_loader.load_model(path)
        fallback = None
        if fallback_checker:
            from softwarerenderer_tpu_torch.ops import texture as tex_ops
            fallback = np.asarray(tex_ops.checkerboard(
                32, 4, (0.85, 0.85, 0.85, 1.0), (0.6, 0.6, 0.65, 1.0))
                ["data"])
        insts = model_loader.model_instances(model,
                                             fallback_texture=fallback)
        if lod:
            from softwarerenderer_tpu_torch.ops import lod as lod_mod
            for inst in insts:
                if inst.mesh["indices"].shape[0] >= 64:
                    inst.mesh = lod_mod.add_lods(inst.mesh)
        self.model = model
        self.scene = scene_mod.build_scene_buffers(insts)
        self.n_tris = int(self.scene["indices"].shape[0])

        # Auto-frame: orbit distance from the packed scene's world bounds.
        centers = np.asarray(self.scene["bounds_center"], F32)
        radii = np.asarray(self.scene["bounds_radius"], F32)
        self.center = centers.mean(axis=0)
        self.radius = float(max(1e-3, (np.linalg.norm(
            centers - self.center, axis=-1) + radii).max()))
        self.distance = self.radius * 2.2
        self.yaw = 0.6
        self.pitch = -0.3

        self.window = make_window(width, height, render_scale,
                                  headless=headless or None, out_path=out)
        self._recorder = None
        if record:
            from softwarerenderer_tpu_torch.utils.video import AviWriter
            self._recorder = AviWriter(record, fps=record_fps)
        self.hud = Hud()
        self.stats = FrameStats()
        rw, rh = self.window.render_size
        self.params = RenderParams(width=rw, height=rh)
        # Engines per (debug mode, raytraced) pair, created on first use
        # ('f' cycles NONE -> WIREFRAME -> OVERDRAW -> DEPTH, 'g' toggles
        # the ray-traced mode); every one shares this engine's scene
        # tensors on the device, so a new mode uploads nothing.
        self.engines = {(DebugMode.NONE, False):
                        Engine(self.scene, self.params, device=self.device)}
        self.mode = DebugMode.NONE
        self.raytrace = False
        self.rt_cap = rt_cap
        self.uniforms = default_frame_uniforms(rw, rh)
        self.anim_frame = 0
        self._prev_keys: set = set()
        self._shot_n = 0
        # F12 can fire before the first frame.
        self._last_rgb: Optional[np.ndarray] = None

    # -- per-frame --------------------------------------------------------

    def _camera(self):
        cp = math.cos(self.pitch)
        eye = self.center + self.distance * np.float32(
            [cp * math.sin(self.yaw), -math.sin(self.pitch),
             cp * math.cos(self.yaw)])
        # look-at quaternion from yaw/pitch: the camera front
        # quat_rotate([0,0,-1], R(yaw, pitch)) points from this eye
        # offset back at the orbit center
        rot = hostmath.quat_from_yaw_pitch_roll(
            np.float32(self.yaw), np.float32(self.pitch), np.float32(0.0))
        return eye.astype(F32), np.asarray(rot, F32)

    def frame_uniforms(self) -> dict:
        """This frame's uniforms: the orbit camera, the far clip, the
        flip-book frame and the animation clock."""
        u = dict(self.uniforms)
        pos, rot = self._camera()
        u["camera_position"] = pos
        u["camera_rotation"] = rot
        u["far_clip"] = np.float32(max(1000.0, self.distance * 10.0))
        u["anim_frame"] = np.int32(self.anim_frame)
        u["anim_time"] = np.float32(time.monotonic() % 3600.0)
        return u

    def step(self, dt: float, inputs: Optional[dict] = None) -> None:
        inp = inputs if inputs is not None else self.window.poll()
        if inp.get("quit") or "escape" in inp["keys"]:
            self.window.should_close = True
        keys = inp["keys"]
        dx, dy = inp["mouse_delta"]
        if inp.get("mouse_down"):
            self.window.set_mouse_capture(not self.window.mouse_captured)
        if self.window.mouse_captured:
            self.yaw += dx * 0.008
            self.pitch = max(-1.4, min(1.4, self.pitch + dy * 0.008))
        zoom = ("w" in keys or "=" in keys) - ("s" in keys or "-" in keys)
        if zoom:
            self.distance = max(self.radius * 0.3,
                                self.distance * (1.0 - 0.9 * dt * zoom))
        if "f" in keys and "f" not in self._prev_keys:
            order = list(DebugMode)
            self.mode = order[(order.index(self.mode) + 1) % len(order)]
        if "g" in keys and "g" not in self._prev_keys:
            # the ray-traced mode (hard shadows) of the NONE debug mode
            self.raytrace = not self.raytrace
        if "f3" in keys and "f3" not in self._prev_keys:
            self.hud.state.show_debug = not self.hud.state.show_debug
        if "f12" in keys and "f12" not in self._prev_keys:
            self.screenshot()
        if "f10" in keys and "f10" not in self._prev_keys:
            self.export_glb()
        self._prev_keys = set(keys)

        # flip-book directories advance on the model's fixed-FPS clock
        if self.model.animation_frames:
            self.anim_frame = self.model.advance_animation(dt)

        u = self.frame_uniforms()
        eng = self._engine_for(self.mode)
        rgb = eng.present(u)
        self._last_rgb = rgb
        if self._recorder is not None:
            self._recorder.add(rgb)
        self.stats.frame(pixels=rgb.shape[0] * rgb.shape[1],
                         triangles=self.n_tris)
        self.hud.tick(dt)
        s = self.hud.state
        s.rendered_meshes = len(self.model.meshes)
        if s.show_debug:
            c = self.stats.counters()
            s.debug_lines = [
                f"tris {self.n_tris}",
                f"dist {self.distance:.2f}  yaw {self.yaw:.2f} "
                f"pitch {self.pitch:.2f}",
                f"mode {self.mode.name if hasattr(self.mode, 'name') else self.mode}",
                f"mean {c.get('frame_ms_mean', 0):.2f} ms",
            ]
        self.window.present(rgb, overlay=self.hud)

    def _engine_for(self, mode):
        key = (mode, self.raytrace and mode == DebugMode.NONE)
        if key not in self.engines:
            kw = {}
            if key[1]:
                from softwarerenderer_tpu_torch.ops.raytrace import (
                    render_frame_raytraced,
                )
                # --rt-cap > 0 takes the bundle route (K4's sweep over
                # Morton clusters), exact for any cap.
                kw["frame_fn"] = functools.partial(
                    render_frame_raytraced, cluster_cap=self.rt_cap)
            first = self.engines[(DebugMode.NONE, False)]
            self.engines[key] = Engine(
                first.scene, self.params.replace(debug_mode=mode),
                device=self.device, **kw)
        return self.engines[key]

    def screenshot(self) -> Optional[str]:
        if self._last_rgb is None:       # nothing rendered yet
            return None
        try:
            from PIL import Image
        except ImportError:
            return None
        path = f"viewer_shot_{self._shot_n:03d}.png"
        self._shot_n += 1
        Image.fromarray(self._last_rgb).save(path)
        self.hud.add_chat(f"* saved {path}")
        return path

    def export_glb(self) -> Optional[str]:
        """Re-export whatever is loaded (any supported format) as GLB —
        the viewer doubles as a format converter (F10)."""
        path = f"viewer_export_{self._shot_n:03d}.glb"
        self._shot_n += 1
        model_loader.save_model(path, self.model, embed_textures=True)
        self.hud.add_chat(f"* exported {path}")
        return path

    def run(self, frames: Optional[int] = None) -> None:
        last = time.monotonic()
        n = 0
        try:
            while not self.window.should_close:
                now = time.monotonic()
                dt, last = now - last, now
                self.step(min(dt, 0.1))
                n += 1
                if frames is not None and n >= frames:
                    break
        finally:
            if self._recorder is not None:
                self._recorder.close()
                self._recorder = None
            self.window.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("model", help="model file (or flip-book directory)")
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--render-scale", type=float, default=0.5)
    ap.add_argument("--headless", action="store_true")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default=None,
                    help="headless PNG path (frame index appended)")
    ap.add_argument("--record", default=None, metavar="PATH.avi",
                    help="record presented frames to an uncompressed AVI "
                         "(utils/video.py)")
    ap.add_argument("--record-fps", type=float, default=30.0)
    ap.add_argument("--lod", action="store_true",
                    help="attach vertex-clustering LOD levels to meshes "
                         "with >=64 triangles")
    ap.add_argument("--rt-cap", type=int, nargs="+", default=[24],
                    metavar="N",
                    help="ray-traced mode ('g'): a cap > 0 takes the "
                         "bundle route, K4's sweep over Morton clusters "
                         "(exact for any cap); 0 = brute force, every "
                         "ray against every triangle")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the viewer (default cuda; cpu "
                         "renders the kernels' plain twins)")
    args = ap.parse_args(argv)
    rt_cap = tuple(args.rt_cap)
    if rt_cap == (0,):
        rt_cap = 0
    v = Viewer(args.model, width=args.width, height=args.height,
               render_scale=args.render_scale, headless=args.headless,
               out=args.out, lod=args.lod, record=args.record,
               record_fps=args.record_fps, rt_cap=rt_cap,
               device=args.device)
    v.run(args.frames if args.frames else (3 if args.headless else None))


if __name__ == "__main__":
    main()
