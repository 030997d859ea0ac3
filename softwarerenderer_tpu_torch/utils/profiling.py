"""Where the time of one frame goes, on a CUDA card.

    python -m softwarerenderer_tpu_torch.utils.profiling [--frames N]
        [--width W] [--height H] [--kbuffer K | --raytrace CAP | --deferred
        | --config 3|5 | --shadows directional|point|spot
        | --image-quality | --animated | --crowd uncapped|suggested|ladder
        | --sim | --game] [--out DIR]

Renders the bench scene (``scenes.bench_scene()``) through ``Engine(scene,
RenderParams(W, H), device="cuda")`` with ``scenes.camera_uniforms(u, i)``;
with --kbuffer K the K-buffer frame of ``scenes.translucent_scene()`` (the
bench soup with six glass panes) through ``RenderParams(W, H, kbuffer=K,
cull_mode=0)``; with --raytrace CAP the ray-traced frame with hard shadows,
``Engine(..., frame_fn=functools.partial(render_frame_raytraced,
cluster_cap=CAP))``; with --deferred the deferred route's frame,
``RenderParams(W, H, use_pallas=False)`` (K5, then the full-frame
interpolation and shading); with --config 3 or 5 golden config 3 (41
meshes under four lights, the lit shaders) or 5 (1,100 cubes) from
``scenes.golden_config``; with --shadows the directional, point or spot
shadowed frame of ``scenes.shadow_golden_frame`` at the frame functions'
map sizes (512, 6 x 256, 512), whose light passes show as
``shadow.geometry`` and ``shadow.fold`` (K5); with --image-quality the
bench frame with ``ssaa=2`` (K1 folds twice the size in each axis),
trilinear mips and the trilinear shader, SSAO, bloom, ACES and FXAA under
``scenes.sky_panorama()``, whose post stages show as ``post.sky``,
``post.ssao``, ``post.bloom``, ``post.tonemap`` and ``post.fxaa`` and the
box filter as ``frame.ssaa_resolve``; with --animated the animated frame
of ``scenes.animated_scene()`` (skinned, flip-book, morphing, particle and
LOD meshes over a normal-mapped floor) with the normal-mapped shaders at
``scenes.animated_uniforms(u, i)``, whose updates show as
``frame.vertex_updates``; with --crowd ``scripts/profile_lod.py``'s 4K
crowd of LOD spheres (``scenes.lod_crowd_scene()``) at its camera,
uncapped, at ``lod.suggested_active_cap`` or at the script's ladder of
caps measured on frame 0 (``scenes.lod_cap_ladder``), whose compactions
show as ``frame.geom_cap`` and ``frame.active_cap``.  Without --width and
--height a frame is 1920x1080, config 5's and the crowd's 3840x2160.  With --sim
it profiles the simulation instead, three programs (``sim_programs``):
bench.py config 4's coupled step at 1280x720, a crowd step of
``CROWD_AGENTS`` (32) agents on the bench scene with routing and combat,
and a step of the 1,024-slot fountain emitter, whose spans are
``sim.character``, ``sim.agents``, ``sim.raycast`` (each raycast wave)
and ``sim.particles``.  It prints:

  * the scene's statistics at frame 0: for a raster frame its binning
    (valid clip-fan slots, global triangles, binned (tile, triangle) pairs,
    the busiest tile, the share of the frame covered by each pass); for the
    ray-traced frame each K4 cast's bundles, rays, listed (bundle, cluster)
    pairs, clusters swept before the early exits, and rays that hit;
  * the frame time without the profiler, back to back and synchronised
    after every frame;
  * from a torch.profiler trace of N frames, per frame: each
    ``record_function`` span's host time and device window (first kernel
    to last kernel of the span, gaps included), kernel time by span and in
    all, kernel launches, host->device copies and stream syncs;
  * the device's idle share: 1 - (kernel time per frame) / (synchronised
    frame time without the profiler).

With --game it profiles the Dust2 game's step instead (``profile_game``:
``apps/dust2.Dust2Game`` at 640x400 unless --width and --height say
otherwise, 7 bots, bench.py's scripted input, after 130 steps), whose
spans are ``game.step`` (the host loop), ``game.join`` (the pipelined
present's wait), ``game.upload`` (the frame's one host-to-device copy),
``game.fused`` (``fused_step``, with the ``sim.*`` and ``frame.*`` spans
inside it), ``game.present_copy`` and ``game.shot`` (a shot's cast and
read).  The module also holds ``FrameStats``, the game's rolling frame
counters (host only).

The chrome trace and a JSON summary go to --out (default
``chiprun_out/profile``; with --sim the summary alone, its spans those
that saw work).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import statistics
import sys
import time
from typing import Dict, Optional

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPANS = ("frame.camera_cull", "frame.vertex_updates", "frame.geom_cap",
         "frame.geometry", "frame.extras", "frame.active_cap",
         "tile.bin_pack", "tile.fold", "tile.shade",
         "tile.peel_prev", "tile.peel_fold", "tile.peel_shade", "tile.replay",
         "rt.world", "rt.accel", "rt.prep", "rt.sweep_nearest",
         "rt.sweep_any", "rt.winner", "rt.shade", "rt.brute_cast",
         "rt.composite", "vis.fold", "deferred.interp", "deferred.shade",
         "shadow.geometry", "shadow.fold", "frame.ssaa_resolve",
         "post.sky", "post.ssao", "post.bloom", "post.tonemap",
         "post.fxaa", "post.callable", "sim.agents", "sim.character",
         "sim.raycast", "sim.particles", "game.step", "game.join",
         "game.upload", "game.fused", "game.present_copy", "game.shot")
# The crowd that --sim profiles: chip_smoke.py phase 22b's largest.
CROWD_AGENTS = 32
# The game --game profiles: bench.py's game loop (bench.py:94-154), 7 bots
# (the app's cap), present depth 3, after one period of its script.
GAME_BOTS = 7
GAME_WARMUP = 130
SHADOW_FRAMES = {"directional": "shadows", "point": "point_shadows",
                 "spot": "spot_shadows"}


# The game's frame counters (the JAX package's utils/profiling.FrameStats,
# host only): the HUD's fps and ms, the debug panel's lines.
class FrameStats:
    """Rolling window of frame times + workload counters."""

    def __init__(self, window: int = 120):
        self._times = collections.deque(maxlen=window)
        self._stages: Dict[str, collections.deque] = {}
        self.pixels_per_frame = 0
        self.triangles_per_frame = 0
        self._last = None

    def frame(self, pixels: Optional[int] = None,
              triangles: Optional[int] = None) -> None:
        """Call once per presented frame."""
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now
        if pixels is not None:
            self.pixels_per_frame = pixels
        if triangles is not None:
            self.triangles_per_frame = triangles

    @contextlib.contextmanager
    def stage(self, name: str):
        """Per-stage host span: with stats.stage("render"): ..."""
        dq = self._stages.setdefault(name, collections.deque(maxlen=120))
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dq.append(time.perf_counter() - t0)

    def _pct(self, sorted_times, q):
        if not sorted_times:
            return 0.0
        i = min(len(sorted_times) - 1, int(q * (len(sorted_times) - 1)))
        return sorted_times[i]

    def counters(self) -> Dict[str, float]:
        ts = sorted(self._times)
        mean = sum(ts) / len(ts) if ts else 0.0
        fps = 1.0 / mean if mean > 0 else 0.0
        out = {
            "fps": fps,
            "frame_ms_mean": mean * 1000.0,
            "frame_ms_p50": self._pct(ts, 0.50) * 1000.0,
            "frame_ms_p99": self._pct(ts, 0.99) * 1000.0,
            "mpixels_per_s": self.pixels_per_frame * fps / 1e6,
            "mtris_per_s": self.triangles_per_frame * fps / 1e6,
        }
        for name, dq in self._stages.items():
            if dq:
                out[f"stage_{name}_ms"] = 1000.0 * sum(dq) / len(dq)
        return out

    def debug_lines(self):
        c = self.counters()
        lines = [f"{c['fps']:6.1f} fps   {c['frame_ms_mean']:6.2f} ms "
                 f"(p99 {c['frame_ms_p99']:.2f})",
                 f"{c['mpixels_per_s']:8.2f} Mpix/s  "
                 f"{c['mtris_per_s']:8.2f} Mtris/s"]
        for k, v in sorted(c.items()):
            if k.startswith("stage_"):
                lines.append(f"{k[6:]:>10s}: {v:6.2f} ms")
        return lines


def scene_stats(eng, uniforms) -> Dict:
    """Binning statistics of one frame, read from the tile fold's inputs,
    and the share of the frame each pass covers."""
    from softwarerenderer_tpu_torch.engine import render_frame
    from softwarerenderer_tpu_torch.ops import tile_raster
    seen = []

    def capture(*args, **kwargs):
        out = tile_raster.tile_fold(*args, **kwargs)
        seen.append((args, out[2]))
        return out

    render_frame(eng.scene, uniforms, eng.params, fold=capture)
    _, setup, _, n_global, _, _, counts, _, _ = seen[0][0]
    f = eng.params.ssaa
    H, W = eng.params.height * f, eng.params.width * f
    ng = int(n_global[0])
    return {
        "slots": int(setup.shape[0]),
        "valid_slots": int((setup[:, 9] != 0).sum()),
        "global_triangles": ng,
        "tiles": int(counts.numel()),
        "binned_pairs": int(counts.sum()),
        "busiest_tile_segment": int(counts.max()),
        "busiest_tile_folded": ng + int(counts.max()),
        "covered_per_pass": [float((bi[:H, :W] >= 0).float().mean())
                             for _, bi in seen],
    }


def deferred_stats(eng, uniforms) -> Dict:
    """Binning statistics of one deferred frame, read from K5's inputs,
    and the share of the frame it covers."""
    from softwarerenderer_tpu_torch.engine import frame_setup
    from softwarerenderer_tpu_torch.ops import binning, vis_fold
    p = eng.params
    f = frame_setup(eng.scene, uniforms, p)
    args, kwargs = binning.fold_inputs(f["tris"], p, p.tile_h, p.tile_w,
                                       p.span_cap)
    _, bi = vis_fold.vis_fold(*args, **kwargs)
    _, setup, _, n_global, _, _, counts = args
    H, W = eng.params.height, eng.params.width
    ng = int(n_global[0])
    return {"slots": int(setup.shape[0]),
            "valid_slots": int((setup[:, 9] != 0).sum()),
            "global_triangles": ng, "tiles": int(counts.numel()),
            "binned_pairs": int(counts.sum()),
            "busiest_tile_folded": ng + int(counts.max()),
            "covered": float((bi[:H, :W] >= 0).float().mean())}


def raytrace_stats(eng, uniforms, cap: int) -> Dict:
    """Each K4 cast of one ray-traced frame: bundles, rays per bundle,
    listed (bundle, cluster) pairs, the clusters the kernel swept before
    its early exits, and the rays that hit."""
    from softwarerenderer_tpu_torch.ops import rt_sweep
    from softwarerenderer_tpu_torch.ops.raytrace import render_frame_raytraced
    casts = []

    def sweep(*args, **kwargs):
        swept = torch.zeros_like(args[3])
        t, g = rt_sweep.rt_sweep(*args, **kwargs, swept=swept)
        hit = (g > 0) if kwargs["any_hit"] else (g < rt_sweep.NOTRI)
        casts.append({"mode": "any_hit" if kwargs["any_hit"] else "nearest",
                      "bundles": int(args[0].shape[0]),
                      "rays_per_bundle": int(args[0].shape[2]),
                      "clusters": int(args[1].shape[1]) // rt_sweep.GROUP,
                      "listed_pairs": int(args[3].sum()),
                      "swept_clusters": int(swept.sum()),
                      "rays_hit": int(hit.sum())})
        return t, g

    render_frame_raytraced(eng.scene, uniforms, eng.params, cluster_cap=cap,
                           sweep=sweep)
    return {"casts": casts}


def _wall_ms(step, frames, sync_each: bool) -> float:
    """Median (sync_each) or mean (back to back) host ms per call of
    step(i)."""
    times = []
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for i in range(frames):
        t = time.perf_counter()
        step(i)
        if sync_each:
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    if sync_each:
        return statistics.median(times)
    return (time.perf_counter() - t_all) * 1e3 / frames


def trace_summary(trace: Dict, frames: int) -> Dict:
    """Per-frame numbers from a chrome trace written by torch.profiler."""
    ev = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    kernels = [e for e in ev if e.get("cat") == "kernel"]
    host = {s: 0.0 for s in SPANS}
    window = {s: 0.0 for s in SPANS}
    by_span = {s: 0.0 for s in SPANS}
    gpu_spans = []
    for e in ev:
        if e.get("name") not in host:
            continue
        if e.get("cat") == "user_annotation":
            host[e["name"]] += e["dur"]
        elif e.get("cat") == "gpu_user_annotation":
            window[e["name"]] += e["dur"]
            gpu_spans.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    for k in kernels:
        # The innermost span holding the kernel (the simulation's spans
        # nest: sim.raycast in sim.character in sim.agents).
        mid = k["ts"] + k["dur"] / 2
        inside = [(hi - lo, name) for lo, hi, name in gpu_spans
                  if lo <= mid <= hi]
        if inside:
            by_span[min(inside)[1]] += k["dur"]
    rt = [e for e in ev if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    launches = sum(1 for e in rt if "LaunchKernel" in e["name"]
                   or e["name"] == "cuLaunchKernel")
    syncs = sum(1 for e in rt if "Synchronize" in e["name"])
    copies = sum(1 for e in ev if e.get("cat") == "gpu_memcpy"
                 and "HtoD" in e["name"])
    per = 1e-3 / frames
    by_name: Dict[str, float] = {}
    for k in kernels:
        by_name[k["name"]] = by_name.get(k["name"], 0.0) + k["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "span_host_ms": {s: host[s] * per for s in SPANS},
        "span_device_window_ms": {s: window[s] * per for s in SPANS},
        "span_kernel_ms": {s: by_span[s] * per for s in SPANS},
        "kernel_ms": sum(k["dur"] for k in kernels) * per,
        "kernels": len(kernels) / frames,
        "launch_calls": launches / frames,
        "syncs": syncs / frames,
        "htod_copies": copies / frames,
        "top_kernels_ms": [(n[:80], v * per) for n, v in top],
    }


def profile(step, frames: int, path: str) -> Dict:
    """step(i) timed back to back and synchronised (30 calls each after 3
    of warm-up), then traced over `frames` calls (the chrome trace to
    `path`): the timings, trace_summary's numbers and the device's idle
    share."""
    _wall_ms(step, 3, True)                              # warm-up
    back_to_back = _wall_ms(step, 30, False)
    synced = _wall_ms(step, 30, True)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(frames):
            step(i)
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        summary = trace_summary(json.load(f), frames)
    return {"frame_ms_back_to_back": back_to_back,
            "frame_ms_synchronised": synced, "profiled_frames": frames,
            **summary,
            "device_idle_share": 1.0 - summary["kernel_ms"] / synced}


def sim_programs() -> Dict:
    """The simulation's programs on the card, each a step(i) that carries
    its state: "coupled", bench.py config 4's step (scenes.coupled_step at
    1280x720); "crowd", a step of CROWD_AGENTS agents on the bench scene with
    routing and combat (scenes.crowd_step); "particles", a step of the
    1,024-slot fountain and its render channels."""
    from softwarerenderer_tpu_torch import scenes, sim
    from softwarerenderer_tpu_torch.config import RenderParams
    from softwarerenderer_tpu_torch.engine import default_frame_uniforms
    from softwarerenderer_tpu_torch.models.convert import (scene_to_torch,
                                                           tree_to_torch)
    dev = "cuda"
    scene = scene_to_torch(scenes.bench_scene(), dev)
    cp = tree_to_torch(sim.default_character_params(), dev)
    br = tree_to_torch(sim.default_brain_params(), dev)
    w, h = scenes.CONFIG4_SIZE
    params = RenderParams(w, h)
    u = tree_to_torch(scenes.camera_uniforms(default_frame_uniforms(w, h)),
                      dev)
    world = sim.build_collision_world(scene)
    crowd = scenes.crowd_setup(world, CROWD_AGENTS)
    em = tree_to_torch(scenes.fountain_emitter(), dev)
    box = {"char": sim.initial_character_state(scenes.CONFIG4_START,
                                               device=dev),
           "crowd": crowd["state"],
           "parts": sim.initial_particle_state(scenes.ANIMATED_PARTICLES,
                                               device=dev)}

    def coupled(i):
        box["char"] = scenes.coupled_step(box["char"], scene, u, params,
                                          cp)[0]

    def crowd_step(i):
        box["crowd"] = scenes.crowd_step(box["crowd"], crowd, world, cp, br)

    def particles(i):
        box["parts"] = sim.particle_step(box["parts"], em, scenes.CONFIG4_DT)
        sim.particle_uniforms(box["parts"], em)
    return {"coupled": coupled, "crowd": crowd_step, "particles": particles}


def profile_game(width: int, height: int, frames: int, path: str) -> Dict:
    """profile() of the Dust2 game's step (apps/dust2.Dust2Game, headless
    and offline from seed 0, GAME_BOTS bots, present depth 3, bench.py's
    scripted input) after GAME_WARMUP steps."""
    import tempfile
    from softwarerenderer_tpu_torch.apps import dust2
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)          # the game's close() writes hud_layout.json
        try:
            game = dust2.Dust2Game(width=width, height=height,
                                   render_scale=1.0, headless=True,
                                   offline=True, seed=0, bots=GAME_BOTS,
                                   device="cuda")
            game.present_depth = 3
            box = {"i": 0}

            def step(i):
                game.step(1.0 / 60.0, dust2.bench_input(box["i"]))
                box["i"] += 1
            for i in range(GAME_WARMUP):
                step(i)
            stats = {"triangles": int(game.scene["indices"].shape[0]),
                     "meshes": int(game.n_meshes), "bots": GAME_BOTS,
                     "profiled_from_step": GAME_WARMUP + 63}
            result = {"device": torch.cuda.get_device_name(0),
                      "size": [width, height], "game": stats,
                      **profile(step, frames, path)}
            result["shot_reads"] = game.shot_reads
            game.close()
        finally:
            os.chdir(cwd)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--width", type=int)
    ap.add_argument("--height", type=int)
    ap.add_argument("--kbuffer", type=int, default=0)
    ap.add_argument("--raytrace", type=int, default=0, metavar="CAP")
    ap.add_argument("--deferred", action="store_true")
    ap.add_argument("--config", type=int, choices=(3, 5), default=0)
    ap.add_argument("--shadows", choices=sorted(SHADOW_FRAMES))
    ap.add_argument("--image-quality", action="store_true")
    ap.add_argument("--animated", action="store_true")
    ap.add_argument("--crowd", choices=("uncapped", "suggested", "ladder"))
    ap.add_argument("--sim", action="store_true")
    ap.add_argument("--game", action="store_true")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "profile"))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiling: no CUDA device", file=sys.stderr)
        return 1
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.config import RenderParams
    from softwarerenderer_tpu_torch.engine import Engine

    if sum((a.kbuffer > 1, bool(a.raytrace), a.deferred, bool(a.config),
            bool(a.shadows), a.image_quality, a.animated, bool(a.crowd),
            a.sim, a.game)) > 1:
        print("profiling: --kbuffer, --raytrace, --deferred, --config, "
              "--shadows, --image-quality, --animated, --crowd, --sim and "
              "--game are different frames; pick one", file=sys.stderr)
        return 1
    if a.game:
        result = profile_game(a.width or 640, a.height or 400, a.frames,
                              os.path.join(a.out, "trace.json"))
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out, "summary.json"), "w") as f:
            json.dump(result, f, indent=1)
        print(json.dumps(result, indent=1))
        return 0
    if a.sim:
        # Three traces of eager steps outgrow what a run may bring back:
        # they go to a temporary directory, and the summary keeps the
        # spans that saw any work.
        import tempfile
        result = {"device": torch.cuda.get_device_name(0),
                  "agents": CROWD_AGENTS}
        with tempfile.TemporaryDirectory() as tmp:
            for name, step in sim_programs().items():
                r = profile(step, a.frames, os.path.join(tmp, "trace.json"))
                for k in ("span_host_ms", "span_device_window_ms",
                          "span_kernel_ms"):
                    r[k] = {n: v for n, v in r[k].items() if v}
                result[name] = r
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out, "summary.json"), "w") as f:
            json.dump(result, f, indent=1)
        print(json.dumps(result, indent=1))
        return 0
    default = scenes.LOD_CROWD_SIZE if a.crowd \
        else scenes.BENCH_SIZES.get(a.config, (1920, 1080))
    a.width, a.height = a.width or default[0], a.height or default[1]
    fixed = None
    if a.config:
        from softwarerenderer_tpu_torch.models.scene import (
            build_scene_buffers)
        eng = Engine(build_scene_buffers(scenes.golden_config(a.config)),
                     RenderParams(a.width, a.height), device="cuda",
                     **scenes.golden_shaders(a.config))
        fixed = scenes.golden_uniforms(a.config, eng.uniforms)
    elif a.shadows:
        scene, _, fixed, fn, shaders = scenes.shadow_golden_frame(
            SHADOW_FRAMES[a.shadows])
        eng = Engine(scene, RenderParams(a.width, a.height), device="cuda",
                     frame_fn=fn.func, **shaders)
    elif a.image_quality:
        from softwarerenderer_tpu_torch.engine import (
            scene_fragment_shader_trilinear)
        eng = Engine(scenes.bench_scene(), RenderParams(
            a.width, a.height, ssaa=2, use_mipmaps="trilinear", ssao=True,
            bloom=True, tonemap="aces", fxaa=True), device="cuda",
            fragment_shader=scene_fragment_shader_trilinear)
        pano = scenes.sky_panorama()
    elif a.animated:
        from softwarerenderer_tpu_torch.ops import normalmap
        eng = Engine(scenes.animated_scene(),
                     RenderParams(a.width, a.height), device="cuda",
                     vertex_shader=normalmap.normal_mapped_vertex_shader,
                     fragment_shader=normalmap.normal_mapped_fragment_shader)
    elif a.crowd:
        from softwarerenderer_tpu_torch.ops import lod
        sc = scenes.lod_crowd_scene()
        params = RenderParams(a.width, a.height)
        eng = Engine(sc, params, device="cuda")
        fixed = scenes.lod_crowd_uniforms(eng.uniforms)
        if a.crowd == "suggested":
            params = params.replace(active_cap=lod.suggested_active_cap(sc))
        elif a.crowd == "ladder":
            params = params.replace(**scenes.lod_cap_ladder(
                eng.scene, fixed, params))
        eng = Engine(eng.scene, params, device="cuda")
    elif a.kbuffer > 1:
        eng = Engine(scenes.translucent_scene(),
                     RenderParams(a.width, a.height, kbuffer=a.kbuffer,
                                  cull_mode=0), device="cuda")
    elif a.raytrace:
        import functools
        from softwarerenderer_tpu_torch.ops.raytrace import (
            render_frame_raytraced)
        eng = Engine(scenes.bench_scene(), RenderParams(a.width, a.height),
                     device="cuda", frame_fn=functools.partial(
                         render_frame_raytraced, cluster_cap=a.raytrace))
    else:
        eng = Engine(scenes.bench_scene(),
                     RenderParams(a.width, a.height,
                                  use_pallas=not a.deferred),
                     device="cuda")

    def uniforms_at(i):
        if a.animated:
            return scenes.animated_uniforms(eng.uniforms, i)
        if a.image_quality:
            return dict(scenes.camera_uniforms(eng.uniforms, i),
                        sky_panorama=pano)
        return fixed or scenes.camera_uniforms(eng.uniforms, i)

    if a.raytrace:
        stats = raytrace_stats(eng, uniforms_at(0), a.raytrace)
    elif a.deferred:
        stats = deferred_stats(eng, uniforms_at(0))
    else:
        stats = scene_stats(eng, uniforms_at(0))
    result = {"device": torch.cuda.get_device_name(0),
              "size": [a.width, a.height], "kbuffer": a.kbuffer,
              "raytrace": a.raytrace, "deferred": a.deferred,
              "config": a.config, "shadows": a.shadows,
              "image_quality": a.image_quality, "animated": a.animated,
              "crowd": a.crowd, "caps": {
                  k: getattr(eng.params, k) for k in (
                      "active_cap", "geom_cap", "pair_cap", "global_cap")},
              "scene": stats,
              **profile(lambda i: eng.render(uniforms_at(i)), a.frames,
                        os.path.join(a.out, "trace.json"))}
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, "summary.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
