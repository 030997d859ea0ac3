"""Where the time of one frame goes, on a CUDA card.

    python -m softwarerenderer_tpu_torch.utils.profiling [--frames N]
        [--width W] [--height H] [--kbuffer K | --raytrace CAP] [--out DIR]

Renders the bench scene (``scenes.bench_scene()``) through ``Engine(scene,
RenderParams(W, H), device="cuda")`` with ``scenes.camera_uniforms(u, i)``;
with --kbuffer K the K-buffer frame of ``scenes.translucent_scene()`` (the
bench soup with six glass panes) through ``RenderParams(W, H, kbuffer=K,
cull_mode=0)``; with --raytrace CAP the ray-traced frame with hard shadows,
``Engine(..., frame_fn=functools.partial(render_frame_raytraced,
cluster_cap=CAP))``.  It prints:

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

The chrome trace and a JSON summary go to --out (default
``chiprun_out/profile``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Dict

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPANS = ("frame.camera_cull", "frame.geometry", "frame.extras",
         "tile.bin_pack", "tile.fold", "tile.shade", "tile.peel_prev",
         "tile.peel_fold", "tile.peel_shade", "tile.replay",
         "rt.world", "rt.accel", "rt.prep", "rt.sweep_nearest",
         "rt.sweep_any", "rt.winner", "rt.shade", "rt.brute_cast",
         "rt.composite")


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
    H, W = eng.params.height, eng.params.width
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


def _wall_ms(eng, frames, uniforms_at, sync_each: bool) -> float:
    """Median (sync_each) or mean (back to back) host ms per frame."""
    times = []
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for i in range(frames):
        t = time.perf_counter()
        eng.render(uniforms_at(i))
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
        mid = k["ts"] + k["dur"] / 2
        for lo, hi, name in gpu_spans:
            if lo <= mid <= hi:
                by_span[name] += k["dur"]
                break
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--kbuffer", type=int, default=0)
    ap.add_argument("--raytrace", type=int, default=0, metavar="CAP")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "profile"))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiling: no CUDA device", file=sys.stderr)
        return 1
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.config import RenderParams
    from softwarerenderer_tpu_torch.engine import Engine

    if a.kbuffer > 1 and a.raytrace:
        print("profiling: --kbuffer and --raytrace are two frames; pick one",
              file=sys.stderr)
        return 1
    if a.kbuffer > 1:
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
        eng = Engine(scenes.bench_scene(), RenderParams(a.width, a.height),
                     device="cuda")

    def uniforms_at(i):
        return scenes.camera_uniforms(eng.uniforms, i)

    stats = (raytrace_stats(eng, uniforms_at(0), a.raytrace) if a.raytrace
             else scene_stats(eng, uniforms_at(0)))
    _wall_ms(eng, 3, uniforms_at, True)                  # warm-up
    back_to_back = _wall_ms(eng, 30, uniforms_at, False)
    synced = _wall_ms(eng, 30, uniforms_at, True)

    os.makedirs(a.out, exist_ok=True)
    path = os.path.join(a.out, "trace.json")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(a.frames):
            eng.render(uniforms_at(i))
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        summary = trace_summary(json.load(f), a.frames)
    idle = 1.0 - summary["kernel_ms"] / synced
    result = {"device": torch.cuda.get_device_name(0),
              "size": [a.width, a.height], "kbuffer": a.kbuffer,
              "raytrace": a.raytrace,
              "scene": stats,
              "frame_ms_back_to_back": back_to_back,
              "frame_ms_synchronised": synced,
              "profiled_frames": a.frames, **summary,
              "device_idle_share": idle}
    with open(os.path.join(a.out, "summary.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
