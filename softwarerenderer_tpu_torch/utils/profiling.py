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
uncapped (no caps of the user's: ``Engine`` still compacts the input
triangles to the scene's own LOD bound, ``lod.suggested_geom_cap``), at
``lod.suggested_active_cap`` or at the script's ladder of caps measured
on frame 0 (``scenes.lod_cap_ladder``), whose compactions show as
``frame.geom_cap`` and ``frame.active_cap``.  Without --width and
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
  * ``span_totals()`` a frame (each span's calls, host ms and self ms:
    host time less that of the spans inside it), from N frames back to
    back under ``recording()`` without the profiler, and from the traced
    frames below, with each run's frame time (the difference is the
    profiler's cost);
  * from a torch.profiler trace of N frames, per frame: each span's host
    time and device window (first kernel to last kernel of the span, gaps
    included), kernel time by span and in all, kernel launches,
    host->device copies and stream syncs, for every span the trace holds;
  * the device's idle share, ``device_idle_pct``: 100 (1 - the union of
    kernel, copy and fill intervals / the traced window, from the first
    host call to the end of the last device activity).

The program's spans are ``span`` objects (``with span("frame.geometry")``
or ``@span("sim.agents")``): off, a span reads one flag and does nothing
else; while the torch profiler runs it is a ``record_function`` on the
trace's clock, and while the profiler runs or inside ``recording()`` it
adds to ``span_totals()``.  ``engine.render`` holds one frame of
``Engine.render``; each ``sync.<what>`` span holds a place where the host
waits for the card (a pageable copy to it, or a read of a device value).

With --game it profiles the Dust2 game's step instead (``profile_game``:
``apps/dust2.Dust2Game`` at 640x400 unless --width and --height say
otherwise, 7 bots, bench.py's scripted input, after 130 steps), whose
spans are ``game.step`` (the host loop), ``game.join`` (the pipelined
present's wait), ``game.upload`` (the frame's one host-to-device copy),
``game.fused`` (``fused_step``, with the ``sim.*`` and ``frame.*`` spans
inside it), ``game.present_copy`` and ``game.shot`` (a shot's cast and
read).  The module also holds ``FrameStats``, the game's rolling frame
counters (host only), and the JAX module's timing and watchdog helpers:
``trace`` (a torch.profiler trace written as Chrome JSON) and
``annotate`` (``span``), ``hard_sync`` (one data-dependent scalar
read that waits for every queued launch, with a watchdog that raises
``DeviceSyncTimeout``), ``timed_frames`` (pipelined frames timed between
two hard syncs) and ``arm_watchdog`` / ``watchdog`` (a thread dump and
``os._exit`` when a stage overruns).

The chrome trace and a JSON summary go to --out (default
``chiprun_out/profile``; with --sim the summary alone, its spans those
that saw work).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import os
import statistics
import sys
import threading
import time
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

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

    def _pct(self, sorted_times, q):
        if not sorted_times:
            return 0.0
        i = min(len(sorted_times) - 1, int(q * (len(sorted_times) - 1)))
        return sorted_times[i]

    def counters(self) -> Dict[str, float]:
        ts = sorted(self._times)
        mean = sum(ts) / len(ts) if ts else 0.0
        fps = 1.0 / mean if mean > 0 else 0.0
        return {
            "fps": fps,
            "frame_ms_mean": mean * 1000.0,
            "frame_ms_p50": self._pct(ts, 0.50) * 1000.0,
            "frame_ms_p99": self._pct(ts, 0.99) * 1000.0,
            "mpixels_per_s": self.pixels_per_frame * fps / 1e6,
            "mtris_per_s": self.triangles_per_frame * fps / 1e6,
        }

    def debug_lines(self):
        c = self.counters()
        return [f"{c['fps']:6.1f} fps   {c['frame_ms_mean']:6.2f} ms "
                f"(p99 {c['frame_ms_p99']:.2f})",
                f"{c['mpixels_per_s']:8.2f} Mpix/s  "
                f"{c['mtris_per_s']:8.2f} Mtris/s"]


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/srt_trace"):
    """A torch.profiler trace around a code span (CPU activity, and CUDA
    when a card is present), written into log_dir as a Chrome trace on
    exit; yields log_dir."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


# What span() keeps while recording is on: calls, host ns and self ns by
# name, and each thread's stack of open spans (the child ns of each).
_totals: Dict[str, list] = {}
_totals_lock = threading.Lock()
_open = threading.local()
_recording = [0]


class span:
    """A named host span: ``with span("frame.geometry"): ...`` or
    ``@span("sim.agents")`` on a function.

    Off (no torch profiler running and no ``recording()``), it reads one
    flag and does nothing else: no torch op, no record_function, so it
    costs nothing a CUDA graph would capture.  While the torch profiler
    runs it opens ``torch.profiler.record_function(name)``, which puts the
    span in the Chrome trace on the device activity's clock.  While
    recording is on (the profiler runs, or inside ``recording()``) it
    adds to ``span_totals()``: its calls, its host time and its self time
    (host time less the time of the spans opened inside it on the same
    thread).  One instance is open at most once at a time; the decorator
    opens a fresh one a call."""

    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._t0 = None

    def __enter__(self):
        traced = _autograd_profiler._is_profiler_enabled
        if not (traced or _recording[0]):
            return self
        self._rf = None
        if traced:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        stack.append([0])
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._t0 is None:
            return False
        host = time.perf_counter_ns() - self._t0
        self._t0 = None
        stack = _open.stack
        child = stack.pop()[0]
        if stack:
            stack[-1][0] += host
        with _totals_lock:
            t = _totals.setdefault(self.name, [0, 0, 0])
            t[0] += 1
            t[1] += host
            t[2] += host - child
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


# The JAX module's name for a span inside a trace.
annotate = span


@contextlib.contextmanager
def recording():
    """Keep span_totals() without the torch profiler (and without its
    cost per op), for as long as the block runs."""
    with _totals_lock:
        _recording[0] += 1
    try:
        yield
    finally:
        with _totals_lock:
            _recording[0] -= 1


def span_totals() -> Dict[str, Dict[str, float]]:
    """{name: {"calls", "host_ms", "self_ms"}} of every span closed while
    recording was on since the last reset_span_totals()."""
    with _totals_lock:
        return {k: {"calls": c, "host_ms": h * 1e-6, "self_ms": s * 1e-6}
                for k, (c, h, s) in _totals.items()}


def reset_span_totals() -> None:
    with _totals_lock:
        _totals.clear()


class DeviceSyncTimeout(RuntimeError):
    """A device sync did not complete within its watchdog window: the card
    is wedged.  Raised by hard_sync/timed_frames instead of hanging the
    caller."""


def _tensor_leaves(tree) -> list:
    """The tensors of a nested dict, list or tuple, in JAX's leaf order
    (dict keys sorted)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensor_leaves(v)]
    return []


def hard_sync(out, timeout_s: Optional[float] = None) -> float:
    """Wait for ALL device work `out` depends on; return a probe.

    Every floating, integer or bool tensor leaf of `out` (a tensor or a
    nested dict, list or tuple of them) is reduced to one float32 sum on
    its device and read back with .item(), which (by in-order execution
    on the stream) waits for every launch queued before it.

    timeout_s: watchdog window.  The read runs on a daemon thread; if it
    has not completed in time, a thread dump goes to stderr and
    DeviceSyncTimeout is raised (the stuck thread does not block process
    exit).  An error inside the read is raised again.  None = block
    indefinitely.

    Use as the one sync point of a pipelined timing loop:

        t0 = perf_counter()
        for i in range(n): out = step(i)
        hard_sync(out, timeout_s=120)
        dt = perf_counter() - t0
    """
    leaves = [x for x in _tensor_leaves(out) if not x.is_complex()]
    if not leaves:
        return 0.0
    probe = leaves[0].to(torch.float32).sum()
    for x in leaves[1:]:
        probe = probe + x.to(torch.float32).sum().to(probe.device)
    if timeout_s is None:
        return probe.item()

    import threading
    box: Dict[str, object] = {}

    def _read():
        try:
            box["value"] = probe.item()
        except BaseException as e:          # raised again below
            box["error"] = e

    th = threading.Thread(target=_read, daemon=True,
                          name="hard_sync_readback")
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        import faulthandler
        sys.stderr.write(
            f"\n[hard_sync] device readback still blocked after "
            f"{timeout_s:.1f}s; dumping all threads:\n")
        faulthandler.dump_traceback(file=sys.stderr)
        raise DeviceSyncTimeout(
            f"device sync did not complete within {timeout_s:.1f}s; the "
            f"card is likely wedged (a previously killed run can leave it "
            f"stuck)")
    if "error" in box:
        raise box["error"]  # type: ignore[misc]
    return box["value"]  # type: ignore[return-value]


def timed_frames(step_fn, n_frames: int, *, warmup: int = 2,
                 timeout_s: Optional[float] = None) -> float:
    """Pipelined-N-frames timing with one hard_sync: `warmup` calls
    step_fn(0 .. warmup - 1), a hard_sync, then n_frames calls with i
    counting on, then a hard_sync.  step_fn(i) must vary its inputs with
    i and return device tensors.  timeout_s bounds each of the two syncs
    (hard_sync's watchdog).  Returns seconds per frame."""
    out = None
    for i in range(warmup):
        out = step_fn(i)
    hard_sync(out, timeout_s=timeout_s)
    t0 = time.perf_counter()
    for i in range(n_frames):
        out = step_fn(warmup + i)
    hard_sync(out, timeout_s=timeout_s)
    return (time.perf_counter() - t0) / n_frames


def arm_watchdog(name: str, timeout_s: float, exit_code: int = 42):
    """Arm a hard process watchdog; returns a zero-arg cancel function.

    If not cancelled within timeout_s: dump all thread stacks to stderr
    and os._exit(exit_code).  A hung device call blocks in native code
    and cannot be interrupted by raising in the main thread, so a script's
    honest failure is a loud diagnostic and a non-zero exit.  Library code
    should prefer hard_sync(timeout_s=...), which raises instead."""
    import faulthandler
    import threading

    done = threading.Event()

    def _fire():
        if done.wait(timeout_s):
            return
        sys.stderr.write(
            f"\n[watchdog] stage '{name}' exceeded {timeout_s:.1f}s; "
            f"device likely wedged; dumping threads and exiting "
            f"{exit_code}:\n")
        faulthandler.dump_traceback(file=sys.stderr)
        sys.stderr.flush()
        os._exit(exit_code)

    threading.Thread(target=_fire, daemon=True,
                     name=f"watchdog:{name}").start()
    return done.set


@contextlib.contextmanager
def watchdog(name: str, timeout_s: float, exit_code: int = 42):
    """Context-manager form of arm_watchdog (see its docstring)."""
    cancel = arm_watchdog(name, timeout_s, exit_code)
    try:
        yield
    finally:
        cancel()


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


# Device activity: kernels, copies and fills on the card.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _busy_us(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def trace_summary(trace: Dict, frames: int) -> Dict:
    """Per-frame numbers from a chrome trace written by torch.profiler,
    for every span the trace holds."""
    ev = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    kernels = [e for e in ev if e.get("cat") == "kernel"]
    host: Dict[str, float] = collections.defaultdict(float)
    window: Dict[str, float] = collections.defaultdict(float)
    by_span: Dict[str, float] = collections.defaultdict(float)
    gpu_spans = []
    for e in ev:
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
    # The traced window: from the first host call or span to the end of
    # the last device activity; the device is idle where no kernel, copy
    # or fill runs (overlapping ones count once).
    device = [(e["ts"], e["ts"] + e["dur"]) for e in ev
              if e.get("cat") in DEVICE_CATS]
    starts = [e["ts"] for e in ev if e.get("cat") in (
        "user_annotation", "cuda_runtime", "cuda_driver")]
    window_us = (max(hi for _, hi in device) - min(starts)
                 if device and starts else 0.0)
    per = 1e-3 / frames
    by_name: Dict[str, float] = {}
    for k in kernels:
        by_name[k["name"]] = by_name.get(k["name"], 0.0) + k["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "span_host_ms": {s: v * per for s, v in sorted(host.items())},
        "span_device_window_ms": {s: v * per
                                  for s, v in sorted(window.items())},
        "span_kernel_ms": {s: v * per for s, v in sorted(by_span.items())},
        "kernel_ms": sum(k["dur"] for k in kernels) * per,
        "kernels": len(kernels) / frames,
        "launch_calls": launches / frames,
        "syncs": syncs / frames,
        "htod_copies": copies / frames,
        "top_kernels_ms": [(n[:80], v * per) for n, v in top],
        "window_ms": window_us * per,
        "device_idle_pct": (100.0 * (1.0 - _busy_us(device) / window_us)
                            if window_us > 0 else None),
    }


def _per_frame(totals: Dict, frames: int) -> Dict:
    """span_totals() divided by the frames it covers."""
    return {k: {"calls": v["calls"] / frames,
                "host_ms": v["host_ms"] / frames,
                "self_ms": v["self_ms"] / frames} for k, v in totals.items()}


def profile(step, frames: int, path: str) -> Dict:
    """step(i) timed back to back and synchronised (30 calls each after 3
    of warm-up), back to back again over `frames` calls under recording()
    (span_totals a frame, without the profiler), then traced over
    `frames` calls (the chrome trace to `path`): the timings, each run's
    span_totals a frame, and trace_summary's numbers."""
    _wall_ms(step, 3, True)                              # warm-up
    back_to_back = _wall_ms(step, 30, False)
    synced = _wall_ms(step, 30, True)
    reset_span_totals()
    with recording():
        recorded_ms = _wall_ms(step, frames, False)
    untraced = _per_frame(span_totals(), frames)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    reset_span_totals()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for i in range(frames):
            step(i)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t) * 1e3 / frames
    traced = _per_frame(span_totals(), frames)
    reset_span_totals()
    prof.export_chrome_trace(path)
    with open(path) as f:
        summary = trace_summary(json.load(f), frames)
    return {"frame_ms_back_to_back": back_to_back,
            "frame_ms_synchronised": synced, "profiled_frames": frames,
            "frame_ms_recording": recorded_ms, "frame_ms_traced": traced_ms,
            "spans_recording": untraced, "spans_traced": traced,
            **summary}


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
    # The spans the program opens live in the imported module, not in
    # this __main__ copy of it: run main there.
    from softwarerenderer_tpu_torch.utils.profiling import main as _main
    sys.exit(_main())
