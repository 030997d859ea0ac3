#!/usr/bin/env python3
"""Smoke run of softwarerenderer_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ (one nvcc per source, in parallel) and
drives the port's paths at 1080p (config 5 at 4K):

  * the opaque frame (``Engine(scene, RenderParams(1920, 1080),
    device="cuda")``): K1, the tile kernel, against its plain PyTorch twin
    on the bench scene at 32x128 tiles and at four more tilings (a tile
    smaller than a block, 8x64; three whole blocks a tile, 24x128; a ragged
    last block, 20x128; a width that does not divide 256, 24x96), timed with and without its longest-first tile
    order, 30 counted frames, the frame against the plain path, golden
    configs 1 and 2, the wireframe golden and golden config4's frame;
  * the K-buffer (``RenderParams(1920, 1080, kbuffer=4, cull_mode=0)``):
    K2, the tile kernel's peel mode, against its twin on passes 1-3 of a
    dense and a translucent frame and on two edge cases (one with a tile
    split over blocks), each live translucent pass timed beside its bound,
    its live pixels and the blocks that return early; K3, the single-pass K-deep
    kernel, against its twin at K=4 on both frames and at K1's four other
    tilings; 30 counted frames of the
    translucent scene through the peel route and 30 through the K-deep
    route, frame 0 against the plain path and the two routes against each
    other; the feature_kbuffer golden;
  * the ray-traced frame (``Engine(scene, RenderParams(1920, 1080),
    device="cuda", frame_fn=functools.partial(render_frame_raytraced,
    cluster_cap=24))``): K4, the ray-bundle sweep, on its edge cases and
    against its twin on the primary (nearest) and shadow (any-hit) casts of
    two frames, each also timed with the bundles in plain order and
    without the clusters' boxes; 30 counted frames with hard
    shadows, frame 0 against the
    twin's frame; one soft-shadow and one reflection frame against the
    twin; the bundle route against the brute route at 320x180;
  * the deferred route (``RenderParams(1920, 1080, use_pallas=False)``):
    K5, the visibility fold, against its twin and against K1's winners on
    the bench frame's bins, at 64-row tiles and on its edge cases (phase
    14); 30 counted frames, frame 0 against the plain path and the tile
    route (phase 15); and at 320x180 the brute and binned routes of LESS,
    GREATER, GREATER_EQUAL and ALWAYS, the forward route for EQUAL, the
    wireframe, overdraw and depth views, each equal to the same call on
    the CPU (phase 16).  Phase 14 also holds K5 at each part length of
    K5_PART_LENS (no split, then lists cut into parts merged by 64-bit
    atomics), times them in turns, and runs the split edge cases;
  * the K-slot K-buffer (``RenderParams(..., kbuffer=4, depth_test=X)``,
    ops.kbuffer): at 320x180 the translucent scene under LESS, GREATER,
    GREATER_EQUAL, ALWAYS and DISABLED equal to the same call on the CPU;
    at 1080p the route under LESS_EQUAL equal to the peel route without
    its short-circuit, and one GREATER frame timed (phase 17);
  * the lit frames (phase 18): golden config 3 (41 meshes under four
    lights through ``ops.lighting``'s shaders) at 1920x1080, 30 counted
    frames, and config 5 (1,100 cubes) at 3840x2160, 10 counted frames,
    one K1 launch each, frame 0 against the plain path; goldens config 3
    and 5; a PBR frame at 320x180 against the CPU's;
  * the shadowed frames at 1920x1080 (phase 19), through
    ``Engine(frame_fn=render_frame_with_shadows / _with_point_shadows /
    _with_spot_shadow)`` with 512, 6 x 256 and 512-texel maps: 10
    counted frames each with K1 + K5 launches of 1 + 1, 1 + 6 and 1 + 1,
    frame 0's light passes through K5 against the plain fold on the same
    triangles on every texel,
    frame 0 against the plain path (K1's and K5's twins), the three
    feature goldens.  Phases 18-19 also profile each frame's kernels;
  * the image-quality frames (phase 20): the bench frame at 1920x1080 with
    ``ssaa=2`` (K1 once a frame at 3840x2160), trilinear mips, the whole
    post chain (SSAO, bloom, ACES, FXAA) and a seeded sky panorama, 10
    counted frames with one launch of each post kernel
    (``csrc/post_fx.cu``) a frame, frame 0 against the plain path; each
    post kernel alone at 3840x2160 against its twin, timed beside its
    byte bound and its twin (ptxas's registers and spills in phase 2); K1
    at that size against its twin beside its bound, the frame's launches
    and host syncs by the profiler and what the post chain adds; goldens
    feature_mips (against the same frame on the CPU), _trilinear, _ssaa
    and _ssao; the ray-traced bench frame under the sky (K4 1 + 1 a
    frame, frame 0 against K4's twin); a PBR frame with env_panorama and
    env_irradiance at 320x180 against the CPU's; the tile route's
    shading kernel (``csrc/tile_shade.cu``) on both benchmark cells'
    frames (``portbench``'s programs): one launch per ``engine.render``,
    the last frame's shading against its plain twin on every value,
    timed beside its byte bound and the twin;
  * the animated frame (phase 21): ``scenes.animated_scene()`` (a
    normal-mapped floor, 64 skinned tentacles of 3 bones, 8 flip-book
    meshes, 4 morphing meshes, a 1,024-slot particle emitter, 16 meshes of
    2 LOD levels) at 1920x1080 with the normal-mapped shaders, anim_time
    stepping 1/60 s: 10 counted frames with one K1 launch each, frame 0
    against the plain path, the vertex updates and LOD mask equal to the
    CPU's on every value at 320x180 (and the LOD levels at 1080 rows), the
    frame's launches and syncs by the profiler and its
    ``frame.vertex_updates`` span's host and kernel time; its directional
    shadowed frame (512-texel map, K1 + K5 1 + 1 a frame, the light pass's
    K5 map equal to the plain fold, two poses' maps different); K1 on the
    frame's inputs and K5 on the light pass's against their twins, timed
    beside their bounds; golden feature_skinning;
  * the simulation (phase 22): bench.py config 4's coupled step
    (``scenes.coupled_step``: the collision world built in the step, the
    character controller, the frame at 1280x720) for 240 steps from
    bench.py's start (0, 3, 6), which lies outside the soup and falls
    past it, and for 60 steps from (0, 3, -3), which lands and walks on
    it; one K1 launch and 0 host syncs a step (torch.profiler), the first
    60 states of each start equal on every value to the same steps on
    the CPU with the render left out, frame 0 against the plain path;
    the crowd on the bench scene (``scenes.crowd_setup`` /
    ``crowd_step``: routing and combat) at N = 1, 8 and 32, each step's
    time, kernels, launches, syncs and rays, 240 steps at N = 32 with the
    first 30 states equal to the CPU's (rotation within 5e-7, aim 1e-6);
    the dust2 app's 256-slot spark emitter and a 1,024-slot fountain
    feeding ``particle_uniforms`` into the animated 1080p frame, 60 steps
    each, one K1 launch a frame, frame 0 against the plain path, the
    states equal to the CPU's; and 10^6 draws each of ``sim.prng``'s
    ``random_bits``, ``uniform``, ``randint`` and ``normal`` equal to the
    CPU's;
  * the Dust2 game (phase 23): ``apps.dust2.Dust2Game`` headless and
    offline from seed 0 with 7 bots and present depth 3 on bench.py's
    scripted input, at 640x400: 250 steps with 1 K1 launch each, 120 of
    them timed on the host clock; a profiled window around a shot (host
    syncs at most the present join and the shots' reads, launches,
    host->device copies); 0 host syncs in ``fused_step`` itself on its
    device inputs; the first 30 fused steps replayed on the CPU from the
    same state and inputs (states equal on every value but the bots'
    rotation and aim, within phase 22b's bounds; the aux rows equal;
    frame 0 equal to the plain path's on every pixel and against the
    CPU's by pixel share); the same game at 1920x1080; ``--kbuffer 4``
    (K2 launches equal to the plain path's live peel passes) and
    ``--raytrace 24`` (1 + 1 K4 a step) against their plain paths; and a
    checkpoint replayed on the card equal on every value;
  * the capacity caps, shade_rate, split screen, picture-in-picture,
    render to texture and the game's --mirror --burn-hud --record (phase
    24): ``scripts/profile_lod.py``'s crowd at 3840x2160 uncapped, at
    ``lod.suggested_active_cap``, at the script's ladder of active, pair,
    global and geom caps and with an active_cap at half its valid slots
    (1 K1 a frame; the capped frames equal to the uncapped one with every
    counter 0 and no host sync added; the overflowing frame equal to its
    plain path, its counter the CPU's; K1 on the compacted lists against
    its twin; the ladder on the deferred route, 1 K5 a frame, and on the
    K-buffer, 1 + 1 K1 and K2, each equal to its uncapped frame); at
    1920x1080 the bench frame at shade_rate=2, two-view
    split screen, picture-in-picture and a 256x256 render-to-texture pass,
    each equal to its plain path (the atlas to the CPU's write); and the
    game of phase 23 with the three flags (2 K1 a step, 0 syncs in
    fused_step, the first steps equal to the CPU's, every recorded frame
    the frame presented);
  * the multi-device layer (phase 25, ``parallel``): K1, K2 and K5 with a
    tile origin map against their twins and against the unmapped kernels'
    whole frame, for every band of 4 and 8 contiguous bands, a permuted
    tile-row map and a tile map, and the mapped K1 and K2 timed beside the
    unmapped ones; a one-rank NCCL group (mesh (1, 1)) whose sharded bench
    frame equals Engine.render's; and four ranks spawned on the card under
    gloo (the kernels built first, here) rendering the meshes (4, 1),
    (2, 2) and (1, 4) at 1080p, config 5 at 4K on (2, 2) and (1, 4),
    balanced rows and tiles (and tiles on the deferred route), the
    K-buffer over contiguous and balanced-row bands, the ring at n = 4 on
    both frames, four views and ray-traced bands, each 0 values off its
    single-card frame on every rank (over NCCL too with four cards);
  * the model viewer (phase 26, ``apps.viewer.Viewer`` headless at
    1920x1080): the native asset library built from
    ``native/srt_native.cpp`` with g++ and used, its bakers equal to
    ``io_host.hostops``'s numpy forms, a 262,144-triangle FBX loaded
    equal with and without it; the FBX sphere (``--lod``), a 65,280-
    triangle 3DS sphere and the cube fixtures (.dae, .fbx, .3ds): frame 0
    with 1 K1 launch, 0 pixels off the same step through K1's twin and
    within 0.1 % of ``Viewer(device="cpu")``'s frame, 29 timed frames of
    1 K1 each, launches, host syncs and kernel time a frame; 'g' on the
    spheres at ``--rt-cap 24`` and ``8 24`` (1 + 1 K4 a frame, 0 pixels
    off K4's twin); 'f' through the wireframe, overdraw and depth views
    of the fixtures against the CPU's; F10's GLB, ``--record``'s AVI and
    ``python -m softwarerenderer_tpu_torch.apps.viewer`` in a subprocess;
  * the rest of the JAX package's public API and its 19 demos (phase 27):
    ``utils.profiling``'s ``timed_frames`` on the bench frame, ``hard_sync``
    raising ``DeviceSyncTimeout`` behind a 2 s spin kernel, the watchdog
    in a subprocess, ``trace`` holding K1 and an ``annotate`` span;
    ``rt_accel``'s bundle counters on the ray-traced bench frame's casts
    against the CPU and the casts' listed pairs; then every demo of
    ``softwarerenderer_tpu_torch.examples`` on the card (multichip_render
    a one-rank NCCL group), its launches of each kernel exactly as
    expected, each image it writes within 0.1 % of pixels of the same
    demo run on the CPU in a process alongside.

Any failed check raises and exits non-zero.  The last three lines of
standard output are the card's name and power limit, a JSON line with the
kernels' numbers, and ``{"ok": true, "device": {...}}``.

Needs a CUDA device: without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
FRAMES = 30
KERNEL_RUNS = 20
PLAIN_RUNS = 10
# Once a process has traced for a while, the profiler loses the first
# device records of a trace (the kernels of about two calls; PERF.md §7),
# so a trace opens with this many seconds of calls it throws away.
TRACE_LEAD_IN_S = 0.02
# Now and then it loses a record later in a trace too: device_ms takes a
# trace again, up to this many in all, until one holds every launch.
TRACE_TRIES = 3
# device_ms's traces, and those it took again.
TRACES = {"taken": 0, "retaken": 0}
GBUF_ATOL = 1e-5           # G-buffer, kernel vs plain
# Kernel and plain twin round every operation once (-fmad=false), so best_i
# and best_d must be equal on every pixel.  A frame may differ from the
# plain path's on at most this share of its covered pixels (differences on
# background pixels count against it too).
FRAME_COVERED_MISMATCH_MAX = 1e-4
KBUFFER = 4
# Registers a thread of K1, K2 and K5 may use: 4, 3 and 4 blocks of 256
# threads an SM; K1, K2 and K5 with a tile origin map (K1m, K2m, K5m) 3.
TILE_REGISTERS = {"K1": 64, "K2": 80, "K5": 64, "K1m": 80, "K2m": 80,
                  "K5m": 80}
# Phase 3's other tilings of the bench frame: a tile smaller than a block
# of 1,024 pixels, one of three whole blocks, one with a ragged last block
# and one whose width does not divide 256 (the kernel's other pixel layout).
EXTRA_TILINGS = ((8, 64), (24, 128), (20, 128), (24, 96))
# A K-buffer frame must have a live second layer on more than this share of
# its pixels, or the translucency the peel exists for is not exercised.
LIVE_SECOND_LAYER_MIN = 0.01
RT_CAP = 24                # the game's --raytrace CAP (bench.py's row)
RT_PLAIN_RUNS = 3          # the sweep's plain twin at 1080p is slow
RT_BRUTE_SIZE = (320, 180)
SMALL_ROUTES_SIZE = (320, 180)   # phase 16: brute routes cost T x H x W
# The least time the card could take (NVIDIA's H100 SXM data sheet, dense,
# at its 700 W limit): FP32 outside the tensor cores and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations of one test, per-triangle terms hoisted: a tile fold's
# (triangle, pixel) test is 3 edge functions of 5 and a depth of 8
# (tile_common.cuh:Row); a sweep's (ray, triangle) Möller–Trumbore
# test is 46 (csrc/rt_sweep.cu).  Comparisons are not counted.
FOLD_OPS = 23
MT_OPS = 46
# Phase 14's part lengths of K5, timed in turns: no split (part (a) of the
# design alone), then lists cut into parts of this many triangles.
K5_PART_LENS = (2 ** 31 - 1, 512, 256, 128, 64)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int) -> float:
    """Median milliseconds of fn() over `runs` runs, timed with CUDA events
    around each run after one warm-up."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_events(fn, runs: int) -> list:
    """The device kernels of `runs` back-to-back calls of fn(), traced by
    torch.profiler after one warm-up, as chrome-trace events (name, dur
    in microseconds).  The trace opens with TRACE_LEAD_IN_S of calls and a
    marker kernel (torch.cuda._sleep's spin_kernel); only what runs after
    the marker is returned."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < TRACE_LEAD_IN_S:
            fn()
        torch.cuda._sleep(1)
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f).get("traceEvents", [])
                      if e.get("ph") == "X" and e.get("cat") == "kernel"]
    marks = [e["ts"] for e in events if "spin_kernel" in e.get("name", "")]
    check(len(marks) == 1, f"the trace kept {len(marks)} of its 1 marker")
    return [e for e in events if e["ts"] > marks[0]]


def frame_kernel_ms(fn, runs: int) -> dict:
    """Device milliseconds a call of fn() spends in all its kernels, in
    K1 (tile_raster_kernel), in K4 (rt_sweep_kernel, both modes) and in
    K5 (its plan and fold kernels), and the kernels it launches, means
    over `runs` profiled calls."""
    events = kernel_events(fn, runs)

    def ms(pred):
        return sum(e["dur"] for e in events if pred(e.get("name", ""))) \
            / runs * 1e-3

    return {"launches": len(events) / runs, "kernels": ms(lambda n: True),
            "K1": ms(lambda n: "tile_raster_kernel" in n),
            "K4": ms(lambda n: "rt_sweep_kernel" in n),
            "K5": ms(lambda n: "vis_fold_kernel" in n
                     or "vis_fold_plan_kernel" in n)}


def device_ms(fn, runs: int, *kernels: str) -> float:
    """Mean device milliseconds a call of fn() spends in the kernels whose
    names hold one of `kernels`, each launched once a call, over `runs`
    back-to-back calls traced by torch.profiler (kernel_events): the
    kernels alone, without the host work or the other launches of their
    wrapper.  The trace used holds exactly `runs` launches of each; one
    that lost a record is taken again, up to TRACE_TRIES traces."""
    for _ in range(TRACE_TRIES):
        TRACES["taken"] += 1
        events = kernel_events(fn, runs)
        durs = {k: [e["dur"] for e in events if k in e.get("name", "")]
                for k in kernels}
        counts = {k: len(d) for k, d in durs.items()}
        if all(n == runs for n in counts.values()):
            return sum(map(sum, durs.values())) / runs * 1e-3
        TRACES["retaken"] += 1
    check(False, f"no trace of {TRACE_TRIES} held every launch of {runs} "
          f"calls (the last: {counts})")


def edge_case_inputs(device):
    """Tile-fold inputs for a 2x8 frame of two 2x4 tiles, each triangle
    covering both whole, and the expected (best_i, best_d) on the CPU.

    Triangles 0 and 1 tie at depth -0.5 and the later id wins; 2 (the one
    global) has a NaN depth and 3 a -inf depth, and neither ever wins; 4 has
    depth -0.0 and wins against the framebuffer's +0.0 because every id is
    above the framebuffer's -1.  Tile 0 folds 0, 1, 3 over a -0.75
    framebuffer, except a nearer pixel (0, 0) that keeps -1 and a pixel
    (0, 1) at -0.5 that the tie gives to triangle 1; tile 1 folds 4, 3 over
    +0.0."""
    nan, inf = float("nan"), float("inf")
    s = [0.0, 0.0, 8.0, 0.0, 0.0, 8.0]
    depths = [-0.5, -0.5, nan, -inf, -0.0]
    setup = torch.tensor([s + [d, d, d, 1.0 / 64.0] for d in depths])
    kp = 5                          # id, screen x, screen y, 1/area, clip w
    payload = torch.tensor([[float(t), sx, sy, 1.0 / 64.0, 1.0]
                            for t in range(5)
                            for sx, sy in zip(s[0::2], s[1::2])])
    payload = payload.reshape(5, 3 * kp)
    fbd = torch.full((2, 8), -0.75)
    fbd[:, 4:] = 0.0
    fbd[0, 0], fbd[0, 1] = 0.0, -0.5
    i32 = torch.int32
    args = tuple(t.to(device) for t in (
        fbd, setup, torch.tensor([2, 0, 1, 3, 4], dtype=i32),
        torch.tensor([1], dtype=i32),
        torch.tensor([0, 1, 3, 4, 3], dtype=i32),
        torch.tensor([0, 3], dtype=i32), torch.tensor([3, 2], dtype=i32),
        payload)) + ((("v0", 0, 0), ("bary", 0, 0), ("pc", 0, 1)),)
    kwargs = dict(tile_h=2, tile_w=4, kp=kp, kpi=5, sl_screen=1, sl_ia=3,
                  clip_w_off=4)
    best_i = torch.tensor([[-1, 1, 1, 1, 4, 4, 4, 4],
                           [1, 1, 1, 1, 4, 4, 4, 4]], dtype=i32)
    best_d = torch.where(best_i == 1, -0.5, 0.0)
    return args, kwargs, best_i, best_d


def peel_edge_case_inputs(device):
    """Peel-mode tile-fold inputs for a 2x12 frame of three 2x4 tiles, each
    triangle covering all three whole, and the expected (best_i, best_d)
    on the CPU.

    Triangles as in edge_case_inputs: 0 and 1 at depth -0.5, 2 (the one
    global) NaN, 3 -inf, 4 at -0.0.  Tile 0 folds 0, 1, 3 over a -0.75
    framebuffer and ties at the previous winner's depth -0.5: with
    prev_i = 1, triangle 0 (below) is admitted and 1 (equal) is pinned out;
    with prev_i = 0, 1 (above) is refused and 0 pinned out; with
    prev_i = -1 and a clear prev_d nothing is.  Tile 1 folds 4, 3 over
    +0.0: -0.0 ties +0.0, so with (+0.0, 5) triangle 4 is admitted and wins
    against the framebuffer, and with (+0.0, 3) it is refused.  Tile 2
    folds 4 with no eligible pixel (prev_i = -1 everywhere, prev_d +1.0,
    which would admit it): the tile is skipped, so it keeps -1 and its
    framebuffer depth -0.75."""
    nan, inf = float("nan"), float("inf")
    s = [0.0, 0.0, 16.0, 0.0, 0.0, 16.0]
    area = 1.0 / 256.0
    depths = [-0.5, -0.5, nan, -inf, -0.0]
    setup = torch.tensor([s + [d, d, d, area] for d in depths])
    kp = 5                          # id, screen x, screen y, 1/area, clip w
    payload = torch.tensor([[float(t), sx, sy, area, 1.0]
                            for t in range(5)
                            for sx, sy in zip(s[0::2], s[1::2])])
    payload = payload.reshape(5, 3 * kp)
    fbd = torch.full((2, 12), -0.75)
    fbd[:, 4:8] = 0.0
    clear = torch.finfo(torch.float32).min
    prev_d = torch.tensor([[-0.5, -0.5, clear, -0.5, 0.0, 0.0, 0.0, 0.0]
                           + [1.0] * 4] * 2)
    i32 = torch.int32
    prev_i = torch.tensor([[1, 0, -1, 1, 5, 3, 5, 3] + [-1] * 4] * 2,
                          dtype=i32)
    args = tuple(t.to(device) for t in (
        fbd, setup, torch.tensor([2, 0, 1, 3, 4], dtype=i32),
        torch.tensor([1], dtype=i32),
        torch.tensor([0, 1, 3, 4, 3, 4], dtype=i32),
        torch.tensor([0, 3, 5], dtype=i32),
        torch.tensor([3, 2, 1], dtype=i32),
        payload)) + ((("v0", 0, 0), ("bary", 0, 0), ("pc", 0, 1)),)
    kwargs = dict(tile_h=2, tile_w=4, kp=kp, kpi=5, sl_screen=1, sl_ia=3,
                  clip_w_off=4, prev_d=prev_d.to(device),
                  prev_i=prev_i.to(device))
    best_i = torch.tensor([[0, -1, -1, 0, 4, -1, 4, -1] + [-1] * 4] * 2,
                          dtype=i32)
    best_d = torch.where(best_i == 0, -0.5, fbd)
    best_d = torch.where(best_i == 4, -0.0, best_d)
    return args, kwargs, best_i, best_d


def split_tile_peel_inputs(device):
    """Peel-mode tile-fold inputs for a 32x256 frame of two 32x128 tiles,
    each split over four blocks of 1,024 pixels by the kernel, and the
    expected (best_i, best_d) on the CPU.

    Triangle 0 at depth -0.5 and triangle 1 at -0.25 cover both tiles
    whole, over a -0.75 framebuffer.  Tile 0's only previous winner sits in
    its last 1,024 pixels: (31, 100) with (-0.25, 1), so triangle 0 is
    admitted there and 1 pinned out.  Because that pixel makes the whole
    tile run, (2, 5) in its first 1,024 pixels and (10, 3) in its second,
    both with prev_i = -1 beside prev_d = +1.0, admit both triangles and
    the nearer one wins; (3, 7), with prev_i = -1 beside the clear depth,
    is dead like the rest of the tile, and the third 1,024 pixels hold no
    live pixel at all.  Tile 1 has no previous winner, so it is skipped
    whole although (4, 137) holds prev_d = +1.0."""
    s = [0.0, 0.0, 1024.0, 0.0, 0.0, 1024.0]
    area = 1.0 / (1024.0 * 1024.0)
    depths = [-0.5, -0.25]
    setup = torch.tensor([s + [d, d, d, area] for d in depths])
    kp = 5                          # id, screen x, screen y, 1/area, clip w
    payload = torch.tensor([[float(t), sx, sy, area, 1.0]
                            for t in range(2)
                            for sx, sy in zip(s[0::2], s[1::2])])
    payload = payload.reshape(2, 3 * kp)
    h, w = 32, 256
    fbd = torch.full((h, w), -0.75)
    i32 = torch.int32
    prev_d = torch.full((h, w), torch.finfo(torch.float32).min)
    prev_i = torch.full((h, w), -1, dtype=i32)
    prev_d[31, 100], prev_i[31, 100] = -0.25, 1
    prev_d[2, 5] = prev_d[10, 3] = prev_d[4, 137] = 1.0
    args = tuple(t.to(device) for t in (
        fbd, setup, torch.tensor([0, 1], dtype=i32),
        torch.tensor([0], dtype=i32), torch.tensor([0, 1, 0, 1], dtype=i32),
        torch.tensor([0, 2], dtype=i32), torch.tensor([2, 2], dtype=i32),
        payload)) + ((("v0", 0, 0), ("bary", 0, 0), ("pc", 0, 1)),)
    kwargs = dict(tile_h=32, tile_w=128, kp=kp, kpi=5, sl_screen=1, sl_ia=3,
                  clip_w_off=4, prev_d=prev_d.to(device),
                  prev_i=prev_i.to(device))
    best_i = torch.full((h, w), -1, dtype=i32)
    best_i[31, 100] = 0
    best_i[2, 5] = best_i[10, 3] = 1
    best_d = torch.where(best_i == 0, -0.5, fbd)
    best_d = torch.where(best_i == 1, -0.25, best_d)
    return args, kwargs, best_i, best_d


def peel_block_stats(prev_d, prev_i, tile_h, tile_w) -> dict:
    """What a peel pass's prev maps leave K2 to do, computed in PyTorch:
    the live pixels (not tile_raster.dead_pixels) inside tiles that run (a
    prev_i >= 0 somewhere), the blocks of tile_raster.BLOCK_PX pixels in
    all, and those that return early (no live pixel, or a tile that does
    not run)."""
    from softwarerenderer_tpu_torch.ops import binning, tile_raster
    tpx = tile_h * tile_w
    per_tile = binning.cdiv(tpx, tile_raster.BLOCK_PX)
    live = ~tile_raster.dead_pixels(prev_d, prev_i)
    live = binning.to_tiles(live, tile_h, tile_w).reshape(-1, tpx)
    runs = binning.to_tiles(prev_i >= 0, tile_h, tile_w).reshape(-1, tpx) \
        .any(1)
    live = live & runs[:, None]
    pad = per_tile * tile_raster.BLOCK_PX - tpx
    folds = torch.nn.functional.pad(live, (0, pad)).reshape(
        -1, per_tile, tile_raster.BLOCK_PX).any(2)
    return {"live_px": int(live.sum()), "blocks": folds.numel(),
            "early_blocks": int((~folds).sum())}


def sparse_winner_maps(prev_d, prev_i, tile_h, tile_w, part):
    """Prev maps with the live pixels of (prev_d, prev_i) but fewer
    previous winners: of every `part` consecutive pixels of a tile only
    the first winner stays, and the others become prev_i = -1 beside
    prev_d = +inf (live, admitting every fragment).  With part = the
    tile's pixels a tile keeps one winner, so K2's other blocks of that
    tile must look for it; with part = tile_raster.BLOCK_PX every block
    that had a winner keeps one of its own."""
    from softwarerenderer_tpu_torch.ops import binning
    Hp, Wp = prev_i.shape
    pi = binning.to_tiles(prev_i, tile_h, tile_w).reshape(-1, part)
    pd = binning.to_tiles(prev_d, tile_h, tile_w).reshape(-1, part)
    win = pi >= 0
    first = win & (win.cumsum(1) == 1)
    pi = torch.where(first, pi, -1)
    pd = torch.where(win & ~first, float("inf"), pd)
    return (binning.to_image(pd.reshape(-1), Hp, Wp, tile_h, tile_w)
            .contiguous(),
            binning.to_image(pi.reshape(-1), Hp, Wp, tile_h, tile_w)
            .contiguous())


def _vis_case(tris, globs, segs, fbd, tile_h, tile_w, row_offset, device):
    """vis_fold's (args, kwargs) for triangles [(screen corners, depth)]
    with constant depth, `globs` the global ids and `segs` each tile's
    segment.  1/area is 1 over the sum of the edge functions, so each
    weight is exact for the dyadic corners used here."""
    rows = []
    for (x0, y0), (x1, y1), (x2, y2), d in tris:
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        rows.append([x0, y0, x1, y1, x2, y2, d, d, d, 1.0 / area])
    i32 = torch.int32
    counts = [len(s) for s in segs]
    starts = np.cumsum([0] + counts[:-1]).tolist()
    args = tuple(t.to(device) for t in (
        fbd, torch.tensor(rows, dtype=torch.float32).reshape(-1, 10),
        torch.tensor(globs + [t for t in range(len(tris)) if t not in globs],
                     dtype=i32),
        torch.tensor([len(globs)], dtype=i32),
        torch.tensor([t for s in segs for t in s], dtype=i32),
        torch.tensor(starts, dtype=i32), torch.tensor(counts, dtype=i32)))
    # A band at row_offset: each tile's screen origin (row_offset +
    # ty * tile_h, tx * tile_w).
    nty, ntx = fbd.shape[0] // tile_h, fbd.shape[1] // tile_w
    origin = torch.tensor([[row_offset + ty * tile_h, tx * tile_w]
                           for ty in range(nty) for tx in range(ntx)],
                          dtype=i32, device=device) if row_offset else None
    return args, dict(tile_h=tile_h, tile_w=tile_w, origin=origin)


def vis_fold_edge_cases(device):
    """K5's edge cases as [(name, args, kwargs, expected best_i, expected
    best_d)], the expectations on the CPU.  Frames of 2x8 pixels are two
    2x4 tiles; "big" covers them with every weight > 0.

    -inf seed: a -inf fragment (global) takes a -inf seed, since its id
    beats -1, and a NaN one (tile 0's segment) never wins.  ties: a
    global at the seed's depth -0.5 takes tile 0 and ties a later segment
    triangle, which wins; in tile 1 a -0.0 fragment ties a +0.0 seed and a
    +0.0 fragment, wins as the later id and is written +0.0.  row_offset:
    the band starts at screen row 4 and a triangle ends at screen row 4.5,
    so only band row 0 is covered.  tile_h > 32: one 64x32 tile (two
    blocks of 1,024 pixels) where a nearer triangle covers rows 40-63.
    empty frame: no triangle, the seed everywhere."""
    big = ((-8.0, -8.0), (24.0, -8.0), (-8.0, 24.0))
    nan, inf = float("nan"), float("inf")
    clear = torch.finfo(torch.float32).min
    cases = []
    args, kw = _vis_case([big + (-inf,), big + (nan,)], [0], [[1], []],
                         torch.full((2, 8), -inf), 2, 4, 0, device)
    cases.append(("-inf seed, NaN fragment", args, kw,
                  torch.zeros((2, 8), dtype=torch.int32),
                  torch.full((2, 8), -inf)))
    fbd = torch.full((2, 8), -0.5)
    fbd[:, 4:] = 0.0
    args, kw = _vis_case([big + (-0.5,), big + (-0.5,), big + (0.0,),
                          big + (-0.0,)], [0], [[1], [2, 3]], fbd, 2, 4, 0,
                         device)
    want_i = torch.tensor([[1] * 4 + [3] * 4] * 2, dtype=torch.int32)
    cases.append(("ties at the seed, global vs segment, -0.0 vs +0.0",
                  args, kw, want_i, torch.where(want_i == 1, -0.5, 0.0)))
    strip = ((-16.0, 4.5), (48.0, 4.5), (16.0, -59.5), -0.25)
    args, kw = _vis_case([strip], [], [[0], [0]], torch.full((2, 8), clear),
                         2, 4, 4, device)
    want_i = torch.tensor([[0] * 8, [-1] * 8], dtype=torch.int32)
    cases.append(("row_offset 4", args, kw, want_i,
                  torch.where(want_i == 0, -0.25, clear)))
    whole = ((-64.0, -64.0), (192.0, -64.0), (-64.0, 192.0), -0.5)
    low = ((-16.0, 39.5), (48.0, 39.5), (16.0, 103.5), -0.25)
    args, kw = _vis_case([whole, low], [0], [[1]],
                         torch.full((64, 32), clear), 64, 32, 0, device)
    want_i = torch.zeros((64, 32), dtype=torch.int32)
    want_i[40:] = 1
    cases.append(("tile_h 64 > 32", args, kw, want_i,
                  torch.where(want_i == 1, -0.25, -0.5)))
    fbd = torch.linspace(-1.0, 0.0, 16).reshape(2, 8)
    args, kw = _vis_case([], [], [[], []], fbd, 2, 4, 0, device)
    cases.append(("empty frame", args, kw,
                  torch.full((2, 8), -1, dtype=torch.int32), fbd))
    return cases


def vis_fold_split_cases(device):
    """K5's edge cases of split lists as [(name, args, kwargs, part_len,
    expected best_i, expected best_d)], the expectations on the CPU.  A
    tile's list is its globals, then its segment; part_len cuts it.

    part ties: tile 0's list (global 0, then 1, 2, all at -0.5) in parts
    [0, 1] (a tie across the globals-segment boundary inside one part) and
    [2] (a tie between parts): 2 wins; tile 1's [0, 3] is one part: 3.
    NaN seed: a split tile whose left column is NaN keeps it (id -1, the
    seed's bits).  signed zeros: -0.0 and +0.0 in different parts, each
    order; the later id wins, written +0.0.  -inf: a -inf fragment takes a
    -inf seed in a split tile, the later of two wins their tie, a NaN
    fragment never.  P and P + 1: lists of 2 and 3 at part_len 2, the
    winner alone in the second part.  one tile: a 32x128 tile (four
    blocks) holding 300 triangles, half of them global, in five parts of
    64; expected from the plain twin."""
    from softwarerenderer_tpu_torch.ops import vis_fold
    big = ((-8.0, -8.0), (24.0, -8.0), (-8.0, 24.0))
    nan, inf = float("nan"), float("inf")
    clear = torch.finfo(torch.float32).min
    i32 = torch.int32
    cases = []

    def halves(a, b):
        return torch.tensor([[a] * 4 + [b] * 4] * 2, dtype=i32)

    args, kw = _vis_case([big + (-0.5,)] * 4, [0], [[1, 2], [3]],
                         torch.full((2, 8), clear), 2, 4, 0, device)
    cases.append(("ties between parts and across the lists in one part",
                  args, kw, 2, halves(2, 3), torch.full((2, 8), -0.5)))
    fbd = torch.full((2, 8), clear)
    fbd[:, 0] = nan
    args, kw = _vis_case([big + (-0.75,), big + (-0.5,)], [], [[0, 1], [0]],
                         fbd, 2, 4, 0, device)
    want_i = halves(1, 0)
    want_i[:, 0] = -1
    want_d = torch.where(want_i == 1, -0.5, -0.75)
    want_d[:, 0] = nan
    cases.append(("NaN seed in a split tile", args, kw, 1, want_i, want_d))
    args, kw = _vis_case([big + (-0.0,), big + (0.0,), big + (0.0,),
                          big + (-0.0,)], [], [[0, 1], [2, 3]],
                         torch.full((2, 8), -0.5), 2, 4, 0, device)
    cases.append(("-0.0 and +0.0 in different parts", args, kw, 1,
                  halves(1, 3), torch.zeros((2, 8))))
    args, kw = _vis_case([big + (-inf,), big + (nan,), big + (-inf,)], [],
                         [[0, 1], [0, 2]], torch.full((2, 8), -inf), 2, 4,
                         0, device)
    cases.append(("a -inf seed and -inf fragments in split tiles", args, kw,
                  1, halves(0, 2), torch.full((2, 8), -inf)))
    args, kw = _vis_case([big + (-0.75,), big + (-0.5,), big + (-0.5,),
                          big + (-0.75,), big + (-0.25,)], [],
                         [[0, 1], [2, 3, 4]], torch.full((2, 8), clear), 2,
                         4, 0, device)
    cases.append(("lists of exactly P and P + 1 entries", args, kw, 2,
                  halves(1, 4), torch.where(halves(1, 4) == 1, -0.5, -0.25)))
    rng = np.random.default_rng(7)
    tris = []
    for _ in range(300):
        c = rng.uniform(-8.0, 136.0, (3, 2)).round()
        tris.append(tuple(map(tuple, c)) + (float(rng.uniform(-1.0, 0.0)),))
    fbd = torch.full((32, 128), clear)
    fbd[:8] = -0.5
    args, kw = _vis_case(tris, list(range(0, 300, 2)),
                         [list(range(1, 300, 2))], fbd, 32, 128, 0, "cpu")
    want_d, want_i = vis_fold.visibility_fold_plain(*args, **kw)
    args = tuple(a.to(device) for a in args)
    cases.append(("one tile holding every triangle", args, kw, 64, want_i,
                  want_d))
    return cases


def nbytes(*values) -> int:
    """Bytes of every tensor among values (other values count 0)."""
    return sum(v.numel() * v.element_size() for v in values
               if isinstance(v, torch.Tensor))


def bound(n_bytes: int, ops: float) -> dict:
    """bound_ms, the larger of the bytes over the memory rate and the
    operations over the FP32 rate, and which of the two it is."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_FP32 * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def fold_bound(args, kwargs, outputs) -> dict:
    """Bound of one tile fold (K1, K2, K3, K5) on these inputs: each tile
    that folds at all (in peel mode, a tile with an eligible pixel) tests
    its binned triangles and the globals against each of its pixels; every
    input is read once and every output written once."""
    n_global, counts = args[3], args[6]
    th, tw = kwargs["tile_h"], kwargs["tile_w"]
    folds = torch.ones_like(counts, dtype=torch.bool)
    if kwargs.get("prev_i") is not None:
        pi = kwargs["prev_i"]
        folds = (pi >= 0).reshape(pi.shape[0] // th, th, pi.shape[1] // tw,
                                  tw).any(3).any(1).reshape(-1)
    tests = (int(counts[folds].sum()) + int(n_global[0]) * int(folds.sum())) \
        * th * tw
    out = bound(nbytes(*args, *kwargs.values(), *outputs), tests * FOLD_OPS)
    out["tests"] = tests
    return out


def sweep_bound(args, outputs, swept) -> dict:
    """Bound of one K4 sweep on these inputs: each (ray, live slot) test of
    every cluster the kernel swept before its early exit (`swept`, per
    bundle and group of rays; each bundle's listed clusters counted at
    their mean live slots); every input read once, every output written
    once."""
    from softwarerenderer_tpu_torch.ops import rt_sweep
    rays, stream, lists, counts, t0q = args
    live = (stream[10] > 0).reshape(-1, rt_sweep.GROUP).sum(1).to(torch.float64)
    capb = lists.shape[1]
    listed = torch.arange(capb, device=lists.device)[None] \
        < counts.clamp(max=capb)[:, None]
    per = torch.where(listed, live[lists.long()], 0.0).sum(1) \
        / counts.clamp(min=1, max=capb)
    group = min(rays.shape[2], rt_sweep.GROUP_RAYS)
    tests = float((swept.to(torch.float64) * per).sum()) * group
    out = bound(nbytes(*args, *outputs), tests * MT_OPS)
    out["tests"] = tests
    return out


def sweep_bound_tested(args, outputs, tested) -> dict:
    """sweep_bound on the work the kernel kept: each (ray, live slot) test
    of the (part, cluster) pairs whose slots it tested (`tested`, per
    bundle), the clusters a part skipped left out.  This is the bound of
    the `kernels` line; sweep_bound, which counts every cluster up to the
    bundle's own early exit, stays beside it as the earlier yardstick."""
    from softwarerenderer_tpu_torch.ops import rt_sweep
    rays, stream, lists, counts, t0q = args
    live = (stream[10] > 0).reshape(-1, rt_sweep.GROUP).sum(1).to(torch.float64)
    capb = lists.shape[1]
    listed = torch.arange(capb, device=lists.device)[None] \
        < counts.clamp(max=capb)[:, None]
    per = torch.where(listed, live[lists.long()], 0.0).sum(1) \
        / counts.clamp(min=1, max=capb)
    part = min(rays.shape[2], rt_sweep.PART_RAYS)
    tests = float((tested.to(torch.float64) * per).sum()) * part
    out = bound(nbytes(*args, *outputs), tests * MT_OPS)
    out["tests"] = tests
    return out


def report_ptxas(output: str) -> None:
    """Print ptxas's registers, spills and shared memory per kernel
    instantiation; fail on a spill."""
    names = {"tile_raster_kernelILb0ELb1ELb0E":
             "K1 tile_raster_kernel<opaque, one column a thread>",
             "tile_raster_kernelILb0ELb0ELb0E": "K1 tile_raster_kernel<opaque>",
             "tile_raster_kernelILb1ELb0ELb0E": "K2 tile_raster_kernel<peel>",
             "tile_raster_kernelILb0ELb1ELb1E":
             "K1m tile_raster_kernel<opaque, one column a thread, mapped>",
             "tile_raster_kernelILb0ELb0ELb1E":
             "K1m tile_raster_kernel<opaque, mapped>",
             "tile_raster_kernelILb1ELb0ELb1E":
             "K2m tile_raster_kernel<peel, mapped>",
             "vis_fold_kernelILb1ELb0E": "K5 vis_fold_kernel<one column a "
                                         "thread>",
             "vis_fold_kernelILb0ELb0E": "K5 vis_fold_kernel",
             "vis_fold_kernelILb1ELb1E": "K5m vis_fold_kernel<one column a "
                                         "thread, mapped>",
             "vis_fold_kernelILb0ELb1E": "K5m vis_fold_kernel<mapped>",
             "sky_kernelILb1E": "post sky_kernel<uint8 panorama>",
             "sky_kernelILb0E": "post sky_kernel<float32 panorama>",
             "ssao_kernel": "post ssao_kernel",
             "bloom_kernel": "post bloom_kernel",
             "tonemap_kernel": "post tonemap_kernel",
             "fxaa_kernel": "post fxaa_kernel",
             "tile_shade_kernelILi0E":
             "shade tile_shade_kernel<nearest_region>",
             "tile_shade_kernelILi1E":
             "shade tile_shade_kernel<trilinear_regions>"}
    fn = "?"
    for line in output.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            fn = next((v for k, v in names.items() if k in mangled), mangled)
            if "tile_kdeep_kernelILi" in mangled:
                k, column = mangled.split("tile_kdeep_kernelILi")[1] \
                    .split("ELb")
                column = ", one column a thread" if column[0] == "1" else ""
                fn = f"K3 tile_kdeep_kernel<{k}{column}>"
            if "rt_sweep_kernelILb" in mangled:
                mode = mangled.split("rt_sweep_kernelILb")[1][0]
                fn = (f"K4 rt_sweep_kernel<"
                      f"{'any-hit' if mode == '1' else 'nearest'}>")
        elif "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas {fn}: {line.strip()}")
            check(" 0 bytes spill stores" in line or "spill" not in line,
                  f"{fn} spills: {line.strip()}")
            if fn.startswith(("K1", "K2", "K5")) and "Used " in line:
                regs = int(line.split("Used ")[1].split()[0])
                most = TILE_REGISTERS[fn.split()[0]]
                check(regs <= most, f"{fn} uses {regs} registers, more "
                      f"than {most}")


def capture_folds(render, fold):
    """Run render(wrapper), where wrapper calls fold, and return its
    result and [(args, kwargs, outputs)] of every fold call, in order."""
    calls = []

    def wrapper(*args, **kwargs):
        out = fold(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    return render(wrapper), calls


def check_peel_kernel(card, device, size) -> dict:
    """Phase 6: K2 against its plain twin on passes 1-3 of two 1080p
    frames: the bench scene with the short-circuit off (a dense peel) and
    the translucent scene; times each pass of the translucent frame that
    ran, beside its bound.  Returns the K2 timing (dense pass 1), its
    largest difference and each frame's pass-0 fold inputs."""
    from softwarerenderer_tpu_torch import RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import Engine, render_frame
    from softwarerenderer_tpu_torch.ops import tile_raster
    from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR
    w, h = size
    inputs = {
        "dense": (scenes.bench_scene(),
                  RenderParams(w, h, kbuffer=KBUFFER,
                               kbuffer_short_circuit=False)),
        "translucent": (scenes.translucent_scene(),
                        RenderParams(w, h, kbuffer=KBUFFER, cull_mode=0))}
    out = {"max_abs_err": 0.0}
    for name, (scene, params) in inputs.items():
        eng = Engine(scene, params, device=device)
        u = scenes.camera_uniforms(eng.uniforms, 0)
        _, calls = capture_folds(
            lambda f: render_frame(eng.scene, u, params, fold=f),
            tile_raster.tile_fold)
        args, kwargs, _ = calls[0]
        out[f"{name}_pass0"] = (args, kwargs)
        for k in range(1, KBUFFER):
            if k < len(calls):
                pkw = calls[k][1]
                ran = "ran"
            else:
                # The frame stopped peeling before pass k: every previous
                # winner was stopped, so its prev maps are the clear ones.
                Hp, Wp = args[0].shape
                pkw = dict(kwargs, prev_d=torch.full(
                    (Hp, Wp), DEPTH_CLEAR, device=args[0].device),
                    prev_i=torch.full((Hp, Wp), -1, dtype=torch.int32,
                                      device=args[0].device))
                ran = "skipped by the frame (no eligible pixel)"
            kg, kd, ki = tile_raster.tile_fold(*args, **pkw)
            pg, pd, pi = tile_raster.tile_fold_plain(*args, **pkw)
            eligible = int((pkw["prev_i"][:h, :w] >= 0).sum())
            covered = int((ki[:h, :w] >= 0).sum())
            diff_i = int((ki != pi).sum())
            diff_d = int((kd != pd).sum())
            g_err = (kg - pg).abs().max().item()
            live = kd[ki >= 0]
            d_err = (live - pd[ki >= 0]).abs().max().item() \
                if live.numel() else 0.0
            out["max_abs_err"] = max(out["max_abs_err"], g_err, d_err)
            log(f"phase 6 K2 {name} pass {k} ({ran}) @{w}x{h}: "
                f"{eligible} eligible, {covered} covered pixels; best_i "
                f"differs on {diff_i}, best_d on {diff_d} pixels; G-buffer "
                f"max abs diff {g_err:.3g}")
            check(diff_i == 0, f"K2 {name} pass {k} best_i differs on "
                  f"{diff_i} pixels")
            check(diff_d == 0, f"K2 {name} pass {k} best_d differs on "
                  f"{diff_d} pixels")
            check(g_err <= GBUF_ATOL, f"K2 {name} pass {k} G-buffer {g_err}")
            if name == "dense" and k == 1:
                check(covered > 0.05 * w * h,
                      f"dense pass 1 covers only {covered} pixels")
                out["ms"] = cuda_ms(
                    lambda: tile_raster.tile_fold(*args, **pkw),
                    KERNEL_RUNS)
                out["plain_ms"] = cuda_ms(
                    lambda: tile_raster.tile_fold_plain(*args, **pkw),
                    PLAIN_RUNS)
                out.update(fold_bound(args, pkw, (kg, kd, ki)))
                st = peel_block_stats(pkw["prev_d"], pkw["prev_i"],
                                      pkw["tile_h"], pkw["tile_w"])
                log(f"phase 6 K2 dense pass 1: {st['live_px']} live "
                    f"pixels, {st['early_blocks']} of {st['blocks']} blocks "
                    f"return early; kernel {out['ms']:.3f} ms "
                    f"(median of {KERNEL_RUNS}), plain "
                    f"{out['plain_ms']:.3f} ms (median of {PLAIN_RUNS}); "
                    f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}, "
                    f"{out['tests']} tests) [{card}]")
            if name == "translucent" and ran == "ran":
                ms = cuda_ms(lambda: tile_raster.tile_fold(*args, **pkw),
                             KERNEL_RUNS)
                b = fold_bound(args, pkw, (kg, kd, ki))
                st = peel_block_stats(pkw["prev_d"], pkw["prev_i"],
                                      pkw["tile_h"], pkw["tile_w"])
                log(f"phase 6 K2 translucent pass {k}: {st['live_px']} live "
                    f"pixels, {st['early_blocks']} of {st['blocks']} blocks "
                    f"return early; kernel {ms:.3f} ms (median of "
                    f"{KERNEL_RUNS}); bound {b['bound_ms']:.4f} ms "
                    f"({b['bound_by']}, {b['tests']} tests) [{card}]")
                out[f"translucent_pass{k}_ms"] = ms
            if name == "translucent" and k == 1:
                # What finding the tile's run flag costs: the same live
                # pixels with one previous winner a tile (blocks without
                # it read the rest of their tile's prev_i) against one a
                # block (no block does).
                th, tw = pkw["tile_h"], pkw["tile_w"]
                times = {}
                for what, part in (("tile", th * tw),
                                   ("block", tile_raster.BLOCK_PX)):
                    sd, si = sparse_winner_maps(pkw["prev_d"], pkw["prev_i"],
                                                th, tw, part)
                    skw = dict(pkw, prev_d=sd, prev_i=si)
                    a = tile_raster.tile_fold(*args, **skw)
                    b = tile_raster.tile_fold_plain(*args, **skw)
                    n = int((a[2] != b[2]).sum()) + int((a[1] != b[1]).sum())
                    check(n == 0, f"K2 with one winner a {what} differs "
                          f"from its twin on {n} values")
                    times[what] = cuda_ms(
                        lambda: tile_raster.tile_fold(*args, **skw),
                        KERNEL_RUNS)
                log(f"phase 6 K2 run flag: translucent pass 1's live pixels "
                    f"with one previous winner a tile {times['tile']:.3f} "
                    f"ms, with one a block {times['block']:.3f} ms (medians "
                    f"of {KERNEL_RUNS}; both equal the twin) [{card}]")

    # Ties at the previous winner's depth, -0.0 against +0.0 and a tile
    # with no eligible pixel; then a tile split over four blocks whose only
    # previous winner is in the last one.  Both on the card.
    for case, inputs in (("peel", peel_edge_case_inputs),
                         ("split-tile peel", split_tile_peel_inputs)):
        e_args, e_kwargs, e_best_i, e_best_d = inputs(device)
        kernel = tile_raster.tile_fold(*e_args, **e_kwargs)
        plain = tile_raster.tile_fold_plain(*e_args, **e_kwargs)
        for name, (g, d, i) in (("kernel", kernel), ("plain", plain)):
            wrong = (i.cpu() != e_best_i) | (d.cpu() != e_best_d)
            check(not bool(wrong.any()),
                  f"{case} edge case {name}: wrong at "
                  f"{torch.nonzero(wrong)[:8].tolist()}")
        check(torch.equal(kernel[0], plain[0]), f"{case} edge case G-buffer")
    log("phase 6 K2 edge cases (ties below, at and above the previous "
        "winner, -0.0, a tile with no eligible pixel; a tile split over "
        "four blocks with its only previous winner in the last, a live "
        "pixel without one in the first two, a block with none, a tile "
        "skipped whole): kernel and plain equal the expected winners")
    return out


def check_kdeep_kernel(card, dense_pass0, translucent_pass0,
                       tilings=()) -> dict:
    """Phase 7: K3 at K=4 against its plain twin on the dense frame's
    fold inputs: every layer's winners and depths equal, G-buffers within
    GBUF_ATOL; then on the translucent frame's (its main path), equal and
    timed beside its bound; then on `tilings`, [(tile_h, tile_w, args,
    kwargs)] of the dense frame's scene at other tilings, against the twin
    and against the 32x128 frame's slots."""
    from softwarerenderer_tpu_torch.ops import tile_raster
    t_args, t_kwargs = translucent_pass0
    t_out = tile_raster.tile_fold_kdeep(*t_args, **t_kwargs, K=KBUFFER)
    t_plain = tile_raster.tile_fold_kdeep_plain(*t_args, **t_kwargs,
                                                K=KBUFFER)
    check(all(torch.equal(a, b) for a, b in zip(t_out[1:], t_plain[1:])),
          "K3 translucent winners differ from the twin's")
    t_ms = cuda_ms(lambda: tile_raster.tile_fold_kdeep(
        *t_args, **t_kwargs, K=KBUFFER), KERNEL_RUNS)
    t_b = fold_bound(t_args, t_kwargs, t_out)
    log(f"phase 7 K3 K={KBUFFER} translucent frame: winners and depths "
        f"equal the twin's; kernel {t_ms:.3f} ms (median of {KERNEL_RUNS}); "
        f"bound {t_b['bound_ms']:.4f} ms ({t_b['bound_by']}, "
        f"{t_b['tests']} tests) [{card}]")
    args, kwargs = dense_pass0
    kg, kd, ki = tile_raster.tile_fold_kdeep(*args, **kwargs, K=KBUFFER)
    pg, pd, pi = tile_raster.tile_fold_kdeep_plain(*args, **kwargs,
                                                   K=KBUFFER)
    per_layer = [int((ki[s] >= 0).sum()) for s in range(KBUFFER)]
    diff_i = int((ki != pi).sum())
    diff_d = int((kd != pd).sum())
    g_err = (kg - pg).abs().max().item()
    live = ki >= 0
    d_err = (kd[live] - pd[live]).abs().max().item()
    ms = cuda_ms(lambda: tile_raster.tile_fold_kdeep(*args, **kwargs,
                                                     K=KBUFFER), KERNEL_RUNS)
    plain_ms = cuda_ms(lambda: tile_raster.tile_fold_kdeep_plain(
        *args, **kwargs, K=KBUFFER), PLAIN_RUNS)
    Hp, Wp = args[0].shape
    b = fold_bound(args, kwargs, (kg, kd, ki))
    log(f"phase 7 K3 K={KBUFFER} bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}, {b['tests']} tests) [{card}]")
    log(f"phase 7 K3 K={KBUFFER} vs plain @{Wp}x{Hp} padded: covered "
        f"pixels per layer {per_layer}; best_i differs on {diff_i}, best_d "
        f"on {diff_d} of {ki.numel()} slots; G-buffer max abs diff "
        f"{g_err:.3g}; kernel {ms:.3f} ms (median of {KERNEL_RUNS}), plain "
        f"{plain_ms:.3f} ms (median of {PLAIN_RUNS}) [{card}]")
    check(diff_i == 0, f"K3 best_i differs on {diff_i} slots")
    check(diff_d == 0, f"K3 best_d differs on {diff_d} slots")
    check(g_err <= GBUF_ATOL, f"K3 G-buffer diff {g_err}")
    check(per_layer[1] > 0, "K3 found no second layer")
    for th, tw, x_args, x_kwargs in tilings:
        h, w = min(Hp, x_args[0].shape[0]), min(Wp, x_args[0].shape[1])
        xg, xd, xi = tile_raster.tile_fold_kdeep(*x_args, **x_kwargs,
                                                 K=KBUFFER)
        qg, qd, qi = tile_raster.tile_fold_kdeep_plain(*x_args, **x_kwargs,
                                                       K=KBUFFER)
        n_i, n_d = int((xi != qi).sum()), int((xd != qd).sum())
        x_err = (xg - qg).abs().max().item()
        same_i = int((xi[:, :h, :w] != ki[:, :h, :w]).sum())
        same_d = int((xd[:, :h, :w] != kd[:, :h, :w]).sum())
        x_ms = cuda_ms(lambda: tile_raster.tile_fold_kdeep(
            *x_args, **x_kwargs, K=KBUFFER), KERNEL_RUNS)
        log(f"phase 7 K3 K={KBUFFER} at {th}x{tw} tiles "
            f"({x_args[6].numel()} tiles): kernel vs plain best_i differs "
            f"on {n_i}, best_d on {n_d} slots, G-buffer max abs diff "
            f"{x_err:.3g}; vs the 32x128 frame best_i differs on {same_i}, "
            f"best_d on {same_d} slots; kernel {x_ms:.3f} ms [{card}]")
        check(n_i == 0 and n_d == 0 and x_err <= GBUF_ATOL,
              f"K3 at {th}x{tw} tiles differs from its twin")
        check(same_i == 0 and same_d == 0,
              f"K3 at {th}x{tw} tiles differs from the 32x128 frame")
    return dict(b, max_abs_err=max(g_err, d_err), ms=ms, plain_ms=plain_ms)


def _sync_events(fn) -> int:
    """Synchronize calls in a torch.profiler trace of fn() and a closing
    torch.cuda.synchronize()."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if "Synchronize" in e.key)


def host_syncs(fn, frames: int) -> float:
    """Host synchronisations per call of fn(i), counted by torch.profiler
    over `frames` calls, less an empty trace's count (the closing
    synchronize and the profiler's own)."""
    def calls():
        for i in range(frames):
            fn(i)
    return (_sync_events(calls) - _sync_events(lambda: None)) / frames


def check_kbuffer_frames(card, device, size, frames) -> dict:
    """Phase 8: the K-buffer main path.  30 frames of the translucent
    scene through Engine (K1 once and K2 once per live pass in every
    frame), frame 0 against the plain twins' frame, and 30 frames of the
    same scene through the single-pass route (K3 once per frame) against
    the peel route's images.  Returns the launch counts."""
    from softwarerenderer_tpu_torch import RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import (Engine, frame_setup,
                                                   render_frame,
                                                   scene_fragment_shader,
                                                   to_rgb8)
    from softwarerenderer_tpu_torch.ops import tile_raster
    from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR
    w, h = size
    params = RenderParams(w, h, kbuffer=KBUFFER, cull_mode=0)
    eng = Engine(scenes.translucent_scene(), params, device=device)

    def u_at(i):
        return scenes.camera_uniforms(eng.uniforms, i)

    # Frame 0's passes, through the kernels and through the plain twins.
    _, calls = capture_folds(lambda f: render_frame(
        eng.scene, u_at(0), params, fold=f), tile_raster.tile_fold)
    second = float((calls[1][2][2][:h, :w] >= 0).float().mean()) \
        if len(calls) > 1 else 0.0
    (plain_color, plain_depth), plain_calls = capture_folds(
        lambda f: render_frame(eng.scene, u_at(0), params, fold=f),
        tile_raster.tile_fold_plain)
    per_pass = [int((c[2][2][:h, :w] >= 0).sum()) for c in calls]
    log(f"phase 8 K-buffer frame 0 @{w}x{h}: {len(calls)} passes, covered "
        f"pixels per pass {per_pass}, live second layer on {second:.4f} of "
        f"the frame; the plain path ran {len(plain_calls)} passes")
    check(second > LIVE_SECOND_LAYER_MIN,
          f"live second layer on only {second:.4f} of the pixels")

    # The main path, counted per frame.
    tile_raster.LAUNCHES = tile_raster.PEEL_LAUNCHES = 0
    frame_ms, k1, k2, finite = [], [], [], True
    for i in range(frames):
        l1, l2 = tile_raster.LAUNCHES, tile_raster.PEEL_LAUNCHES
        t = time.perf_counter()
        color, depth = eng.render(u_at(i))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
        k1.append(tile_raster.LAUNCHES - l1)
        k2.append(tile_raster.PEEL_LAUNCHES - l2)
        finite &= bool(torch.isfinite(color).all()
                       and torch.isfinite(depth).all())
        check(color.shape == (h, w, 4) and depth.shape == (h, w),
              f"frame shapes {tuple(color.shape)} {tuple(depth.shape)}")
        if i == 0:
            first, first_depth = color, depth
    peel_launches = tile_raster.PEEL_LAUNCHES
    check(finite, "non-finite K-buffer output")
    check(all(n == 1 for n in k1), f"K1 launches per frame {k1}")
    check(all(1 <= n <= KBUFFER - 1 for n in k2),
          f"K2 launches per frame {k2}")
    check(k2[0] == len(calls) - 1 == len(plain_calls) - 1,
          f"frame 0: {k2[0]} K2 launches, {len(calls) - 1} peel passes, "
          f"{len(plain_calls) - 1} on the plain path")
    syncs = host_syncs(lambda i: eng.render(u_at(i)), 3)
    n_cov = int(((first_depth != DEPTH_CLEAR)
                 | (plain_depth != DEPTH_CLEAR)).sum())
    n_diff = int(((first - plain_color).abs().amax(-1) > 1e-5).sum())
    n_diff_d = int((first_depth != plain_depth).sum())
    rgb = eng.present(u_at(0))
    n_diff_rgb = int((rgb != to_rgb8(plain_color).cpu().numpy())
                     .any(-1).sum())
    steady = statistics.median(frame_ms[1:])
    log(f"phase 8 K-buffer main path @{w}x{h}, K={KBUFFER}: {frames} "
        f"frames, K1 launches {sum(k1)}, K2 launches {peel_launches} "
        f"(per frame {min(k2)}-{max(k2)}), {syncs:.1f} host syncs per "
        f"frame, first frame {frame_ms[0]:.1f} ms, median frame "
        f"{steady:.3f} ms; frame 0 vs plain path: of {n_cov} covered "
        f"pixels, {n_diff} differ > 1e-5 in color, {n_diff_d} in depth, "
        f"{n_diff_rgb} in present [{card}]")
    limit = FRAME_COVERED_MISMATCH_MAX * n_cov
    check(n_diff <= limit, f"K-buffer frame 0 color differs on {n_diff}")
    check(n_diff_d <= limit, f"K-buffer frame 0 depth differs on {n_diff_d}")
    check(n_diff_rgb <= limit, f"K-buffer present differs on {n_diff_rgb}")

    # The single-pass route over the same frames, counted.
    def single(i):
        f = frame_setup(eng.scene, u_at(i), params)
        return tile_raster.render_tile_kbuffer_single(
            f["tris"], scene_fragment_shader, f["uniforms"], params,
            f["fb_color"], f["fb_depth"], per_tri_extra=f["per_tri"])

    tile_raster.KDEEP_LAUNCHES = 0
    single_ms = []
    for i in range(frames):
        t = time.perf_counter()
        color3, depth3 = single(i)
        torch.cuda.synchronize()
        single_ms.append((time.perf_counter() - t) * 1e3)
        if i == 0:
            c3, d3 = color3, depth3
    kdeep_launches = tile_raster.KDEEP_LAUNCHES
    check(kdeep_launches == frames,
          f"{kdeep_launches} K3 launches for {frames} frames")
    cov = (first_depth != DEPTH_CLEAR) | (d3 != DEPTH_CLEAR)
    c_err = (c3 - first).abs().amax(-1)[cov].max().item()
    d_err = (d3 - first_depth)[cov].abs().max().item()
    log(f"phase 8 single-pass K-deep route: {frames} frames, "
        f"{kdeep_launches} K3 launches, median frame "
        f"{statistics.median(single_ms[1:]):.3f} ms (peel route "
        f"{steady:.3f} ms); frame 0 vs the peel route on {int(cov.sum())} "
        f"covered pixels: color max abs diff {c_err:.3g}, depth "
        f"{d_err:.3g} [{card}]")
    check(c_err <= 1e-5 and d_err <= 1e-5,
          f"K-deep frame 0 differs: color {c_err}, depth {d_err}")
    return {"peel_launches": peel_launches, "kdeep_launches": kdeep_launches}


def check_kbuffer_golden(device) -> None:
    """Phase 9: feature_kbuffer.png through the kernels, under
    tests/test_goldens.py's rule."""
    from PIL import Image
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.engine import Engine
    scene, params, u = scenes.kbuffer_golden_frame()
    got = Engine(scene, params, device=device).present(u).astype(np.int32)
    golden = np.asarray(Image.open(os.path.join(
        REPO, "tests", "goldens", "feature_kbuffer.png"))).astype(np.int32)
    diff = np.abs(got - golden)
    off = float(np.mean(np.any(diff > 2, axis=-1)))
    log(f"phase 9 golden feature_kbuffer {params.width}x{params.height}: "
        f"{off:.6f} of pixels off by > 2, mean diff {diff.mean():.4f}")
    check(got.shape == golden.shape and off < 2e-3,
          "golden feature_kbuffer")


def _k4_world(tris, device):
    """A collision world of (T, 3, 3) corners with +z normals."""
    t = torch.as_tensor(np.asarray(tris, np.float32), device=device)
    n = torch.zeros_like(t[:, 0])
    n[:, 2] = 1.0
    return {"v0": t[:, 0], "v1": t[:, 1], "v2": t[:, 2], "n0": n, "n1": n,
            "n2": n, "tri_mesh_id": torch.zeros(t.shape[0], dtype=torch.int32,
                                                device=device)}


def k4_edge_cases(device):
    """K4's edge cases as [(name, world, origins (B, R, 3), directions,
    face_mask, tri_mask, expected hit (B, R), expected tri (B, R),
    expected t (B, R) or None)], numpy except the world and tri_mask.

    ties: two identical triangles, the lower id wins (and, masked, the
    other).  signed zero: an origin on the plane of a triangle and of its
    mirror-wound copy, so one passes at t = +0.0 and the other at -0.0; the
    lower id wins the tie and keeps its own t.  epsilon: a ray through a
    triangle whose det is just under EPSILON and on to one just over it.
    face masks: a front and a back hit under each mask.  NaN origins: a
    bundle that keeps no cluster.  last cluster: the bundle's first cluster
    (by entry time) holds a far hit and its second the winner, which the
    early exit must not skip.  coplanar: two triangles in one plane, in
    two clusters; the cluster swept second has that plane as the face of
    its box that the rays enter by, so its entry time equals the best hit
    so far, and it holds the lower id, which wins the tie: neither the
    early exit nor a part's own skip may drop it."""
    P = [(0, 0, 0), (2, 0, 0), (0, 2, 0)]
    P_rev = [(0, 0, 0), (0, 2, 0), (2, 0, 0)]
    down, up = (0.0, 0.0, -1.0), (0.0, 0.0, 1.0)

    def rays(*pairs):
        o = np.asarray([p[0] for p in pairs], np.float32)[None]
        d = np.asarray([p[1] for p in pairs], np.float32)[None]
        return o, d

    cases = []
    o, d = rays(((0.4, 0.4, 5.0), down), ((0.5, 0.3, 3.0), down))
    dup = _k4_world([P, P], device)
    cases.append(("ties", dup, o, d, 0, None, [[True, True]], [[0, 0]],
                  None))
    cases.append(("ties, tri_mask", dup, o, d, 0,
                  torch.tensor([False, True], device=device),
                  [[True, True]], [[1, 1]], None))
    o, d = rays(((0.4, 0.4, 0.0), down), ((0.4, 0.4, 0.0), up))
    mirror = _k4_world([P, P_rev], device)
    cases.append(("signed zero", mirror, o, d, 0, None, [[True, True]],
                  [[0, 0]], [[0.0, -0.0]]))
    cases.append(("signed zero, tri_mask", mirror, o, d, 0,
                  torch.tensor([False, True], device=device),
                  [[True, True]], [[1, 1]], [[-0.0, 0.0]]))
    a0, a1 = np.float32(9.99e-5), np.float32(1.0001e-4)
    check(a0 * a0 < np.float32(1e-8) <= a1 * a1, "epsilon case dets")
    eps = _k4_world([[(0, 0, 0), (a0, 0, 0), (0, a0, 0)],
                     [(0, 0, -1), (a1, 0, -1), (0, a1, -1)]], device)
    o, d = rays(((2.5e-5, 2.5e-5, 5.0), down))
    cases.append(("det under / over EPSILON", eps, o, d, 0, None, [[True]],
                  [[1]], None))
    one = _k4_world([P], device)
    o, d = rays(((0.4, 0.4, 5.0), down), ((0.4, 0.4, -5.0), up))
    for fm, hit in ((0, [True, True]), (1, [True, False]),
                    (2, [False, True]), (3, [False, False])):
        cases.append((f"face mask {fm}", one, o, d, fm, None, [hit],
                      [[0, 0]], None))
    o = np.asarray([[(np.nan,) * 3] * 2, [(0.4, 0.4, 5.0)] * 2], np.float32)
    d = np.asarray([[down] * 2] * 2, np.float32)
    cases.append(("NaN origins", one, o, d, 0, None,
                  [[False, False], [True, True]], [[0, 0], [0, 0]], None))
    # Cluster A (ids 0-127): the far hit at z = -8 (t = 18), a tall sliver
    # off the rays that lifts A's bounds to z = 9.5 (entry t = 0.5), and
    # fillers; cluster B (ids 128-255): the winner at z = 5 (t = 5, entry
    # t = 5) and fillers.  Morton order puts A's 128 centroids (z < -2.5)
    # before B's.
    fill = [[(50 + 0.01 * i, 0, 0), (50.005 + 0.01 * i, 0, 0),
             (50 + 0.01 * i, 0.005, 0)] for i in range(127)]
    A = [[(-1, -1, -8), (3, -1, -8), (-1, 3, -8)],
         [(50, 0, -10), (51, 0, -10), (50, 1, 9.5)]] \
        + [[(x, y, -10) for x, y, _ in f] for f in fill[:126]]
    B_ = [[(0, 0, 5), (2, 0, 5), (0, 2, 5)]] \
        + [[(x, y, 5) for x, y, _ in f] for f in fill]
    o, d = rays(*[((0.5 + 0.1 * i, 0.5, 10.0), down) for i in range(4)])
    cases.append(("winner in the last cluster", _k4_world(A + B_, device),
                  o, d, 0, None, [[True] * 4], [[128] * 4], [[5.0] * 4]))
    # Every centroid at z = 5, so Morton order goes by y: the low cluster
    # (ids 0-127, flat at z = 5, entry t = 5) and the high one (ids 128-255,
    # with a sliver off the rays up to z = 9.5, entry t = 0.5).  Edges of 32
    # keep every t exact.
    def fillers(n, y):
        return [[(50 + 0.01 * i, y, 5), (50.005 + 0.01 * i, y, 5),
                 (50 + 0.01 * i, y + 0.005, 5)] for i in range(n)]

    low = [[(8, 8, 5), (-24, 8, 5), (8, -24, 5)]] + fillers(127, -20)
    high = [[(-8, -8, 5), (24, -8, 5), (-8, 24, 5)],
            [(50, 20, 9.5), (51, 20, 2.75), (50, 21, 2.75)]] \
        + fillers(126, 20)
    cases.append(("coplanar across clusters", _k4_world(low + high, device),
                  o, d, 0, None, [[True] * 4], [[0] * 4], [[5.0] * 4]))
    return cases


def check_k4_edge_cases(device) -> int:
    """Phase 10: every K4 edge case through rt_sweep on `device` (the
    kernel on a card, the twin on the CPU) and through the twin: hit and
    tri as expected, t equal bit for bit, any-hit equal to the hits, and
    the last-cluster and coplanar bundles sweeping both clusters; then a
    NaN ray among healthy ones (check_k4_nan_ray).  Returns the cases run."""
    from softwarerenderer_tpu_torch.ops import rt_sweep
    cases = k4_edge_cases(device)
    for name, world, o, d, fm, tmask, hit, tri, t in cases:
        accel = rt_sweep.build_rt_accel_pl(world)
        ot = torch.as_tensor(o, device=device)
        dt = torch.as_tensor(d, device=device)
        kw = dict(face_mask=fm, tri_mask=tmask)
        res = rt_sweep.raycast_bundles_nearest(ot, dt, world, accel, **kw)
        plain = rt_sweep.raycast_bundles_nearest(
            ot, dt, world, accel, sweep=rt_sweep.rt_sweep_plain, **kw)
        anyh = rt_sweep.raycast_bundles_any(ot, dt, world, accel, **kw)
        hit = np.asarray(hit)
        check(np.array_equal(res["hit"].cpu().numpy(), hit),
              f"K4 edge case {name}: hit {res['hit'].cpu().tolist()}")
        check(np.array_equal(anyh["hit"].cpu().numpy(), hit),
              f"K4 edge case {name}: any-hit {anyh['hit'].cpu().tolist()}")
        got_tri = res["tri"].cpu().numpy()
        check(np.array_equal(got_tri[hit], np.asarray(tri)[hit]),
              f"K4 edge case {name}: tri {got_tri.tolist()}")
        kt = res["distance"].cpu()
        check(torch.equal(kt.view(torch.int32),
                          plain["distance"].cpu().view(torch.int32))
              and torch.equal(res["tri"].cpu(), plain["tri"].cpu()),
              f"K4 edge case {name}: kernel {kt.tolist()} vs twin "
              f"{plain['distance'].cpu().tolist()}")
        if t is not None:
            want = torch.tensor(t, dtype=torch.float32)
            check(torch.equal(kt.view(torch.int32), want.view(torch.int32)),
                  f"K4 edge case {name}: t {kt.tolist()}, want {t}")
        if name == "NaN origins":
            _, _, rays_, stream, lists, counts, t0q, _ = rt_sweep._prep(
                ot, dt, accel, accel["slot_ok"], None)
            check(counts.cpu().tolist() == [0, 1],
                  f"NaN-origin survivors {counts.cpu().tolist()}")
        order = {"winner in the last cluster": [[0, 1]],
                 "coplanar across clusters": [[1, 0]]}.get(name)
        if order is not None:
            _, _, rays_, stream, lists, counts, t0q, _ = rt_sweep._prep(
                ot, dt, accel, accel["slot_ok"], None)
            swept = torch.zeros_like(counts)
            tested = torch.zeros_like(counts)
            rt_sweep.rt_sweep(rays_, stream, lists, counts, t0q,
                              any_hit=False, face_mask=0, swept=swept,
                              boxes=(accel["cl_lo"], accel["cl_hi"]),
                              tested=tested)
            check(lists.cpu().tolist() == order and swept.item() == 2
                  and tested.item() == 2,
                  f"{name}: list {lists.cpu().tolist()}, swept "
                  f"{swept.item()}, tested {tested.item()}")
    check_k4_nan_ray(device)
    return len(cases) + 1


def check_k4_nan_ray(device) -> None:
    """One ray with a NaN origin among 31 healthy ones that all point down
    at a triangle, through rt_sweep itself with a hand-made list and the
    clusters' boxes: the part's bounds hold a NaN, on which the slab test
    would find the cluster out of reach, so the part must skip nothing.  The
    healthy rays hit, the NaN ray misses, and t equals the twin's bit for
    bit, in both modes."""
    from softwarerenderer_tpu_torch.ops import rt_sweep
    world = _k4_world([[(0, 0, 0), (2, 0, 0), (0, 2, 0)]], device)
    accel = rt_sweep.build_rt_accel_pl(world)
    R, bad = 32, 7
    rays = torch.zeros((1, 6, R), device=device)
    rays[0, 0] = 0.4 + 0.01 * torch.arange(R, device=device)
    rays[0, 1] = 0.4
    rays[0, 2] = 5.0
    rays[0, 5] = -1.0
    rays[0, 0:3, bad] = float("nan")
    lists = torch.zeros((1, 1), dtype=torch.int32, device=device)
    counts = torch.ones((1,), dtype=torch.int32, device=device)
    t0q = torch.zeros((1, 1), dtype=torch.int32, device=device)
    healthy = torch.arange(R, device=device) != bad
    for any_hit in (False, True):
        kw = dict(any_hit=any_hit, face_mask=0,
                  boxes=(accel["cl_lo"], accel["cl_hi"]))
        tested = torch.zeros_like(counts)
        t, g = rt_sweep.rt_sweep(rays, accel["tri_stream"], lists, counts,
                                 t0q, tested=tested, **kw)
        pt, pg = rt_sweep.rt_sweep_plain(rays, accel["tri_stream"], lists,
                                         counts, t0q, **kw)
        hit = (g[0] > 0) if any_hit else (g[0] == 0)
        check(torch.equal(hit, healthy) and tested.item() == 1,
              f"K4 NaN ray (any_hit={any_hit}): hits {hit.cpu().tolist()}, "
              f"tested {tested.item()}")
        check(torch.equal(t.view(torch.int32), pt.view(torch.int32))
              and torch.equal(g, pg),
              f"K4 NaN ray (any_hit={any_hit}): kernel {t.cpu().tolist()} "
              f"vs twin {pt.cpu().tolist()}")


def capture_sweeps(render):
    """Run render(sweep) with a sweep that records every K4 call, and
    return [(args, kwargs)] in call order."""
    from softwarerenderer_tpu_torch.ops import rt_sweep
    calls = []

    def sweep(*args, **kwargs):
        calls.append((args, kwargs))
        return rt_sweep.rt_sweep(*args, **kwargs)

    render(sweep)
    return calls


def sweep_variants(args, kwargs, want) -> str:
    """What each part of K4's design is worth on one cast: the same launch
    timed as it ships, with the bundles in plain order and without the
    clusters' boxes (no part skips a cluster), each equal to `want` bit for
    bit."""
    from softwarerenderer_tpu_torch.ops import rt_sweep
    counts = args[3]

    def run(kw):
        t, g = rt_sweep.rt_sweep(*args, **kw)
        check(torch.equal(t.view(torch.int32), want[0].view(torch.int32))
              and torch.equal(g, want[1]), "a K4 variant changes the result")
        return cuda_ms(lambda: rt_sweep.rt_sweep(*args, **kw), KERNEL_RUNS)

    out = [f"as it ships {run(kwargs):.3f} ms"]
    longest_first = rt_sweep.bundle_order
    rt_sweep.bundle_order = lambda c: torch.arange(c.numel(),
                                                   device=c.device)
    try:
        out.append(f"bundles in plain order {run(kwargs):.3f} ms")
    finally:
        rt_sweep.bundle_order = longest_first
    out.append(f"bundle_order alone "
               f"{cuda_ms(lambda: rt_sweep.bundle_order(counts), KERNEL_RUNS):.3f} ms")
    out.append(f"without boxes {run(dict(kwargs, boxes=None)):.3f} ms")
    return "; ".join(out) + f" (medians of {KERNEL_RUNS}, equal outputs)"


def check_sweep_kernel(card, device, size) -> dict:
    """Phase 11: K4 against its plain twin on the primary (nearest) and
    shadow (any-hit) casts of two 1080p frames of the bench scene, the
    bench view and the default camera at the origin: hit, tri and the
    occlusion flag equal on every ray, t equal bit for bit.  Returns the
    bench view's per-mode timings and bounds."""
    from softwarerenderer_tpu_torch import RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import Engine
    from softwarerenderer_tpu_torch.ops import rt_sweep
    from softwarerenderer_tpu_torch.ops.raytrace import render_frame_raytraced
    w, h = size
    params = RenderParams(w, h)
    eng = Engine(scenes.bench_scene(), params, device=device)
    views = {"bench view": scenes.camera_uniforms(eng.uniforms, 0),
             "origin": dict(eng.uniforms)}
    out = {}
    for view, u in views.items():
        calls = capture_sweeps(lambda sw: render_frame_raytraced(
            eng.scene, u, params, cluster_cap=RT_CAP, sweep=sw))
        check(len(calls) == 2 and not calls[0][1]["any_hit"]
              and calls[1][1]["any_hit"],
              f"{view}: sweeps {[c[1]['any_hit'] for c in calls]}")
        for (args, kwargs), cast in zip(calls, ("primary", "shadow")):
            B, _, R = args[0].shape
            counts = args[3]
            swept = torch.zeros_like(counts)
            tested = torch.zeros_like(counts)
            kt, kg = rt_sweep.rt_sweep(*args, **kwargs, swept=swept,
                                       tested=tested)
            plain_swept = torch.zeros_like(counts)
            pt, pg = rt_sweep.rt_sweep_plain(*args, **kwargs,
                                             swept=plain_swept)
            diff_g = int((kg != pg).sum())
            diff_t = int((kt.view(torch.int32) != pt.view(torch.int32)).sum())
            # Any-hit: the largest flag difference; nearest: the largest
            # |t| difference over rays that both hit.
            if kwargs["any_hit"]:
                err = float((kg - pg).abs().amax())
            else:
                both = (kg < rt_sweep.NOTRI) & (pg < rt_sweep.NOTRI)
                err = float(torch.where(both, (kt - pt).abs(), 0.0).amax())
            ms = cuda_ms(lambda: rt_sweep.rt_sweep(*args, **kwargs),
                         KERNEL_RUNS)
            plain_ms = cuda_ms(lambda: rt_sweep.rt_sweep_plain(*args,
                                                               **kwargs),
                               RT_PLAIN_RUNS)
            n_pairs = int(counts.sum())
            n_swept = int(swept.sum())
            extra = sweep_variants(args, kwargs, (kt, kg))
            hits = int((kg > 0).sum() if kwargs["any_hit"]
                       else (kg < rt_sweep.NOTRI).sum())
            b = sweep_bound_tested(args, (kt, kg), tested)
            b_swept = sweep_bound(args, (kt, kg), swept)
            per_group = rt_sweep.GROUP_RAYS // rt_sweep.PART_RAYS
            log(f"phase 11 K4 {view} {cast} @{w}x{h}: {B} bundles x {R} "
                f"rays, {hits} hit; {n_pairs} listed (bundle, cluster) "
                f"pairs, {n_swept} cluster sweeps by the kernel (twin "
                f"{int(plain_swept.sum())}); tri/flag differs on {diff_g}, "
                f"t on {diff_t} rays (max abs err {err}); kernel "
                f"{ms:.3f} ms (median of "
                f"{KERNEL_RUNS}), plain {plain_ms:.3f} ms (median of "
                f"{RT_PLAIN_RUNS}); {int(tested.sum())} of "
                f"{n_swept * per_group} (part, cluster) pairs tested, parts "
                f"of {rt_sweep.PART_RAYS} rays; bound {b['bound_ms']:.4f} ms "
                f"({b['bound_by']}, {b['tests']:.4g} tests in the pairs "
                f"tested), with the clusters the parts skipped "
                f"{b_swept['bound_ms']:.4f} ms ({b_swept['tests']:.4g} "
                f"tests, the bound of the first kernel) [{card}]")
            log(f"phase 11 K4 {view} {cast}: {extra} [{card}]")
            check(diff_g == 0, f"K4 {view} {cast}: {diff_g} rays differ")
            check(diff_t == 0, f"K4 {view} {cast}: t differs on {diff_t}")
            check(hits > 0, f"K4 {view} {cast}: no ray hits")
            if view == "bench view":
                out[cast] = dict(b, ms=ms, plain_ms=plain_ms,
                                 max_abs_err=err)
    return out


def _frame_diff(a, b):
    """Pixels of two (color, depth) frames that differ in color (> 1e-5),
    in depth, and in present."""
    from softwarerenderer_tpu_torch.engine import to_rgb8
    n_c = int(((a[0] - b[0]).abs().amax(-1) > 1e-5).sum())
    n_d = int((a[1] != b[1]).sum())
    n_rgb = int((to_rgb8(a[0]) != to_rgb8(b[0])).any(-1).sum())
    return n_c, n_d, n_rgb


def check_raytraced_frames(card, device, size, frames) -> dict:
    """Phase 12: the ray-traced main path.  30 frames of the bench scene
    through Engine(frame_fn=render_frame_raytraced, cluster_cap=24) with
    hard shadows (K4 nearest once and any-hit once per frame), frame 0
    against the plain twin's frame; soft shadows (4 samples, radius 0.3)
    and reflections once each against the twin.  Returns the launch
    counts."""
    import functools
    from softwarerenderer_tpu_torch import RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import Engine, to_rgb8
    from softwarerenderer_tpu_torch.ops import rt_sweep
    from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR
    from softwarerenderer_tpu_torch.ops.raytrace import render_frame_raytraced
    w, h = size
    params = RenderParams(w, h)
    eng = Engine(scenes.bench_scene(), params, device=device,
                 frame_fn=functools.partial(render_frame_raytraced,
                                            cluster_cap=RT_CAP))

    def u_at(i):
        return scenes.camera_uniforms(eng.uniforms, i)

    rt_sweep.LAUNCHES = rt_sweep.ANY_HIT_LAUNCHES = 0
    frame_ms, per_frame, finite = [], [], True
    for i in range(frames):
        n0, a0 = rt_sweep.LAUNCHES, rt_sweep.ANY_HIT_LAUNCHES
        t = time.perf_counter()
        color, depth = eng.render(u_at(i))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
        per_frame.append((rt_sweep.LAUNCHES - n0 - rt_sweep.ANY_HIT_LAUNCHES
                          + a0, rt_sweep.ANY_HIT_LAUNCHES - a0))
        finite &= bool(torch.isfinite(color).all()
                       and torch.isfinite(depth).all())
        check(color.shape == (h, w, 4) and depth.shape == (h, w),
              f"frame shapes {tuple(color.shape)} {tuple(depth.shape)}")
        if i == 0:
            first = (color, depth)
    launches = {"nearest": rt_sweep.LAUNCHES - rt_sweep.ANY_HIT_LAUNCHES,
                "any_hit": rt_sweep.ANY_HIT_LAUNCHES}
    check(finite, "non-finite ray-traced output")
    check(all(p == (1, 1) for p in per_frame),
          f"K4 (nearest, any-hit) launches per frame {per_frame}")
    syncs = host_syncs(lambda i: eng.render(u_at(i)), 3)
    plain = render_frame_raytraced(eng.scene, u_at(0), params,
                                   cluster_cap=RT_CAP,
                                   sweep=rt_sweep.rt_sweep_plain)
    n_cov = int(((first[1] != DEPTH_CLEAR) | (plain[1] != DEPTH_CLEAR)).sum())
    n_c, n_d, n_rgb = _frame_diff(first, plain)
    rgb = eng.present(u_at(0))
    n_present = int((torch.from_numpy(rgb).to(device)
                     != to_rgb8(plain[0])).any(-1).sum())
    steady = statistics.median(frame_ms[1:])
    log(f"phase 12 ray-traced main path @{w}x{h}, cluster_cap={RT_CAP}, "
        f"hard shadows: {frames} frames, K4 launches {launches['nearest']} "
        f"nearest + {launches['any_hit']} any-hit, {syncs:.1f} host syncs "
        f"per frame, first frame {frame_ms[0]:.1f} ms, median frame "
        f"{steady:.3f} ms = {w * h / steady / 1e3:.1f} Mpixels/s; frame 0 "
        f"vs the plain twin's: {n_cov} covered pixels, {n_c} differ > 1e-5 "
        f"in color, {n_d} in depth, {n_rgb} in to_rgb8, {n_present} in "
        f"present [{card}]")
    limit = FRAME_COVERED_MISMATCH_MAX * w * h
    check(n_cov > 0.05 * w * h, f"only {n_cov} ray-traced pixels covered")
    for what, n in (("color", n_c), ("depth", n_d), ("present", n_present)):
        check(n <= limit, f"ray-traced frame 0 {what} differs on {n} pixels")

    for name, kw, u in (
            ("soft shadows", dict(shadow_samples=4),
             dict(u_at(0), rt_light_radius=np.float32(0.3))),
            ("reflections", dict(reflections=True), u_at(0))):
        n0, a0 = rt_sweep.LAUNCHES, rt_sweep.ANY_HIT_LAUNCHES
        got = render_frame_raytraced(eng.scene, u, params,
                                     cluster_cap=RT_CAP, **kw)
        torch.cuda.synchronize()
        near = rt_sweep.LAUNCHES - n0 - (rt_sweep.ANY_HIT_LAUNCHES - a0)
        anyh = rt_sweep.ANY_HIT_LAUNCHES - a0
        want = render_frame_raytraced(eng.scene, u, params,
                                      cluster_cap=RT_CAP,
                                      sweep=rt_sweep.rt_sweep_plain, **kw)
        n_c, n_d, n_rgb = _frame_diff(got, want)
        log(f"phase 12 {name} @{w}x{h}: K4 launches {near} nearest + "
            f"{anyh} any-hit; vs the plain twin: {n_c} pixels differ "
            f"> 1e-5 in color, {n_d} in depth, {n_rgb} in to_rgb8")
        check((near, anyh) == ((1, 1) if name == "soft shadows" else (2, 1)),
              f"{name}: K4 launches {(near, anyh)}")
        for what, n in (("color", n_c), ("depth", n_d), ("to_rgb8", n_rgb)):
            check(n <= limit, f"{name} {what} differs on {n} pixels")
    return {"launches": launches, "frame_ms": steady}


def check_bundle_vs_brute(card, device, size) -> None:
    """Phase 13: the bundle route (K4) against the brute route
    (cluster_cap=0, raycast_batch) on the bench scene: coverage, depth and
    color equal on every pixel, for hard shadows from the bench view and
    for two soft-shadow samples with reflections from the origin."""
    from softwarerenderer_tpu_torch import RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import Engine
    from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR
    from softwarerenderer_tpu_torch.ops.raytrace import render_frame_raytraced
    w, h = size
    params = RenderParams(w, h)
    eng = Engine(scenes.bench_scene(), params, device=device)
    for name, u, kw in (
            ("bench view, hard shadows",
             scenes.camera_uniforms(eng.uniforms, 0), {}),
            ("origin, 2 soft samples and reflections",
             dict(eng.uniforms, rt_light_radius=np.float32(0.3)),
             dict(shadow_samples=2, reflections=True))):
        bc, bd = render_frame_raytraced(eng.scene, u, params, cluster_cap=0,
                                        **kw)
        kc, kd = render_frame_raytraced(eng.scene, u, params,
                                        cluster_cap=RT_CAP, **kw)
        cov = int((kd != DEPTH_CLEAR).sum())
        flips = int(((bd == DEPTH_CLEAR) != (kd == DEPTH_CLEAR)).sum())
        n_d = int((bd.view(torch.int32) != kd.view(torch.int32)).sum())
        n_c = int((bc.view(torch.int32) != kc.view(torch.int32))
                  .any(-1).sum())
        log(f"phase 13 bundle vs brute route @{w}x{h}, {name}: {cov} "
            f"covered pixels, coverage differs on {flips}, depth on {n_d}, "
            f"color on {n_c} pixels [{card}]")
        check(cov > 0 and flips == 0 and n_d == 0 and n_c == 0,
              f"bundle vs brute route, {name}")


def check_vis_fold_kernel(card, k1_args, k1_kwargs, k1_out,
                          device) -> dict:
    """Phase 14: K5 against its plain twin on the bench frame's bins (the
    K1 fold's own inputs, 32x128 tiles): best_i equal on every pixel and
    best_d bit for bit, and equal to K1's winners and depths on the same
    bins; the same, and timed, at each part length of K5_PART_LENS (no
    split, then lists cut into parts merged by 64-bit atomics); the same
    at 64x128 tiles (two blocks a tile); the edge cases, at the shipped
    part length and at one triangle a part; the split edge cases.
    Returns K5's times at the shipped part length (ms: the kernel alone,
    the lower of two profiled means; wrapper_ms: with its wrapper), bound
    and largest difference."""
    from softwarerenderer_tpu_torch.ops import binning, vis_fold
    args = k1_args[:7]
    kwargs = dict(tile_h=k1_kwargs["tile_h"], tile_w=k1_kwargs["tile_w"])
    kd, ki = vis_fold.vis_fold(*args, **kwargs)
    pd, pi = vis_fold.visibility_fold_plain(*args, **kwargs)
    torch.cuda.synchronize()
    diff_i = int((ki != pi).sum())
    diff_d = int((kd.view(torch.int32) != pd.view(torch.int32)).sum())
    _, k1_d, k1_i = k1_out
    diff_k1_i = int((ki != k1_i).sum())
    diff_k1_d = int((kd != k1_d).sum())
    d_err = float((kd - pd).abs().max())
    n_cov = int((ki >= 0).sum())
    plain_ms = cuda_ms(lambda: vis_fold.visibility_fold_plain(*args,
                                                              **kwargs),
                       PLAIN_RUNS)
    b = fold_bound(args, kwargs, (kd, ki))
    Hp, Wp = args[0].shape
    lens = args[3].long() + args[6].long()
    log(f"phase 14 K5 vs plain @{Wp}x{Hp} padded, {kwargs['tile_h']}x"
        f"{kwargs['tile_w']} tiles ({lens.numel()} tiles, lists of mean "
        f"{float(lens.float().mean()):.1f} and at most {int(lens.max())} "
        f"triangles): {n_cov} covered pixels; best_i differs on {diff_i}, "
        f"best_d (bits) on {diff_d} pixels; vs K1 on the same bins: best_i "
        f"differs on {diff_k1_i}, best_d on {diff_k1_d}; plain "
        f"{plain_ms:.3f} ms (median of {PLAIN_RUNS}); bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}, {b['tests']} tests) "
        f"[{card}]")
    check(n_cov > 0.05 * ki.numel(), f"K5 covers only {n_cov} pixels")
    check(diff_i == 0 and diff_d == 0,
          f"K5 vs twin: best_i {diff_i}, best_d {diff_d}")
    check(diff_k1_i == 0 and diff_k1_d == 0,
          f"K5 vs K1: best_i {diff_k1_i}, best_d {diff_k1_d}")

    # Each part length, held against the twin and timed in turns: the
    # wrapper with CUDA events (as every kernel of this script), and the
    # kernel alone with the profiler (the wrapper also builds the work
    # list, a few small launches).
    blocks = -(-kwargs["tile_h"] * kwargs["tile_w"] // 1024)
    times = {p: [] for p in K5_PART_LENS}
    alone = {p: [] for p in K5_PART_LENS}
    items = {}
    for p in K5_PART_LENS:
        d, i = vis_fold.vis_fold(*args, **kwargs, part_len=p)
        n = int((i != pi).sum()) + int(
            (d.view(torch.int32) != pd.view(torch.int32)).sum())
        check(n == 0, f"K5 at part_len {p}: {n} values differ from the twin")
        # The plan kernel's work list against its twin on the CPU.
        tiles, first = vis_fold.fold_items(args[3], args[6], p, blocks)
        want_t, want_f = vis_fold.fold_items(args[3].cpu(), args[6].cpu(), p,
                                             blocks)
        check(torch.equal(tiles.cpu(), want_t)
              and torch.equal(first.cpu(), want_f),
              f"K5 work list at part_len {p} differs from its twin")
        items[p] = int(want_f[-1])
    for _ in range(2):
        for p in K5_PART_LENS:
            def call():
                return vis_fold.vis_fold(*args, **kwargs, part_len=p)
            times[p].append(cuda_ms(call, KERNEL_RUNS))
            alone[p].append(device_ms(call, KERNEL_RUNS, "vis_fold_kernel",
                                      "vis_fold_plan_kernel"))
    wrapped = {}
    for p in K5_PART_LENS:
        wrapped[p] = statistics.median(times[p])
        name = "no split" if p >= 2 ** 31 - 1 else f"part_len {p}"
        log(f"phase 14 K5 {name}: {items[p]} work items, equal to the twin "
            f"on every pixel, work list equal to its twin; kernel alone "
            f"{', '.join(f'{t:.4f}' for t in alone[p])} ms (two means of "
            f"{KERNEL_RUNS}, profiler), {b['bound_ms'] / min(alone[p]):.1%} "
            f"of the bound; with its wrapper "
            f"{', '.join(f'{t:.3f}' for t in times[p])} ms (two medians "
            f"of {KERNEL_RUNS}, CUDA events) [{card}]")
    ms = wrapped[vis_fold.PART_LEN]
    kernel_ms = min(alone[vis_fold.PART_LEN])
    order_ms = cuda_ms(lambda: vis_fold.fold_items(
        args[3], args[6], vis_fold.PART_LEN, blocks), KERNEL_RUNS)
    log(f"phase 14 K5 shipped part_len {vis_fold.PART_LEN}: kernel alone "
        f"(plan and fold) {kernel_ms:.4f} ms, with its wrapper {ms:.3f} ms; "
        f"fold_items alone {order_ms:.3f} ms; "
        f"{vis_fold.blocks_per_sm(kwargs['tile_w'])} blocks an SM [{card}]")

    # Tiles of 64 rows: the bins of the tile_h the deferred route takes
    # uncapped, each tile split over two blocks.
    from softwarerenderer_tpu_torch import RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import Engine, frame_setup
    eng = Engine(scenes.bench_scene(), RenderParams(W, H), device=device)
    params = RenderParams(W, H)
    f = frame_setup(eng.scene, scenes.camera_uniforms(eng.uniforms, 0),
                    params)
    a64, kw64 = binning.fold_inputs(f["tris"], params, 64, params.tile_w,
                                    params.span_cap)
    d64, i64 = vis_fold.vis_fold(*a64, **kw64)
    q64, j64 = vis_fold.visibility_fold_plain(*a64, **kw64)
    n64 = int((i64 != j64).sum()) + int(
        (d64.view(torch.int32) != q64.view(torch.int32)).sum())
    same64 = int((i64[:H, :W] != ki[:H, :W]).sum())
    log(f"phase 14 K5 at 64x128 tiles: kernel vs plain differ on {n64} "
        f"values; winners differ from the 32-row tiles' on {same64} pixels")
    check(n64 == 0 and same64 == 0, "K5 at 64-row tiles")

    def holds(name, e_args, e_kwargs, part_len, want_i, want_d):
        for who, fold in (("kernel", functools.partial(
                vis_fold.vis_fold, part_len=part_len)),
                          ("plain", vis_fold.visibility_fold_plain)):
            d, i = fold(*e_args, **e_kwargs)
            check(torch.equal(i.cpu(), want_i),
                  f"K5 edge case {name} {who} part_len {part_len} best_i "
                  f"{i.cpu().tolist()}")
            check(torch.equal(d.cpu().view(torch.int32),
                              want_d.view(torch.int32)),
                  f"K5 edge case {name} {who} part_len {part_len} best_d "
                  f"{d.cpu().tolist()}")

    for name, e_args, e_kwargs, want_i, want_d in vis_fold_edge_cases(device):
        for part_len in (vis_fold.PART_LEN, 1):
            holds(name, e_args, e_kwargs, part_len, want_i, want_d)
    log("phase 14 K5 edge cases (a -inf seed and a NaN fragment, ties at "
        "the seed and between the lists, -0.0 vs +0.0, row_offset 4, "
        "tile_h 64, an empty frame), whole and at one triangle a part: "
        "kernel and plain equal the expected winners, depth bit for bit")
    for case in vis_fold_split_cases(device):
        holds(*case)
    log("phase 14 K5 split edge cases (ties between parts and across the "
        "lists inside a part, a NaN seed, -0.0 and +0.0 in different "
        "parts, a -inf seed with -inf fragments, lists of P and P + 1, one "
        "tile holding 300 triangles over four blocks): kernel and plain "
        "equal the expected winners, depth bit for bit")
    return dict(b, ms=kernel_ms, wrapper_ms=ms, plain_ms=plain_ms,
                max_abs_err=d_err)


def check_deferred_frames(card, device, size, frames) -> dict:
    """Phase 15: the deferred main path, Engine(bench scene,
    RenderParams(use_pallas=False)): 30 frames with one K5 launch each;
    frame 0 against the plain path (K5's twin) and against the tile
    route's frame (K1), within 1e-5 on every covered pixel."""
    from softwarerenderer_tpu_torch import RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import (Engine, frame_setup,
                                                   render_frame,
                                                   scene_fragment_shader)
    from softwarerenderer_tpu_torch.ops import raster, vis_fold
    w, h = size
    params = RenderParams(w, h, use_pallas=False)
    eng = Engine(scenes.bench_scene(), params, device=device)

    def u_at(i):
        return scenes.camera_uniforms(eng.uniforms, i)

    run = counted_frames(lambda i: eng.render(u_at(i)), frames, size)
    per_frame, first, frame_ms = run["k5"], run["first"], run["frame_ms"]
    launches = sum(per_frame)
    check(per_frame == [1] * frames and run["k1"] == [0] * frames,
          f"K5 launches per frame {per_frame}, K1 {run['k1']}")
    syncs = host_syncs(lambda i: eng.render(u_at(i)), 3)
    f = frame_setup(eng.scene, u_at(0), params)
    plain = raster.render_deferred(
        f["tris"], scene_fragment_shader, f["uniforms"], params,
        f["fb_color"], f["fb_depth"], per_tri_extra=f["per_tri"],
        visibility_fn=vis_fold.make_visibility_fold(
            vis_fold.visibility_fold_plain))
    tile = render_frame(eng.scene, u_at(0), params.replace(use_pallas=True))
    steady = run["median_ms"]
    out = {"launches": launches, "frame_ms": steady}
    cov = (first[1] != raster.DEPTH_CLEAR)
    n_cov = int(cov.sum())
    parts = []
    for name, other in (("plain path", plain), ("tile route (K1)", tile)):
        both = cov | (other[1] != raster.DEPTH_CLEAR)
        c_err = float((first[0] - other[0]).abs().amax(-1)[both].max())
        d_err = float((first[1] - other[1])[both].abs().max())
        n_c, n_d, n_rgb = _frame_diff(first, other)
        parts.append(f"vs the {name}: color max abs diff {c_err:.3g}, "
                     f"depth {d_err:.3g}; {n_c} pixels differ > 1e-5 in "
                     f"color, {n_d} in depth, {n_rgb} in to_rgb8")
        check(c_err <= 1e-5 and d_err <= 1e-5,
              f"deferred frame 0 vs the {name}: color {c_err}, depth "
              f"{d_err}")
    log(f"phase 15 deferred main path @{w}x{h} (use_pallas=False): "
        f"{frames} frames, K5 launches {launches} (per frame "
        f"{min(per_frame)}-{max(per_frame)}), {syncs:.1f} host syncs per "
        f"frame, first frame {frame_ms[0]:.1f} ms, median frame "
        f"{steady:.3f} ms = {w * h / steady / 1e3:.1f} Mpixels/s; frame 0 "
        f"({n_cov} covered pixels) {'; '.join(parts)} [{card}]")
    check(n_cov > 0.05 * w * h, f"only {n_cov} deferred pixels covered")
    return out


# Phase 16 holds the card's frame against the CPU's: the same PyTorch code
# on two devices, every fold an exact max of integer keys and every other
# step elementwise, so no pixel may differ by more than 1e-5 in color or
# depth (0 measured on the H100 on every route).
CPU_FRAME_MISMATCH_MAX = 0


def check_small_routes(card, size, device="cuda") -> None:
    """Phase 16: the depth tests and views at 320x180 on the card, each
    against the same call on the CPU: the brute and binned routes for
    LESS, GREATER and GREATER_EQUAL (over a MaxValue depth buffer) and
    ALWAYS; the forward route for EQUAL (additive, over each device's own
    LESS_EQUAL frame); the deferred wireframe; the overdraw and depth
    views."""
    from softwarerenderer_tpu_torch import (BlendMode, DebugMode, DepthTest,
                                            RenderParams, scenes)
    from softwarerenderer_tpu_torch.engine import Engine, render_frame
    w, h = size
    scene = scenes.bench_scene()
    engs = {"card": Engine(scene, RenderParams(w, h), device=device),
            "cpu": Engine(scene, RenderParams(w, h), device="cpu")}
    u = scenes.camera_uniforms(engs["cpu"].uniforms, 0)
    fmax = torch.finfo(torch.float32).max
    cases = []
    for mode in (DepthTest.LESS, DepthTest.GREATER, DepthTest.GREATER_EQUAL,
                 DepthTest.ALWAYS):
        seed = "max" if mode in (DepthTest.GREATER,
                                 DepthTest.GREATER_EQUAL) else None
        for binned in (True, False):
            cases.append((f"{mode.name} {'binned' if binned else 'brute'}",
                          dict(depth_test=mode, binned=binned), seed))
    cases += [("EQUAL forward, additive", dict(
        depth_test=DepthTest.EQUAL, blend_mode=BlendMode.ADDITIVE), "frame"),
              ("wireframe", dict(debug_mode=DebugMode.WIREFRAME), None),
              ("overdraw", dict(debug_mode=DebugMode.OVERDRAW), None),
              ("depth view", dict(debug_mode=DebugMode.DEPTH), None)]
    for name, fields, seed in cases:
        params = RenderParams(w, h, **fields)
        out = {}
        for dev, eng in engs.items():
            fb = None
            if seed == "max":
                fb = (torch.zeros((h, w, 4)), torch.full((h, w), fmax))
            elif seed == "frame":
                fb = render_frame(eng.scene, u, RenderParams(
                    w, h, use_pallas=False))
            out[dev] = tuple(x.cpu() for x in render_frame(
                eng.scene, u, params, fb=fb))
        n_c, n_d, n_rgb = _frame_diff(out["card"], out["cpu"])
        drawn = int((out["card"][1] != out["card"][1][0, 0]).sum()) \
            if name in ("overdraw", "depth view") \
            else int((out["card"][0] != out["card"][0][0, 0]).any(-1).sum())
        log(f"phase 16 {name} @{w}x{h}, card vs CPU: {n_c} pixels differ "
            f"> 1e-5 in color, {n_d} in depth, {n_rgb} in to_rgb8; "
            f"{drawn} pixels differ from the top-left one [{card}]")
        check(n_c <= CPU_FRAME_MISMATCH_MAX
              and n_d <= CPU_FRAME_MISMATCH_MAX,
              f"phase 16 {name}: {n_c} color, {n_d} depth pixels differ")
        check(torch.isfinite(out["card"][0]).all() and drawn > 0,
              f"phase 16 {name}: nothing drawn")


def check_kslot_route(card, small, size, device="cuda") -> None:
    """Phase 17: the K-slot K-buffer (ops.kbuffer) on the card.  At
    `small` the translucent scene at K=4 under LESS, GREATER and
    GREATER_EQUAL (over a MaxValue depth buffer), ALWAYS and DISABLED,
    each against the same call on the CPU: no pixel may differ, and the
    saturation counts agree.  At `size` the route called directly under
    LESS_EQUAL against the peel route with the short-circuit off, which
    must render the same frame (no pixel off by more than 1e-5); and one
    GREATER frame at K=4 through render_frame, timed."""
    from softwarerenderer_tpu_torch import DepthTest, RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import (Engine, frame_setup,
                                                   render_frame,
                                                   scene_fragment_shader)
    from softwarerenderer_tpu_torch.ops import kbuffer, tile_raster
    scene = scenes.translucent_scene()
    fmax = torch.finfo(torch.float32).max

    def max_seed(w, h):
        return (torch.zeros((h, w, 4)), torch.full((h, w), fmax))

    w, h = small
    engs = {"card": Engine(scene, RenderParams(w, h), device=device),
            "cpu": Engine(scene, RenderParams(w, h), device="cpu")}
    u = scenes.camera_uniforms(engs["cpu"].uniforms, 0)
    for mode in (DepthTest.LESS, DepthTest.GREATER, DepthTest.GREATER_EQUAL,
                 DepthTest.ALWAYS, DepthTest.DISABLED):
        params = RenderParams(w, h, kbuffer=KBUFFER, cull_mode=0,
                              depth_test=mode, kbuffer_stats=True)
        fb = max_seed(w, h) if mode in (DepthTest.GREATER,
                                        DepthTest.GREATER_EQUAL) else None
        out = {dev: render_frame(eng.scene, u, params, fb=fb)
               for dev, eng in engs.items()}
        card_f = tuple(x.cpu() for x in out["card"][:2])
        n_c, n_d, n_rgb = _frame_diff(card_f, out["cpu"][:2])
        sat = {dev: int(o[2]["kbuffer_saturated_px"]) for dev, o in
               out.items()}
        drawn = int((card_f[0] != card_f[0][0, 0]).any(-1).sum())
        log(f"phase 17 K-slot {mode.name} K={KBUFFER} @{w}x{h}, card vs "
            f"CPU: {n_c} pixels differ > 1e-5 in color, {n_d} in depth, "
            f"{n_rgb} in to_rgb8; saturated {sat['card']} / {sat['cpu']}; "
            f"{drawn} pixels differ from the top-left one [{card}]")
        check(n_c == 0 and n_d == 0 and sat["card"] == sat["cpu"],
              f"phase 17 {mode.name}: {n_c} color, {n_d} depth pixels, "
              f"saturation {sat}")
        check(torch.isfinite(card_f[0]).all() and drawn > 0,
              f"phase 17 {mode.name}: nothing drawn")

    w, h = size
    params = RenderParams(w, h, kbuffer=KBUFFER, cull_mode=0,
                          kbuffer_short_circuit=False)
    eng = Engine(scene, params, device=device)
    u = scenes.camera_uniforms(eng.uniforms, 0)
    f = frame_setup(eng.scene, u, params)
    args = (f["tris"], scene_fragment_shader, f["uniforms"], params,
            f["fb_color"], f["fb_depth"])
    kc, kd, ks = kbuffer.render_binned_kbuffer(
        *args, per_tri_extra=f["per_tri"], with_stats=True)
    pc, pd, ps = tile_raster.render_tile_kbuffer(
        *args, per_tri_extra=f["per_tri"], with_stats=True)
    n_c = int(((kc - pc).abs().amax(-1) > 1e-5).sum())
    n_d = int(((kd - pd).abs() > 1e-5).sum())
    sat = (int(ks["kbuffer_saturated_px"]), int(ps["kbuffer_saturated_px"]))
    log(f"phase 17 K-slot LESS_EQUAL K={KBUFFER} @{w}x{h} against the peel "
        f"route without short-circuit: {n_c} pixels differ > 1e-5 in "
        f"color, {n_d} in depth; saturated {sat[0]} / {sat[1]} [{card}]")
    check(n_c == 0 and n_d == 0 and sat[0] == sat[1] > 0,
          f"phase 17 K-slot vs peel: {n_c} color, {n_d} depth, {sat}")

    params = RenderParams(w, h, kbuffer=KBUFFER, cull_mode=0,
                          depth_test=DepthTest.GREATER)
    fb = tuple(x.to(device) for x in max_seed(w, h))
    render_frame(eng.scene, u, params, fb=fb)
    torch.cuda.synchronize()
    t = time.perf_counter()
    color, depth = render_frame(eng.scene, u, params, fb=fb)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t) * 1e3
    drawn = int((depth < fmax).sum())
    log(f"phase 17 K-slot GREATER K={KBUFFER} frame @{w}x{h}: "
        f"{frame_ms:.1f} ms (one frame after one warm-up), {drawn} pixels "
        f"drawn [{card}]")
    check(torch.isfinite(color).all() and drawn > 0.05 * w * h,
          f"phase 17 GREATER frame: {drawn} pixels drawn")


def check_frame_goldens(device="cuda") -> None:
    """Phase 5, second half: the feature_wireframe golden under
    tests/test_goldens.py's rule, and golden config4's frame (the bench
    scene from the bench camera at 320x180).  config4.png was rendered from
    the Dust2 asset, which a checkout does not hold, so the card's frame is
    held by the same rule against the same frame on the CPU, and its
    distance from the PNG is printed."""
    from PIL import Image
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.engine import Engine

    def off_share(a, b):
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        return float(np.mean(np.any(diff > 2, axis=-1)))

    def golden(name):
        return np.asarray(Image.open(os.path.join(REPO, "tests", "goldens",
                                                  name)))

    scene, params, u = scenes.wireframe_golden_frame()
    got = Engine(scene, params, device=device).present(u)
    want = golden("feature_wireframe.png")
    off = off_share(got, want) if got.shape == want.shape else 1.0
    log(f"phase 5 golden feature_wireframe {params.width}x{params.height}: "
        f"{off:.6f} of pixels off by > 2")
    check(off < 2e-3, "golden feature_wireframe")
    scene, params, u = scenes.config4_golden_frame()
    got = Engine(scene, params, device=device).present(u)
    cpu = Engine(scene, params, device="cpu").present(u)
    off = off_share(got, cpu)
    log(f"phase 5 golden config4's frame {params.width}x{params.height}: "
        f"{off:.6f} of pixels off by > 2 from the same frame on the CPU; "
        f"{off_share(got, golden('config4.png')):.6f} from config4.png, "
        f"which shows the Dust2 map and not this scene")
    check(got.shape == cpu.shape and off < 2e-3, "golden config4's frame")


def counted_frames(render, frames: int, size) -> dict:
    """Phases 18-19: `frames` calls of render(i), each synchronised and
    timed on the host clock, with K1's and K5's counts set to 0 just
    before and read after each frame.  Returns the frame times, the K1
    and K5 launches of each frame and frame 0."""
    from softwarerenderer_tpu_torch.ops import tile_raster, vis_fold
    w, h = size
    tile_raster.LAUNCHES = vis_fold.VIS_LAUNCHES = 0
    frame_ms, k1, k5 = [], [], []
    first, finite = None, True
    for i in range(frames):
        n1, n5 = tile_raster.LAUNCHES, vis_fold.VIS_LAUNCHES
        t = time.perf_counter()
        color, depth = render(i)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
        k1.append(tile_raster.LAUNCHES - n1)
        k5.append(vis_fold.VIS_LAUNCHES - n5)
        finite &= bool(torch.isfinite(color).all()
                       and torch.isfinite(depth).all())
        check(color.shape == (h, w, 4) and depth.shape == (h, w),
              f"frame shapes {tuple(color.shape)} {tuple(depth.shape)}")
        if i == 0:
            first = (color, depth)
    check(finite, "non-finite frame")
    return {"frame_ms": frame_ms, "k1": k1, "k5": k5, "first": first,
            "median_ms": statistics.median(frame_ms[1:])}


def against_plain(name, first, plain) -> str:
    """Frame 0 against the same frame through the plain twins: at most
    FRAME_COVERED_MISMATCH_MAX of the covered pixels may differ (> 1e-5
    in color, in depth, in present).  Returns the counts as text."""
    from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR
    n_cov = int(((first[1] != DEPTH_CLEAR) | (plain[1] != DEPTH_CLEAR)).sum())
    n_c, n_d, n_rgb = _frame_diff(first, plain)
    limit = FRAME_COVERED_MISMATCH_MAX * n_cov
    h, w = first[1].shape
    check(n_cov > 0.05 * w * h, f"{name}: only {n_cov} pixels covered")
    check(max(n_c, n_d, n_rgb) <= limit, f"{name} frame 0 vs its plain "
          f"path: {n_c} color, {n_d} depth, {n_rgb} present pixels differ")
    return (f"frame 0 vs plain path: of {n_cov} covered pixels, {n_c} "
            f"differ > 1e-5 in color, {n_d} in depth, {n_rgb} in present")


def golden_off(got: np.ndarray, png: str) -> float:
    """tests/test_goldens.py's measure against tests/goldens/<png>: the
    share of pixels off by > 2 (1.0 for a shape mismatch)."""
    from PIL import Image
    want = np.asarray(Image.open(os.path.join(REPO, "tests", "goldens",
                                              png)))
    if got.shape != want.shape:
        return 1.0
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return float(np.mean(np.any(diff > 2, axis=-1)))


def timing_text(run, prof, w, h) -> str:
    steady = run["median_ms"]
    return (f"first frame {run['frame_ms'][0]:.1f} ms, median frame "
            f"{steady:.3f} ms = {w * h / steady / 1e3:.1f} Mpixels/s; "
            f"profiled: kernels {prof['kernels']:.3f} ms a frame, K1 "
            f"{prof['K1']:.3f} ms, K5 {prof['K5']:.3f} ms")


# Phase 18: counted frames of golden configs 3 and 5 at bench.py's sizes.
LIT_FRAMES = {3: 30, 5: 10}
# A PBR frame may differ card against CPU where torch.pow rounds
# differently on the two devices (the specular exponent amplifies an ulp
# up to 2048 times): at most this share of covered pixels by > 1e-5, and
# no pixel by more than 1e-3.
PBR_CPU_MISMATCH_MAX = 1e-3


def pbr_frame(device, size, env=None):
    """A glossy metal sphere and an emissive cube through the PBR shader,
    tests/test_pbr.py's materials and light, with the uniforms `env` (the
    environment terms) added: (color, depth) on the device."""
    from softwarerenderer_tpu_torch import RenderParams
    from softwarerenderer_tpu_torch.engine import Engine
    from softwarerenderer_tpu_torch.models import primitives
    from softwarerenderer_tpu_torch.models import scene as scene_mod
    from softwarerenderer_tpu_torch.ops import lighting
    from softwarerenderer_tpu_torch.utils import mathlib as ml
    metal = scene_mod.Material(base_color=(0.6, 0.6, 0.6, 1.0),
                               metallic=1.0, roughness=0.15)
    glow = scene_mod.Material(base_color=(1, 1, 1, 1), metallic=0.3,
                              roughness=0.6, emissive=(0.0, 0.9, 0.0))
    scene = scene_mod.build_scene_buffers([
        scene_mod.MeshInstance(primitives.uv_sphere(1.0, rings=24,
                                                    sectors=48),
                               ml.translation([-0.9, 0, -3.0]),
                               material=metal),
        scene_mod.MeshInstance(primitives.cube(1.0),
                               ml.matrix_from_yaw_pitch_roll(0.5, 0.3, 0)
                               @ ml.translation([1.2, 0, -3.5]),
                               material=glow)])
    eng = Engine(scene, RenderParams(*size), device=device,
                 vertex_shader=lighting.lit_scene_vertex_shader,
                 fragment_shader=lighting.pbr_scene_fragment_shader)
    u = dict(eng.uniforms)
    ld = np.float32([0.3, -0.5, -1.0])
    u["light_direction"] = ld / np.linalg.norm(ld)
    u["fog_start"], u["fog_end"] = np.float32(900.0), np.float32(1000.0)
    return eng.render(dict(u, **(env or {})))


def check_lit_frames(card, device="cuda") -> dict:
    """Phase 18: golden config 3 (41 meshes under four lights, the lit
    shaders) at 1920x1080 and config 5 (1,100 cubes) at 3840x2160 through
    Engine: LIT_FRAMES counted frames with one K1 launch each, frame 0
    against the plain path, the kernels' share; goldens config 3 and 5 on
    the card; a PBR frame at 320x180 against the CPU's."""
    from softwarerenderer_tpu_torch import RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import Engine, render_frame
    from softwarerenderer_tpu_torch.models.scene import build_scene_buffers
    from softwarerenderer_tpu_torch.ops import tile_raster
    out = {}
    for n, frames in LIT_FRAMES.items():
        w, h = scenes.BENCH_SIZES[n]
        params = RenderParams(w, h)
        shaders = scenes.golden_shaders(n)
        eng = Engine(build_scene_buffers(scenes.golden_config(n)), params,
                     device=device, **shaders)
        u = scenes.golden_uniforms(n, eng.uniforms)
        run = counted_frames(lambda i: eng.render(u), frames, (w, h))
        check(run["k1"] == [1] * frames and run["k5"] == [0] * frames,
              f"config {n}: K1 launches {run['k1']}, K5 {run['k5']}")
        plain = render_frame(eng.scene, u, params,
                             fold=tile_raster.tile_fold_plain, **shaders)
        text = against_plain(f"config {n}", run["first"], plain)
        prof = frame_kernel_ms(lambda: eng.render(u), 5)
        log(f"phase 18 config {n} @{w}x{h} ({len(scenes.golden_config(n))} "
            f"meshes, {'lit shaders' if shaders else 'game shaders'}): "
            f"{frames} frames, K1 launches {sum(run['k1'])}, "
            f"{timing_text(run, prof, w, h)}; {text} [{card}]")
        out[n] = dict(run, prof=prof)
        del run, plain

        gw, gh = scenes.GOLDEN_SIZES[n]
        g_eng = Engine(build_scene_buffers(scenes.golden_config(n)),
                       RenderParams(gw, gh), device=device, **shaders)
        off = golden_off(g_eng.present(scenes.golden_uniforms(
            n, g_eng.uniforms)), f"config{n}.png")
        log(f"phase 18 golden config{n} {gw}x{gh}: {off:.6f} of pixels off "
            f"by > 2")
        check(off < 2e-3, f"golden config{n}")

    size = SMALL_ROUTES_SIZE
    card_f = [x.cpu() for x in pbr_frame(device, size)]
    cpu_f = pbr_frame("cpu", size)
    n_c, n_d, n_rgb = _frame_diff(card_f, cpu_f)
    err = float((card_f[0] - cpu_f[0]).abs().max())
    n_cov = int((cpu_f[1] > -3e38).sum())
    log(f"phase 18 PBR frame @{size[0]}x{size[1]}, card vs CPU: of {n_cov} "
        f"covered pixels {n_c} differ > 1e-5 in color (max abs diff "
        f"{err:.3g}), {n_d} in depth, {n_rgb} in to_rgb8 [{card}]")
    check(n_cov > 0.05 * size[0] * size[1], "PBR frame: nothing drawn")
    check(n_c <= PBR_CPU_MISMATCH_MAX * n_cov and err <= 1e-3 and n_d == 0,
          f"PBR frame card vs CPU: {n_c} color, {n_d} depth pixels differ")
    return out


# Phase 19: the shadowed frames at 1080p, their maps at the frame
# functions' default sizes, and the K1 and K5 launches of a frame.
SHADOW_FRAMES = 10
SHADOW_SIZES = {"shadows": 512, "point_shadows": 256, "spot_shadows": 512}
SHADOW_LAUNCHES = {"shadows": (1, 1), "point_shadows": (1, 6),
                   "spot_shadows": (1, 1)}


def checked_light_fold(texels: list):
    """A light-pass visibility_fn for the timed frames: the fold the frame
    would run itself (shadows.light_pass_visibility) and, while texels[0]
    is set, visibility_fold_plain on the same triangles, appending
    (texels that differ, texels covered) a pass to texels[1]."""
    from softwarerenderer_tpu_torch.ops import shadows, vis_fold
    from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR
    plain = vis_fold.make_visibility_fold(vis_fold.visibility_fold_plain)

    def fold(tris, sp):
        out = shadows.light_pass_visibility(sp, tris["depth"].device)(
            tris, sp)
        if texels[0]:
            q, _ = plain(tris, sp)
            texels[1].append((int((out[0] != q).sum()),
                              int((q != DEPTH_CLEAR).sum())))
        return out
    return fold


def check_shadowed_frames(card, device="cuda", size=(W, H)) -> dict:
    """Phase 19: the directional, point and spot shadowed frames
    (scenes.shadow_golden_frame's scenes) at `size` through
    Engine(frame_fn=...) with the lit shaders: SHADOW_FRAMES counted
    frames with their K1 and K5 launches, frame 0's light passes each
    held against visibility_fold_plain on the same triangles on every
    texel; frame 0 against the plain path (K1's and K5's twins); the
    kernels' share; the three feature goldens on the card."""
    from softwarerenderer_tpu_torch import RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import Engine, to_rgb8
    from softwarerenderer_tpu_torch.models.convert import scene_to_torch
    from softwarerenderer_tpu_torch.ops import tile_raster, vis_fold
    plain_vis = vis_fold.make_visibility_fold(vis_fold.visibility_fold_plain)
    w, h = size
    params = RenderParams(w, h)
    out = {}
    for name, S in SHADOW_SIZES.items():
        scene, g_params, u, golden_fn, shaders = \
            scenes.shadow_golden_frame(name)
        fn = functools.partial(golden_fn.func, shadow_size=S)
        texels = [False, []]
        eng = Engine(scene, params, device=device, frame_fn=functools.partial(
            fn, visibility_fn=checked_light_fold(texels)), **shaders)

        def render(i):
            texels[0] = i == 0
            return eng.render(u)
        run = counted_frames(render, SHADOW_FRAMES, size)
        n1, n5 = SHADOW_LAUNCHES[name]
        maps = texels[1]
        check(run["k1"] == [n1] * SHADOW_FRAMES
              and run["k5"] == [n5] * SHADOW_FRAMES and len(maps) == n5,
              f"{name}: K1 launches {run['k1']}, K5 {run['k5']}, "
              f"{len(maps)} light passes checked")
        check(all(d == 0 for d, _ in maps),
              f"{name}: K5's light-pass maps differ from the plain fold's "
              f"on {[d for d, _ in maps]} texels")
        check(sum(c for _, c in maps) > 0, f"{name}: empty shadow maps")
        plain = fn(eng.scene, u, params, fold=tile_raster.tile_fold_plain,
                   visibility_fn=plain_vis, **shaders)
        text = against_plain(name, run["first"], plain)
        prof = frame_kernel_ms(lambda: eng.render(u), 5)
        log(f"phase 19 {name} @{w}x{h}, {len(maps)} light pass"
            f"{'es' if len(maps) > 1 else ''} of {S}x{S}: frame 0's K5 maps "
            f"vs the plain fold differ on {sum(d for d, _ in maps)} texels "
            f"(of {sum(c for _, c in maps)} covered); {SHADOW_FRAMES} "
            f"frames, launches a frame K1 {n1} + K5 {n5}; "
            f"{timing_text(run, prof, w, h)}; {text} [{card}]")
        out[name] = dict(run, prof=prof)
        del run, plain

        st = scene_to_torch(scene, device)
        off = golden_off(to_rgb8(golden_fn(st, u, g_params)[0]).cpu().numpy(),
                         f"feature_{name}.png")
        log(f"phase 19 golden feature_{name} {g_params.width}x"
            f"{g_params.height}: {off:.6f} of pixels off by > 2")
        check(off < 2e-3, f"golden feature_{name}")
    return out


# Phase 20: the image-quality frames.
IQ_FRAMES = 10
RT_SKY_FRAMES = 3
# The PBR frame with its environment terms, card against CPU: atan2 and
# asin may round differently on the two devices, and a panorama lookup
# scales an ulp of its coordinate by the panorama's width; at most this
# share of covered pixels may differ by > 1e-5, and none by more than
# 1e-3 (as PBR_CPU_MISMATCH_MAX).
PBR_ENV_CPU_MISMATCH_MAX = 0.05


def sky_share(frame, clear) -> float:
    """The share of a frame's clear-depth pixels whose color is not the
    clear color `clear` (a device tensor): where the sky shows."""
    from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR
    color, depth = frame
    miss = depth == DEPTH_CLEAR
    return float(((color - clear).abs().amax(-1) > 1e-3)[miss].float()
                 .mean())


def check_image_quality_frames(card, device="cuda", size=(W, H)) -> None:
    """Phase 20: the bench scene at `size` with ssaa=2, trilinear mips,
    SSAO, bloom, ACES and FXAA under a seeded sky (Engine with the
    trilinear shader): IQ_FRAMES counted frames with one K1 launch each
    at twice the size in each axis, frame 0 against the plain path; K1 on
    that frame's inputs against its twin, timed beside its bound; the
    frame's kernels, launches and host syncs by the profiler and those of
    the same frame without the post chain; the goldens feature_mips (held
    against the same frame on the CPU: its PNG has XLA's contracted
    rounding, ROADMAP queue C), _trilinear, _ssaa and _ssao; the
    ray-traced bench frame under the sky with K4 launches 1 + 1, frame 0
    against K4's twin, and K4 on its two casts timed beside their bounds;
    a PBR frame with env_panorama and env_irradiance against the CPU's."""
    from softwarerenderer_tpu_torch import RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import (
        Engine, render_frame, scene_fragment_shader_trilinear)
    from softwarerenderer_tpu_torch.ops import (post_kernels, rt_sweep,
                                                tile_raster)
    from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR
    from softwarerenderer_tpu_torch.ops.raytrace import render_frame_raytraced
    w, h = size
    trilinear = scene_fragment_shader_trilinear
    params = RenderParams(w, h, ssaa=2, use_mipmaps="trilinear", ssao=True,
                          bloom=True, tonemap="aces", fxaa=True)
    pano = scenes.sky_panorama()
    eng = Engine(scenes.bench_scene(), params, device=device,
                 fragment_shader=trilinear)

    def u_at(i):
        return dict(scenes.camera_uniforms(eng.uniforms, i),
                    sky_panorama=pano)

    post_kernels.LAUNCHES.update(dict.fromkeys(post_kernels.STAGES, 0))
    run = counted_frames(lambda i: eng.render(u_at(i)), IQ_FRAMES, size)
    check(run["k1"] == [1] * IQ_FRAMES and run["k5"] == [0] * IQ_FRAMES,
          f"image-quality frame: K1 launches {run['k1']}, K5 {run['k5']}")
    check(post_kernels.LAUNCHES == dict.fromkeys(post_kernels.STAGES,
                                                 IQ_FRAMES),
          f"image-quality frame: post kernel launches "
          f"{post_kernels.LAUNCHES} in {IQ_FRAMES} frames")
    post_launches = sum(post_kernels.LAUNCHES.values())
    plain = render_frame(eng.scene, u_at(0), params,
                         fragment_shader=trilinear,
                         fold=tile_raster.tile_fold_plain)
    text = against_plain("image-quality frame", run["first"], plain)
    clear = torch.as_tensor(eng.uniforms["clear_color"], device=device)
    sky_px = sky_share(run["first"], clear)
    check(sky_px > 0.9, f"the sky shows on {sky_px:.3f} of missed pixels")
    del plain

    _, calls = capture_folds(
        lambda f: render_frame(eng.scene, u_at(0), params,
                               fragment_shader=trilinear, fold=f),
        tile_raster.tile_fold)
    check(len(calls) == 1, f"{len(calls)} folds in one frame")
    args, kwargs, (kg, kd, ki) = calls[0]
    check(ki.shape[0] >= 2 * h and ki.shape[1] >= 2 * w,
          f"K1 folded {tuple(ki.shape)}, not {2 * w}x{2 * h}")
    pg, pd, pi = tile_raster.tile_fold_plain(*args, **kwargs)
    n_i, n_d = int((ki != pi).sum()), int((kd != pd).sum())
    g_err = float((kg - pg).abs().max())
    check(n_i == 0 and n_d == 0 and g_err <= GBUF_ATOL,
          f"K1 at {2 * w}x{2 * h}: best_i differs on {n_i}, best_d on "
          f"{n_d} pixels, G-buffer {g_err}")
    k1_ms = cuda_ms(lambda: tile_raster.tile_fold(*args, **kwargs),
                    KERNEL_RUNS)
    k1_plain_ms = cuda_ms(
        lambda: tile_raster.tile_fold_plain(*args, **kwargs), 3)
    k1_bound = fold_bound(args, kwargs, (kg, kd, ki))
    del calls, args, kwargs, kg, kd, ki, pg, pd, pi
    prof = frame_kernel_ms(lambda: eng.render(u_at(0)), 5)
    prof["syncs"] = host_syncs(lambda i: eng.render(u_at(i)), 3)
    bare = params.replace(ssao=False, bloom=False, tonemap=None, fxaa=False)
    bare_eng = Engine(scenes.bench_scene(), bare, device=device,
                      fragment_shader=trilinear)
    bare_u = scenes.camera_uniforms(bare_eng.uniforms, 0)
    bare_prof = frame_kernel_ms(lambda: bare_eng.render(bare_u), 5)
    log(f"phase 20 image-quality frame @{w}x{h}, ssaa=2 (K1 at {2 * w}x"
        f"{2 * h}), trilinear, SSAO, bloom, ACES, FXAA, sky: {IQ_FRAMES} "
        f"frames, K1 launches {sum(run['k1'])}, post kernel launches "
        f"{post_launches} (1 a stage a frame), "
        f"{timing_text(run, prof, w, h)}; {prof['launches']:.0f} launches "
        f"and {prof['syncs']:.1f} host syncs a frame; without the post "
        f"chain and sky {bare_prof['launches']:.0f} launches, kernels "
        f"{bare_prof['kernels']:.3f} ms; the sky on {sky_px:.4f} of missed "
        f"pixels; {text} [{card}]")
    log(f"phase 20 K1 at {2 * w}x{2 * h} (the ssaa frame's inputs): kernel "
        f"vs plain equal (best_i, best_d, G-buffer max abs diff "
        f"{g_err:.3g}); kernel {k1_ms:.3f} ms (median of {KERNEL_RUNS}), "
        f"plain {k1_plain_ms:.3f} ms (median of 3); bound "
        f"{k1_bound['bound_ms']:.4f} ms ({k1_bound['bound_by']}, "
        f"{k1_bound['tests']} tests) [{card}]")
    del run, eng, bare_eng

    for name in ("mips", "trilinear", "ssaa", "ssao"):
        scene, g_params, g_u, shaders = scenes.feature_golden_frame(name)
        got = Engine(scene, g_params, device=device,
                     **shaders).present(g_u)
        off = golden_off(got, f"feature_{name}.png")
        if name == "mips":
            cpu = Engine(scene, g_params, device="cpu",
                         **shaders).present(g_u)
            diff = np.abs(got.astype(np.int32) - cpu.astype(np.int32))
            cpu_off = float(np.mean(np.any(diff > 2, axis=-1)))
            log(f"phase 20 golden feature_mips {g_params.width}x"
                f"{g_params.height}: {cpu_off:.6f} of pixels off by > 2 "
                f"from the same frame on the CPU; {off:.6f} from the PNG, "
                f"whose floor rows sit on texel edges in XLA's contracted "
                f"rounding")
            check(cpu_off < 2e-3, "golden feature_mips' frame")
            continue
        log(f"phase 20 golden feature_{name} {g_params.width}x"
            f"{g_params.height}: {off:.6f} of pixels off by > 2")
        check(off < 2e-3, f"golden feature_{name}")

    rt_eng = Engine(scenes.bench_scene(), RenderParams(w, h), device=device,
                    frame_fn=functools.partial(render_frame_raytraced,
                                               cluster_cap=RT_CAP))

    def rt_u(i):
        return dict(scenes.camera_uniforms(rt_eng.uniforms, i),
                    sky_panorama=pano)

    per_frame, rt_ms = [], []
    for i in range(RT_SKY_FRAMES):
        n0, a0 = rt_sweep.LAUNCHES, rt_sweep.ANY_HIT_LAUNCHES
        t = time.perf_counter()
        color, depth = rt_eng.render(rt_u(i))
        torch.cuda.synchronize()
        rt_ms.append((time.perf_counter() - t) * 1e3)
        per_frame.append((rt_sweep.LAUNCHES - n0
                          - (rt_sweep.ANY_HIT_LAUNCHES - a0),
                          rt_sweep.ANY_HIT_LAUNCHES - a0))
        if i == 0:
            first = (color, depth)
    check(all(p == (1, 1) for p in per_frame),
          f"ray-traced sky frame: K4 launches per frame {per_frame}")
    twin = render_frame_raytraced(rt_eng.scene, rt_u(0), RenderParams(w, h),
                                  cluster_cap=RT_CAP,
                                  sweep=rt_sweep.rt_sweep_plain)
    n_c, n_d, n_rgb = _frame_diff(first, twin)
    rt_miss = first[1] == DEPTH_CLEAR
    rt_sky = sky_share(first, clear)
    rt_prof = frame_kernel_ms(lambda: rt_eng.render(rt_u(0)), 3)
    casts = capture_sweeps(lambda sw: render_frame_raytraced(
        rt_eng.scene, rt_u(0), RenderParams(w, h), cluster_cap=RT_CAP,
        sweep=sw))
    check(len(casts) == 2, f"{len(casts)} K4 casts in the sky frame")
    k4 = {}
    for (args, kwargs), cast in zip(casts, ("nearest", "any-hit")):
        tested = torch.zeros_like(args[3])
        outs = rt_sweep.rt_sweep(*args, **kwargs, tested=tested)
        k4[cast] = dict(
            sweep_bound_tested(args, outs, tested),
            ms=cuda_ms(lambda: rt_sweep.rt_sweep(*args, **kwargs),
                       KERNEL_RUNS))
    log(f"phase 20 ray-traced bench frame @{w}x{h} under the sky, "
        f"cluster_cap={RT_CAP}: {RT_SKY_FRAMES} frames, K4 launches a "
        f"frame {per_frame[0][0]} nearest + {per_frame[0][1]} any-hit, "
        f"frames {', '.join(f'{t:.1f}' for t in rt_ms)} ms; profiled: "
        f"kernels {rt_prof['kernels']:.3f} ms a frame, K4 "
        f"{rt_prof['K4']:.3f} ms, {rt_prof['launches']:.0f} launches; K4 "
        + "; ".join(f"{c} {b['ms']:.3f} ms (median of {KERNEL_RUNS}), "
                    f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})"
                    for c, b in k4.items())
        + f"; the sky on {rt_sky:.4f} of {int(rt_miss.sum())} missed "
        f"pixels; frame 0 vs K4's twin: {n_c} pixels differ > 1e-5 in "
        f"color, {n_d} in depth, {n_rgb} in to_rgb8 [{card}]")
    limit = FRAME_COVERED_MISMATCH_MAX * w * h
    check(max(n_c, n_d, n_rgb) <= limit, "ray-traced sky frame vs twin")
    check(rt_sky > 0.9, f"the sky shows on {rt_sky:.3f} of missed pixels")
    del rt_eng, first, twin, casts

    from softwarerenderer_tpu_torch.ops.sky import irradiance_panorama
    env = {"env_panorama": pano, "env_irradiance": irradiance_panorama(pano)}
    small = SMALL_ROUTES_SIZE
    card_f = [x.cpu() for x in pbr_frame(device, small, env)]
    cpu_f = pbr_frame("cpu", small, env)
    bare_f = pbr_frame("cpu", small)
    n_c, n_d, n_rgb = _frame_diff(card_f, cpu_f)
    err = float((card_f[0] - cpu_f[0]).abs().max())
    n_cov = int((cpu_f[1] > -3e38).sum())
    lit = int(((cpu_f[0] - bare_f[0]).abs().amax(-1) > 1e-3).sum())
    log(f"phase 20 PBR frame with env_panorama and env_irradiance "
        f"@{small[0]}x{small[1]}, card vs CPU: of {n_cov} covered pixels "
        f"({lit} changed by the environment) {n_c} differ > 1e-5 in color "
        f"(max abs diff {err:.3g}), {n_d} in depth, {n_rgb} in to_rgb8 "
        f"[{card}]")
    check(lit > 0.5 * n_cov, "the environment terms changed too little")
    check(n_c <= PBR_ENV_CPU_MISMATCH_MAX * n_cov and err <= 1e-3
          and n_d == 0, f"PBR environment frame card vs CPU: {n_c} color, "
          f"{n_d} depth pixels differ")


def check_post_kernels(card, device="cuda", size=(2 * W, 2 * H)) -> dict:
    """Phase 20: each post kernel (csrc/post_fx.cu) alone at `size`, the
    image-quality frame's supersampled size, on the bench frame's color and
    depth at that size with the trilinear shader under a seeded sky, each
    stage fed the one before it as in the chain: equal to its plain twin
    on every value, timed with CUDA events (median of KERNEL_RUNS) beside
    its byte bound (every input read once, the frame written once) and
    its twin (median of PLAIN_RUNS).  Returns {stage: numbers}."""
    from softwarerenderer_tpu_torch import RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import (
        Engine, scene_fragment_shader_trilinear)
    from softwarerenderer_tpu_torch.engine.renderer import post_uniforms
    from softwarerenderer_tpu_torch.ops import (bloom, fxaa, post_kernels,
                                                sky, ssao, tonemap)
    w, h = size
    eng = Engine(scenes.bench_scene(),
                 RenderParams(w, h, use_mipmaps="trilinear"), device=device,
                 fragment_shader=scene_fragment_shader_trilinear)
    u = dict(scenes.camera_uniforms(eng.uniforms, 0),
             sky_panorama=scenes.sky_panorama())
    pu = post_uniforms(u, device)
    color, depth = eng.render(u)
    rays = sky.ray_basis(u, w, h, device)
    # The sky's kernel is timed alone: composite_sky computes and stages
    # its camera basis on the host first, which the events would count.
    stages = (
        ("sky", lambda c: post_kernels.sky(c, depth, rays,
                                           pu["sky_panorama"]),
         lambda c: sky.composite_sky_plain(c, depth, u,
                                           pu["sky_panorama"])[0],
         (depth, pu["sky_panorama"], rays)),
        ("ssao", lambda c: ssao.apply_ssao(c, depth, pu)[0],
         lambda c: ssao.apply_ssao_plain(c, depth, pu)[0], (depth,)),
        ("bloom", lambda c: bloom.apply_bloom(c),
         lambda c: bloom.apply_bloom_plain(c), ()),
        ("tonemap", lambda c: tonemap.apply_tonemap(c, "aces", pu),
         lambda c: tonemap.apply_tonemap_plain(c, "aces", pu), ()),
        ("fxaa", lambda c: fxaa.apply_fxaa(c),
         lambda c: fxaa.apply_fxaa_plain(c), ()))
    out = {}
    for name, kernel, twin, more in stages:
        got, want = kernel(color), twin(color)
        n_off = int((got != want).sum())
        check(n_off == 0, f"post {name} kernel at {w}x{h}: {n_off} values "
              f"differ from its twin, max "
              f"{float((got - want).abs().max()):.3g}")
        ms = cuda_ms(lambda: kernel(color), KERNEL_RUNS)
        plain_ms = cuda_ms(lambda: twin(color), PLAIN_RUNS)
        b = bound(nbytes(color, got, *more), 0.0)
        out[name] = dict(b, ms=ms, plain_ms=plain_ms, max_abs_err=0.0)
        log(f"phase 20 post kernel {name} @{w}x{h}: equal to its twin on "
            f"every value; kernel {ms:.4f} ms (median of {KERNEL_RUNS}), "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
            f"{100 * b['bound_ms'] / ms:.1f} % of it; twin {plain_ms:.3f} "
            f"ms (median of {PLAIN_RUNS}) [{card}]")
        color = got
    return out


# Phase 20's shading kernel: the benchmark cells whose frames it shades,
# the seed of their inputs and the frames counted along each cell's path.
SHADE_CELLS = ("lodcrowd-4k.sweep", "lodcrowd-iq-1080p.pan")
SHADE_SEED = 2600000001
SHADE_FRAMES = 8


def shade_bound(args) -> dict:
    """Bound of one shading pass (tile_shade.shade's arguments): each
    covered pixel reads its G-buffer channels and depth once, every pixel
    its winner and framebuffer depth once and writes color and depth once,
    the framebuffer color read once (16 bytes when it is the clear color
    expanded); the atlas's texels are left out (mostly from cache) and the
    operations are negligible."""
    from softwarerenderer_tpu_torch.ops import tile_shade
    fetch, ctx, gbuf, best_d, best_i, u, params, fb_c, fb_d = args
    H, W = ctx["H"], ctx["W"]
    covered = int((best_i[:H, :W] >= 0).sum())
    planes = len(tile_shade.planes_of(ctx, fetch))
    fb_bytes = 16 if fb_c.stride()[:2] == (0, 0) else H * W * 16
    out = bound(covered * (planes + 1) * 4 + H * W * 28 + fb_bytes, 0.0)
    out.update(covered=covered, planes=planes)
    return out


def check_shade_kernel(card) -> dict:
    """Phase 20: the tile route's shading kernel (csrc/tile_shade.cu) on
    both benchmark cells' frames, portbench's Program for each cell at
    SHADE_SEED along the cell's camera path: SHADE_FRAMES frames under
    recording() launch it once per engine.render; the last frame's
    shading inputs, captured, give the kernel's color and depth equal to
    its plain twin's (tile_raster.shade_plain) on every value; the kernel is
    timed with CUDA events around its wrapper (median of KERNEL_RUNS),
    alone in a profiler trace, beside its byte bound (shade_bound) and the
    twin (median of PLAIN_RUNS).  Registers and spills: phase 2.  Returns
    {cell: numbers}."""
    from portbench import harness
    from softwarerenderer_tpu_torch.ops import tile_raster, tile_shade
    from softwarerenderer_tpu_torch.utils import profiling
    out = {}
    for name in SHADE_CELLS:
        cell = harness.cell_of(name)
        mod = cell["module"]
        prog = mod.Program(mod.make_inputs(SHADE_SEED), "cuda")
        calls = []
        shade = tile_shade.shade

        def spy(*args):
            calls.append(args)
            return shade(*args)

        n0 = sum(tile_shade.LAUNCHES.values())
        profiling.reset_span_totals()
        tile_shade.shade = spy
        try:
            with profiling.recording():
                for i in range(SHADE_FRAMES):
                    prog.render(harness.camera_at(cell["camera"], i))
                torch.cuda.synchronize()
        finally:
            tile_shade.shade = shade
        renders = profiling.span_totals()["engine.render"]["calls"]
        launches = sum(tile_shade.LAUNCHES.values()) - n0
        check(launches == renders == SHADE_FRAMES,
              f"{name}: {launches} shade kernel launches over {renders} "
              f"engine.render calls, expected {SHADE_FRAMES} of each")
        args = calls[-1]
        fetch, ctx, gbuf, bd, bi, u, params, fb_c, fb_d = args
        got = shade(*args)
        want = tile_raster.shade_plain(ctx, gbuf, bd, bi,
                                       prog.engine.fragment_shader, u,
                                       params, fb_c, fb_d)
        torch.cuda.synchronize()
        n_off = [_differing(g, w.cpu()) for g, w in zip(got, want)]
        check(n_off == [0, 0], f"{name}: the shade kernel's color and depth "
              f"differ from its twin's on {n_off} values")
        ms = cuda_ms(lambda: shade(*args), KERNEL_RUNS)
        alone = device_ms(lambda: shade(*args), KERNEL_RUNS,
                          "tile_shade_kernel")
        plain_ms = cuda_ms(lambda: tile_raster.shade_plain(
            ctx, gbuf, bd, bi, prog.engine.fragment_shader, u, params, fb_c,
            fb_d), PLAIN_RUNS)
        b = shade_bound(args)
        H, W = ctx["H"], ctx["W"]
        out[name] = dict(b, ms=ms, alone_ms=alone, plain_ms=plain_ms,
                         launches_per_render=launches / renders)
        log(f"phase 20 shade kernel <{fetch}> on {name} @{W}x{H} "
            f"(sr {params.shade_rate}): {launches} launches in {renders} "
            f"engine.render; equal to its twin on every value; "
            f"{b['covered']} covered pixels, {b['planes']} planes; kernel "
            f"{ms:.4f} ms with its wrapper (median of {KERNEL_RUNS}), "
            f"{alone:.4f} ms alone; bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}), {100 * b['bound_ms'] / alone:.1f} % of it; "
            f"twin {plain_ms:.3f} ms (median of {PLAIN_RUNS}) [{card}]")
    return out


# Phase 21: the animated frame (scenes.animated_scene).
ANIMATED_FRAMES = 10
ANIMATED_SHADOW_FRAMES = 5
ANIMATED_SHADOW_SIZE = 512
ANIMATED_CPU_SIZE = (320, 180)
# Frames of animated_uniforms whose updates and LOD masks are held card
# against CPU, and the two whose light-pass maps must differ (0 and 0.5 s).
ANIMATED_CPU_FRAMES = (0, 5, 9)
ANIMATED_POSES = (0, 30)


def _differing(got: torch.Tensor, want: torch.Tensor) -> int:
    """Values of got (moved to the CPU) that differ from want, NaN equal
    to NaN."""
    got = got.cpu()
    same = (got == want) | (torch.isnan(got) & torch.isnan(want)) \
        if got.is_floating_point() else got == want
    return int((~same).sum())


def _mesh_levels(scene, mask: torch.Tensor) -> torch.Tensor:
    """Each mesh's active LOD level under a LOD mask (on the CPU)."""
    mask = mask.cpu()
    levels = torch.zeros(scene["mesh_lod_px"].shape[0], dtype=torch.int32)
    levels[scene["tri_mesh_id"].cpu().long()[mask]] = \
        scene["tri_lod_level"].cpu()[mask]
    return levels


def check_path_fold(card, name, calls, fold, plain, *kernels,
                    phase="21") -> dict:
    """A fold kernel (K1 or K5) on the one call a path made of it
    (capture_folds' (args, kwargs, outputs)): held against its plain twin
    (winners and depths equal on every pixel, a G-buffer within
    GBUF_ATOL), timed with its wrapper (CUDA events) and alone (device_ms),
    its plain twin timed, and its bound."""
    check(len(calls) == 1, f"{name}: {len(calls)} fold calls")
    args, kwargs, out = calls[0]
    want = plain(*args, **kwargs)
    n_i, n_d = int((out[-1] != want[-1]).sum()), \
        int((out[-2] != want[-2]).sum())
    g_err = float((out[0] - want[0]).abs().max()) if len(out) == 3 else 0.0
    check(n_i == 0 and n_d == 0 and g_err <= GBUF_ATOL,
          f"{name}: winners differ on {n_i}, depths on {n_d} pixels, "
          f"G-buffer {g_err}")
    b = fold_bound(args, kwargs, out)
    res = dict(b, max_abs_err=g_err,
               alone_ms=device_ms(lambda: fold(*args, **kwargs), KERNEL_RUNS,
                                  *kernels),
               ms=cuda_ms(lambda: fold(*args, **kwargs), KERNEL_RUNS),
               plain_ms=cuda_ms(lambda: plain(*args, **kwargs), 3))
    log(f"phase {phase} {name}: kernel vs plain equal (winners, depths; "
        f"G-buffer max abs diff {g_err:.3g}); with its wrapper "
        f"{res['ms']:.3f} ms (median of {KERNEL_RUNS}, CUDA events), alone "
        f"{res['alone_ms']:.4f} ms (profiler), plain {res['plain_ms']:.3f} "
        f"ms (median of 3); bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
        f"{b['tests']} tests) [{card}]")
    return res


def check_animated_frames(card, device="cuda", size=(W, H)) -> dict:
    """Phase 21: scenes.animated_scene (a normal-mapped floor, 64 skinned
    tentacles, 8 flip-book meshes, 4 morphing meshes, a 1,024-slot
    emitter, 16 meshes of 2 LOD levels) at `size` through Engine with the
    normal-mapped shaders: ANIMATED_FRAMES counted frames, anim_time
    stepping 1/60 s, one K1 launch each, frame 0 against the plain path;
    K1 on that frame's inputs against its twin, timed beside its bound;
    the vertex updates (positions, normals, tangents, colors) and the LOD
    mask against the same calls on the CPU at ANIMATED_CPU_SIZE and the
    meshes' levels at both heights, every value equal; the frame's
    launches and host syncs by the profiler, the frame.vertex_updates
    span's host time under profiling.recording() and its kernel time by
    the profiler, and what the updates launch alone; the directional
    shadowed frame of the same scene with a 512-texel map, K1 + K5 1 + 1 a
    frame, frame 0's light pass through K5 against the plain fold on every
    texel, K5 on that pass's inputs against its twin, timed beside its
    bound, frame 0 against the plain path, the light maps of two poses
    different; golden feature_skinning."""
    from softwarerenderer_tpu_torch import RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import Engine, render_frame
    from softwarerenderer_tpu_torch.engine.renderer import (
        device_uniforms, frame_vertices, posed_geometry,
        render_frame_with_shadows)
    from softwarerenderer_tpu_torch.models.convert import scene_to_torch
    from softwarerenderer_tpu_torch.ops import (binning, lighting, lod,
                                                normalmap, shadows,
                                                tile_raster, vis_fold)
    from softwarerenderer_tpu_torch.utils import profiling
    from portbench import tracesum
    w, h = size
    params = RenderParams(w, h)
    shaders = dict(vertex_shader=normalmap.normal_mapped_vertex_shader,
                   fragment_shader=normalmap.normal_mapped_fragment_shader)
    scene = scenes.animated_scene()
    eng = Engine(scene, params, device=device, **shaders)
    base_u = dict(eng.uniforms)

    def u_at(i):
        return scenes.animated_uniforms(base_u, i)

    run = counted_frames(lambda i: eng.render(u_at(i)), ANIMATED_FRAMES,
                         size)
    check(run["k1"] == [1] * ANIMATED_FRAMES
          and run["k5"] == [0] * ANIMATED_FRAMES,
          f"animated frame: K1 launches {run['k1']}, K5 {run['k5']}")
    plain = render_frame(eng.scene, u_at(0), params,
                         fold=tile_raster.tile_fold_plain, **shaders)
    text = against_plain("animated frame", run["first"], plain)
    del plain
    k1 = check_path_fold(
        card, "K1 on the animated frame's inputs", capture_folds(
            lambda f: render_frame(eng.scene, u_at(0), params, fold=f,
                                   **shaders), tile_raster.tile_fold)[1],
        tile_raster.tile_fold, tile_raster.tile_fold_plain,
        "tile_raster_kernel")

    cpu_scene = scene_to_torch(scene, "cpu")
    sw, sh = ANIMATED_CPU_SIZE
    n_vals = n_diff = n_lod = n_lod_diff = n_mesh_diff = 0
    for i in ANIMATED_CPU_FRAMES:
        u = u_at(i)
        card_u = device_uniforms(u, sw, sh, device)
        cpu_u = device_uniforms(u, sw, sh, "cpu")
        got = frame_vertices(eng.scene, card_u)
        want = frame_vertices(cpu_scene, cpu_u)
        check(sorted(got) == sorted(want), f"update keys {sorted(got)}")
        for k in ("position", "normal", "tangent", "color"):
            n_vals += want[k].numel()
            n_diff += _differing(got[k], want[k])
        for rows in (sh, H):
            card_m = lod.lod_tri_mask(eng.scene, card_u, rows)
            cpu_m = lod.lod_tri_mask(cpu_scene, cpu_u, rows)
            n_lod += cpu_m.numel()
            n_lod_diff += _differing(card_m, cpu_m)
            n_mesh_diff += int((_mesh_levels(eng.scene, card_m)
                                != _mesh_levels(cpu_scene, cpu_m)).sum())
    levels = {rows: torch.bincount(_mesh_levels(
        cpu_scene, lod.lod_tri_mask(cpu_scene, cpu_u, rows))[
            cpu_scene["mesh_lod_px"][:, 0] > 0].long(), minlength=2).tolist()
        for rows in (sh, H)}
    check(n_diff == 0 and n_lod_diff == 0 and n_mesh_diff == 0,
          f"animated updates card vs CPU: {n_diff} values, {n_lod_diff} "
          f"LOD mask entries, {n_mesh_diff} mesh levels differ")
    check(0 < levels[H][0] < sum(levels[H]),
          f"the LOD meshes' levels at {H} rows {levels[H]}")

    prof = frame_kernel_ms(lambda: eng.render(u_at(0)), 5)
    prof["syncs"] = host_syncs(lambda i: eng.render(u_at(i)), 3)
    span = "frame.vertex_updates"
    eng.render(u_at(0))
    torch.cuda.synchronize()
    profiling.reset_span_totals()
    with profiling.recording():
        for i in range(5):
            eng.render(u_at(i))
        torch.cuda.synchronize()
    spans = {"span_host_ms": {
        k: v["host_ms"] / 5 for k, v in profiling.span_totals().items()}}
    profiling.reset_span_totals()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as trace:
        for i in range(5):
            eng.render(u_at(i))
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        trace.export_chrome_trace(path)
        with open(path) as f:
            spans["span_kernel_ms"] = tracesum.summarize(
                json.load(f), 5, (span,), {})["span_kernel_ms"]
    du = device_uniforms(u_at(0), w, h, device)

    def updates():
        posed_geometry(eng.scene, du, h)
    upd = frame_kernel_ms(updates, 5)
    upd["syncs"] = host_syncs(lambda i: updates(), 3)
    upd_ms = cuda_ms(updates, KERNEL_RUNS)
    log(f"phase 21 animated frame @{w}x{h} (64 skinned tentacles, 15,360 "
        f"skinned vertices, 8 flip-books, 4 morphs, 1,024 particles, 16 LOD "
        f"meshes, normal-mapped): {ANIMATED_FRAMES} frames, K1 launches "
        f"{sum(run['k1'])}, {timing_text(run, prof, w, h)}; "
        f"{prof['launches']:.0f} launches and {prof['syncs']:.1f} host "
        f"syncs a frame; {span} span host {spans['span_host_ms'][span]:.3f}"
        f" ms, kernels {spans['span_kernel_ms'][span]:.3f} ms; the updates "
        f"and LOD mask alone: {upd['launches']:.0f} launches, "
        f"{upd['syncs']:.1f} host syncs, kernels {upd['kernels']:.3f} ms, "
        f"{upd_ms:.3f} ms (CUDA events, median of {KERNEL_RUNS}); {text} "
        f"[{card}]")
    log(f"phase 21 updates card vs CPU @{sw}x{sh}, frames "
        f"{ANIMATED_CPU_FRAMES}: {n_diff} of {n_vals} position, normal, "
        f"tangent and color values differ; LOD masks at {sh} and {H} rows: "
        f"{n_lod_diff} of {n_lod} entries, {n_mesh_diff} mesh levels "
        f"differ; LOD meshes at levels 0 / 1: {levels[sh]} at {sh} rows, "
        f"{levels[H]} at {H}")
    out = dict(run, prof=prof, updates=upd, updates_ms=upd_ms,
               span=spans)
    del run, eng

    S = ANIMATED_SHADOW_SIZE
    lit = dict(vertex_shader=lighting.lit_scene_vertex_shader,
               fragment_shader=shadows.shadowed_scene_fragment_shader)
    texels = [False, []]
    fn = functools.partial(render_frame_with_shadows, shadow_size=S)
    sh_eng = Engine(scene, params, device=device, frame_fn=functools.partial(
        fn, visibility_fn=checked_light_fold(texels)), **lit)

    def render(i):
        texels[0] = i == 0
        return sh_eng.render(u_at(i))
    srun = counted_frames(render, ANIMATED_SHADOW_FRAMES, size)
    maps = texels[1]
    check(srun["k1"] == [1] * ANIMATED_SHADOW_FRAMES
          and srun["k5"] == [1] * ANIMATED_SHADOW_FRAMES and len(maps) == 1,
          f"animated shadowed frame: K1 launches {srun['k1']}, K5 "
          f"{srun['k5']}, {len(maps)} light passes checked")
    check(maps[0][0] == 0 and maps[0][1] > 0, f"animated light pass: K5 "
          f"differs from the plain fold on {maps[0][0]} of {maps[0][1]} "
          f"covered texels")
    plain_vis = vis_fold.make_visibility_fold(vis_fold.visibility_fold_plain)
    plain = fn(sh_eng.scene, u_at(0), params,
               fold=tile_raster.tile_fold_plain, visibility_fn=plain_vis,
               **lit)
    stext = against_plain("animated shadowed frame", srun["first"], plain)
    del plain
    light = sh_eng.uniforms["light_direction"]
    view, proj, _ = shadows.directional_light_camera(
        light, *shadows.scene_bounds(sh_eng.scene))
    pose_maps = [shadows.render_shadow_depth(sh_eng.scene, u_at(i), view,
                                             proj, S, params)
                 for i in ANIMATED_POSES]
    moved = int((pose_maps[0] != pose_maps[1]).sum())
    check(moved > 0, "the light pass drew the same map at two poses")
    light_calls = []

    def capture_light_fold(tris, sp):
        args, kwargs = binning.fold_inputs(tris, sp, sp.tile_h, sp.tile_w,
                                           sp.span_cap)
        light_calls.append((args, kwargs, vis_fold.vis_fold(*args,
                                                            **kwargs)))
        return vis_fold.visibility_fold(tris, sp)
    fn(sh_eng.scene, u_at(0), params, visibility_fn=capture_light_fold,
       **lit)
    k5 = check_path_fold(card, "K5 on the animated light pass's inputs",
                         light_calls, vis_fold.vis_fold,
                         vis_fold.visibility_fold_plain, "vis_fold_kernel",
                         "vis_fold_plan_kernel")
    sprof = frame_kernel_ms(lambda: sh_eng.render(u_at(0)), 5)
    log(f"phase 21 animated shadowed frame @{w}x{h}, one {S}x{S} light "
        f"pass (light {[round(float(x), 3) for x in light]}): frame "
        f"0's K5 map vs the plain fold differ on {maps[0][0]} of "
        f"{maps[0][1]} covered texels; {ANIMATED_SHADOW_FRAMES} frames, "
        f"launches a frame K1 1 + K5 1; {timing_text(srun, sprof, w, h)}; "
        f"{sprof['launches']:.0f} launches a frame; the maps at frames "
        f"{ANIMATED_POSES} differ on {moved} texels; {stext} [{card}]")
    out["shadowed"] = dict(srun, prof=sprof)
    out["k1"], out["k5"] = k1, k5
    del srun, sh_eng, pose_maps

    g_scene, g_params, g_u, g_shaders = scenes.feature_golden_frame(
        "skinning")
    got = Engine(g_scene, g_params, device=device, **g_shaders).present(g_u)
    off = golden_off(got, "feature_skinning.png")
    log(f"phase 21 golden feature_skinning {g_params.width}x"
        f"{g_params.height}: {off:.6f} of pixels off by > 2")
    check(off < 2e-3, "golden feature_skinning")
    return out


# Phase 22: the simulation (bench.py config 4's coupled step, the crowd,
# the particle emitters, the PRNG), each held against the CPU.
SIM_STEPS = 240
SIM_CPU_STEPS = 60
# A second start for config 4, over the soup's middle: bench.py's (0, 3,
# 6) lies outside the soup and falls past it, this one lands, slides and
# walks on it (grounded in 42 of the first 60 steps).
SOUP_START = (0.0, 3.0, -3.0)
CROWD_SIZES = (1, 8, 32)
CROWD_CPU_STEPS = 30
CROWD_TIMED_STEPS = 20     # at N = 1 and 8; N = 32 runs SIM_STEPS
PARTICLE_STEPS = 60
SPARK_EVERY = 10           # a spark burst every 10 steps
PRNG_DRAWS = 10 ** 6
# Card against CPU: atan2, sin and cos (the facing quaternion only) may
# round differently on the two devices; aim and the normal draws use
# float64 log1p and correctly rounded roots, so 0 is expected there.
SIM_ROTATION_ATOL = 5e-7
SIM_AIM_ATOL = 1e-6
NORMAL_CARD_ULPS = 1


def _state_diff(got, want, loose=()) -> dict:
    """A state tree on the card against the same tree on the CPU: values,
    values that differ (bit for bit, NaN equal to NaN) outside `loose`,
    and the largest absolute difference of each leaf named in `loose`."""
    out = {"values": 0, "differ": 0, "loose": {}}
    for k, w in want.items():
        if isinstance(w, dict):
            sub = _state_diff(got[k], w, loose)
            out["values"] += sub["values"]
            out["differ"] += sub["differ"]
            for n, e in sub["loose"].items():
                out["loose"][n] = max(out["loose"].get(n, 0.0), e)
            continue
        out["values"] += w.numel()
        if k in loose:
            e = float((got[k].cpu() - w).abs().max()) if w.numel() else 0.0
            out["loose"][k] = max(out["loose"].get(k, 0.0), e)
        else:
            out["differ"] += _differing(got[k], w)
    return out


def _sum_diffs(diffs) -> dict:
    total = {"values": 0, "differ": 0, "loose": {}}
    for d in diffs:
        total["values"] += d["values"]
        total["differ"] += d["differ"]
        for n, e in d["loose"].items():
            total["loose"][n] = max(total["loose"].get(n, 0.0), e)
    return total


def crowd_rays(n: int, tris: int) -> dict:
    """The rays and chunks of one crowd step of n agents, from the
    shapes: the two probes' 2 x 9 rays an agent in one wave, six slide
    waves (snap and move, 3 iterations each) of 2 x 18 shell rays an
    agent, and the line-of-sight wave of n x n rays (every agent a
    target).  raycast_batch cuts a wave into chunks of MAX_BLOCK // T
    rays."""
    from softwarerenderer_tpu_torch.sim.raycast import MAX_BLOCK
    per = max(1, MAX_BLOCK // tris)
    waves = [18 * n] + [36 * n] * 6 + [n * n]
    rays = sum(waves)
    return {"rays": rays, "pairs": rays * tris,
            "chunks": sum(-(-r // per) for r in waves), "waves": len(waves)}


def check_simulation(card, device="cuda", size=(W, H)) -> dict:
    """Phase 22: the simulation on the card.  (a) bench.py config 4's
    coupled step (scenes.coupled_step: the collision world built in the
    step, character_step, the frame at 1280x720) for SIM_STEPS steps from
    bench.py's (0, 3, 6) and SIM_CPU_STEPS steps from SOUP_START: one K1
    launch and 0 host syncs a step, the first SIM_CPU_STEPS states of
    each start equal on every value to the same steps on the CPU with the
    render left out, frame 0 against the plain path, the step's time,
    kernels and launches.  (b) the crowd on the bench scene
    (scenes.crowd_setup / crowd_step: routing and combat) at N = 1, 8
    and 32: steps timed with their kernels, launches and rays; at N = 32,
    SIM_STEPS steps and the first CROWD_CPU_STEPS states equal to the
    CPU's (rotation and aim within their bounds); the share of
    agent-steps still on the soup.  (c) the dust2 app's
    256-slot spark emitter and a 1,024-slot fountain, each feeding
    particle_uniforms into animated_scene's 1080p frame: PARTICLE_STEPS
    steps, one K1 launch a frame, frame 0 against the plain path, the
    states equal to the CPU's.  (d) PRNG_DRAWS draws of random_bits,
    uniform, randint and normal, card against CPU."""
    from softwarerenderer_tpu_torch import RenderParams, scenes, sim
    from softwarerenderer_tpu_torch.engine import (Engine,
                                                   default_frame_uniforms,
                                                   render_frame)
    from softwarerenderer_tpu_torch.models.convert import (scene_to_torch,
                                                           tree_to_torch)
    from softwarerenderer_tpu_torch.ops import normalmap, tile_raster
    from softwarerenderer_tpu_torch.sim import prng
    out = {}
    t0 = time.perf_counter()
    bench = scenes.bench_scene()
    scene = scene_to_torch(bench, device)
    cpu_scene = scene_to_torch(bench, "cpu")
    tris = int(bench["indices"].shape[0])
    params_np = sim.default_character_params()
    cp, cpu_cp = (tree_to_torch(params_np, d) for d in (device, "cpu"))

    # ---- (a) config 4's coupled step ---------------------------------
    w, h = scenes.CONFIG4_SIZE
    params = RenderParams(w, h)
    u = tree_to_torch(scenes.camera_uniforms(default_frame_uniforms(w, h)),
                      device)
    out["coupled"] = {}
    for where, pos0, steps in (("bench.py's start", scenes.CONFIG4_START,
                                SIM_STEPS),
                               ("over the soup", SOUP_START, SIM_CPU_STEPS)):
        box = {"state": sim.initial_character_state(pos0, device=device)}
        states = []

        def coupled(i):
            box["state"], color, depth = scenes.coupled_step(
                box["state"], scene, u, params, cp)
            if i < SIM_CPU_STEPS:
                states.append(box["state"])
            return color, depth
        run = counted_frames(coupled, steps, (w, h))
        check(run["k1"] == [1] * steps,
              f"config 4 {where}: K1 launches a step "
              f"{sorted(set(run['k1']))}")
        cpu_state = sim.initial_character_state(pos0, device="cpu")
        diffs, grounded = [], 0
        for got in states:
            cpu_state = scenes.config4_physics(cpu_state, cpu_scene, cpu_cp)
            grounded += int(cpu_state["grounded"][0])
            diffs.append(_state_diff(got, cpu_state))
        diff = _sum_diffs(diffs)
        check(diff["differ"] == 0, f"config 4 {where} states card vs CPU: "
              f"{diff['differ']} of {diff['values']} values differ")
        start = sim.initial_character_state(pos0, device=device)
        plain = scenes.coupled_step(start, scene, u, params, cp,
                                    fold=tile_raster.tile_fold_plain)[1:]
        text = against_plain(f"config 4 {where}", run["first"], plain)
        del plain
        # Profiled from the state after the SIM_CPU_STEPS compared steps.
        box["state"] = states[-1]

        def step():
            box["state"] = scenes.coupled_step(box["state"], scene, u,
                                               params, cp)[0]
        prof = frame_kernel_ms(step, 5)
        prof["syncs"] = host_syncs(lambda i: step(), 3)
        check(prof["syncs"] == 0,
              f"config 4 {where}: {prof['syncs']} host syncs a step")
        final = states[-1]["position"].cpu().numpy()[0]
        log(f"phase 22a config 4 coupled step @{w}x{h} from {pos0} "
            f"({where}; bench scene, {tris} triangles, the world built in "
            f"the step): {steps} steps, K1 launches {sum(run['k1'])}; "
            f"first step {run['frame_ms'][0]:.1f} ms, median step "
            f"{run['median_ms']:.3f} ms; profiled after step "
            f"{SIM_CPU_STEPS}: {prof['launches']:.0f} launches, kernels "
            f"{prof['kernels']:.3f} ms (K1 {prof['K1']:.3f}), "
            f"{prof['syncs']:.1f} host syncs a step; states card vs CPU "
            f"over the first {SIM_CPU_STEPS} steps: {diff['differ']} of "
            f"{diff['values']} values differ, grounded in {grounded} of "
            f"them, position after them {np.round(final, 3).tolist()}; "
            f"{text}; took {time.perf_counter() - t0:.1f} s [{card}]")
        t0 = time.perf_counter()
        out["coupled"][where] = dict(median_ms=run["median_ms"], prof=prof,
                                     cpu_values=diff["values"],
                                     grounded=grounded)
        del run, states

    # ---- (b) the crowd -------------------------------------------------
    world = sim.build_collision_world(scene)
    cpu_world = sim.build_collision_world(cpu_scene)
    brain_np = sim.default_brain_params()
    br, cpu_br = (tree_to_torch(brain_np, d) for d in (device, "cpu"))
    out["crowd"] = {}
    for n in CROWD_SIZES:
        crowd = scenes.crowd_setup(world, n)
        steps = SIM_STEPS if n == CROWD_SIZES[-1] else CROWD_TIMED_STEPS
        box = {"state": crowd["state"]}
        kept, times = [], []
        shots = torch.zeros((), dtype=torch.int64, device=device)
        on_soup = torch.zeros((), dtype=torch.int64, device=device)
        for i in range(steps):
            t = time.perf_counter()
            box["state"] = scenes.crowd_step(box["state"], crowd, world, cp,
                                             br)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            shots += box["state"]["fire"].sum()
            on_soup += (box["state"]["char"]["position"][:, 1] > -3.0).sum()
            if i < CROWD_CPU_STEPS and n == CROWD_SIZES[-1]:
                kept.append(box["state"])
        pos = box["state"]["char"]["position"]
        check(bool(torch.isfinite(pos).all()), f"crowd {n}: non-finite")
        # Agent-steps still on the soup (y > -3): the rest are falling.
        soup_share = int(on_soup) / (n * steps)

        def crowd_step():
            box["state"] = scenes.crowd_step(box["state"], crowd, world, cp,
                                             br)
        cprof = frame_kernel_ms(crowd_step, 3)
        cprof["syncs"] = host_syncs(lambda i: crowd_step(), 3)
        check(cprof["syncs"] == 0, f"crowd {n}: {cprof['syncs']} host "
              f"syncs a step")
        rays = crowd_rays(n, tris)
        cprof.update(rays, median_ms=statistics.median(times[1:]),
                     shots=int(shots), soup_share=soup_share)
        out["crowd"][n] = cprof
        log(f"phase 22b crowd N={n} on the bench scene ("
            f"{crowd['waypoints'].shape[0]} waypoints, routing, combat): "
            f"{steps} steps, median step {cprof['median_ms']:.3f} ms; "
            f"profiled: {cprof['launches']:.0f} launches, kernels "
            f"{cprof['kernels']:.3f} ms, {cprof['syncs']:.1f} host syncs a "
            f"step; {rays['rays']} rays ({rays['pairs']} ray-triangle "
            f"pairs) in {rays['waves']} waves of {rays['chunks']} chunks; "
            f"{cprof['shots']} shots fired in the run, "
            f"{int((pos[:, 1] > -3.0).sum())} of {n} agents still on the "
            f"soup (y > -3) at its end and {soup_share:.3f} of its "
            f"agent-steps [{card}]")
    cpu_crowd = scenes.crowd_setup(cpu_world, CROWD_SIZES[-1])
    check(torch.equal(cpu_crowd["waypoints"], crowd["waypoints"].cpu())
          and torch.equal(cpu_crowd["next_hop"], crowd["next_hop"].cpu()),
          "crowd set-up: the CPU's waypoints or routes differ")
    cstate = cpu_crowd["state"]
    diffs = []
    for got in kept:
        cstate = scenes.crowd_step(cstate, cpu_crowd, cpu_world, cpu_cp,
                                   cpu_br)
        diffs.append(_state_diff(got, cstate, ("rotation", "aim")))
    diff = _sum_diffs(diffs)
    rot, aim = diff["loose"]["rotation"], diff["loose"]["aim"]
    log(f"phase 22b crowd N={CROWD_SIZES[-1]} card vs CPU over the first "
        f"{CROWD_CPU_STEPS} steps: {diff['differ']} of {diff['values']} "
        f"values differ outside rotation and aim; rotation at most "
        f"{rot:.3g} off (bound {SIM_ROTATION_ATOL}), aim {aim:.3g} (bound "
        f"{SIM_AIM_ATOL}); part (b) took {time.perf_counter() - t0:.1f} s "
        f"[{card}]")
    check(diff["differ"] == 0 and rot <= SIM_ROTATION_ATOL
          and aim <= SIM_AIM_ATOL, "crowd states card vs CPU")
    out["crowd_cpu"] = dict(diff["loose"], values=diff["values"])
    del kept, world, cpu_world

    # ---- (c) particles into the animated frame ---------------------------
    t0 = time.perf_counter()
    W1, H1 = size
    shaders = dict(vertex_shader=normalmap.normal_mapped_vertex_shader,
                   fragment_shader=normalmap.normal_mapped_fragment_shader)
    quiet = scenes.spark_emitter()
    bursts = [scenes.spark_emitter((-1.5 + 0.5 * k, -1.0, -4.0 - 0.3 * k))
              for k in range(PARTICLE_STEPS // SPARK_EVERY)]
    fountain = scenes.fountain_emitter()
    emitters = {
        "sparks": (scenes.SPARK_SLOTS, lambda i: bursts[i // SPARK_EVERY]
                   if i % SPARK_EVERY == 0 else quiet),
        "fountain": (scenes.ANIMATED_PARTICLES, lambda i: fountain)}
    # Each emitter on the card once, so a step copies nothing.
    on = {id(e): tree_to_torch(e, device)
          for e in [quiet, fountain] + bursts}
    out["particles"] = {}
    for name, (slots, emitter_at) in emitters.items():
        sc = scenes.animated_scene(particles=slots)
        eng = Engine(sc, RenderParams(W1, H1), device=device, **shaders)
        base_u = dict(eng.uniforms)
        pstate = {"s": sim.initial_particle_state(slots, device=device)}
        kept = []

        def frame_u(i, state, em):
            u = scenes.animated_uniforms(base_u, i, particles=slots)
            u.update(sim.particle_uniforms(state, em))
            return u

        def render(i):
            em = on[id(emitter_at(i))]
            pstate["s"] = sim.particle_step(pstate["s"], em,
                                            scenes.CONFIG4_DT)
            kept.append(pstate["s"])
            return eng.render(frame_u(i, pstate["s"], em))
        prun = counted_frames(render, PARTICLE_STEPS, (W1, H1))
        check(prun["k1"] == [1] * PARTICLE_STEPS,
              f"{name}: K1 launches a frame {sorted(set(prun['k1']))}")
        plain = render_frame(eng.scene, frame_u(
            0, kept[0], on[id(emitter_at(0))]), eng.params,
            fold=tile_raster.tile_fold_plain, **shaders)
        ptext = against_plain(f"{name} frame", prun["first"], plain)
        del plain
        cs = sim.initial_particle_state(slots, device="cpu")
        diffs = []
        for i, got in enumerate(kept):
            cs = sim.particle_step(cs, tree_to_torch(emitter_at(i), "cpu"),
                                   scenes.CONFIG4_DT)
            diffs.append(_state_diff(got, cs))
        diff = _sum_diffs(diffs)
        alive = int((kept[-1]["lifetime"] > 0).sum())
        pprof = frame_kernel_ms(lambda: render(0), 3)
        em0 = on[id(emitter_at(0))]

        def particles_alone():
            pstate["s"] = sim.particle_step(pstate["s"], em0,
                                            scenes.CONFIG4_DT)
            sim.particle_uniforms(pstate["s"], em0)
        pprof["step_syncs"] = host_syncs(lambda i: particles_alone(), 3)
        pprof["step"] = frame_kernel_ms(particles_alone, 3)
        check(pprof["step_syncs"] == 0, f"{name}: the particle step "
              f"syncs {pprof['step_syncs']} times")
        log(f"phase 22c {name} ({slots} slots) into the animated frame "
            f"@{W1}x{H1}: {PARTICLE_STEPS} steps, K1 launches "
            f"{sum(prun['k1'])}, {alive} alive at the end; "
            f"{timing_text(prun, pprof, W1, H1)}; the step and its "
            f"uniforms alone: {pprof['step']['launches']:.0f} launches, "
            f"kernels {pprof['step']['kernels']:.3f} ms, "
            f"{pprof['step_syncs']:.1f} host syncs; states card vs CPU: "
            f"{diff['differ']} of {diff['values']} values differ; {ptext} "
            f"[{card}]")
        check(diff["differ"] == 0, f"{name} states card vs CPU")
        check(alive > 0, f"{name}: no particle alive")
        out["particles"][name] = dict(median_ms=prun["median_ms"],
                                      prof=pprof, alive=alive)
        del eng, kept, prun

    log(f"phase 22c took {time.perf_counter() - t0:.1f} s")

    # ---- (d) the PRNG ------------------------------------------------------
    key, cpu_key = prng.prng_key(22, device), prng.prng_key(22, "cpu")
    shape = (PRNG_DRAWS,)
    draws = {
        "random_bits": lambda k: prng.random_bits(k, shape),
        "uniform": lambda k: prng.uniform(k, shape),
        "randint": lambda k: prng.randint(k, shape, -1000, 1000),
        "normal": lambda k: prng.normal(k, shape)}
    counts = {}
    for name, fn in draws.items():
        got, want = fn(key).cpu(), fn(cpu_key)
        if name == "normal":
            ulps = (got.view(torch.int32).long()
                    - want.view(torch.int32).long()).abs()
            counts[name] = (int((ulps > 0).sum()), int(ulps.max()))
        else:
            counts[name] = (_differing(got, want), 0)
    log(f"phase 22d PRNG, {PRNG_DRAWS} draws each, card vs CPU: "
        + ", ".join(f"{n} {c[0]} differ" + (f" (at most {c[1]} ulps)"
                                            if n == "normal" else "")
                    for n, c in counts.items()) + f" [{card}]")
    check(all(c[0] == 0 for n, c in counts.items() if n != "normal")
          and counts["normal"][1] <= NORMAL_CARD_ULPS,
          f"PRNG card vs CPU: {counts}")
    out["prng"] = counts
    return out


# Phase 23: the Dust2 game (apps/dust2) on the card.
GAME_SIZE = (640, 400)     # bench.py's game loop (bench.py:94-154)
GAME_BOTS = 7              # the app's cap for max_players = 8 (:369)
GAME_DEPTH = 3             # bench.py's present_depth
GAME_WARMUP = 130          # one script period (120 frames) and a shot
GAME_STEPS = 120
GAME_CPU_STEPS = 30        # the first steps, replayed on the CPU
GAME_PROFILE_FROM = 272    # a profiled window holding the shot at 275
GAME_PROFILE_STEPS = 5
GAME_BIG_WARMUP = 20
GAME_BIG_STEPS = 40
GAME_MODE_STEPS = 10
GAME_CKPT = (40, 20)       # save after 40 steps, replay the next 20
# The replayed steps take inputs 90-109: a shot on the sixth.  (For its
# first present_depth steps a restored game's host pose is the
# checkpoint's while the pipeline refills, as the JAX app's load_state
# drops the in-flight frames; a shot there fires from another pose than
# in the unbroken run.)
GAME_CKPT_OFFSET = 50
# Frame 0 on the card against the same step on the CPU: the share of
# pixels off by more than 2 in a channel.  The states are equal; the
# frame's shading and the atlas's bilinear taps may round differently on
# the two devices (phase 16 holds the routes at 0 on simpler scenes).
GAME_CPU_OFF_MAX = 1e-3


class _Recorder:
    """dust2.fused_step wrapped while recording: each call's (inputs,
    kwargs, outputs), host values of the uniforms copied (the ray-traced
    mode passes the app's live host dict)."""

    def __init__(self, dust2):
        self.dust2, self.calls = dust2, []

    def __enter__(self):
        fused = self.plain = self.dust2.fused_step

        def recorded(scene, sim, ctl, uniforms, **kw):
            out = fused(scene, sim, ctl, uniforms, **kw)
            u = {k: v.copy() if isinstance(v, np.ndarray) else v
                 for k, v in uniforms.items()}
            # The app may write a new position into its state dict (a
            # respawn): keep the step's own output.
            new = {k: dict(v) for k, v in out[0].items()}
            self.calls.append(((scene, sim, ctl, u), kw, (new,) + out[1:]))
            return out
        self.dust2.fused_step = recorded
        return self.calls

    def __exit__(self, *exc):
        self.dust2.fused_step = self.plain


def _game(device, size, **kw):
    """The game as bench.py's game loop builds it, headless and offline
    from seed 0, at render scale 1 with present_depth 3."""
    from softwarerenderer_tpu_torch.apps import dust2
    g = dust2.Dust2Game(width=size[0], height=size[1], render_scale=1.0,
                        headless=True, offline=True, seed=0, device=device,
                        **kw)
    g.present_depth = GAME_DEPTH
    return g


def _game_steps(game, first, n, offset=0, times=None) -> list:
    """Steps first..first+n-1 of bench.py's script (input first+offset...),
    each one's K1, K2 and K4 (nearest, any-hit) launches, and with `times`
    its host-clock ms (no synchronize: the loop as a player runs it)."""
    from softwarerenderer_tpu_torch.apps import dust2
    from softwarerenderer_tpu_torch.ops import rt_sweep, tile_raster
    counts = []
    for i in range(first, first + n):
        c0 = (tile_raster.LAUNCHES, tile_raster.PEEL_LAUNCHES,
              rt_sweep.LAUNCHES, rt_sweep.ANY_HIT_LAUNCHES)
        t = time.perf_counter()
        game.step(1.0 / 60.0, dust2.bench_input(i + offset))
        if times is not None:
            times.append((time.perf_counter() - t) * 1e3)
        c1 = (tile_raster.LAUNCHES, tile_raster.PEEL_LAUNCHES,
              rt_sweep.LAUNCHES, rt_sweep.ANY_HIT_LAUNCHES)
        d = [b - a for a, b in zip(c0, c1)]
        counts.append((d[0], d[1], d[2] - d[3], d[3]))
    return counts


def _runtime_calls(fn) -> dict:
    """The CUDA runtime calls and copies of fn() and a closing
    synchronize, by name (cudaLaunchKernel, cudaEventSynchronize, "Memcpy
    HtoD ...", ...), from a torch.profiler trace of CUDA activity alone
    (a third of the cost of one with the CPU's operators)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()}


def _reset_counts() -> None:
    from softwarerenderer_tpu_torch.ops import rt_sweep, tile_raster
    tile_raster.LAUNCHES = tile_raster.PEEL_LAUNCHES = 0
    rt_sweep.LAUNCHES = rt_sweep.ANY_HIT_LAUNCHES = 0


def _spread(ms) -> str:
    q = np.percentile(ms, [10, 50, 90])
    return (f"median {q[1]:.3f} ms (p10 {q[0]:.3f}, p90 {q[2]:.3f}, "
            f"min {min(ms):.3f}, max {max(ms):.3f})")


def _replay(call, engine, device=None):
    """A recorded fused_step call again, through `engine` (on `device`,
    its inputs moved there)."""
    from softwarerenderer_tpu_torch.apps import dust2
    from softwarerenderer_tpu_torch.models.convert import tree_to_torch
    (scene, sim, ctl, u), kw, _ = call
    if device is not None:
        sim, ctl, u = (tree_to_torch(t, device) for t in (sim, ctl, u))
    return dust2.fused_step(engine.scene, sim, ctl, u,
                            **dict(kw, engine=engine))


def _anchor(state):
    """The tensor a step replaces in a sim part (character, crowd or
    sparks): the next step's input holds the same one unless the host
    edited the state in between."""
    return state["char"]["position"] if "char" in state \
        else state["position"]


def _aux(packed, h, n_aux):
    return packed[h:].reshape(-1)[:4 * n_aux].view(torch.float32)


def _cpu_replay(calls, game, h, n_aux, frame_fn=None):
    """Recorded fused_step calls of `game` again on the CPU, from the
    first call's state and each call's inputs (a state the app edited on
    the host between steps is taken over): each step's aux rows checked
    against the card's (equal but the bots' rotation and aim, within
    SIM_ROTATION_ATOL and SIM_AIM_ATOL).  Returns (the state diffs, the
    host edits taken over, frame 0's CPU image).  frame_fn: the game
    engine's, render_frame by default."""
    from softwarerenderer_tpu_torch.apps import dust2
    from softwarerenderer_tpu_torch.engine import Engine
    from softwarerenderer_tpu_torch.models.convert import tree_to_torch
    from softwarerenderer_tpu_torch.sim import build_collision_world
    cpu_eng = Engine(game.scene, game.engine.params, device="cpu",
                     frame_fn=frame_fn)
    cpu_kw = dict(world=build_collision_world(cpu_eng.scene),
                  tri_mask=torch.from_numpy(game._map_tri_mask),
                  bots=tree_to_torch(game._bots_static(), "cpu"),
                  gun_slice=game.gun_slice, engine=cpu_eng)
    state, diffs, resyncs = None, [], 0
    for k, call in enumerate(calls):
        (_, sim, ctl, u), _, (new, packed, _) = call
        if state is None:
            state = tree_to_torch(sim, "cpu")
        else:
            prev = calls[k - 1][2][0]
            for part in ("char", "bots", "particles"):
                if _anchor(sim[part]) is not _anchor(prev[part]):
                    state[part] = tree_to_torch(sim[part], "cpu")
                    resyncs += 1
            state["char"] = dict(state["char"],
                                 noclip=sim["char"]["noclip"].cpu())
        cnew, cpacked, _ = dust2.fused_step(
            cpu_eng.scene, state, tree_to_torch(ctl, "cpu"),
            tree_to_torch(u, "cpu"), **cpu_kw)
        diffs.append(_state_diff(new["char"], cnew["char"]))
        diffs.append(_state_diff(new["particles"], cnew["particles"]))
        diffs.append(_state_diff(new["bots"], cnew["bots"],
                                 ("rotation", "aim")))
        a, ca = _aux(packed, h, n_aux).cpu(), _aux(cpacked, h, n_aux)
        rot = slice(3 + 3 * GAME_BOTS, 3 + 7 * GAME_BOTS)
        aim = slice(3 + 8 * GAME_BOTS, n_aux)
        exact = torch.cat([a[:rot.start], a[rot.stop:aim.start]])
        cexact = torch.cat([ca[:rot.start], ca[rot.stop:aim.start]])
        check(_differing(exact, cexact) == 0
              and float((a[rot] - ca[rot]).abs().max())
              <= SIM_ROTATION_ATOL
              and float((a[aim] - ca[aim]).abs().max()) <= SIM_AIM_ATOL,
              f"game step {k}: aux rows card vs CPU")
        if k == 0:
            cpu_first = cpacked[:h]
        state = cnew
    return diffs, resyncs, cpu_first


def check_game(card, device="cuda", size=GAME_SIZE, big=(W, H)) -> dict:
    """Phase 23: the Dust2 game (apps/dust2.Dust2Game) headless and
    offline from seed 0 with 7 bots and present_depth 3, driven by
    bench.py's game-loop script.  (a) At 640x400: GAME_WARMUP steps, then
    GAME_STEPS timed on the host clock; 1 K1 launch a step; a profiled
    window of steps around a shot (launches, kernels, host->device
    copies, host syncs: at most the joins plus the shots' reads); 0 host
    syncs in fused_step itself on its recorded device inputs.  (b) The
    same game at 1920x1080, timed and profiled, 1 K1 launch a step.
    (c) The first GAME_CPU_STEPS fused steps replayed on the CPU from the
    same state with the same inputs: character and particle states equal
    on every value, the bots' but rotation and aim within phase 22b's
    bounds, the aux rows decoding to the same pose and roster; frame 0
    equal to the plain path's (K1's twin) on every pixel, and against the
    CPU's frame within GAME_CPU_OFF_MAX.  (d) --kbuffer 4 and --raytrace
    24, GAME_MODE_STEPS steps each: 1 K1 and one K2 launch per live peel
    pass (the game looking down at its shot's decal and sparks), or 1 + 1
    K4 launches, a step; the first frame with live peel passes, and the
    ray-traced frame 0, against the plain path.
    (e) Checkpoint replay on the card: states equal on every value."""
    from softwarerenderer_tpu_torch.apps import dust2
    from softwarerenderer_tpu_torch.engine import Engine, render_frame
    from softwarerenderer_tpu_torch.models.convert import tree_to_torch
    from softwarerenderer_tpu_torch.ops import rt_sweep, tile_raster
    from softwarerenderer_tpu_torch.ops.raytrace import render_frame_raytraced
    out = {}
    t_phase = time.perf_counter()
    cwd = os.getcwd()
    tmp = tempfile.mkdtemp()
    os.chdir(tmp)              # the game's close() writes hud_layout.json
    try:
        # ---- (a) the game loop at 640x400 -----------------------------
        t0 = time.perf_counter()
        game = _game(device, size, bots=GAME_BOTS)
        built_s = time.perf_counter() - t0
        w, h = size
        n_aux = 3 + 11 * GAME_BOTS
        _reset_counts()
        times = []
        with _Recorder(dust2) as calls:
            counts = _game_steps(game, 0, GAME_CPU_STEPS)
        counts += _game_steps(game, GAME_CPU_STEPS,
                              GAME_WARMUP - GAME_CPU_STEPS)
        torch.cuda.synchronize()
        counts += _game_steps(game, GAME_WARMUP, GAME_STEPS, times=times)
        torch.cuda.synchronize()
        k1 = [c[0] for c in counts]
        k1_total = tile_raster.LAUNCHES
        check(k1 == [1] * len(k1) and k1_total == len(k1),
              f"game: K1 launches a step {sorted(set(k1))}")
        check(all(c[1:] == (0, 0, 0) for c in counts),
              "game: a K2 or K4 launch on the opaque route")
        reads = game.shot_reads
        t_steps = time.perf_counter() - t0
        # A profiled window around the shot at step 275.
        _game_steps(game, GAME_WARMUP + GAME_STEPS,
                    GAME_PROFILE_FROM - GAME_WARMUP - GAME_STEPS)
        torch.cuda.synchronize()
        r0 = game.shot_reads
        calls_in = _runtime_calls(lambda: _game_steps(
            game, GAME_PROFILE_FROM, GAME_PROFILE_STEPS))
        shots = game.shot_reads - r0
        empty = _runtime_calls(lambda: None)

        def count(names, counted=calls_in):
            return sum(n for k, n in counted.items()
                       if any(m in k for m in names))
        syncs = count(("Synchronize",)) - count(("Synchronize",), empty)
        launches = count(("LaunchKernel",)) / GAME_PROFILE_STEPS
        copies = count(("HtoD",)) / GAME_PROFILE_STEPS
        check(syncs <= GAME_PROFILE_STEPS + shots,
              f"game: {syncs} host syncs in {GAME_PROFILE_STEPS} steps "
              f"with {shots} shot reads")
        check(shots >= 1, "game: the profiled window holds no shot")
        t_prof = time.perf_counter() - t0 - t_steps
        # Kernel time a step over the next steps, traced as the other
        # phases trace kernels (kernel_events; in a CPU and CUDA trace of
        # this window the kernels' durations came back as 0 on the card).
        box = {"i": GAME_PROFILE_FROM + GAME_PROFILE_STEPS}

        def next_step():
            game.step(1.0 / 60.0, dust2.bench_input(box["i"]))
            box["i"] += 1
        kprof = frame_kernel_ms(next_step, 5)
        t_kern = time.perf_counter() - t0 - t_steps - t_prof
        # fused_step alone on its recorded device inputs.
        last = calls[-1]

        def replays():
            for _ in range(3):
                _replay(last, game.engine)
        fused_syncs = (count(("Synchronize",), _runtime_calls(replays))
                       - count(("Synchronize",), empty)) / 3
        check(fused_syncs == 0, f"fused_step: {fused_syncs} host syncs")
        fused = frame_kernel_ms(lambda: _replay(last, game.engine), 3)
        steady = statistics.median(times)
        idle = 1.0 - kprof["kernels"] / steady
        log(f"phase 23a game loop @{w}x{h}, {GAME_BOTS} bots, present "
            f"depth {GAME_DEPTH} (built in {built_s:.1f} s): "
            f"{len(counts)} steps, K1 launches {k1_total} (1 "
            f"a step), {reads} shot reads; {GAME_STEPS} timed steps after "
            f"{GAME_WARMUP}: {_spread(times)} = {1e3 / steady:.1f} fps; "
            f"profiled steps {GAME_PROFILE_FROM}-"
            f"{GAME_PROFILE_FROM + GAME_PROFILE_STEPS - 1} ({shots} shot "
            f"reads): {launches:.0f} launches, {copies:.1f} "
            f"host->device copies, {syncs / GAME_PROFILE_STEPS:.1f} host "
            f"syncs a step (at most the join and the shots' reads: "
            f"{syncs} in {GAME_PROFILE_STEPS}); the next 5 steps: "
            f"{kprof['launches']:.0f} kernels, {kprof['kernels']:.3f} ms "
            f"(K1 {kprof['K1']:.3f}), idle {idle:.1%} of the median step; "
            f"fused_step alone: {fused['launches']:.0f} "
            f"launches, kernels {fused['kernels']:.3f} ms (K1 "
            f"{fused['K1']:.3f}), {fused_syncs:.1f} host syncs; took "
            f"{time.perf_counter() - t_phase:.1f} s (steps {t_steps:.1f}, "
            f"the profiled window {t_prof:.1f}, kernel time {t_kern:.1f}, "
            f"fused_step alone "
            f"{time.perf_counter() - t0 - t_steps - t_prof - t_kern:.1f}) "
            f"[{card}]")
        out["loop"] = dict(median_ms=steady, times=times,
                           launches=launches, copies=copies,
                           kernels=kprof, syncs=syncs / GAME_PROFILE_STEPS,
                           shots=shots, fused=fused, idle=idle)

        # ---- (c) card against CPU over the first steps -----------------
        t0 = time.perf_counter()
        diffs, resyncs, cpu_first = _cpu_replay(calls, game, h, n_aux)
        diff = _sum_diffs(diffs)
        first = calls[0][2][1][:h]
        plain_eng = Engine(game.engine.scene, game.engine.params,
                           device=device, frame_fn=functools.partial(
                               render_frame,
                               fold=tile_raster.tile_fold_plain))
        plain_first = _replay(calls[0], plain_eng)[1][:h]
        n_plain = int((first != plain_first).any(-1).sum())
        off = float(((first.cpu().int() - cpu_first.int()).abs()
                     .amax(-1) > 2).float().mean())
        rot, aim = diff["loose"]["rotation"], diff["loose"]["aim"]
        fired = sum(int(c[2][0]["bots"]["fire"].sum()) for c in calls)
        log(f"phase 23c game card vs CPU, the first {GAME_CPU_STEPS} fused "
            f"steps from the same state and inputs ({resyncs} host edits "
            f"of the state taken over, {fired} bot shots): "
            f"{diff['differ']} of {diff['values']} values differ outside "
            f"the bots' rotation and aim; rotation at most {rot:.3g} off "
            f"(bound {SIM_ROTATION_ATOL}), aim {aim:.3g} (bound "
            f"{SIM_AIM_ATOL}); aux rows equal (rotation and aim within "
            f"those bounds); frame 0 vs the plain path (K1's twin) on the "
            f"card: {n_plain} of {w * h} pixels differ; frame 0 card vs "
            f"CPU: {off:.6f} of pixels off by > 2 (bound "
            f"{GAME_CPU_OFF_MAX}); took {time.perf_counter() - t0:.1f} s "
            f"[{card}]")
        check(diff["differ"] == 0 and rot <= SIM_ROTATION_ATOL
              and aim <= SIM_AIM_ATOL, "game states card vs CPU")
        check(n_plain == 0, f"game frame 0: {n_plain} pixels off the "
              f"plain path")
        check(off <= GAME_CPU_OFF_MAX, f"game frame 0 vs CPU: {off}")
        out["cpu"] = dict(values=diff["values"], rotation=rot, aim=aim,
                          cpu_off=off)
        # K1 on frame 0's inputs: against its twin, timed, its bound.
        _, k1_calls = capture_folds(lambda f: _replay(calls[0], Engine(
            game.engine.scene, game.engine.params, device=device,
            frame_fn=functools.partial(render_frame, fold=f))),
            tile_raster.tile_fold)
        out["k1"] = check_path_fold(card, "K1 on the game's frame 0 @"
                                    f"{w}x{h}", k1_calls,
                                    tile_raster.tile_fold,
                                    tile_raster.tile_fold_plain,
                                    "tile_raster_kernel", phase="23c")
        game.close()
        del game, calls, plain_eng

        # ---- (b) the same game at 1920x1080 ----------------------------
        t0 = time.perf_counter()
        bg = _game(device, big, bots=GAME_BOTS)
        _reset_counts()
        bcounts = _game_steps(bg, 0, GAME_BIG_WARMUP)
        torch.cuda.synchronize()
        btimes = []
        bcounts += _game_steps(bg, GAME_BIG_WARMUP, GAME_BIG_STEPS,
                               times=btimes)
        torch.cuda.synchronize()
        bk1 = [c[0] for c in bcounts]
        check(bk1 == [1] * len(bk1), f"game @{big}: K1 launches a step "
              f"{sorted(set(bk1))}")
        box = {"i": GAME_BIG_WARMUP + GAME_BIG_STEPS}

        def big_step():
            bg.step(1.0 / 60.0, dust2.bench_input(box["i"]))
            box["i"] += 1
        bprof = frame_kernel_ms(big_step, 5)
        bsteady = statistics.median(btimes)
        log(f"phase 23b game loop @{big[0]}x{big[1]}, {GAME_BOTS} bots: "
            f"{len(bcounts)} steps, K1 launches {sum(bk1)} (1 a step); "
            f"{GAME_BIG_STEPS} timed after {GAME_BIG_WARMUP}: "
            f"{_spread(btimes)} = {1e3 / bsteady:.1f} fps; profiled: "
            f"{bprof['launches']:.0f} kernels a step, kernels "
            f"{bprof['kernels']:.3f} ms (K1 {bprof['K1']:.3f}), idle "
            f"{1.0 - bprof['kernels'] / bsteady:.1%}; took "
            f"{time.perf_counter() - t0:.1f} s [{card}]")
        out["big"] = dict(median_ms=bsteady, prof=bprof)
        bg.close()
        del bg

        # ---- (d) the K-buffer and ray-traced modes ---------------------
        t0 = time.perf_counter()
        kg = _game(device, size, bots=GAME_BOTS, kbuffer=KBUFFER)
        # Looking down, so the shot at step 5 puts a decal (alpha 0.85) and
        # its sparks in view: the translucency the peel passes exist for.
        kg.cam_rotation = np.asarray([-0.5, 0.0, 0.0, 0.8660254],
                                     np.float32)
        _reset_counts()
        with _Recorder(dust2) as kcalls:
            kcounts = _game_steps(kg, 0, GAME_MODE_STEPS)
        torch.cuda.synchronize()
        passes, kn, kref = [], 0, None
        for k, call in enumerate(kcalls):
            res, pc = capture_folds(lambda f: _replay(call, Engine(
                kg.engine.scene, kg.engine.params, device=device,
                frame_fn=functools.partial(render_frame, fold=f))),
                tile_raster.tile_fold_plain)
            passes.append(len(pc) - 1)
            if kref is None and passes[-1]:
                # the first frame with live peel passes, against the plain
                # path's
                kref = k
                kn = int((call[2][1][:h] != res[1][:h]).any(-1).sum())
        check([c[0] for c in kcounts] == [1] * GAME_MODE_STEPS,
              f"--kbuffer: K1 launches {kcounts}")
        check([c[1] for c in kcounts] == passes and sum(passes) > 0,
              f"--kbuffer: K2 launches {[c[1] for c in kcounts]}, live "
              f"peel passes {passes}")
        check(kn <= FRAME_COVERED_MISMATCH_MAX * w * h,
              f"--kbuffer frame {kref}: {kn} pixels off the plain path")
        kg.close()
        del kg, kcalls
        rg = _game(device, size, bots=GAME_BOTS, raytrace=RT_CAP)
        _reset_counts()
        with _Recorder(dust2) as rcalls:
            rcounts = _game_steps(rg, 0, GAME_MODE_STEPS)
        torch.cuda.synchronize()
        rplain = _replay(rcalls[0], Engine(
            rg.engine.scene, rg.engine.params, device=device,
            frame_fn=functools.partial(render_frame_raytraced,
                                       cluster_cap=RT_CAP,
                                       sweep=rt_sweep.rt_sweep_plain)))
        rn = int((rcalls[0][2][1][:h] != rplain[1][:h]).any(-1).sum())
        check([c[0] for c in rcounts] == [0] * GAME_MODE_STEPS
              and [c[2:] for c in rcounts] == [(1, 1)] * GAME_MODE_STEPS,
              f"--raytrace: K1 and K4 launches a step {rcounts}")
        check(rn <= FRAME_COVERED_MISMATCH_MAX * w * h,
              f"--raytrace frame 0: {rn} pixels off K4's twin")
        log(f"phase 23d game modes @{w}x{h}, {GAME_MODE_STEPS} steps each: "
            f"--kbuffer {KBUFFER}: K1 {sum(c[0] for c in kcounts)}, K2 "
            f"{sum(c[1] for c in kcounts)} (per step "
            f"{[c[1] for c in kcounts]}, the plain path's live peel passes "
            f"{passes}), frame {kref} (the first with live peel passes) "
            f"vs the plain path {kn} pixels differ; "
            f"--raytrace {RT_CAP}: K4 {sum(c[2] for c in rcounts)} nearest "
            f"+ {sum(c[3] for c in rcounts)} any-hit, frame 0 vs K4's twin "
            f"{rn} pixels differ; took {time.perf_counter() - t0:.1f} s "
            f"[{card}]")
        out["modes"] = dict(k2=[c[1] for c in kcounts], passes=passes)
        rg.close()
        del rg, rcalls

        # ---- (e) checkpoint replay on the card ---------------------------
        # Without bots: their targets come from the host roster and the
        # pipelined aux, which a checkpoint does not hold (nor the JAX
        # app's).
        cg = _game(device, size)
        save, tail = GAME_CKPT
        _game_steps(cg, 0, save, offset=GAME_CKPT_OFFSET)
        ckpt = os.path.join(tmp, "game.npz")
        cg.save_state(ckpt)
        _game_steps(cg, save, tail, offset=GAME_CKPT_OFFSET)
        end = {"char": cg.char, "particles": cg._particles}
        cg.load_state(ckpt)
        _game_steps(cg, save, tail, offset=GAME_CKPT_OFFSET)
        again = {"char": cg.char, "particles": cg._particles}
        cdiff = _state_diff(again, tree_to_torch(end, "cpu"))
        alive = int((cg._particles["lifetime"] > 0).sum())
        log(f"phase 23e checkpoint replay on the card: saved after {save} "
            f"steps, {tail} more, restored, the same {tail} again: "
            f"{cdiff['differ']} of {cdiff['values']} state values differ "
            f"({alive} sparks alive at the end) [{card}]")
        check(cdiff["differ"] == 0, "game checkpoint replay")
        cg.close()
        log(f"phase 23 took {time.perf_counter() - t_phase:.1f} s")
    finally:
        os.chdir(cwd)
    return out


# Phase 24: the capacity caps on profile_lod.py's 4K LOD crowd, shade_rate,
# split screen, picture-in-picture and render to texture at 1080p, and the
# game with --mirror --burn-hud --record.
CROWD_FRAMES = 8
CROWD_PROFILE_FRAMES = 3
CROWD_SYNC_FRAMES = 3
SHADE_RATE = 2
VIEW_FRAMES = 8
MIRROR_CPU_STEPS = 10      # the first steps, replayed on the CPU
MIRROR_WARMUP = 20
MIRROR_STEPS = 40          # timed on the host clock


def _equal_frames(a, b) -> int:
    """Pixels where two (color, depth) frames differ in any value."""
    return int(((a[0] != b[0]).any(-1) | (a[1] != b[1])).sum())


def _caps(params) -> dict:
    """The capacity caps that are set."""
    return {k: getattr(params, k) for k in ("active_cap", "geom_cap",
                                            "pair_cap", "global_cap")
            if getattr(params, k)}


def _stats_ints(stats) -> dict:
    return {k: int(v) for k, v in stats.items()}


def check_crowd_caps(card, device="cuda", size=None) -> dict:
    """Phase 24a: scripts/profile_lod.py's crowd (scenes.lod_crowd_scene,
    584,064 packed triangles over three LOD levels) at 3840x2160 through
    K1: uncapped, at lod.suggested_active_cap, at the script's ladder
    (scenes.lod_cap_ladder: active, pair, global and geom caps measured on
    frame 0) and with an active_cap at half the frame's valid slots.  Each
    run: CROWD_FRAMES frames with 1 K1 launch each, timed on the host
    clock; its kernels profiled; host syncs a frame; the counters.  The
    capped frames equal the uncapped frame on every pixel with every
    counter 0 and no sync added; the overflowing frame equals its
    plain-twin path on every pixel and its counter the CPU's from the same
    tensors; K1 on the ladder frame's compacted lists against its twin;
    and the ladder on the deferred route (K5) and the K-buffer (K1 + K2),
    each equal to its uncapped frame (check_crowd_routes)."""
    from softwarerenderer_tpu_torch import RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import Engine, render_frame
    from softwarerenderer_tpu_torch.engine import renderer
    from softwarerenderer_tpu_torch.models.convert import scene_to_torch
    from softwarerenderer_tpu_torch.ops import lod, tile_raster
    size = size or scenes.LOD_CROWD_SIZE
    w, h = size
    t_phase = time.perf_counter()
    sc = scenes.lod_crowd_scene()
    base = RenderParams(*size)
    eng = Engine(sc, base, device=device)

    def u_at(i):
        return scenes.lod_crowd_uniforms(eng.uniforms, i)

    ladder = scenes.lod_cap_ladder(eng.scene, u_at(0), base)
    n_valid = int(renderer.frame_setup(eng.scene, u_at(0), base)["tris"][
        "valid"].sum())
    runs = {"uncapped": base,
            "suggested": base.replace(
                active_cap=lod.suggested_active_cap(sc)),
            "ladder": base.replace(**ladder),
            "overflow": base.replace(active_cap=n_valid // 2)}
    out = {}
    for name, p in runs.items():
        e = Engine(eng.scene, p, device=device)
        run = counted_frames(lambda i: e.render(u_at(i)), CROWD_FRAMES, size)
        check(run["k1"] == [1] * CROWD_FRAMES,
              f"crowd {name}: K1 launches a frame {run['k1']}")
        prof = frame_kernel_ms(lambda: e.render(u_at(0)),
                               CROWD_PROFILE_FRAMES)
        syncs = host_syncs(lambda i: e.render(u_at(i)), CROWD_SYNC_FRAMES)
        stats = _stats_ints(render_frame(
            eng.scene, u_at(0), p.replace(active_cap_stats=True))[2])
        steady = run["median_ms"]
        out[name] = dict(params=p, first=run["first"], median_ms=steady,
                         prof=prof, syncs=syncs, stats=stats,
                         idle=1.0 - prof["kernels"] / steady,
                         k1_idle=1.0 - prof["K1"] / steady)
    ref = out["uncapped"]
    for name in ("suggested", "ladder"):
        r = out[name]
        n = _equal_frames(r["first"], ref["first"])
        over = {k: v for k, v in r["stats"].items() if k.endswith("overflow")}
        check(n == 0, f"crowd {name}: {n} pixels off the uncapped frame")
        check(over and not any(over.values()),
              f"crowd {name}: counters {r['stats']}")
        check(r["syncs"] <= ref["syncs"],
              f"crowd {name}: {r['syncs']} host syncs a frame, uncapped "
              f"{ref['syncs']}")
    ov = out["overflow"]
    p_over = ov["params"]
    plain = render_frame(eng.scene, u_at(0), p_over,
                         fold=tile_raster.tile_fold_plain)
    n_plain = _equal_frames(ov["first"], plain)
    cpu_over = int(renderer.frame_setup(scene_to_torch(sc, "cpu"), u_at(0),
                                        p_over)["overflow"][
        "active_cap_overflow"])
    check(n_plain == 0, f"crowd overflow: {n_plain} pixels off the plain "
          f"path")
    check(ov["stats"]["active_cap_overflow"] == cpu_over > 0,
          f"crowd overflow counter {ov['stats']} vs the CPU's {cpu_over}")
    check(_equal_frames(ov["first"], ref["first"]) > 0,
          "crowd overflow: the frame did not change")
    for name, r in out.items():
        log(f"phase 24a crowd {name} @{w}x{h} ({sc['indices'].shape[0]} "
            f"packed triangles, {n_valid} valid slots on frame 0; "
            f"{_caps(r['params'])}): "
            f"{CROWD_FRAMES} frames, 1 K1 launch each, median frame "
            f"{r['median_ms']:.3f} ms; kernels {r['prof']['kernels']:.3f} ms "
            f"a frame (K1 {r['prof']['K1']:.3f} ms), "
            f"{r['prof']['launches']:.0f} launches; idle {r['idle']:.1%} of "
            f"the frame ({r['k1_idle']:.1%} outside K1); "
            f"{r['syncs']:.1f} host syncs a frame; counters {r['stats']} "
            f"[{card}]")
    log(f"phase 24a crowd: suggested and ladder frames 0 pixels off the "
        f"uncapped frame, every counter 0; overflow (active_cap "
        f"{p_over.active_cap}) frame {n_plain} pixels off its plain path, "
        f"counter {ov['stats']['active_cap_overflow']} = the CPU's "
        f"{cpu_over}")
    _, calls = capture_folds(lambda f: render_frame(
        eng.scene, u_at(0), out["ladder"]["params"], fold=f),
        tile_raster.tile_fold)
    out["k1"] = check_path_fold(card, f"K1 on the crowd's ladder frame @"
                                f"{w}x{h}", calls, tile_raster.tile_fold,
                                tile_raster.tile_fold_plain,
                                "tile_raster_kernel", phase="24a")
    out["routes"] = check_crowd_routes(card, eng, u_at, runs, device, size)
    log(f"phase 24a took {time.perf_counter() - t_phase:.1f} s")
    return out


# The other routes the ladder's caps act on, and the kernels they launch
# a frame: the deferred route (K5) and the depth-peeled K-buffer without
# its short-circuit (K1, then K2 for its second layer).
CROWD_ROUTES = {"deferred": (dict(use_pallas=False), (0, 0, 1)),
                "K-buffer": (dict(kbuffer=2, kbuffer_short_circuit=False),
                             (1, 1, 0))}


def check_crowd_routes(card, eng, u_at, runs, device, size) -> dict:
    """Phase 24a on the crowd's other routes: each route uncapped and at
    the ladder's caps, CROWD_FRAMES frames each with the route's K1, K2
    and K5 launches counted a frame; the capped frame equal to the
    uncapped one on every pixel."""
    from softwarerenderer_tpu_torch.engine import Engine
    from softwarerenderer_tpu_torch.ops import tile_raster, vis_fold
    w, h = size
    out = {}
    for route, (kw, kernels) in CROWD_ROUTES.items():
        res = {}
        for name in ("uncapped", "ladder"):
            e = Engine(eng.scene, runs[name].replace(**kw), device=device)
            tile_raster.PEEL_LAUNCHES = 0
            run = counted_frames(lambda i: e.render(u_at(i)), CROWD_FRAMES,
                                 size)
            got = (run["k1"], [tile_raster.PEEL_LAUNCHES // CROWD_FRAMES]
                   * CROWD_FRAMES, run["k5"])
            check(all(c == [n] * CROWD_FRAMES for c, n in zip(got, kernels))
                  and tile_raster.PEEL_LAUNCHES == kernels[1] * CROWD_FRAMES,
                  f"crowd {route} {name}: K1, K2, K5 launches {got}, K2 "
                  f"in all {tile_raster.PEEL_LAUNCHES}")
            prof = frame_kernel_ms(lambda: e.render(u_at(0)),
                                   CROWD_PROFILE_FRAMES)
            res[name] = dict(first=run["first"], median_ms=run["median_ms"],
                             prof=prof)
        n = _equal_frames(res["ladder"]["first"], res["uncapped"]["first"])
        check(n == 0, f"crowd {route}: the ladder's frame {n} pixels off "
              f"the uncapped frame")
        for name, r in res.items():
            log(f"phase 24a crowd {route} {name} @{w}x{h}: "
                f"{CROWD_FRAMES} frames, K1 / K2 / K5 launches "
                f"{' / '.join(map(str, kernels))} a frame, median frame "
                f"{r['median_ms']:.3f} ms; kernels {r['prof']['kernels']:.3f}"
                f" ms (K1 and K2 {r['prof']['K1']:.3f}, K5 "
                f"{r['prof']['K5']:.3f}), idle "
                f"{1.0 - r['prof']['kernels'] / r['median_ms']:.1%} [{card}]")
        log(f"phase 24a crowd {route}: the ladder's frame {n} pixels off the "
            f"uncapped frame")
        out[route] = {k: {"median_ms": v["median_ms"], "prof": v["prof"]}
                      for k, v in res.items()}
    return out


def check_views(card, device="cuda", size=(W, H)) -> dict:
    """Phase 24b and 24c on the bench scene at 1920x1080: shade_rate=2
    (VIEW_FRAMES counted frames, 1 K1 each; frame 0 equal to its plain
    path on every pixel, its anchor rows equal to the full-rate frame's);
    two-view split screen (2 K1 a frame), picture-in-picture (2 K1) and a
    render-to-texture pass at 256x256 into the main view (2 K1), each
    frame 0 equal to its plain path on every pixel, the atlas the pass
    wrote equal to the CPU's write of the same image, and the pass's frame
    against the CPU's by pixel share."""
    from softwarerenderer_tpu_torch import RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import (Engine, render_frame,
                                                   renderer, rtt)
    from softwarerenderer_tpu_torch.models.convert import scene_to_torch
    from softwarerenderer_tpu_torch.ops import tile_raster
    t_phase = time.perf_counter()
    w, h = size
    eng, params, u0 = bench_engine(device, size)
    plain = tile_raster.tile_fold_plain

    def u_at(i):
        return scenes.camera_uniforms(eng.uniforms, i)

    out = {}

    def frames(name, render, k1, plain_first):
        run = counted_frames(render, VIEW_FRAMES, size)
        check(run["k1"] == [k1] * VIEW_FRAMES,
              f"{name}: K1 launches a frame {run['k1']}")
        n = _equal_frames(run["first"], plain_first)
        check(n == 0, f"{name}: {n} pixels off the plain path")
        prof = frame_kernel_ms(lambda: render(0), CROWD_PROFILE_FRAMES)
        out[name] = dict(median_ms=run["median_ms"], prof=prof,
                         first=run["first"])
        log(f"phase {name} @{w}x{h}: {VIEW_FRAMES} frames, {k1} K1 "
            f"launch{'es' if k1 > 1 else ''} each, frame 0 vs plain path "
            f"{n} pixels differ; median frame {run['median_ms']:.3f} ms; "
            f"kernels {prof['kernels']:.3f} ms (K1 {prof['K1']:.3f} ms), "
            f"idle {1.0 - prof['kernels'] / run['median_ms']:.1%} [{card}]")

    # (b) shade_rate
    frames("24b full rate", lambda i: eng.render(u_at(i)), 1,
           render_frame(eng.scene, u0, params, fold=plain))
    p_sr = params.replace(shade_rate=SHADE_RATE)
    e_sr = Engine(eng.scene, p_sr, device=device)
    frames(f"24b shade_rate={SHADE_RATE}", lambda i: e_sr.render(u_at(i)), 1,
           render_frame(eng.scene, u0, p_sr, fold=plain))
    full, half = out["24b full rate"]["first"], \
        out[f"24b shade_rate={SHADE_RATE}"]["first"]
    n_anchor = int((full[0][::SHADE_RATE] != half[0][::SHADE_RATE])
                   .any(-1).sum())
    check(n_anchor == 0, f"shade_rate anchor rows: {n_anchor} pixels off "
          f"the full-rate frame")
    log(f"phase 24b shade_rate={SHADE_RATE}: anchor rows vs the full-rate "
        f"frame {n_anchor} pixels differ")

    # (c) split screen, picture-in-picture, render to texture
    views = tuple({k: u_at(i)[k] for k in ("camera_position",
                                           "camera_rotation")}
                  for i in (0, 40))
    frames("24c multiview (2 views, side by side)",
           lambda i: renderer.render_frame_multiview(eng.scene, u_at(i),
                                                     params, views), 2,
           renderer.render_frame_multiview(eng.scene, u0, params, views,
                                           fold=plain))

    def pip_u(i):
        u = u_at(i)
        return dict(u, pip_view={k: u_at(i + 300)[k] for k in
                                 ("camera_position", "camera_rotation")})
    frames("24c picture-in-picture",
           lambda i: renderer.render_frame_pip(eng.scene, pip_u(i), params),
           2, renderer.render_frame_pip(eng.scene, pip_u(0), params,
                                        fold=plain))
    sc_rtt, tid = scenes.rtt_bench_scene()
    pp = RenderParams(scenes.RTT_SLOT, scenes.RTT_SLOT)
    passes = (rtt.RttPass(tex_id=tid, params=pp, uniforms_key="feed"),)
    e_rtt = Engine(sc_rtt, params, device=device, rtt_passes=passes)

    def rtt_u(i):
        return dict(scenes.camera_uniforms(e_rtt.uniforms, i),
                    feed=scenes.rtt_pass_uniforms(
                        renderer.default_frame_uniforms(pp.width,
                                                        pp.height)))
    got = rtt.render_frame_rtt(e_rtt.scene, rtt_u(0), params, passes,
                               return_atlas=True)
    want = rtt.render_frame_rtt(e_rtt.scene, rtt_u(0), params, passes,
                                fold=plain, return_atlas=True)
    n_atlas = int((got[2] != want[2]).sum())
    check(n_atlas == 0, f"rtt atlas vs plain path: {n_atlas} bytes")
    frames("24c render to texture (256x256 pass)",
           lambda i: e_rtt.render(rtt_u(i)), 2, want[:2])
    feed = render_frame(e_rtt.scene, rtt_u(0)["feed"], pp)[0]
    st_cpu = scene_to_torch(sc_rtt, "cpu")
    cpu_atlas = rtt.write_atlas_texture(st_cpu, tid, feed.cpu())[
        "atlas_data"]
    n_cpu = int((got[2].cpu() != cpu_atlas).sum())
    check(n_cpu == 0, f"rtt atlas vs the CPU's write: {n_cpu} bytes")
    cpu_feed = render_frame(st_cpu, rtt_u(0)["feed"], pp)[0]
    off = float(((renderer.to_rgb8(feed).cpu().int()
                  - renderer.to_rgb8(cpu_feed).int()).abs().amax(-1) > 2)
                .float().mean())
    check(off <= GAME_CPU_OFF_MAX, f"rtt pass vs the CPU's: {off}")
    # the monitor's pixels: those the feed changes against the frame over
    # the placeholder slot
    bare = render_frame(e_rtt.scene, {k: v for k, v in rtt_u(0).items()
                                      if k != "feed"}, params)[0]
    changed = int((got[0] != bare).any(-1).sum())
    check(changed > 0.02 * w * h, f"rtt: the monitor shows {changed} "
          f"pixels of its feed")
    log(f"phase 24c render to texture: atlas {n_atlas} bytes off the plain "
        f"path, {n_cpu} off the CPU's write of the card's pass; the pass "
        f"frame card vs CPU {off:.6f} of pixels off by > 2 (bound "
        f"{GAME_CPU_OFF_MAX}); the monitor covers {changed} pixels")
    log(f"phase 24b-c took {time.perf_counter() - t_phase:.1f} s")
    return out


def check_mirrored_game(card, device="cuda", size=GAME_SIZE,
                        plain_ms=None) -> dict:
    """Phase 24d: the game as phase 23 drives it (640x400, 7 bots, present
    depth 3, bench.py's script) with --mirror --burn-hud --record: 2 K1
    launches a step (the frame and the rear-view inset, in fused_step);
    0 host syncs in fused_step on its recorded device inputs; the first
    MIRROR_CPU_STEPS fused steps replayed on the CPU as phase 23c does
    (states and aux rows, frame 0 against the CPU's and its plain path);
    every recorded frame equal to the frame presented; the step time on
    the host clock beside phase 23's (plain_ms)."""
    from softwarerenderer_tpu_torch.apps import dust2
    from softwarerenderer_tpu_torch.engine import Engine
    from softwarerenderer_tpu_torch.engine import renderer
    from softwarerenderer_tpu_torch.ops import tile_raster
    from softwarerenderer_tpu_torch.utils.video import read_avi
    t_phase = time.perf_counter()
    w, h = size
    n_aux = 3 + 11 * GAME_BOTS
    cwd = os.getcwd()
    tmp = tempfile.mkdtemp()
    os.chdir(tmp)
    try:
        clip = os.path.join(tmp, "mirror.avi")
        game = _game(device, size, bots=GAME_BOTS, mirror=True,
                     burn_hud=True, record=clip)
        check(game.engine.frame_fn is renderer.render_frame_pip,
              "--mirror: the frame is not render_frame_pip")
        _reset_counts()
        shown, counts, times = [], [], []
        with _Recorder(dust2) as calls:
            for i in range(MIRROR_CPU_STEPS):
                counts += _game_steps(game, i, 1)
                shown.append(game.window.last_frame.copy())
        for i in range(MIRROR_CPU_STEPS, MIRROR_WARMUP):
            counts += _game_steps(game, i, 1)
            shown.append(game.window.last_frame.copy())
        torch.cuda.synchronize()
        for i in range(MIRROR_WARMUP, MIRROR_WARMUP + MIRROR_STEPS):
            counts += _game_steps(game, i, 1, times=times)
            shown.append(game.window.last_frame.copy())
        torch.cuda.synchronize()
        k1 = [c[0] for c in counts]
        check(k1 == [2] * len(k1), f"--mirror: K1 launches a step "
              f"{sorted(set(k1))}")
        last = calls[-1]
        empty = _runtime_calls(lambda: None)

        def replays():
            for _ in range(3):
                _replay(last, game.engine)
        syncs = (sum(n for k, n in _runtime_calls(replays).items()
                     if "Synchronize" in k)
                 - sum(n for k, n in empty.items()
                       if "Synchronize" in k)) / 3
        check(syncs == 0, f"fused_step with --mirror --burn-hud: {syncs} "
              f"host syncs")
        fused = frame_kernel_ms(lambda: _replay(last, game.engine), 3)
        depth = game.present_depth
        game.close()
        frames, _ = read_avi(clip)
        n_steps = len(counts)
        check(frames.shape[0] == n_steps, f"--record: {frames.shape[0]} "
              f"frames for {n_steps} steps")
        bad = [i for i in range(n_steps - depth)
               if not np.array_equal(frames[i], shown[i + depth])]
        check(not bad, f"--record: frames {bad[:5]} differ from the "
              f"presented frames")

        # the first steps on the CPU, as phase 23c
        diffs, _, cpu_first = _cpu_replay(calls, game, h, n_aux,
                                          renderer.render_frame_pip)
        diff = _sum_diffs(diffs)
        rot, aim = diff["loose"]["rotation"], diff["loose"]["aim"]
        check(diff["differ"] == 0 and rot <= SIM_ROTATION_ATOL
              and aim <= SIM_AIM_ATOL, "mirrored game states card vs CPU")
        first = calls[0][2][1][:h]
        plain_eng = Engine(game.engine.scene, game.engine.params,
                           device=device, frame_fn=functools.partial(
                               renderer.render_frame_pip,
                               fold=tile_raster.tile_fold_plain))
        n_plain = int((first != _replay(calls[0], plain_eng)[1][:h])
                      .any(-1).sum())
        off = float(((first.cpu().int() - cpu_first.int()).abs()
                     .amax(-1) > 2).float().mean())
        check(n_plain == 0, f"mirrored frame 0: {n_plain} pixels off the "
              f"plain path")
        check(off <= GAME_CPU_OFF_MAX, f"mirrored frame 0 vs CPU: {off}")
        steady = statistics.median(times)
        log(f"phase 24d game @{w}x{h}, {GAME_BOTS} bots, --mirror "
            f"--burn-hud --record: {n_steps} steps, K1 launches "
            f"{sum(k1)} (2 a step); {MIRROR_STEPS} timed steps after "
            f"{MIRROR_WARMUP}: {_spread(times)} = {1e3 / steady:.1f} fps"
            + (f" (phase 23a's plain game {plain_ms:.3f} ms)"
               if plain_ms else "")
            + f"; fused_step alone: {fused['launches']:.0f} launches, "
            f"kernels {fused['kernels']:.3f} ms (K1 {fused['K1']:.3f}), "
            f"{syncs:.1f} host syncs; recorded {frames.shape[0]} frames "
            f"for {n_steps} steps, each the frame presented; the first "
            f"{MIRROR_CPU_STEPS} steps card vs CPU: {diff['differ']} of "
            f"{diff['values']} values differ outside the bots' rotation "
            f"({rot:.3g}) and aim ({aim:.3g}), aux rows equal, frame 0 "
            f"{off:.6f} of pixels off by > 2, {n_plain} pixels off the "
            f"plain path; took {time.perf_counter() - t_phase:.1f} s "
            f"[{card}]")
        return dict(median_ms=steady, fused=fused, syncs=syncs)
    finally:
        os.chdir(cwd)


# ---- phase 25: the multi-device layer ---------------------------------------

PAR_RANKS = 4
PAR_TIMED = 3              # timed frames a case, after one checked frame
PAR_ROWS_TILE_H = 27       # 1080 = 40 tile rows of 27, 10 a rank
PAR_BANDS = (4, 8)
PAR_GROUP_FRAMES = 10


def _launch_counts() -> dict:
    """Every kernel's launches so far: K1, K2 and K5 without a tile origin
    map and with one (K1m, K2m, K5m), K4 (K4a its any-hit casts)."""
    from softwarerenderer_tpu_torch.ops import rt_sweep, tile_raster, vis_fold
    return {"K1": tile_raster.LAUNCHES, "K2": tile_raster.PEEL_LAUNCHES,
            "K1m": tile_raster.MAPPED_LAUNCHES,
            "K2m": tile_raster.MAPPED_PEEL_LAUNCHES,
            "K4": rt_sweep.LAUNCHES, "K4a": rt_sweep.ANY_HIT_LAUNCHES,
            "K5": vis_fold.VIS_LAUNCHES,
            "K5m": vis_fold.VIS_MAPPED_LAUNCHES}


def _zero_counts() -> None:
    from softwarerenderer_tpu_torch.ops import tile_raster, vis_fold
    _reset_counts()
    tile_raster.MAPPED_LAUNCHES = tile_raster.MAPPED_PEEL_LAUNCHES = 0
    vis_fold.VIS_LAUNCHES = vis_fold.VIS_MAPPED_LAUNCHES = 0


def _values_off(got: torch.Tensor, want: torch.Tensor) -> int:
    """Values of got that differ from want (same device), NaN equal to
    NaN; every value when the shapes differ."""
    if got.shape != want.shape:
        return max(got.numel(), want.numel())
    same = (got == want) | (torch.isnan(got) & torch.isnan(want)) \
        if got.is_floating_point() else got == want
    return int((~same).sum())


def _origin_layouts(params, device):
    """Phase 25a's bands of the frame at K1's tiling: (name, band params,
    the band's tile origin map, its row offset (a contiguous band, binned
    there) or None, full-frame tile ids (binned over the whole frame) or
    None)."""
    from softwarerenderer_tpu_torch.ops import binning
    th, tw = min(params.tile_h, 32), params.tile_w
    ntx = binning.cdiv(params.width, tw)
    nty = binning.cdiv(params.height, th)
    out = []
    for n in PAR_BANDS:
        h = params.height // n
        out += [(f"{n} bands, band {i}", params.replace(height=h),
                 binning.band_origin(binning.cdiv(h, th), ntx, th, tw, i * h,
                                     device), i * h, None)
                for i in range(n)]
    gen = torch.Generator().manual_seed(25)
    rows = torch.randperm(nty, generator=gen)[:nty // 4].to(device)
    tiles = (rows[:, None] * ntx
             + torch.arange(ntx, device=device)).reshape(-1)
    out.append((f"tile-row map ({len(rows)} permuted rows)",
                params.replace(height=len(rows) * th),
                binning.tile_origins(tiles, ntx, th, tw), None, tiles))
    tiles = torch.randperm(nty * ntx, generator=gen)[:97].to(device)
    out.append(("tile map (97 permuted tiles)",
                params.replace(height=len(tiles) * th, width=tw),
                binning.tile_origins(tiles, ntx, th, tw), None, tiles))
    return out


def check_origin_map(card, eng, params, u0, device="cuda") -> dict:
    """Phase 25a: K1, K2 and K5 with a tile origin map, on the bench
    frame's triangles, against their twins and against the unmapped
    kernels' whole frame at the same screen pixels: every band of
    PAR_BANDS contiguous bands, a permuted tile-row map and a tile map.
    Then the mapped K1, K2 and K5 on the whole frame (an identity map)
    timed in turns with the unmapped kernels.  Returns the mapped
    kernels' numbers and the unmapped K1's times."""
    from softwarerenderer_tpu_torch.engine import (frame_setup,
                                                   scene_fragment_shader)
    from softwarerenderer_tpu_torch.ops import (binning, raster, tile_raster,
                                                vis_fold)
    t_phase = time.perf_counter()
    f = frame_setup(eng.scene, u0, params)
    keep = frozenset(scene_fragment_shader.varyings)
    ctx = tile_raster.prepare(f["tris"], params, f["fb_depth"], f["per_tri"],
                              keep)
    args, kw = tile_raster.fold_inputs(ctx)
    th, tw = kw["tile_h"], kw["tile_w"]
    full1 = tile_raster.tile_fold(*args, **kw)
    prev = dict(prev_d=full1[1], prev_i=full1[2])
    full2 = tile_raster.tile_fold(*args, **kw, **prev)
    full5 = vis_fold.vis_fold(*args[:7], tile_h=th, tile_w=tw)
    H, W = params.height, params.width
    worst = {"K1": 0.0, "K2": 0.0, "K5": 0.0}
    off = {"K1": 0, "K2": 0, "K5": 0}
    pixels = 0
    for name, pb, origin, row_offset, tiles in _origin_layouts(params,
                                                               device):
        bins = (binning.bin_triangles(f["tris"], pb, th, tw, params.span_cap,
                                      row_offset) if tiles is None
                else binning.bin_tiles(f["tris"], params, th, tw,
                                       params.span_cap, tiles))
        fb = torch.full((pb.height, pb.width), raster.DEPTH_CLEAR,
                        device=device)
        bctx = tile_raster.prepare(f["tris"], pb, fb, f["per_tri"], keep,
                                   origin=origin, bins=bins)
        bargs, bkw = tile_raster.fold_inputs(bctx)
        hp, wp = bctx["Hp"], bctx["Wp"]
        px, py = binning.pixel_coords(hp, wp, th, tw, device, origin)
        px, py = px.long(), py.long()
        # The band's own pixels (not its tile padding) that lie on the
        # screen.
        stored = (torch.arange(hp, device=device)[:, None] < pb.height) \
            & (torch.arange(wp, device=device)[None, :] < pb.width)
        on = (py < H) & (px < W) & stored.reshape(-1)
        ys, xs = py.clamp(max=H - 1), px.clamp(max=W - 1)
        pixels += int(on.sum())
        bprev = dict(
            prev_d=torch.where(on, full1[1][ys, xs],
                               raster.DEPTH_CLEAR).reshape(hp, wp),
            prev_i=torch.where(on, full1[2][ys, xs], -1).reshape(hp, wp))
        runs = {
            "K1": (lambda fn: fn(*bargs, **bkw), tile_raster.tile_fold,
                   tile_raster.tile_fold_plain, full1),
            "K2": (lambda fn: fn(*bargs, **bkw, **bprev),
                   tile_raster.tile_fold, tile_raster.tile_fold_plain, full2),
            "K5": (lambda fn: fn(*bargs[:7], tile_h=th, tile_w=tw,
                                 origin=origin), vis_fold.vis_fold,
                   vis_fold.visibility_fold_plain, full5)}
        for k, (run, kernel, plain, full) in runs.items():
            for g, p, w in zip(run(kernel), run(plain), full):
                g = g.reshape(*g.shape[:-2], -1)[..., on]
                p = p.reshape(*p.shape[:-2], -1)[..., on]
                w = w[..., ys, xs][..., on]
                if g.dim() == 2:       # the G-buffer: within GBUF_ATOL
                    err = float((g - p).abs().max())
                    worst[k] = max(worst[k], err)
                    off[k] += int(((g - p).abs() > GBUF_ATOL).sum())
                else:
                    off[k] += _values_off(g, p)
                    if g.is_floating_point() and g.numel():
                        err = torch.where(g == p, 0.0, (g - p).abs())
                        worst[k] = max(worst[k], float(err.max()))
                off[k] += _values_off(g, w)
    log(f"phase 25a tile origin map, bench frame @{W}x{H}, {th}x{tw} tiles "
        f"(K5 on the same bins): every band of {' and '.join(map(str, PAR_BANDS))} "
        f"contiguous bands, a permuted tile-row map and a tile map, "
        f"{pixels} screen pixels; values off the twin or the unmapped whole "
        f"frame: K1 {off['K1']}, K2 {off['K2']}, K5 {off['K5']}; largest "
        f"diff to the twin K1 {worst['K1']:.3g}, K2 {worst['K2']:.3g}, K5 "
        f"{worst['K5']:.3g} [{card}]")
    check(off == {"K1": 0, "K2": 0, "K5": 0}, f"origin map values off {off}")

    # The mapped instantiations on the whole frame through an identity map,
    # in turns with the unmapped ones, and their twins through the map.
    ident = binning.tile_origins(torch.arange(args[5].numel(), device=device),
                                 binning.cdiv(W, tw), th, tw)
    mkw = dict(kw, origin=ident)
    kw5 = dict(tile_h=th, tile_w=tw)
    mkw5 = dict(kw5, origin=ident)
    check(all(torch.equal(a, b) for a, b in zip(
        tile_raster.tile_fold(*args, **mkw), full1)),
        "K1 through an identity map differs from K1")
    check(all(torch.equal(a, b) for a, b in zip(
        tile_raster.tile_fold(*args, **mkw, **prev), full2)),
        "K2 through an identity map differs from K2")
    check(all(torch.equal(a, b) for a, b in zip(
        vis_fold.vis_fold(*args[:7], **mkw5), full5)),
        "K5 through an identity map differs from K5")
    ms = {k: [] for k in ("K1", "K1m", "K2", "K2m", "K5", "K5m")}
    for _ in range(2):
        for k, fn, kwk in (
                ("K1", tile_raster.tile_fold, kw),
                ("K1m", tile_raster.tile_fold, mkw),
                ("K2", tile_raster.tile_fold, dict(kw, **prev)),
                ("K2m", tile_raster.tile_fold, dict(mkw, **prev)),
                ("K5", vis_fold.vis_fold, kw5),
                ("K5m", vis_fold.vis_fold, mkw5)):
            a = args if k[:2] != "K5" else args[:7]
            ms[k].append(cuda_ms(lambda: fn(*a, **kwk), KERNEL_RUNS))
    plain1 = cuda_ms(lambda: tile_raster.tile_fold_plain(*args, **mkw),
                     PLAIN_RUNS)
    plain2 = cuda_ms(lambda: tile_raster.tile_fold_plain(*args, **mkw,
                                                         **prev), PLAIN_RUNS)
    plain5 = cuda_ms(lambda: vis_fold.visibility_fold_plain(*args[:7],
                                                            **mkw5),
                     PLAIN_RUNS)

    def pair(k):
        return " and ".join(f"{x:.3f}" for x in ms[k])

    log(f"phase 25a whole frame in turns (medians of {KERNEL_RUNS}, with "
        f"the wrappers): K1 unmapped {pair('K1')} ms, through an identity "
        f"map {pair('K1m')} ms (twin {plain1:.3f}); K2 pass 1 unmapped "
        f"{pair('K2')} ms, mapped {pair('K2m')} ms (twin {plain2:.3f}); K5 "
        f"unmapped {pair('K5')} ms, mapped {pair('K5m')} ms (twin "
        f"{plain5:.3f}); took {time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"K1m": dict(fold_bound(args, kw, full1),
                        ms=statistics.median(ms["K1m"]), plain_ms=plain1,
                        max_abs_err=worst["K1"]),
            "K2m": dict(fold_bound(args, dict(kw, **prev), full2),
                        ms=statistics.median(ms["K2m"]), plain_ms=plain2,
                        max_abs_err=worst["K2"]),
            "K5m": dict(fold_bound(args[:7], kw5, full5),
                        ms=statistics.median(ms["K5m"]), plain_ms=plain5,
                        max_abs_err=worst["K5"]),
            "K1_ms": ms["K1"]}


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_one_rank_group(card, eng, params, u0, device="cuda") -> dict:
    """Phase 25b: a one-rank process group through the port's bootstrap
    (NCCL on the card), mesh (1, 1): the sharded bench frame equal to
    Engine.render's on every value with one launch of the mapped K1 a
    frame (a band always folds through its origin map) and none of the
    unmapped one, timed in turns with the unsharded frame, whose launches
    are the unmapped K1's.  Returns the mapped K1's launches over the
    timed sharded frames and the medians."""
    import torch.distributed as dist
    from softwarerenderer_tpu_torch import parallel
    from softwarerenderer_tpu_torch.parallel import multihost
    os.environ.update(SRT_COORD=f"localhost:{_free_port()}",
                      SRT_NUM_PROCS="1", SRT_PROC_ID="0")
    try:
        check(multihost.initialize_from_env(device=device),
              "initialize_from_env started no group")
        mesh = parallel.make_mesh(1, 1, device=device)

        def sharded():
            return parallel.render_frame_sharded(eng.scene, u0, params, mesh)

        want = eng.render(u0)
        _zero_counts()
        got = sharded()
        first = _launch_counts()
        n_off = _values_off(got[0], want[0]) + _values_off(got[1], want[1])
        check(n_off == 0, f"sharded (1, 1) frame: {n_off} values off")
        check(first["K1m"] == 1 and first["K1"] == 0,
              f"sharded (1, 1) frame: K1 mapped {first['K1m']}, unmapped "
              f"{first['K1']}")
        times = {"sharded": [], "unsharded": []}
        _zero_counts()
        for _ in range(PAR_GROUP_FRAMES):
            for name, fn in (("sharded", sharded),
                             ("unsharded", lambda: eng.render(u0))):
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t) * 1e3)
        counts = _launch_counts()
        check(counts["K1m"] == PAR_GROUP_FRAMES
              and counts["K1"] == PAR_GROUP_FRAMES,
              f"over {PAR_GROUP_FRAMES} frames of each: K1 mapped "
              f"{counts['K1m']}, unmapped {counts['K1']}")
        med = {k: statistics.median(v) for k, v in times.items()}
        log(f"phase 25b one-rank {dist.get_backend()} group, mesh (1, 1), "
            f"bench frame @{params.width}x{params.height}: 0 values off "
            f"Engine.render's frame; {PAR_GROUP_FRAMES} frames each in turns "
            f"(host clock, synchronised): mapped K1 launches "
            f"{counts['K1m']} (sharded), unmapped {counts['K1']} "
            f"(unsharded); sharded median {med['sharded']:.2f} ms, "
            f"unsharded {med['unsharded']:.2f} ms [{card}]")
        return {"launches": counts["K1m"], "median_ms": med}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in ("SRT_COORD", "SRT_NUM_PROCS", "SRT_PROC_ID"):
            os.environ.pop(k, None)


PAR_KERNELS = ("K1", "K1m", "K2", "K2m", "K4", "K4a", "K5", "K5m")


def _peel_passes(frame):
    """An expectation of a K-buffer case: the mapped K1 once and the mapped
    K2 once per live peel pass of this rank's band, the passes counted by
    rendering the band again through the plain twin (every rank calls it,
    as the frame's gather needs)."""
    from softwarerenderer_tpu_torch.ops import tile_raster

    def expect(mesh):
        peels = []

        def counting(*a, **k):
            if k.get("prev_i") is not None:
                peels.append(1)
            return tile_raster.tile_fold_plain(*a, **k)
        frame(mesh, fold=counting)
        return {"K1m": 1, "K2m": len(peels)}
    return expect


def _par_cases(device) -> dict:
    """Phase 25c's cases: name -> (mesh maker taking device=, frame of the
    mesh, single-card reference frame, each kernel's launches expected on
    a rank: a dict of PAR_KERNELS counts, 0 where absent, or a callable
    of the mesh that returns one)."""
    from softwarerenderer_tpu_torch import RenderParams, parallel, scenes
    from softwarerenderer_tpu_torch.engine import (default_frame_uniforms,
                                                   render_frame)
    from softwarerenderer_tpu_torch.models.convert import scene_to_torch
    from softwarerenderer_tpu_torch.models.scene import build_scene_buffers
    from softwarerenderer_tpu_torch.ops.raytrace import render_frame_raytraced

    def packed(sc):
        return {n: scene_to_torch(parallel.shard_scene_triangles(sc, n),
                                  device) for n in (1, 2, 4)}

    bench = packed(scenes.bench_scene())
    cfg5 = packed(build_scene_buffers(scenes.golden_config(5)))
    glass = packed(scenes.translucent_scene())
    u = scenes.camera_uniforms(default_frame_uniforms(W, H), 0)
    w5, h5 = scenes.BENCH_SIZES[5]
    u5 = scenes.golden_uniforms(5, default_frame_uniforms(w5, h5))
    p, p5 = RenderParams(W, H), RenderParams(w5, h5)
    s5 = scenes.golden_shaders(5)
    pk = RenderParams(W, H, kbuffer=KBUFFER, cull_mode=0)
    rows = dict(tile_h=PAR_ROWS_TILE_H)
    views = [{k: scenes.camera_uniforms(dict(u), i)[k]
              for k in ("camera_position", "camera_rotation")}
             for i in range(PAR_RANKS)]
    # One mapped fold a band: K1 on the tile route, K5 on the deferred one.
    tile, deferred = {"K1m": 1}, {"K5m": 1}

    def sharded(shape, sc, uu, pp, expect, balanced=False, **kw):
        def frame(mesh, **more):
            return parallel.render_frame_sharded(
                sc[shape[1]], uu, pp, mesh, balanced=balanced, **kw, **more)
        return (functools.partial(parallel.make_mesh, *shape), frame,
                lambda: render_frame(sc[1], uu, pp, **kw)[:2],
                _peel_passes(frame) if expect is None else expect)

    cases = {}
    for shape in ((4, 1), (2, 2), (1, 4)):
        cases[f"mesh {shape[0]}x{shape[1]}, bench 1080p"] = sharded(
            shape, bench, u, p, tile)
    for shape in ((2, 2), (1, 4)):
        cases[f"mesh {shape[0]}x{shape[1]}, config 5 4K"] = sharded(
            shape, cfg5, u5, p5, tile, **s5)
    for mode in ("rows", "tiles"):
        cases[f"balanced {mode}, bench 1080p, tile_h 27"] = sharded(
            (4, 1), bench, u, p.replace(**rows), tile, mode)
    cases["balanced tiles, deferred route (K5), tile_h 27"] = sharded(
        (4, 1), bench, u, p.replace(use_pallas=False, **rows), deferred,
        "tiles")
    cases["K-buffer K=4, contiguous bands, translucent 1080p"] = sharded(
        (4, 1), glass, u, pk, None)
    cases["K-buffer K=4, balanced rows, tile_h 27"] = sharded(
        (4, 1), glass, u, pk.replace(**rows), None, "rows")
    for name, sc, uu, pp, kw in (("bench 1080p", bench, u, p, {}),
                                 ("config 5 4K", cfg5, u5, p5, s5)):
        # n shards fold into each band, one mapped K5 each.
        cases[f"ring n=4, {name}"] = (
            functools.partial(parallel.make_ring_mesh, PAR_RANKS),
            lambda mesh, sc=sc, uu=uu, pp=pp, kw=kw:
            parallel.render_frame_ring(sc[PAR_RANKS], uu, pp, mesh, **kw),
            lambda sc=sc, uu=uu, pp=pp, kw=kw:
            render_frame(sc[1], uu, pp, **kw)[:2], {"K5m": PAR_RANKS})
    # A view is a whole frame: the unmapped K1.
    cases["views V=4, bench 1080p"] = (
        functools.partial(parallel.make_view_mesh, PAR_RANKS),
        lambda mesh: parallel.render_frame_views(
            bench[1], u, p, parallel.stack_views(views), mesh),
        lambda: tuple(torch.stack(x) for x in zip(
            *[render_frame(bench[1], {**u, **ov}, p) for ov in views])),
        {"K1": 1})
    # A band's nearest cast and its shadow (any-hit) cast.
    cases["ray-traced bands, cluster_cap 24, hard shadows"] = (
        functools.partial(parallel.make_mesh, PAR_RANKS, 1),
        lambda mesh: parallel.render_frame_raytraced_sharded(
            bench[1], u, p, mesh, cluster_cap=RT_CAP),
        lambda: render_frame_raytraced(bench[1], u, p, cluster_cap=RT_CAP),
        {"K4": 2, "K4a": 1})
    return cases


def _par_rank(rank: int, n: int, port: int, out_dir: str, device: str,
              backend: str) -> None:
    """One rank of phase 25c: the port's bootstrap, then every case (one
    checked frame with its launches against the single-card frame and the
    expected launches, then PAR_TIMED timed frames each beside the
    single-card frame), written as JSON to out_dir."""
    import traceback
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    os.environ.update(SRT_COORD=f"localhost:{port}", SRT_NUM_PROCS=str(n),
                      SRT_PROC_ID=str(rank))
    result = {"rank": rank, "cases": {}, "error": None}
    try:
        from softwarerenderer_tpu_torch.parallel import (collectives,
                                                         multihost)
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", multihost.local_rank(rank))
            torch.cuda.set_device(dev)
        multihost.initialize_from_env(device=dev.type, backend=backend)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize()

        for name, (make, frame, ref, expect) in _par_cases(dev).items():
            mesh = make(device=str(dev))
            _zero_counts()
            got = frame(mesh)
            sync()
            counts = _launch_counts()
            if callable(expect):
                expect = expect(mesh)
            want = ref()
            n_off = _values_off(got[0], want[0]) \
                + _values_off(got[1], want[1])
            del got, want
            times, single = [], []
            for _ in range(PAR_TIMED):
                dist.barrier()
                t = time.perf_counter()
                frame(mesh)
                sync()
                times.append((time.perf_counter() - t) * 1e3)
                t = time.perf_counter()
                ref()
                sync()
                single.append((time.perf_counter() - t) * 1e3)
            result["cases"][name] = {
                "off": n_off, "launches": counts,
                "expected": {k: expect.get(k, 0) for k in PAR_KERNELS},
                "ms": statistics.median(times),
                "single_ms": statistics.median(single)}
        result["host_staged"] = dict(collectives.HOST_STAGED)
        result["backend"] = dist.get_backend()
    except Exception:
        result["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(result, fh)
    if dist.is_initialized():
        dist.destroy_process_group()


def run_par_ranks(n: int, device: str, backend: str) -> list:
    """Spawn n ranks of _par_rank (never fork: this process holds a CUDA
    context) and return their results, a missing one as an error."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=_par_rank,
                             args=(r, n, port, out_dir, device, backend))
                 for r in range(n)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        out = []
        for r, p in enumerate(procs):
            if p.is_alive():
                p.kill()
                p.join()
            path = os.path.join(out_dir, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as fh:
                    out.append(json.load(fh))
            else:
                out.append({"rank": r, "error": f"rank {r} exited "
                            f"{p.exitcode} without a result"})
    return out


def check_parallel_ranks(card, device="cuda") -> dict:
    """Phase 25c: four ranks spawned on the one card under gloo (NCCL
    refuses two ranks on one device; gloo takes CUDA tensors for
    all_reduce and broadcast, and the port stages its gather and ring
    exchange through pinned host buffers), every case at full width with
    each rank's kernels on the card: each frame 0 values off the
    single-card frame on every rank, each kernel of the case launched on
    every rank.  With PAR_RANKS cards or more, the same over NCCL, a card
    a rank.  Returns each run's rank results by backend."""
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count() if device == "cuda" else 0
    runs = [("gloo", f"{PAR_RANKS} ranks on {min(n_cards, PAR_RANKS)} "
             f"card(s)")]
    if n_cards >= PAR_RANKS:
        runs.append(("nccl", f"{PAR_RANKS} ranks, a card each"))
    else:
        log(f"phase 25c NCCL over {PAR_RANKS} cards: not run, {n_cards} "
            f"card(s) here")
    out = {}
    for backend, label in runs:
        res = run_par_ranks(PAR_RANKS, device, backend)
        errors = [r["error"] for r in res if r.get("error")]
        for e in errors:
            log(e)
        check(not errors, f"phase 25c ({backend}): a rank failed")
        log(f"phase 25c {backend}, {label}: collectives staged through "
            f"pinned host buffers, calls on rank 0: "
            f"{res[0]['host_staged'] or 'none'}.  The ranks share "
            f"{'one card and its host' if n_cards < PAR_RANKS else 'a host'}"
            f", so the times below measure nothing about scale-out [{card}]")
        for name in res[0]["cases"]:
            per = [r["cases"][name] for r in res]
            offs = [c["off"] for c in per]
            launches = {k: [c["launches"][k] for c in per]
                        for k in PAR_KERNELS}
            expected = {k: [c["expected"][k] for c in per]
                        for k in PAR_KERNELS}
            shown = "; ".join(
                f"{k} {launches[k]}" for k in PAR_KERNELS
                if any(launches[k]) or any(expected[k]))
            log(f"phase 25c {name}: values off the single-card frame per "
                f"rank {offs}; launches per rank {shown} (every other "
                f"kernel 0), as expected: {launches == expected}; median "
                f"frame per rank {[round(c['ms'], 2) for c in per]} ms "
                f"beside the single-card frame "
                f"{[round(c['single_ms'], 2) for c in per]} ms [{card}]")
            check(all(o == 0 for o in offs), f"{name}: values off {offs}")
            check(launches == expected,
                  f"{name}: launches {launches}, expected {expected}")
        out[backend] = res
    log(f"phase 25c took {time.perf_counter() - t_phase:.1f} s")
    return out


VIEWER_FRAMES = 29         # timed frames a model, after frame 0
VIEWER_PROFILE_FRAMES = 3
VIEWER_RT_FRAMES = 9
VIEWER_RT_CAPS = ((24,), (8, 24))   # --rt-cap 24 and the ladder 8 24
VIEWER_CPU_OFF_MAX = 1e-3  # share of pixels off the CPU's frame by > 2
VIEWER_CLOCK = 1234.5      # the viewer's animation clock, pinned
# (rings, sectors) of the written spheres: a single-mesh FBX of 262,144
# triangles, and a 3DS of 65,280, just under the format's 65,535.
VIEWER_FBX_SPHERE = (256, 512)
VIEWER_3DS_SPHERE = (128, 255)
# The FBX's node transform (tests/fixtures' cube: translate, rotate 30
# degrees about z, scale), so the load bakes it through the library.
VIEWER_FBX_TRS = dict(translation=(0.5, -0.25, -3.0),
                      rotation_deg=(0.0, 0.0, 30.0), scaling=(1.0, 2.0, 1.5))
NO_INPUT = {"keys": set(), "mouse_delta": (0.0, 0.0)}
# Kernel launches of two frames in each debug view: the depth view's
# visibility pass is the deferred route's (K5 on the card).
VIEW_LAUNCHES = {"WIREFRAME": {}, "OVERDRAW": {}, "DEPTH": {"K5": 2}}


def _tree_off(got, want) -> int:
    """Values of two loaded trees (dicts, lists, dataclasses, arrays,
    scalars) that differ; a structural difference counts as 1."""
    import dataclasses
    if dataclasses.is_dataclass(want):
        if type(got).__name__ != type(want).__name__:
            return 1
        return _tree_off(dataclasses.asdict(got), dataclasses.asdict(want))
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            return 1
        return sum(_tree_off(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            return 1
        return sum(_tree_off(g, w) for g, w in zip(got, want))
    if isinstance(want, np.ndarray):
        g = np.asarray(got)
        if g.dtype != want.dtype or g.shape != want.shape:
            return 1
        return int((g != want).sum())
    return int(not (got == want))


def check_native_library(card, sphere_fbx: str) -> dict:
    """Phase 26a: the native asset library built from the checkout's
    srt_native.cpp into the package's _build/ with g++ (no fallback: the
    phase fails without a compiler), its five entry points used, the
    bakers equal to io_host.hostops's numpy forms on a million seeded
    points, and the transformed sphere FBX loaded through the library
    equal on every value to the same load with the library out of reach."""
    import shutil
    from softwarerenderer_tpu_torch import native
    from softwarerenderer_tpu_torch.io_host import hostops, model_loader
    from softwarerenderer_tpu_torch.native import binding, build
    gxx = shutil.which("g++") or shutil.which("clang++")
    check(gxx is not None, "phase 26a: no g++ or clang++ to build the "
          "native library")
    t = time.perf_counter()
    check(build.build(force=not native.is_available()),
          "phase 26a: the native library did not build")
    build_s = time.perf_counter() - t
    want_dir = os.path.join(REPO, "softwarerenderer_tpu_torch", "_build")
    check(os.path.dirname(build.LIBRARY) == want_dir
          and os.path.getmtime(build.LIBRARY)
          >= os.path.getmtime(build.SOURCE),
          f"phase 26a: library {build.LIBRARY} is not built from "
          f"{build.SOURCE} into {want_dir}")
    check(native.is_available() and binding._lib._name == build.LIBRARY,
          "phase 26a: the native library does not load")
    rng = np.random.default_rng(26)
    pts = rng.normal(size=(10 ** 6, 3)).astype(np.float32) * 40
    pts[:3] = 0.0
    m = np.asarray(rng.normal(size=(4, 4)), np.float32)
    times = {}
    off = 0
    for name in ("bake_positions", "bake_normals"):
        t = time.perf_counter()
        got = getattr(native, name)(pts, m)
        times[name] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        want = getattr(hostops, name)(pts, m)
        times[name + "_numpy"] = (time.perf_counter() - t) * 1e3
        off += int((got.view(np.int32) != want.view(np.int32)).sum())
    pcm = rng.integers(-32768, 32767, 10 ** 5, endpoint=True) \
        .astype(np.int16)
    pcm_ok = np.array_equal(native.scale_pcm16(pcm, 1.7), np.clip(
        pcm.astype(np.float32) * np.float32(1.7), -32768, 32767)
        .astype(np.int16))
    raw = pts[:1000].tobytes()
    acc = native.accessor_to_f32(raw, 1000, 3, 5126, 12, False)
    sphere = native.bounding_sphere_native(pts[:1000])
    check(off == 0, f"phase 26a: the library's bakers differ from "
          f"hostops's on {off} values")
    check(pcm_ok and acc is not None and np.array_equal(acc, pts[:1000])
          and sphere is not None and np.all(np.linalg.norm(
              pts[:1000] - sphere[0], axis=-1) <= sphere[1] + 1e-3),
          "phase 26a: scale_pcm16, accessor_to_f32 or the bounding "
          "sphere is off")

    # The sphere FBX through the library, counting the calls that reached
    # it, then with the library out of reach (hostops's forms).
    calls = {"lib": 0}
    load = binding._load

    def counted():
        lib = load()
        calls["lib"] += lib is not None
        return lib

    binding._load = counted
    try:
        model_loader.clear_caches()
        t = time.perf_counter()
        with_lib = model_loader.load_model(sphere_fbx)
        lib_s = time.perf_counter() - t
        lib_calls = calls["lib"]
        saved = binding._lib
        binding._lib, calls["lib"] = None, 0
        model_loader.clear_caches()
        t = time.perf_counter()
        without = model_loader.load_model(sphere_fbx)
        numpy_s = time.perf_counter() - t
        fallback_calls = calls["lib"]
        binding._lib = saved
    finally:
        binding._load = load
        model_loader.clear_caches()
    n_off = _tree_off(with_lib, without)
    log(f"phase 26a native library: {build.LIBRARY} built by {gxx} from "
        f"srt_native.cpp in {build_s:.2f} s; 10^6 points baked: positions "
        f"{times['bake_positions']:.1f} ms (numpy "
        f"{times['bake_positions_numpy']:.1f}), normals "
        f"{times['bake_normals']:.1f} ms (numpy "
        f"{times['bake_normals_numpy']:.1f}), {off} values differ; the "
        f"sphere FBX ({len(with_lib.meshes[0]['indices'])} triangles) "
        f"loaded in {lib_s:.2f} s through {lib_calls} library calls and "
        f"in {numpy_s:.2f} s through hostops ({fallback_calls} library "
        f"calls): {n_off} values differ [{card}]")
    check(lib_calls >= 2 and fallback_calls == 0,
          f"phase 26a: library calls {lib_calls}, {fallback_calls}")
    check(n_off == 0, f"phase 26a: the sphere FBX differs on {n_off} "
          f"values without the library")
    return {"build_s": build_s, "lib_calls": lib_calls}


def _viewer_models(tmp: str) -> dict:
    """The models phase 26 opens, by name: (path, lod)."""
    from softwarerenderer_tpu_torch.io_host import fbx, tds
    from softwarerenderer_tpu_torch.models import primitives
    r, s = VIEWER_FBX_SPHERE
    big = primitives.uv_sphere(rings=r, sectors=s)
    fbx_path = os.path.join(tmp, "sphere.fbx")
    fbx.write_fbx(fbx_path, big["position"], big["indices"],
                  normals=big["normal"], uvs=big["uv"],
                  diffuse_color=(0.8, 0.6, 0.4), **VIEWER_FBX_TRS)
    r, s = VIEWER_3DS_SPHERE
    small = primitives.uv_sphere(rings=r, sectors=s)
    tds_path = os.path.join(tmp, "sphere.3ds")
    tds.write_3ds(tds_path, small["position"], small["indices"],
                  uvs=small["uv"], diffuse_color=(0.3, 0.5, 0.8))
    fix = os.path.join(REPO, "tests", "fixtures")
    return {"sphere.fbx": (fbx_path, True), "sphere.3ds": (tds_path, False),
            **{n: (os.path.join(fix, n), False)
               for n in ("cube.dae", "cube.fbx", "cube.3ds")}}


def _rgb_off(a: np.ndarray, b: np.ndarray, by: int = 0) -> int:
    """Pixels of two RGB8 frames that differ by more than `by`."""
    return int((np.abs(a.astype(np.int32) - b.astype(np.int32))
                .max(-1) > by).sum())


def _viewer_step(v, inputs=NO_INPUT) -> np.ndarray:
    v.step(1 / 60, inputs)
    return v.window.last_frame


def check_viewer(card, device="cuda", size=(W, H)) -> dict:
    """Phase 26: the model viewer (apps.viewer.Viewer, headless at
    render_scale 1.0) on the models of _viewer_models: (a) the native
    library (check_native_library); (b) for each model frame 0 with 1 K1
    launch, 0 pixels off the same step through K1's twin and within
    VIEWER_CPU_OFF_MAX of Viewer(device="cpu")'s frame, VIEWER_FRAMES
    timed frames of 1 K1 each, launches, host syncs and kernel time a
    frame by the profiler; (c) 'g' on the two spheres at each of
    VIEWER_RT_CAPS: 1 + 1 K4 a frame, 0 pixels off K4's twin, the ladder's
    frame equal to --rt-cap 24's; (d) 'f' through WIREFRAME, OVERDRAW and
    DEPTH on the three fixtures against the CPU's frames (those views are
    brute routes, T x H x W, which phase 16 holds on the bench scene);
    (e) F10's GLB, --record's AVI and the entry point in a subprocess.
    The viewer's animation clock is pinned (VIEWER_CLOCK)."""
    import types
    from softwarerenderer_tpu_torch.apps import viewer as viewer_mod
    from softwarerenderer_tpu_torch.io_host import model_loader
    t_phase = time.perf_counter()
    clock = viewer_mod.time
    viewer_mod.time = types.SimpleNamespace(monotonic=lambda: VIEWER_CLOCK)
    out = {"models": {}}
    try:
        with tempfile.TemporaryDirectory(prefix="viewer_") as tmp:
            models = _viewer_models(tmp)
            out["native"] = check_native_library(card,
                                                 models["sphere.fbx"][0])
            for name, (path, lod) in models.items():
                model_loader.clear_caches()
                t = time.perf_counter()
                v = viewer_mod.Viewer(path, width=size[0], height=size[1],
                                      render_scale=1.0, headless=True,
                                      lod=lod, rt_cap=VIEWER_RT_CAPS[0],
                                      device=device)
                res = _viewer_frames(card, name, v, path, lod, size,
                                     time.perf_counter() - t)
                if name.startswith("sphere"):
                    res["rt"] = _viewer_raytraced(card, name, v, size)
                else:
                    res["views"] = _viewer_views(card, name, v, path, size)
                out["models"][name] = res
                del v
            out["io"] = _viewer_io(card, models, tmp, size, device)
    finally:
        viewer_mod.time = clock
    log(f"phase 26 took {time.perf_counter() - t_phase:.1f} s")
    return out


def _cpu_viewer(path, lod, size):
    """The same model in Viewer(device="cpu"), frame 0 rendered."""
    from softwarerenderer_tpu_torch.apps import viewer as viewer_mod
    from softwarerenderer_tpu_torch.io_host import model_loader
    model_loader.clear_caches()
    cv = viewer_mod.Viewer(path, width=size[0], height=size[1],
                           render_scale=1.0, headless=True, lod=lod,
                           device="cpu")
    _viewer_step(cv)
    return cv


def _viewer_frames(card, name, v, path, lod, size, built_s) -> dict:
    """Phase 26b on one model: frame 0 (1 K1) against the plain path and
    the CPU's frame, VIEWER_FRAMES timed frames, the profiler's counts."""
    from softwarerenderer_tpu_torch import DebugMode
    from softwarerenderer_tpu_torch.engine import render_frame
    from softwarerenderer_tpu_torch.ops import tile_raster
    w, h = size
    eng = v.engines[(DebugMode.NONE, False)]
    _zero_counts()
    first = _viewer_step(v).copy()
    k1_first = _launch_counts()
    eng.frame_fn = functools.partial(render_frame,
                                     fold=tile_raster.tile_fold_plain)
    try:
        plain = _viewer_step(v).copy()
    finally:
        eng.frame_fn = render_frame
    k1_plain = tile_raster.LAUNCHES - k1_first["K1"]
    n_plain = _rgb_off(first, plain)
    covered = float((first != first[0, 0]).any(-1).mean())
    t = time.perf_counter()
    cv = _cpu_viewer(path, lod, size)
    cpu_s = time.perf_counter() - t
    n_cpu = _rgb_off(first, cv.window.last_frame, 2)
    same_view = (np.array_equal(cv.center, v.center)
                 and cv.distance == v.distance and cv.n_tris == v.n_tris)
    del cv

    k1, times = [], []
    for _ in range(VIEWER_FRAMES):
        n0 = tile_raster.LAUNCHES
        t = time.perf_counter()
        _viewer_step(v)
        times.append((time.perf_counter() - t) * 1e3)
        k1.append(tile_raster.LAUNCHES - n0)
    median = statistics.median(times)

    def frames():
        for _ in range(VIEWER_PROFILE_FRAMES):
            _viewer_step(v)
    calls, empty = _runtime_calls(frames), _runtime_calls(lambda: None)

    def count(names, counted):
        return sum(n for k, n in counted.items()
                   if any(m in k for m in names))
    launches = count(("LaunchKernel",), calls) / VIEWER_PROFILE_FRAMES
    syncs = (count(("Synchronize",), calls)
             - count(("Synchronize",), empty)) / VIEWER_PROFILE_FRAMES
    prof = frame_kernel_ms(lambda: _viewer_step(v), VIEWER_PROFILE_FRAMES)
    idle = 1.0 - prof["kernels"] / median
    log(f"phase 26b viewer {name} @{w}x{h}{' --lod' if lod else ''}: "
        f"{v.n_tris} triangles packed, built in {built_s:.1f} s; frame 0 "
        f"K1 launches {k1_first['K1']} (other kernels "
        f"{sum(k1_first.values()) - k1_first['K1']}), {covered:.1%} of "
        f"pixels not the clear colour; vs the same step through K1's twin "
        f"{n_plain} pixels differ ({k1_plain} K1 launches); vs "
        f"Viewer(device='cpu') (built and drawn in {cpu_s:.1f} s) {n_cpu} "
        f"pixels off by > 2 ({n_cpu / (w * h):.2e}); {VIEWER_FRAMES} "
        f"frames with K1 launches {sum(k1)}, {_spread(times)} on the host "
        f"clock (present reads the frame back) = "
        f"{w * h / median / 1e3:.1f} Mpixels/s; profiled: "
        f"{launches:.1f} launches and {syncs:.1f} host syncs a frame, "
        f"kernels {prof['kernels']:.3f} ms (K1 {prof['K1']:.3f} ms), idle "
        f"{idle:.1%} [{card}]")
    check(k1_first["K1"] == 1 and sum(k1_first.values()) == 1,
          f"viewer {name}: frame 0 launches {k1_first}")
    check(k1_plain == 0, f"viewer {name}: the plain path launched K1")
    check(n_plain == 0, f"viewer {name}: {n_plain} pixels off the plain "
          f"path")
    check(covered > 0.02, f"viewer {name}: only {covered:.1%} drawn")
    check(same_view, f"viewer {name}: the CPU viewer frames it otherwise")
    check(n_cpu <= VIEWER_CPU_OFF_MAX * w * h,
          f"viewer {name}: {n_cpu} pixels off the CPU's by > 2")
    check(k1 == [1] * VIEWER_FRAMES, f"viewer {name}: K1 launches {k1}")
    return dict(median_ms=median, launches=launches, syncs=syncs,
                prof=prof, idle=idle, k1=sum(k1) + 1, n_tris=v.n_tris)


def _viewer_raytraced(card, name, v, size) -> dict:
    """Phase 26c: 'g' at each of VIEWER_RT_CAPS, 1 + 1 K4 a frame, frame 0
    0 pixels off the same step through K4's twin (and the float frames
    within phase 12's limits), the ladder's frame equal to the first
    cap's; 'g' again returns to the K1 frame."""
    from softwarerenderer_tpu_torch import DebugMode
    from softwarerenderer_tpu_torch.ops import rt_sweep
    from softwarerenderer_tpu_torch.ops.raytrace import render_frame_raytraced
    w, h = size
    press_g = {"keys": {"g"}, "mouse_delta": (0.0, 0.0)}
    out, frames = {}, {}
    for cap in VIEWER_RT_CAPS:
        v.rt_cap = cap
        v.engines.pop((DebugMode.NONE, True), None)
        _zero_counts()
        first = _viewer_step(v, press_g if not v.raytrace else NO_INPUT)
        first = first.copy()
        c0 = _launch_counts()
        check(v.raytrace, "'g' did not turn the ray-traced mode on")
        eng = v.engines[(DebugMode.NONE, True)]
        u = v.frame_uniforms()
        got = eng.render(u)
        eng.frame_fn = functools.partial(render_frame_raytraced,
                                         cluster_cap=cap,
                                         sweep=rt_sweep.rt_sweep_plain)
        try:
            twin = _viewer_step(v).copy()
            want = eng.render(u)
        finally:
            eng.frame_fn = functools.partial(render_frame_raytraced,
                                             cluster_cap=cap)
        n_twin = _rgb_off(first, twin)
        n_c, n_d, n_rgb = _frame_diff(got, want)
        del got, want
        per, times = [], []
        for _ in range(VIEWER_RT_FRAMES):
            n0, a0 = rt_sweep.LAUNCHES, rt_sweep.ANY_HIT_LAUNCHES
            t = time.perf_counter()
            _viewer_step(v)
            times.append((time.perf_counter() - t) * 1e3)
            a = rt_sweep.ANY_HIT_LAUNCHES - a0
            per.append((rt_sweep.LAUNCHES - n0 - a, a))
        frames[cap] = first
        n_first = _rgb_off(first, frames[VIEWER_RT_CAPS[0]])
        prof = frame_kernel_ms(lambda: _viewer_step(v),
                               VIEWER_PROFILE_FRAMES)
        median = statistics.median(times)
        log(f"phase 26c viewer {name} 'g' @{w}x{h}, rt_cap={cap}: frame 0 "
            f"K4 launches {c0['K4'] - c0['K4a']} nearest + {c0['K4a']} "
            f"any-hit (K1 {c0['K1']}); vs the same step through K4's twin "
            f"{n_twin} pixels differ (float frames: {n_c} color > 1e-5, "
            f"{n_d} depth, {n_rgb} to_rgb8); vs rt_cap="
            f"{VIEWER_RT_CAPS[0]} {n_first} pixels differ; "
            f"{VIEWER_RT_FRAMES} frames {_spread(times)}, K4 a frame "
            f"{sorted(set(per))}; kernels {prof['kernels']:.3f} ms (K4 "
            f"{prof['K4']:.3f} ms), idle "
            f"{1.0 - prof['kernels'] / median:.1%} [{card}]")
        check((c0["K4"] - c0["K4a"], c0["K4a"], c0["K1"]) == (1, 1, 0),
              f"viewer {name} rt_cap={cap}: frame 0 launches {c0}")
        check(per == [(1, 1)] * VIEWER_RT_FRAMES,
              f"viewer {name} rt_cap={cap}: K4 a frame {per}")
        check(n_twin == 0 and n_first == 0,
              f"viewer {name} rt_cap={cap}: {n_twin} pixels off K4's "
              f"twin, {n_first} off rt_cap={VIEWER_RT_CAPS[0]}")
        limit = FRAME_COVERED_MISMATCH_MAX * w * h
        check(max(n_c, n_d, n_rgb) <= limit,
              f"viewer {name} rt_cap={cap}: float frames off the twin "
              f"{(n_c, n_d, n_rgb)}")
        out[cap] = dict(median_ms=median, prof=prof)
    _zero_counts()
    _viewer_step(v, press_g)
    _viewer_step(v)
    back = _launch_counts()
    check(not v.raytrace and back["K1"] == 2 and back["K4"] == 0,
          f"viewer {name}: 'g' off launched {back}")
    return out


def _viewer_views(card, name, v, path, size) -> dict:
    """Phase 26d: 'f' through WIREFRAME, OVERDRAW and DEPTH in the card's
    and the CPU's viewer, two frames each (the key pressed, then
    released), each view's first frame against the CPU's; the wireframe
    and overdraw views launch none of the kernels, the depth view's
    visibility pass K5 once a frame (VIEW_LAUNCHES); a fourth 'f' returns
    to NONE."""
    from softwarerenderer_tpu_torch import DebugMode
    w, h = size
    press_f = {"keys": {"f"}, "mouse_delta": (0.0, 0.0)}
    cv = _cpu_viewer(path, False, size)
    offs, launches = {}, {}
    for _ in range(3):
        _zero_counts()
        got, want = _viewer_step(v, press_f), _viewer_step(cv, press_f)
        check(v.mode == cv.mode, "the viewers' 'f' cycles differ")
        offs[v.mode.name] = (_rgb_off(got, want), _rgb_off(got, want, 2),
                             float((got != got[0, 0]).any(-1).mean()))
        _viewer_step(v)
        _viewer_step(cv)
        launches[v.mode.name] = {k: n for k, n in _launch_counts().items()
                                 if n}
    _viewer_step(v, press_f)
    _viewer_step(v)
    log(f"phase 26d viewer {name} 'f' @{w}x{h} against "
        f"Viewer(device='cpu'): " + "; ".join(
            f"{m} {a} pixels differ, {b} by > 2 ({c:.2%} drawn), launches "
            f"in 2 frames {launches[m] or 'none'}"
            for m, (a, b, c) in offs.items()) + f" [{card}]")
    check(list(offs) == ["WIREFRAME", "OVERDRAW", "DEPTH"]
          and v.mode == DebugMode.NONE, f"viewer 'f' cycle {list(offs)}")
    check(launches == VIEW_LAUNCHES, f"viewer views launched {launches}")
    for m, (_, b, c) in offs.items():
        check(b <= VIEWER_CPU_OFF_MAX * w * h and c > 1e-4,
              f"viewer {name} {m}: {b} pixels off the CPU's by > 2, "
              f"{c:.2%} drawn")
    return offs


def _viewer_io(card, models, tmp, size, device) -> dict:
    """Phase 26e: F10's GLB of the 3DS sphere reloads with the model's
    positions; --record's AVI holds the presented frames; the entry point
    runs headless in a subprocess and writes its PNGs."""
    from softwarerenderer_tpu_torch.apps import viewer as viewer_mod
    from softwarerenderer_tpu_torch.io_host import model_loader
    from softwarerenderer_tpu_torch.utils.video import read_avi
    w, h = size
    path, _ = models["sphere.3ds"]
    model_loader.clear_caches()
    v = viewer_mod.Viewer(path, width=w, height=h, render_scale=1.0,
                          headless=True, device=device)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        _viewer_step(v, {"keys": {"f10"}, "mouse_delta": (0.0, 0.0)})
        glb = os.path.join(tmp, "viewer_export_000.glb")
        model_loader.clear_caches()
        back = model_loader.load_model(glb)
    finally:
        os.chdir(cwd)
    pos_off = sum(_tree_off(b["position"], s["position"])
                  for b, s in zip(back.meshes, v.model.meshes))         + abs(len(back.meshes) - len(v.model.meshes))
    del v

    clip = os.path.join(tmp, "orbit.avi")
    rv = viewer_mod.Viewer(models["cube.dae"][0], width=w, height=h,
                           render_scale=1.0, headless=True, record=clip,
                           record_fps=30.0, device=device)
    shown = []
    present = rv.window.present

    def keep(rgb, overlay=None):
        shown.append(rgb.copy())
        present(rgb, overlay)
    rv.window.present = keep
    rv.run(frames=3)
    frames, fps = read_avi(clip)
    rec_ok = frames.shape == (3, h, w, 3) and np.array_equal(
        frames, np.stack(shown)) and abs(fps - 30.0) < 1e-3

    out_png = os.path.join(tmp, "entry.png")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "softwarerenderer_tpu_torch.apps.viewer",
         models["sphere.fbx"][0], "--headless", "--frames", "3", "--out",
         out_png], cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO))
    entry_s = time.perf_counter() - t
    pngs = sorted(f for f in os.listdir(tmp) if f.startswith("entry"))
    log(f"phase 26e viewer io: F10 exported {os.path.getsize(glb)} bytes, "
        f"reloaded with {pos_off} position values off the model's; "
        f"--record {frames.shape[0]} frames at {fps} fps, equal to the "
        f"presented frames: {rec_ok}; python -m "
        f"softwarerenderer_tpu_torch.apps.viewer sphere.fbx --headless "
        f"--frames 3: exit {proc.returncode} in {entry_s:.1f} s, wrote "
        f"{pngs} [{card}]")
    if proc.returncode != 0:
        log(proc.stderr[-2000:])
    check(pos_off == 0, f"viewer F10: {pos_off} position values off")
    check(rec_ok, "viewer --record: the AVI is not the presented frames")
    check(proc.returncode == 0 and pngs == ["entry.png", "entry_0001.png",
                                            "entry_0002.png"],
          f"viewer entry point: exit {proc.returncode}, {pngs}")
    return dict(entry_s=entry_s)


# ---- phase 27: the rest of the public API, the 19 demos ---------------------

API_TIMED_FRAMES = 29      # timed_frames on the bench frame, beside phase 4
SYNC_SLEEP_S = 2.0         # the spin queued ahead of hard_sync's read
SYNC_TIMEOUT_S = 0.5
SYNC_RAISE_MAX_S = 1.5     # hard_sync must raise within this
DEMO_CPU_OFF_MAX = 1e-3    # share of pixels off the CPU's by > 2 (phase 26)
SHOWCASE_CPU_FRAMES = 4    # the CPU's showcase: the orbit's first frames
DEMO_CPU_TIMEOUT_S = 900
# The CPU runs, in processes beside the card's demos: (demos, torch
# threads), None the rest.  Most demos are many small ops, fastest on one
# thread; the ray-traced demo's twin sweeps blocks of 2^24 (bundle, ray,
# slot) triples.
DEMO_CPU_GROUPS = ((("raytraced",), 4), (("particle_fountain",), 1),
                   (None, 1))
# Each demo's kernel launches on the card, by _launch_counts' names (the
# rest 0).  translucency_kbuffer's K2 is its live peel passes, counted on
# the CPU run; raytraced casts through the bundle route, 2 nearest (primary,
# reflection) and 1 any-hit (its 8 shadow samples in one cast).
DEMO_LAUNCHES = {
    "spinning_cube": {"K1": 8}, "custom_shader": {"K1": 1},
    "translucency_kbuffer": {"K1": 1, "K2": None},
    "raytraced": {"K1": 1, "K4": 3, "K4a": 1},
    "shadowed_scene": {"K1": 1, "K5": 1},
    "point_light_shadows": {"K1": 1, "K5": 6},
    "pbr_materials": {"K1": 1}, "sky_environment": {"K1": 1},
    "normal_mapping": {"K1": 2}, "mesh_lod": {"K1": 1},
    "morph_targets": {"K1": 12}, "skeletal_animation": {"K1": 12},
    "skinned_crowd": {"K1": 1}, "particle_fountain": {"K1": 120},
    "ai_agents": {"K1": 1}, "render_to_texture": {"K1": 6},
    "split_screen": {"K1": 16}, "multichip_render": {"K1m": 1},
    "showcase": {"K1": 96}}


def check_api_helpers(card, eng, u0, phase4_ms, device="cuda") -> dict:
    """Phase 27a: utils.profiling's helpers and rt_accel's bundle counters
    on the card.  timed_frames over API_TIMED_FRAMES bench frames (logged
    beside phase 4's median); hard_sync(timeout_s=SYNC_TIMEOUT_S) on a
    tensor queued behind a SYNC_SLEEP_S spin raises DeviceSyncTimeout
    within SYNC_RAISE_MAX_S and the card then finishes the work; an armed
    watchdog in a subprocess exits 42 with its dump; trace writes a Chrome
    trace holding K1's kernel and an annotate span; bundle_pair_count and
    bundle_survivor_count on the ray-traced bench frame's two casts equal
    the CPU's and the casts' listed pairs (phase 11's count)."""
    import glob
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.utils import profiling
    t_phase = time.perf_counter()
    spf = profiling.timed_frames(
        lambda i: eng.render(scenes.camera_uniforms(eng.uniforms, i)),
        API_TIMED_FRAMES, timeout_s=120)
    log(f"phase 27a timed_frames: bench frame @{W}x{H}, "
        f"{API_TIMED_FRAMES} pipelined frames between two hard syncs: "
        f"{spf * 1e3:.3f} ms a frame (phase 4's median, each frame "
        f"synchronised: {phase4_ms:.3f} ms) [{card}]")

    # A spin kernel's cycles a second, then one of SYNC_SLEEP_S ahead of
    # the tensor hard_sync reads.
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 8)
    end.record()
    end.synchronize()
    per_s = 10 ** 8 / (start.elapsed_time(end) * 1e-3)
    x = torch.ones(1024, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(int(per_s * SYNC_SLEEP_S))
    y = x * 2.0
    raised = False
    try:
        profiling.hard_sync({"y": y}, timeout_s=SYNC_TIMEOUT_S)
    except profiling.DeviceSyncTimeout:
        raised = True
    raise_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    done_s = time.perf_counter() - t0
    value = profiling.hard_sync({"y": y}, timeout_s=10)
    log(f"phase 27a hard_sync(timeout_s={SYNC_TIMEOUT_S}) behind a "
        f"{SYNC_SLEEP_S} s spin: DeviceSyncTimeout raised {raised} after "
        f"{raise_s:.3f} s; the card finished the queue at {done_s:.3f} s; "
        f"the probe then {value} (2048 expected) [{card}]")
    check(raised and raise_s < SYNC_RAISE_MAX_S,
          f"hard_sync raised {raised} after {raise_s:.3f} s")
    check(done_s > SYNC_SLEEP_S * 0.5 and value == 2048.0,
          f"after the timeout: {done_s:.3f} s, probe {value}")

    code = ("import time\nfrom softwarerenderer_tpu_torch.utils import "
            "profiling\nprofiling.arm_watchdog('smoke stage', 0.5)\n"
            "time.sleep(60)\n")
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    log(f"phase 27a watchdog in a subprocess: exit {out.returncode} after "
        f"{time.perf_counter() - t:.1f} s, "
        f"{out.stderr.count(chr(10))} lines of thread dump on stderr")
    check(out.returncode == 42
          and "[watchdog] stage 'smoke stage'" in out.stderr,
          f"watchdog: exit {out.returncode}, stderr {out.stderr[-400:]}")

    with tempfile.TemporaryDirectory(prefix="trace_") as tmp:
        with profiling.trace(tmp) as d:
            for _ in range(5):
                with profiling.annotate("smoke.api_trace"):
                    eng.render(u0)
            torch.cuda.synchronize()
        files = glob.glob(os.path.join(d, "*.json"))
        check(len(files) == 1, f"trace wrote {files}")
        with open(files[0]) as f:
            names = [e.get("name", "") for e in
                     json.load(f).get("traceEvents", [])]
    k1_events = sum("tile_raster_kernel" in n for n in names)
    spans = names.count("smoke.api_trace")
    log(f"phase 27a trace: {len(names)} events, {k1_events} of K1 "
        f"(tile_raster_kernel), {spans} 'smoke.api_trace' spans")
    check(k1_events > 0 and spans > 0,
          f"trace: K1 events {k1_events}, spans {spans}")

    out = check_bundle_counters(card, device)
    out.update(timed_ms=spf * 1e3, sync_raise_s=raise_s)
    log(f"phase 27a took {time.perf_counter() - t_phase:.1f} s")
    return out


def check_bundle_counters(card, device="cuda", size=(W, H)) -> dict:
    """Phase 27a's bundle counters: the ray-traced bench frame (cluster_cap
    RT_CAP) with its two casts captured; on each cast's bundles
    bundle_pair_count equals the CPU's and the cast's listed pairs
    (phase 11's count), and bundle_survivor_count of every bundle equals
    the CPU's."""
    from softwarerenderer_tpu_torch import RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import Engine
    from softwarerenderer_tpu_torch.ops import rt_accel, rt_sweep
    from softwarerenderer_tpu_torch.ops.raytrace import render_frame_raytraced
    w, h = size
    params = RenderParams(w, h)
    eng = Engine(scenes.bench_scene(), params, device=device)
    u = scenes.camera_uniforms(eng.uniforms, 0)
    casts = []
    cast_fns = {"primary": rt_sweep.raycast_bundles_nearest,
                "shadow": rt_sweep.raycast_bundles_any}

    def capturing(name):
        def cast(o, d, world, accel, **kw):
            res = cast_fns[name](o, d, world, accel, **kw)
            casts.append((name, o, d, world, accel, kw.get("tri_mask"),
                          int(res["n_pairs"])))
            return res
        return cast

    rt_sweep.raycast_bundles_nearest = capturing("primary")
    rt_sweep.raycast_bundles_any = capturing("shadow")
    try:
        render_frame_raytraced(eng.scene, u, params, cluster_cap=RT_CAP)
    finally:
        rt_sweep.raycast_bundles_nearest = cast_fns["primary"]
        rt_sweep.raycast_bundles_any = cast_fns["shadow"]
    check([c[0] for c in casts] == ["primary", "shadow"],
          f"casts {[c[0] for c in casts]}")

    def cpu(tree):
        return {k: v.cpu() if isinstance(v, torch.Tensor) else v
                for k, v in tree.items()}

    out = {}
    for name, o, d, world, accel, tm, listed in casts:
        cworld, caccel = cpu(world), cpu(accel)
        ctm = None if tm is None else tm.cpu()
        got = int(rt_accel.bundle_pair_count(o, d, world, accel, tm))
        want = int(rt_accel.bundle_pair_count(o.cpu(), d.cpu(), cworld,
                                              caccel, ctm))
        t = time.perf_counter()
        per = [int(rt_accel.bundle_survivor_count(o[b], d[b], world, accel,
                                                  tm))
               for b in range(o.shape[0])]
        per_s = time.perf_counter() - t
        cper = [int(rt_accel.bundle_survivor_count(
            o[b].cpu(), d[b].cpu(), cworld, caccel, ctm))
            for b in range(o.shape[0])]
        n_off = sum(a != b for a, b in zip(per, cper))
        log(f"phase 27a bundle counters, ray-traced bench frame @{w}x{h} "
            f"{name} cast ({o.shape[0]} bundles x {o.shape[1]} rays, "
            f"{caccel['n_clusters']} clusters of {caccel['group']}): "
            f"bundle_pair_count {got} on the card, {want} on the CPU, the "
            f"cast listed {listed}; bundle_survivor_count over the bundles "
            f"{sum(per)} (max {max(per)}), {n_off} bundles off the CPU's, "
            f"{per_s * 1e3 / len(per):.3f} ms a call [{card}]")
        check(got == want == listed, f"{name}: pairs {got}, CPU {want}, "
              f"listed {listed}")
        check(per == cper and sum(per) == got,
              f"{name}: survivors differ from the CPU's or the pairs")
        out[name] = {"pairs": got, "max_survivors": max(per)}
    return out


def _demo_kwargs(mod, out_dir: str) -> dict:
    """main's keyword arguments that write a demo's outputs into out_dir
    under their default basenames; a module-level OUT (a path the JAX demo
    hard-codes) is pointed there too."""
    import inspect
    kw = {}
    for name, p in inspect.signature(mod.main).parameters.items():
        if name in ("out", "out_dir") and isinstance(p.default, str):
            kw[name] = os.path.join(out_dir,
                                    os.path.basename(p.default.rstrip("/")))
    if hasattr(mod, "OUT"):
        mod.OUT = os.path.join(out_dir, os.path.basename(mod.OUT))
    return kw


def _demo_images(name: str, out_dir: str, frames=None) -> dict:
    """The images a demo wrote under out_dir, by relative path (an AVI's
    first `frames` frames as path#i)."""
    from PIL import Image
    from softwarerenderer_tpu_torch.utils.video import read_avi
    out = {}
    for root, _, files in os.walk(out_dir):
        for f in sorted(files):
            path = os.path.join(root, f)
            rel = os.path.relpath(path, out_dir)
            if f.endswith(".png"):
                with Image.open(path) as im:
                    out[rel] = np.asarray(im)
            elif f.endswith(".avi"):
                clip, _fps = read_avi(path)
                for i, fr in enumerate(clip[:frames]):
                    out[f"{rel}#{i}"] = fr
    return out


def cpu_demo_runs(out_dir: str, names: list, threads: int) -> None:
    """Phase 27b's CPU half, run in processes of their own beside the
    card's demos: the demos `names` with device="cpu" into out_dir/<name>
    on `threads` torch threads, showcase's first SHOWCASE_CPU_FRAMES
    frames of its orbit, each timed, with the kernels' wrappers counted
    (K1, K2 and their mapped forms, K4 and its any-hit casts; on the CPU
    they run the plain twins), into out_dir/<first name>.json."""
    import importlib
    import itertools
    from PIL import Image
    from softwarerenderer_tpu_torch.ops import rt_sweep, tile_raster
    torch.set_num_threads(threads)
    fold, sweep = tile_raster.tile_fold, rt_sweep.rt_sweep
    counts = {}

    def counted_fold(*a, **k):
        key = ("K2" if k.get("prev_i") is not None else "K1") \
            + ("m" if k.get("origin") is not None else "")
        counts[key] = counts.get(key, 0) + 1
        return fold(*a, **k)

    def counted_sweep(*a, **k):
        counts["K4"] = counts.get("K4", 0) + 1
        if k.get("any_hit"):
            counts["K4a"] = counts.get("K4a", 0) + 1
        return sweep(*a, **k)

    tile_raster.tile_fold, rt_sweep.rt_sweep = counted_fold, counted_sweep
    results = {}
    for name in names:
        d = os.path.join(out_dir, name)
        os.makedirs(d)
        os.chdir(d)
        mod = importlib.import_module(
            f"softwarerenderer_tpu_torch.examples.{name}")
        counts.clear()
        t = time.perf_counter()
        if name == "showcase":
            for i, rgb in enumerate(itertools.islice(
                    mod.orbit_frames(device="cpu"), SHOWCASE_CPU_FRAMES)):
                Image.fromarray(rgb).save(
                    os.path.join(d, f"showcase.avi#{i}.png"))
        else:
            mod.main(device="cpu", **_demo_kwargs(mod, d))
        results[name] = {"s": time.perf_counter() - t, "folds": dict(counts),
                         "threads": threads}
        print(f"cpu {name} {results[name]}", flush=True)
    os.chdir(out_dir)
    with open(os.path.join(out_dir, f"{names[0]}.json"), "w") as f:
        json.dump(results, f)


def check_demos(card, device="cuda") -> dict:
    """Phase 27b: each of the 19 demos (softwarerenderer_tpu_torch.examples)
    on the card, in this process, into a temporary directory (also the
    working directory: two write relative paths), multichip_render as a
    one-rank NCCL group: seconds, every kernel's launches (exactly
    DEMO_LAUNCHES, no plain twin on the card path), the files and their
    sizes.  Meanwhile cpu_demo_runs runs them all with device="cpu" in
    processes of their own (DEMO_CPU_GROUPS); each image the card wrote
    is then held against the CPU's: at most DEMO_CPU_OFF_MAX of its pixels
    off by more than 2 (showcase: the AVI's first SHOWCASE_CPU_FRAMES
    frames against the CPU's first frames of the same orbit)."""
    import importlib
    from softwarerenderer_tpu_torch.examples import DEMOS
    t_phase = time.perf_counter()
    cwd = os.getcwd()
    out = {}
    named = [n for group, _ in DEMO_CPU_GROUPS if group for n in group]
    groups = [(list(g) if g else [n for n in DEMOS if n not in named], k)
              for g, k in DEMO_CPU_GROUPS]
    with tempfile.TemporaryDirectory(prefix="demos_") as tmp:
        cpu_dir, card_dir = os.path.join(tmp, "cpu"), os.path.join(tmp, "card")
        os.makedirs(cpu_dir)
        cpu_log = open(os.path.join(tmp, "cpu.log"), "w")
        procs = [subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; "
             f"chip_smoke.cpu_demo_runs({cpu_dir!r}, {names!r}, {k})"],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            stdout=cpu_log, stderr=subprocess.STDOUT)
            for names, k in groups]
        try:
            for name in DEMOS:
                d = os.path.join(card_dir, name)
                os.makedirs(d)
                os.chdir(d)
                mod = importlib.import_module(
                    f"softwarerenderer_tpu_torch.examples.{name}")
                _zero_counts()
                t = time.perf_counter()
                mod.main(device=device, **_demo_kwargs(mod, d))
                torch.cuda.synchronize()
                secs = time.perf_counter() - t
                counts = {k: v for k, v in _launch_counts().items() if v}
                files = {os.path.relpath(os.path.join(r, f), d):
                         os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(d) for f in fs}
                out[name] = {"s": secs, "launches": counts, "files": files}
            os.chdir(cwd)
            card_s = time.perf_counter() - t_phase
            rcs = [p.wait(timeout=DEMO_CPU_TIMEOUT_S) for p in procs]
        finally:
            os.chdir(cwd)
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            cpu_log.close()
        with open(os.path.join(tmp, "cpu.log")) as f:
            cpu_text = f.read()
        check(rcs == [0] * len(procs), f"the CPU demos' processes exited "
              f"{rcs}: {cpu_text[-2000:]}")
        cpu = {}
        for names, _ in groups:
            with open(os.path.join(cpu_dir, f"{names[0]}.json")) as f:
                cpu.update(json.load(f))
        for name in DEMOS:
            res = out[name]
            want = dict(DEMO_LAUNCHES[name])
            if want.get("K2", 0) is None:
                want["K2"] = cpu[name]["folds"].get("K2", 0)
            folds = cpu[name]["folds"]
            card_imgs = _demo_images(name, os.path.join(card_dir, name),
                                     SHOWCASE_CPU_FRAMES)
            cpu_imgs = {k[:-len(".png")] if "#" in k else k: v
                        for k, v in _demo_images(
                            name, os.path.join(cpu_dir, name)).items()}
            check(sorted(card_imgs) == sorted(cpu_imgs),
                  f"{name}: the card wrote {sorted(card_imgs)}, the CPU "
                  f"{sorted(cpu_imgs)}")
            if name != "showcase":      # the CPU's showcase is 4 frames
                check(folds == {k: v for k, v in want.items() if k != "K5"},
                      f"{name}: the CPU run's wrappers {folds}, expected "
                      f"{want}")
            offs = {}
            for rel, img in cpu_imgs.items():
                got = card_imgs.get(rel)
                check(got is not None and got.shape == img.shape,
                      f"{name}: the card wrote no {rel} like the CPU's")
                offs[rel] = _rgb_off(got, img, 2) / (img.shape[0]
                                                     * img.shape[1])
            worst = max(offs.values())
            res.update(cpu_s=cpu[name]["s"], worst_off=worst)
            log(f"phase 27b demo {name}: card {res['s']:.2f} s, launches "
                f"{res['launches']} (expected {want}; CPU run's wrappers "
                f"{folds}), wrote "
                + ", ".join(f"{k} ({v} B)" for k, v in
                            sorted(res["files"].items()))
                + f"; CPU run {cpu[name]['s']:.1f} s on "
                f"{cpu[name]['threads']} threads, {len(offs)} images "
                f"compared, worst {worst:.2e} of pixels off by > 2 [{card}]")
            check(res["launches"] == want,
                  f"{name}: launches {res['launches']}, expected {want}")
            check(worst <= DEMO_CPU_OFF_MAX,
                  f"{name}: {worst:.2e} of pixels off the CPU's by > 2")
            check(all(v > 0 for v in res["files"].values()),
                  f"{name}: an empty file")
    log(f"phase 27b: the card's demos {card_s:.1f} s, the CPU's beside "
        f"them {sum(c['s'] for c in cpu.values()):.1f} s in "
        f"{len(groups)} processes; phase 27b took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out


def build_kernels() -> None:
    """Phase 2: build every kernel from the checkout's sources and print
    what ptxas says of each."""
    from softwarerenderer_tpu_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all(["tile_raster", "tile_kdeep", "rt_sweep",
                            "vis_fold", "post_fx", "tile_shade"])
    build_s = time.perf_counter() - t0
    log(f"phase 2 build: {', '.join(p.name for p in libs.values())} in "
        f"{build_s:.2f} s (one nvcc per source, in parallel)")
    for name in libs:
        report_ptxas(build.BUILD_LOG.get(name, (0, ""))[1])


def bench_engine(device="cuda", size=(W, H)):
    """The opaque main path's engine, parameters and frame-0 uniforms."""
    from softwarerenderer_tpu_torch import RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import Engine
    params = RenderParams(*size)
    eng = Engine(scenes.bench_scene(), params, device=device)
    return eng, params, scenes.camera_uniforms(eng.uniforms, 0)


def first_fold(scene, u, params):
    """(args, kwargs) of the first tile_fold call of a frame."""
    from softwarerenderer_tpu_torch.engine import render_frame
    from softwarerenderer_tpu_torch.ops import tile_raster
    _, calls = capture_folds(
        lambda f: render_frame(scene, u, params, fold=f),
        tile_raster.tile_fold)
    return calls[0][0], calls[0][1]


def check_tile_kernel(card, eng, params, u0) -> dict:
    """Phase 3: K1 against its plain twin on the main path's inputs (the
    bench frame at 32x128 tiles), timed beside its bound and beside the
    same launch with the tiles in plain order; the same frame at
    EXTRA_TILINGS; a plan with every kind; the edge cases.  Returns the
    fold's inputs and outputs and K1's numbers."""
    from softwarerenderer_tpu_torch.ops import tile_raster
    h, w = params.height, params.width
    args, kwargs = first_fold(eng.scene, u0, params)
    kg, kd, ki = tile_raster.tile_fold(*args, **kwargs)
    pg, pd, pi = tile_raster.tile_fold_plain(*args, **kwargs)
    torch.cuda.synchronize()
    covered = (ki >= 0) | (pi >= 0)
    n_cov = int(covered.sum())
    diff_i = int((ki != pi).sum())
    diff_d = int((kd != pd).sum())
    gbuf_err = (kg - pg).abs().max().item()
    d_err = (kd - pd).abs().max().item()
    kernel_ms = cuda_ms(lambda: tile_raster.tile_fold(*args, **kwargs),
                        KERNEL_RUNS)
    plain_ms = cuda_ms(lambda: tile_raster.tile_fold_plain(*args, **kwargs),
                       PLAIN_RUNS)
    k1_bound = fold_bound(args, kwargs, (kg, kd, ki))
    log(f"phase 3 kernel vs plain @{w}x{h}: {n_cov} covered pixels "
        f"({n_cov / ki.numel():.4f} of the frame); best_i differs on "
        f"{diff_i}, best_d on {diff_d} pixels; G-buffer max abs diff "
        f"{gbuf_err:.3g}, depth max abs diff {d_err:.3g}; kernel "
        f"{kernel_ms:.3f} ms (median of {KERNEL_RUNS}), plain "
        f"{plain_ms:.3f} ms (median of {PLAIN_RUNS}); binned pairs "
        f"{int(args[6].sum())}, globals {int(args[3][0])}, bound "
        f"{k1_bound['bound_ms']:.4f} ms ({k1_bound['bound_by']}, "
        f"{k1_bound['tests']} tests) [{card}]")
    check(diff_i == 0, f"best_i differs on {diff_i} pixels")
    check(diff_d == 0, f"best_d differs on {diff_d} pixels")
    check(gbuf_err <= GBUF_ATOL, f"G-buffer diff {gbuf_err}")
    check(n_cov > 0.05 * ki.numel(), f"only {n_cov} pixels covered")

    # The same launch with the tiles in plain order instead of longest
    # list first: equal outputs, and what the order is worth.
    def plain_order(counts):
        return torch.arange(counts.numel(), device=counts.device)

    longest_first = tile_raster.tile_order
    tile_raster.tile_order = plain_order
    try:
        og, od, oi = tile_raster.tile_fold(*args, **kwargs)
        plain_order_ms = cuda_ms(
            lambda: tile_raster.tile_fold(*args, **kwargs), KERNEL_RUNS)
    finally:
        tile_raster.tile_order = longest_first
    again_ms = cuda_ms(lambda: tile_raster.tile_fold(*args, **kwargs),
                       KERNEL_RUNS)
    order_ms = cuda_ms(lambda: tile_raster.tile_order(args[6]), KERNEL_RUNS)
    check(torch.equal(oi, ki) and torch.equal(od, kd)
          and torch.equal(og, kg), "K1 depends on the tile order")
    log(f"phase 3 K1 tile order: longest list first {kernel_ms:.3f} and "
        f"{again_ms:.3f} ms, tiles in plain order {plain_order_ms:.3f} ms "
        f"(medians of {KERNEL_RUNS}; equal outputs); tile_order alone "
        f"{order_ms:.3f} ms; busiest tile {int(args[6].max())} pairs, mean "
        f"{float(args[6].float().mean()):.1f} [{card}]")

    # Other tilings of the same frame: a tile smaller than a block, whole
    # blocks, a ragged last block.  Kernel against twin on the padded
    # frame, and winners against the 32x128 frame's on the frame itself.
    for th, tw in EXTRA_TILINGS:
        t_args, t_kwargs = first_fold(
            eng.scene, u0, params.replace(tile_h=th, tile_w=tw))
        check((t_kwargs["tile_h"], t_kwargs["tile_w"]) == (th, tw),
              f"tiling {th}x{tw} became {t_kwargs['tile_h']}x"
              f"{t_kwargs['tile_w']}")
        tg, td, ti = tile_raster.tile_fold(*t_args, **t_kwargs)
        qg, qd, qi = tile_raster.tile_fold_plain(*t_args, **t_kwargs)
        n_i, n_d = int((ti != qi).sum()), int((td != qd).sum())
        g_err = (tg - qg).abs().max().item()
        same_i = int((ti[:h, :w] != ki[:h, :w]).sum())
        same_d = int((td[:h, :w] != kd[:h, :w]).sum())
        ms = cuda_ms(lambda: tile_raster.tile_fold(*t_args, **t_kwargs),
                     KERNEL_RUNS)
        log(f"phase 3 K1 at {th}x{tw} tiles ({t_args[6].numel()} tiles, "
            f"{int(t_args[6].sum())} pairs, {int(t_args[3][0])} globals): "
            f"kernel vs plain best_i differs on {n_i}, best_d on {n_d} "
            f"pixels, G-buffer max abs diff {g_err:.3g}; vs the 32x128 "
            f"frame best_i differs on {same_i}, best_d on {same_d} pixels; "
            f"kernel {ms:.3f} ms [{card}]")
        check(n_i == 0 and n_d == 0 and g_err <= GBUF_ATOL,
              f"K1 at {th}x{tw} tiles differs from its twin")
        check(same_i == 0 and same_d == 0,
              f"K1 at {th}x{tw} tiles differs from the 32x128 frame")

    # The main path's plan has pc, pw3 and v0 entries only; a plan over the
    # same payload with every kind (pc, pw, pw3, bary, v0) holds the
    # kernel's other interpolation branches against the twin too.
    plan = (("pc", 2, 6), ("pw", 9, 11), ("pw3", 6, 9), ("bary", 0, 0),
            ("v0", 14, 0))
    args_all = args[:-1] + (plan,)
    kwargs_all = dict(kwargs, kpi=13)
    ag, _, ai = tile_raster.tile_fold(*args_all, **kwargs_all)
    bg, _, bi = tile_raster.tile_fold_plain(*args_all, **kwargs_all)
    all_diff_i = int((ai != bi).sum())
    all_err = (ag - bg).abs().max().item()
    log(f"phase 3 every plan kind: best_i differs on {all_diff_i} pixels, "
        f"G-buffer max abs diff {all_err:.3g}")
    check(all_diff_i == 0, f"every-kind best_i differs on {all_diff_i}")
    check(all_err <= GBUF_ATOL, f"every-kind G-buffer diff {all_err}")

    # Ties, NaN and -inf depths and a -0.0 depth against a +0.0
    # framebuffer, through globals and segments, on the card.
    e_args, e_kwargs, e_best_i, e_best_d = edge_case_inputs(args[0].device)
    eg, ed, ei = tile_raster.tile_fold(*e_args, **e_kwargs)
    pg_e, pd_e, pi_e = tile_raster.tile_fold_plain(*e_args, **e_kwargs)
    for name, (g, d, i) in (("kernel", (eg, ed, ei)),
                            ("plain", (pg_e, pd_e, pi_e))):
        check(torch.equal(i.cpu(), e_best_i), f"edge case {name} best_i "
              f"{i.cpu().tolist()}")
        check(bool((d.cpu() == e_best_d).all()), f"edge case {name} best_d "
              f"{d.cpu().tolist()}")
    check(torch.equal(eg, pg_e), "edge case G-buffer differs")
    log("phase 3 edge cases (depth ties, NaN, -inf, -0.0): kernel and plain "
        "equal the expected winners")
    return dict(k1_bound, args=args, kwargs=kwargs, outputs=(kg, kd, ki),
                max_abs_err=max(gbuf_err, d_err), ms=kernel_ms,
                plain_ms=plain_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from softwarerenderer_tpu_torch import RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import Engine, render_frame
    from softwarerenderer_tpu_torch.models.scene import build_scene_buffers
    from softwarerenderer_tpu_torch.ops import tile_raster

    card = gpu_line()
    log(card)
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    build_kernels()
    eng, params, u0 = bench_engine()
    k1 = check_tile_kernel(card, eng, params, u0)
    args, kwargs, (kg, kd, ki) = k1["args"], k1["kwargs"], k1["outputs"]

    # ---- phase 4: the main path, counted --------------------------------
    run = counted_frames(
        lambda i: eng.render(scenes.camera_uniforms(eng.uniforms, i)),
        FRAMES, (W, H))
    launches = sum(run["k1"])
    check(run["k1"] == [1] * FRAMES, f"K1 launches per frame {run['k1']}")
    text = against_plain("main path", run["first"], render_frame(
        eng.scene, u0, params, fold=tile_raster.tile_fold_plain))
    steady = run["median_ms"]
    log(f"phase 4 main path @{W}x{H}: {FRAMES} frames, {launches} kernel "
        f"launches, first frame {run['frame_ms'][0]:.1f} ms, median frame "
        f"{steady:.3f} ms = {W * H / steady / 1e3:.1f} Mpixels/s; {text} "
        f"[{card}]")
    del run

    # ---- phase 5: golden configs through the kernel ---------------------
    from PIL import Image
    for n in (1, 2):
        gw, gh = scenes.GOLDEN_SIZES[n]
        g_eng = Engine(build_scene_buffers(scenes.golden_config(n)),
                       RenderParams(gw, gh), device="cuda")
        got = g_eng.present(dict(g_eng.uniforms)).astype(np.int32)
        golden = np.asarray(Image.open(os.path.join(
            REPO, "tests", "goldens", f"config{n}.png"))).astype(np.int32)
        diff = np.abs(got - golden)
        off = float(np.mean(np.any(diff > 2, axis=-1)))
        log(f"phase 5 golden config{n} {gw}x{gh}: {off:.6f} of pixels off "
            f"by > 2, mean diff {diff.mean():.4f}")
        check(got.shape == golden.shape and off < 2e-3
              and diff.mean() < 0.5, f"golden config{n}")

    check_frame_goldens()

    # ---- phases 6-9: the K-buffer ---------------------------------------
    peel = check_peel_kernel(card, "cuda", (W, H))
    kdeep = check_kdeep_kernel(
        card, peel["dense_pass0"], peel["translucent_pass0"],
        [(th, tw) + first_fold(eng.scene, u0,
                               params.replace(tile_h=th, tile_w=tw))
         for th, tw in EXTRA_TILINGS])
    kframes = check_kbuffer_frames(card, "cuda", (W, H), FRAMES)
    check_kbuffer_golden("cuda")

    # ---- phases 10-13: K4 and the ray-traced frame ----------------------
    n_cases = check_k4_edge_cases("cuda")
    log(f"phase 10 K4 edge cases ({n_cases}: ties, tri_mask, t = +0.0 and "
        f"-0.0, det under and over EPSILON, each face mask, NaN origins, "
        f"the winner in the last cluster, coplanar triangles across "
        f"clusters, a NaN ray among healthy ones): kernel and twin equal "
        f"the expected winners, t bit for bit")
    sweep = check_sweep_kernel(card, "cuda", (W, H))
    rt = check_raytraced_frames(card, "cuda", (W, H), FRAMES)
    check_bundle_vs_brute(card, "cuda", RT_BRUTE_SIZE)

    # ---- phases 14-16: K5 and the deferred route -----------------------
    k5 = check_vis_fold_kernel(card, args, kwargs, (kg, kd, ki), "cuda")
    deferred = check_deferred_frames(card, "cuda", (W, H), FRAMES)
    check_small_routes(card, SMALL_ROUTES_SIZE)

    # ---- phase 17: the K-slot K-buffer, the other depth tests ----------
    check_kslot_route(card, SMALL_ROUTES_SIZE, (W, H))

    # ---- phases 18-19: lit and shadowed frames -------------------------
    check_lit_frames(card)
    check_shadowed_frames(card)

    # ---- phase 20: the image-quality frames ----------------------------
    check_image_quality_frames(card)
    check_post_kernels(card)
    check_shade_kernel(card)

    # ---- phase 21: the animated frame ------------------------------------
    check_animated_frames(card)

    # ---- phase 22: the simulation ----------------------------------------
    check_simulation(card)

    # ---- phase 23: the Dust2 game ----------------------------------------
    game = check_game(card)

    # ---- phase 24: caps, shade_rate, views, the mirrored game -------------
    check_crowd_caps(card)
    check_views(card)
    check_mirrored_game(card, plain_ms=game["loop"]["median_ms"])

    # ---- phase 25: the multi-device layer --------------------------------
    mapped = check_origin_map(card, eng, params, u0)
    group = check_one_rank_group(card, eng, params, u0)
    ranks = check_parallel_ranks(card)
    # The mapped K2's and K5's launches on rank 0 over phase 25c's cases.
    k2m_launches = sum(c["launches"]["K2m"]
                       for c in ranks["gloo"][0]["cases"].values())
    k5m_launches = sum(c["launches"]["K5m"]
                       for c in ranks["gloo"][0]["cases"].values())

    # ---- phase 26: the model viewer --------------------------------------
    check_viewer(card)

    # ---- phase 27: the rest of the public API, the 19 demos ---------------
    t27 = time.perf_counter()
    check_api_helpers(card, eng, u0, steady)
    check_demos(card)
    log(f"phase 27 took {time.perf_counter() - t27:.1f} s")
    log(f"profiler: {TRACES['retaken']} of device_ms's {TRACES['taken']} "
        f"traces were taken again for a lost launch record")

    def entry(name, source, replaces, launches, numbers):
        return {"name": name, "route": "cuda",
                "source": f"softwarerenderer_tpu_torch/csrc/{source}",
                "replaces": f"softwarerenderer_tpu/{replaces}",
                "launches": launches, "max_abs_err": numbers["max_abs_err"],
                "ms": numbers["ms"], "plain_ms": numbers["plain_ms"],
                "bound_ms": numbers["bound_ms"],
                "bound_by": numbers["bound_by"], "library_ms": None}

    log(card)
    log(json.dumps({"kernels": [
        entry("tile_raster", "tile_raster.cu", "ops/pallas_tile.py:96",
              launches, k1),
        entry("tile_raster_peel", "tile_raster.cu", "ops/pallas_tile.py:96",
              kframes["peel_launches"], peel),
        entry("tile_kdeep", "tile_kdeep.cu", "ops/pallas_tile.py:649",
              kframes["kdeep_launches"], kdeep),
        entry("rt_sweep_nearest", "rt_sweep.cu", "ops/rt_pallas.py:59",
              rt["launches"]["nearest"], sweep["primary"]),
        entry("rt_sweep_any_hit", "rt_sweep.cu", "ops/rt_pallas.py:59",
              rt["launches"]["any_hit"], sweep["shadow"]),
        entry("vis_fold", "vis_fold.cu", "ops/pallas_raster.py:67",
              deferred["launches"], k5),
        entry("tile_raster_mapped", "tile_raster.cu", "ops/pallas_tile.py:96",
              group["launches"], mapped["K1m"]),
        entry("tile_raster_peel_mapped", "tile_raster.cu",
              "ops/pallas_tile.py:96", k2m_launches, mapped["K2m"]),
        entry("vis_fold_mapped", "vis_fold.cu", "ops/pallas_raster.py:67",
              k5m_launches, mapped["K5m"])]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
