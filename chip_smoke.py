#!/usr/bin/env python3
"""Smoke run of softwarerenderer_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ (one nvcc per source, in parallel) and
drives the port's two paths at 1080p:

  * the opaque frame (``Engine(scene, RenderParams(1920, 1080),
    device="cuda")``): K1, the tile kernel, against its plain PyTorch twin
    on the bench scene, 30 counted frames, the frame against the plain
    path, golden configs 1 and 2;
  * the K-buffer (``RenderParams(1920, 1080, kbuffer=4, cull_mode=0)``):
    K2, the tile kernel's peel mode, against its twin on passes 1-3 of a
    dense and a translucent frame and on an edge case; K3, the single-pass
    K-deep kernel, against its twin at K=4; 30 counted frames of the
    translucent scene through the peel route and 30 through the K-deep
    route, frame 0 against the plain path and the two routes against each
    other; the feature_kbuffer golden.

Any failed check raises and exits non-zero.  The last three lines of
standard output are the card's name and power limit, a JSON line with the
kernels' numbers, and ``{"ok": true, "device": {...}}``.

Needs a CUDA device: without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1080
FRAMES = 30
KERNEL_RUNS = 20
PLAIN_RUNS = 10
GBUF_ATOL = 1e-5           # G-buffer, kernel vs plain
# Kernel and plain twin round every operation once (-fmad=false), so best_i
# and best_d must be equal on every pixel.  A frame may differ from the
# plain path's on at most this share of its covered pixels (differences on
# background pixels count against it too).
FRAME_COVERED_MISMATCH_MAX = 1e-4
KBUFFER = 4
K1_REGISTERS = 126         # what ptxas gave K1 before the peel mode existed
# A K-buffer frame must have a live second layer on more than this share of
# its pixels, or the translucency the peel exists for is not exercised.
LIVE_SECOND_LAYER_MIN = 0.01


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


def kbuffer_golden_frame():
    """scripts/make_goldens.py's feature_kbuffer frame: a checkered floor,
    a cube, and a translucent glass cube in front of it, at 320x240 with
    K=4.  Returns (packed scene, RenderParams, uniforms)."""
    from softwarerenderer_tpu.models import primitives
    from softwarerenderer_tpu.models import scene as scene_mod
    from softwarerenderer_tpu.ops import texture as tex_np
    from softwarerenderer_tpu.utils import mathlib as ml
    from softwarerenderer_tpu_torch import CullMode, RenderParams
    from softwarerenderer_tpu_torch.engine import default_frame_uniforms
    checker = np.asarray(tex_np.checkerboard(32, 4)["data"])
    glass = np.zeros((8, 8, 4), np.float32)
    glass[...] = (0.3, 0.5, 1.0, 0.45)
    insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                    ml.translation([0, -1, 0]),
                                    texture=checker),
             scene_mod.MeshInstance(primitives.cube(1.0),
                                    ml.translation([0, 0, -4]),
                                    texture=checker),
             scene_mod.MeshInstance(primitives.cube(1.4),
                                    ml.translation([0, 0, -2.2]),
                                    texture=glass)]
    params = RenderParams(width=320, height=240, kbuffer=4,
                          cull_mode=CullMode.BACK)
    u = default_frame_uniforms(320, 240)
    u["camera_position"] = np.float32([0, 0.8, 2.0])
    return scene_mod.build_scene_buffers(insts), params, u


def translucent_scene():
    """The bench scene's fallback soup (bench.py:43-45) with the six
    alpha-0.5 glass panes of scripts/profile_translucent.py:52-63, as a
    packed scene."""
    from softwarerenderer_tpu.models import primitives
    from softwarerenderer_tpu.models import scene as scene_mod
    from softwarerenderer_tpu.ops import texture as tex_np
    from softwarerenderer_tpu.utils import mathlib as ml
    fallback = np.asarray(tex_np.checkerboard(
        64, 8, (0.8, 0.75, 0.6, 1.0), (0.55, 0.5, 0.4, 1.0))["data"])
    insts = [scene_mod.MeshInstance(
        primitives.random_triangle_soup(9061, seed=0), texture=fallback)]
    rng = np.random.default_rng(3)
    for i in range(6):
        pane = dict(primitives.plane(1.6))
        col = np.ones((pane["position"].shape[0], 4), np.float32)
        col[:, 3] = 0.5
        col[:, :3] = rng.uniform(0.4, 1.0, 3)
        pane["color"] = col
        m = (ml.matrix_from_yaw_pitch_roll(0.0, np.pi / 2, 0.0)
             @ ml.translation([-3.0 + 1.4 * i, 2.0, 2.0 + 0.4 * (i % 3)])
             ).astype(np.float32)
        insts.append(scene_mod.MeshInstance(pane, m))
    return scene_mod.build_scene_buffers(insts)


def report_ptxas(output: str) -> None:
    """Print ptxas's registers, spills and shared memory per kernel
    instantiation; fail on a spill."""
    names = {"tile_raster_kernelILb0E": "K1 tile_raster_kernel<false>",
             "tile_raster_kernelILb1E": "K2 tile_raster_kernel<true>"}
    fn = "?"
    for line in output.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            fn = next((v for k, v in names.items() if k in mangled), mangled)
            if "tile_kdeep_kernelILi" in mangled:
                k = mangled.split("tile_kdeep_kernelILi")[1].split("E")[0]
                fn = f"K3 tile_kdeep_kernel<{k}>"
        elif "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas {fn}: {line.strip()}")
            check(" 0 bytes spill stores" in line or "spill" not in line,
                  f"{fn} spills: {line.strip()}")
            if fn.startswith("K1") and "Used " in line:
                regs = int(line.split("Used ")[1].split()[0])
                check(regs <= K1_REGISTERS, f"K1 uses {regs} registers, "
                      f"more than its {K1_REGISTERS}")


def capture_folds(render, fold):
    """Run render(wrapper), where wrapper calls fold, and return its
    result and [(args, kwargs, outputs)] of every fold call, in order."""
    calls = []

    def wrapper(*args, **kwargs):
        out = fold(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    return render(wrapper), calls


def check_peel_kernel(card, bench, device, size) -> dict:
    """Phase 6: K2 against its plain twin on passes 1-3 of two 1080p
    frames: the bench scene with the short-circuit off (a dense peel) and
    the translucent scene.  Returns the K2 timing, its largest difference
    and the dense frame's pass-0 fold inputs."""
    from softwarerenderer_tpu_torch import RenderParams
    from softwarerenderer_tpu_torch.engine import Engine, render_frame
    from softwarerenderer_tpu_torch.ops import tile_raster
    from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR
    w, h = size
    inputs = {
        "dense": (bench.build_scene(),
                  RenderParams(w, h, kbuffer=KBUFFER,
                               kbuffer_short_circuit=False)),
        "translucent": (translucent_scene(),
                        RenderParams(w, h, kbuffer=KBUFFER, cull_mode=0))}
    out = {"max_abs_err": 0.0}
    for name, (scene, params) in inputs.items():
        eng = Engine(scene, params, device=device)
        u = bench.camera_uniforms(eng.uniforms, 0)
        _, calls = capture_folds(
            lambda f: render_frame(eng.scene, u, params, fold=f),
            tile_raster.tile_fold)
        args, kwargs, _ = calls[0]
        if name == "dense":
            out["dense_pass0"] = (args, kwargs)
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
                log(f"phase 6 K2 dense pass 1: kernel {out['ms']:.3f} ms "
                    f"(median of {KERNEL_RUNS}), plain "
                    f"{out['plain_ms']:.3f} ms (median of {PLAIN_RUNS}) "
                    f"[{card}]")
            if name == "translucent" and k == 1:
                ms = cuda_ms(lambda: tile_raster.tile_fold(*args, **pkw),
                             KERNEL_RUNS)
                log(f"phase 6 K2 translucent pass 1 (tiles without an "
                    f"eligible pixel skip): kernel {ms:.3f} ms [{card}]")

    # Ties at the previous winner's depth, -0.0 against +0.0 and a tile
    # with no eligible pixel, on the card.
    e_args, e_kwargs, e_best_i, e_best_d = peel_edge_case_inputs(device)
    kernel = tile_raster.tile_fold(*e_args, **e_kwargs)
    plain = tile_raster.tile_fold_plain(*e_args, **e_kwargs)
    for name, (g, d, i) in (("kernel", kernel), ("plain", plain)):
        check(torch.equal(i.cpu(), e_best_i),
              f"peel edge case {name} best_i {i.cpu().tolist()}")
        check(bool((d.cpu() == e_best_d).all()),
              f"peel edge case {name} best_d {d.cpu().tolist()}")
    check(torch.equal(kernel[0], plain[0]), "peel edge case G-buffer")
    log("phase 6 K2 edge cases (ties below, at and above the previous "
        "winner, -0.0, a tile with no eligible pixel): kernel and plain "
        "equal the expected winners")
    return out


def check_kdeep_kernel(card, dense_pass0) -> dict:
    """Phase 7: K3 at K=4 against its plain twin on the dense frame's
    fold inputs: every layer's winners and depths equal, G-buffers within
    GBUF_ATOL."""
    from softwarerenderer_tpu_torch.ops import tile_raster
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
    log(f"phase 7 K3 K={KBUFFER} vs plain @{Wp}x{Hp} padded: covered "
        f"pixels per layer {per_layer}; best_i differs on {diff_i}, best_d "
        f"on {diff_d} of {ki.numel()} slots; G-buffer max abs diff "
        f"{g_err:.3g}; kernel {ms:.3f} ms (median of {KERNEL_RUNS}), plain "
        f"{plain_ms:.3f} ms (median of {PLAIN_RUNS}) [{card}]")
    check(diff_i == 0, f"K3 best_i differs on {diff_i} slots")
    check(diff_d == 0, f"K3 best_d differs on {diff_d} slots")
    check(g_err <= GBUF_ATOL, f"K3 G-buffer diff {g_err}")
    check(per_layer[1] > 0, "K3 found no second layer")
    return {"max_abs_err": max(g_err, d_err), "ms": ms,
            "plain_ms": plain_ms}


def host_syncs(fn, frames: int) -> float:
    """Host synchronisations per call of fn(i), counted by torch.profiler
    over `frames` calls (the closing synchronize not counted)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(frames):
            fn(i)
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if "Synchronize" in e.key)
    return (n - 1) / frames


def check_kbuffer_frames(card, bench, device, size, frames) -> dict:
    """Phase 8: the K-buffer main path.  30 frames of the translucent
    scene through Engine (K1 once and K2 once per live pass in every
    frame), frame 0 against the plain twins' frame, and 30 frames of the
    same scene through the single-pass route (K3 once per frame) against
    the peel route's images.  Returns the launch counts."""
    from softwarerenderer_tpu_torch import RenderParams
    from softwarerenderer_tpu_torch.engine import (Engine, frame_setup,
                                                   render_frame,
                                                   scene_fragment_shader,
                                                   to_rgb8)
    from softwarerenderer_tpu_torch.ops import tile_raster
    from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR
    w, h = size
    params = RenderParams(w, h, kbuffer=KBUFFER, cull_mode=0)
    eng = Engine(translucent_scene(), params, device=device)

    def u_at(i):
        return bench.camera_uniforms(eng.uniforms, i)

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
    from softwarerenderer_tpu_torch.engine import Engine
    scene, params, u = kbuffer_golden_frame()
    got = Engine(scene, params, device=device).present(u).astype(np.int32)
    golden = np.asarray(Image.open(os.path.join(
        REPO, "tests", "goldens", "feature_kbuffer.png"))).astype(np.int32)
    diff = np.abs(got - golden)
    off = float(np.mean(np.any(diff > 2, axis=-1)))
    log(f"phase 9 golden feature_kbuffer {params.width}x{params.height}: "
        f"{off:.6f} of pixels off by > 2, mean diff {diff.mean():.4f}")
    check(got.shape == golden.shape and off < 2e-3,
          "golden feature_kbuffer")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import bench
    from softwarerenderer_tpu_torch import RenderParams
    from softwarerenderer_tpu_torch.engine import Engine, render_frame
    from softwarerenderer_tpu_torch.engine import to_rgb8
    from softwarerenderer_tpu_torch.kernels import build
    from softwarerenderer_tpu_torch.ops import tile_raster
    from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR

    card = gpu_line()
    log(card)
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    # ---- phase 2: build the kernels from the checkout's sources ---------
    t0 = time.perf_counter()
    libs = build.build_all(["tile_raster", "tile_kdeep"])
    build_s = time.perf_counter() - t0
    log(f"phase 2 build: {', '.join(p.name for p in libs.values())} in "
        f"{build_s:.2f} s (one nvcc per source, in parallel)")
    for name in libs:
        report_ptxas(build.BUILD_LOG.get(name, (0, ""))[1])

    # ---- phase 3: kernel against plain on the main path's inputs --------
    params = RenderParams(W, H)
    eng = Engine(bench.build_scene(), params, device="cuda")
    u0 = bench.camera_uniforms(eng.uniforms, 0)
    captured = {}

    def capture(*args, **kwargs):
        captured["args"], captured["kwargs"] = args, kwargs
        return tile_raster.tile_fold(*args, **kwargs)

    render_frame(eng.scene, u0, params, fold=capture)
    args, kwargs = captured["args"], captured["kwargs"]
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
    log(f"phase 3 kernel vs plain @{W}x{H}: {n_cov} covered pixels "
        f"({n_cov / ki.numel():.4f} of the frame); best_i differs on "
        f"{diff_i}, best_d on {diff_d} pixels; G-buffer max abs diff "
        f"{gbuf_err:.3g}, depth max abs diff {d_err:.3g}; kernel "
        f"{kernel_ms:.3f} ms (median of {KERNEL_RUNS}), plain "
        f"{plain_ms:.3f} ms (median of {PLAIN_RUNS}) [{card}]")
    check(diff_i == 0, f"best_i differs on {diff_i} pixels")
    check(diff_d == 0, f"best_d differs on {diff_d} pixels")
    check(gbuf_err <= GBUF_ATOL, f"G-buffer diff {gbuf_err}")
    check(n_cov > 0.05 * ki.numel(), f"only {n_cov} pixels covered")

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
    e_args, e_kwargs, e_best_i, e_best_d = edge_case_inputs("cuda")
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

    # ---- phase 4: the main path, counted --------------------------------
    tile_raster.LAUNCHES = 0
    frame_ms, finite = [], True
    first = None
    for i in range(FRAMES):
        u = bench.camera_uniforms(eng.uniforms, i)
        t = time.perf_counter()
        color, depth = eng.render(u)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
        finite &= bool(torch.isfinite(color).all() and
                       torch.isfinite(depth).all())
        check(color.shape == (H, W, 4) and depth.shape == (H, W),
              f"frame shapes {tuple(color.shape)} {tuple(depth.shape)}")
        if i == 0:
            first, first_depth = color, depth
    launches = tile_raster.LAUNCHES
    check(launches == FRAMES, f"{launches} kernel launches for {FRAMES} "
          "frames")
    check(finite, "non-finite output")
    plain_color, plain_depth = render_frame(
        eng.scene, bench.camera_uniforms(eng.uniforms, 0), params,
        fold=tile_raster.tile_fold_plain)
    n_cov = int(((first_depth != DEPTH_CLEAR) |
                 (plain_depth != DEPTH_CLEAR)).sum())
    n_diff = int(((first - plain_color).abs().amax(-1) > 1e-5).sum())
    n_diff_d = int((first_depth != plain_depth).sum())
    rgb = eng.present(u0)
    rgb_plain = to_rgb8(plain_color).cpu().numpy()
    n_diff_rgb = int((rgb != rgb_plain).any(-1).sum())
    steady = statistics.median(frame_ms[1:])
    log(f"phase 4 main path @{W}x{H}: {FRAMES} frames, {launches} kernel "
        f"launches, first frame {frame_ms[0]:.1f} ms, median frame "
        f"{steady:.3f} ms = {W * H / steady / 1e3:.1f} Mpixels/s; frame 0 vs "
        f"plain path: of {n_cov} covered pixels, {n_diff} differ > 1e-5 in "
        f"color, {n_diff_d} in depth, {n_diff_rgb} in present [{card}]")
    limit = FRAME_COVERED_MISMATCH_MAX * n_cov
    check(n_cov > 0.05 * W * H, f"only {n_cov} pixels covered")
    check(n_diff <= limit, f"frame 0 color differs on {n_diff} pixels")
    check(n_diff_d <= limit, f"frame 0 depth differs on {n_diff_d} pixels")
    check(n_diff_rgb <= limit, f"present differs on {n_diff_rgb} pixels")

    # ---- phase 5: golden configs through the kernel ---------------------
    from PIL import Image
    from scripts.make_goldens import GOLDEN_SIZES
    from softwarerenderer_tpu.models import scene as scene_mod
    for n in (1, 2):
        insts, _, _, _, _ = bench.config_workload(n)
        gw, gh = GOLDEN_SIZES[n]
        g_eng = Engine(scene_mod.build_scene_buffers(insts),
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

    # ---- phases 6-9: the K-buffer ---------------------------------------
    peel = check_peel_kernel(card, bench, "cuda", (W, H))
    kdeep = check_kdeep_kernel(card, peel["dense_pass0"])
    kframes = check_kbuffer_frames(card, bench, "cuda", (W, H), FRAMES)
    check_kbuffer_golden("cuda")

    log(card)
    log(json.dumps({"kernels": [{
        "name": "tile_raster", "route": "cuda",
        "source": "softwarerenderer_tpu_torch/csrc/tile_raster.cu",
        "replaces": "softwarerenderer_tpu/ops/pallas_tile.py:96",
        "launches": launches, "max_abs_err": max(gbuf_err, d_err),
        "ms": kernel_ms, "plain_ms": plain_ms}, {
        "name": "tile_raster_peel", "route": "cuda",
        "source": "softwarerenderer_tpu_torch/csrc/tile_raster.cu",
        "replaces": "softwarerenderer_tpu/ops/pallas_tile.py:96",
        "launches": kframes["peel_launches"],
        "max_abs_err": peel["max_abs_err"], "ms": peel["ms"],
        "plain_ms": peel["plain_ms"]}, {
        "name": "tile_kdeep", "route": "cuda",
        "source": "softwarerenderer_tpu_torch/csrc/tile_kdeep.cu",
        "replaces": "softwarerenderer_tpu/ops/pallas_tile.py:649",
        "launches": kframes["kdeep_launches"],
        "max_abs_err": kdeep["max_abs_err"], "ms": kdeep["ms"],
        "plain_ms": kdeep["plain_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
