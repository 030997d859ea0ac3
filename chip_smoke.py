#!/usr/bin/env python3
"""Smoke run of softwarerenderer_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ (one nvcc per source, in parallel) and
drives the port's three paths at 1080p:

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
    other; the feature_kbuffer golden;
  * the ray-traced frame (``Engine(scene, RenderParams(1920, 1080),
    device="cuda", frame_fn=functools.partial(render_frame_raytraced,
    cluster_cap=24))``): K4, the ray-bundle sweep, on its edge cases and
    against its twin on the primary (nearest) and shadow (any-hit) casts of
    two frames; 30 counted frames with hard shadows, frame 0 against the
    twin's frame; one soft-shadow and one reflection frame against the
    twin; the bundle route against the brute route at 320x180.

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
RT_CAP = 24                # the game's --raytrace CAP (bench.py's row)
RT_PLAIN_RUNS = 3          # the sweep's plain twin at 1080p is slow
RT_BRUTE_SIZE = (320, 180)
# The least time the card could take (NVIDIA's H100 SXM data sheet, dense,
# at its 700 W limit): FP32 outside the tensor cores and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations of one test, per-triangle terms hoisted: a tile fold's
# (triangle, pixel) test is 3 edge functions of 5 and a depth of 8
# (tile_common.cuh:fragment); a sweep's (ray, triangle) Möller–Trumbore
# test is 46 (csrc/rt_sweep.cu).  Comparisons are not counted.
FOLD_OPS = 23
MT_OPS = 46


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
    """Bound of one tile fold (K1, K2, K3) on these inputs: each tile that
    folds at all (in peel mode, a tile with an eligible pixel) tests its
    binned triangles and the globals against each of its pixels; every
    input is read once and every output written once."""
    _, _, _, n_global, _, _, counts, _, _ = args
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


def report_ptxas(output: str) -> None:
    """Print ptxas's registers, spills and shared memory per kernel
    instantiation; fail on a spill."""
    names = {"tile_raster_kernelILb0E": "K1 tile_raster_kernel<false>",
             "tile_raster_kernelILb1E": "K2 tile_raster_kernel<true>",
             "rt_sweep_kernelILb0E": "K4 rt_sweep_kernel<nearest>",
             "rt_sweep_kernelILb1E": "K4 rt_sweep_kernel<any-hit>"}
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


def check_peel_kernel(card, device, size) -> dict:
    """Phase 6: K2 against its plain twin on passes 1-3 of two 1080p
    frames: the bench scene with the short-circuit off (a dense peel) and
    the translucent scene.  Returns the K2 timing, its largest difference
    and the dense frame's pass-0 fold inputs."""
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
                out.update(fold_bound(args, pkw, (kg, kd, ki)))
                log(f"phase 6 K2 dense pass 1: kernel {out['ms']:.3f} ms "
                    f"(median of {KERNEL_RUNS}), plain "
                    f"{out['plain_ms']:.3f} ms (median of {PLAIN_RUNS}); "
                    f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}, "
                    f"{out['tests']} tests) [{card}]")
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
    return dict(b, max_abs_err=max(g_err, d_err), ms=ms, plain_ms=plain_ms)


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
    early exit must not skip."""
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
    return cases


def check_k4_edge_cases(device) -> int:
    """Phase 10: every K4 edge case through rt_sweep on `device` (the
    kernel on a card, the twin on the CPU) and through the twin: hit and
    tri as expected, t equal bit for bit, any-hit equal to the hits, and
    the last-cluster bundle sweeping both clusters.  Returns the cases
    run."""
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
        if name == "winner in the last cluster":
            _, _, rays_, stream, lists, counts, t0q, _ = rt_sweep._prep(
                ot, dt, accel, accel["slot_ok"], None)
            swept = torch.zeros_like(counts)
            rt_sweep.rt_sweep(rays_, stream, lists, counts, t0q,
                              any_hit=False, face_mask=0, swept=swept)
            check(lists.cpu().tolist() == [[0, 1]] and swept.item() == 2,
                  f"last-cluster bundle: list {lists.cpu().tolist()}, "
                  f"swept {swept.item()}")
    return len(cases)


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
            kt, kg = rt_sweep.rt_sweep(*args, **kwargs, swept=swept)
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
            hits = int((kg > 0).sum() if kwargs["any_hit"]
                       else (kg < rt_sweep.NOTRI).sum())
            b = sweep_bound(args, (kt, kg), swept)
            log(f"phase 11 K4 {view} {cast} @{w}x{h}: {B} bundles x {R} "
                f"rays, {hits} hit; {n_pairs} listed (bundle, cluster) "
                f"pairs, {n_swept} cluster sweeps by the kernel (twin "
                f"{int(plain_swept.sum())}); tri/flag differs on {diff_g}, "
                f"t on {diff_t} rays (max abs err {err}); kernel "
                f"{ms:.3f} ms (median of "
                f"{KERNEL_RUNS}), plain {plain_ms:.3f} ms (median of "
                f"{RT_PLAIN_RUNS}); bound {b['bound_ms']:.4f} ms "
                f"({b['bound_by']}, {b['tests']:.4g} tests) [{card}]")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from softwarerenderer_tpu_torch import RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import Engine, render_frame
    from softwarerenderer_tpu_torch.engine import to_rgb8
    from softwarerenderer_tpu_torch.kernels import build
    from softwarerenderer_tpu_torch.models.scene import build_scene_buffers
    from softwarerenderer_tpu_torch.ops import rt_sweep, tile_raster
    from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR

    card = gpu_line()
    log(card)
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    # ---- phase 2: build the kernels from the checkout's sources ---------
    t0 = time.perf_counter()
    libs = build.build_all(["tile_raster", "tile_kdeep", "rt_sweep"])
    build_s = time.perf_counter() - t0
    log(f"phase 2 build: {', '.join(p.name for p in libs.values())} in "
        f"{build_s:.2f} s (one nvcc per source, in parallel)")
    for name in libs:
        report_ptxas(build.BUILD_LOG.get(name, (0, ""))[1])

    # ---- phase 3: kernel against plain on the main path's inputs --------
    params = RenderParams(W, H)
    eng = Engine(scenes.bench_scene(), params, device="cuda")
    u0 = scenes.camera_uniforms(eng.uniforms, 0)
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
    k1_bound = fold_bound(args, kwargs, (kg, kd, ki))
    log(f"phase 3 kernel vs plain @{W}x{H}: {n_cov} covered pixels "
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
        u = scenes.camera_uniforms(eng.uniforms, i)
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
        eng.scene, scenes.camera_uniforms(eng.uniforms, 0), params,
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

    # ---- phases 6-9: the K-buffer ---------------------------------------
    peel = check_peel_kernel(card, "cuda", (W, H))
    kdeep = check_kdeep_kernel(card, peel["dense_pass0"])
    kframes = check_kbuffer_frames(card, "cuda", (W, H), FRAMES)
    check_kbuffer_golden("cuda")

    # ---- phases 10-13: K4 and the ray-traced frame ----------------------
    n_cases = check_k4_edge_cases("cuda")
    log(f"phase 10 K4 edge cases ({n_cases}: ties, tri_mask, t = +0.0 and "
        f"-0.0, det under and over EPSILON, each face mask, NaN origins, "
        f"the winner in the last cluster): kernel and twin equal the "
        f"expected winners, t bit for bit")
    sweep = check_sweep_kernel(card, "cuda", (W, H))
    rt = check_raytraced_frames(card, "cuda", (W, H), FRAMES)
    check_bundle_vs_brute(card, "cuda", RT_BRUTE_SIZE)

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
              launches, dict(k1_bound, max_abs_err=max(gbuf_err, d_err),
                             ms=kernel_ms, plain_ms=plain_ms)),
        entry("tile_raster_peel", "tile_raster.cu", "ops/pallas_tile.py:96",
              kframes["peel_launches"], peel),
        entry("tile_kdeep", "tile_kdeep.cu", "ops/pallas_tile.py:649",
              kframes["kdeep_launches"], kdeep),
        entry("rt_sweep_nearest", "rt_sweep.cu", "ops/rt_pallas.py:59",
              rt["launches"]["nearest"], sweep["primary"]),
        entry("rt_sweep_any_hit", "rt_sweep.cu", "ops/rt_pallas.py:59",
              rt["launches"]["any_hit"], sweep["shadow"])]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
