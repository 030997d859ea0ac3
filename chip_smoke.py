#!/usr/bin/env python3
"""Smoke run of softwarerenderer_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA tile kernel from csrc/, holds it against its plain PyTorch
twin at 1080p on the bench scene, renders 30 frames of the main path
(``Engine(scene, RenderParams(1920, 1080), device="cuda")``) and checks that
every frame went through the kernel, that the output is finite and matches
the plain path, and that golden configs 1 and 2 still match their PNGs.
Any failed check raises and exits non-zero.  The last three lines of
standard output are the card's name and power limit, a JSON line with the
kernel's numbers, and ``{"ok": true, "device": {...}}``.

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

    # ---- phase 2: build the kernel from the checkout's sources ----------
    t0 = time.perf_counter()
    lib = build.build("tile_raster")
    build_s = time.perf_counter() - t0
    log(f"phase 2 build: {lib.name} in {build_s:.2f} s")
    for line in build.BUILD_LOG.get("tile_raster", (0, ""))[1].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

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

    log(card)
    log(json.dumps({"kernels": [{
        "name": "tile_raster", "route": "cuda",
        "source": "softwarerenderer_tpu_torch/csrc/tile_raster.cu",
        "replaces": "softwarerenderer_tpu/ops/pallas_tile.py:96",
        "launches": launches, "max_abs_err": max(gbuf_err, d_err),
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
