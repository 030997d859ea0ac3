"""What the ray-bundle sweep (K4) has to do on one ray-traced frame, counted.

    python -m softwarerenderer_tpu_torch.utils.sweep_study [--width W]
        [--height H] [--cap CAP] [--device cuda|cpu] [--out DIR]

Renders the bench scene's ray-traced frame with hard shadows from two
cameras (the bench view, ``scenes.camera_uniforms(u, 0)``, and the default
camera at the origin), catches the inputs of both K4 casts (primary:
nearest; shadow: any-hit) and counts, with the plain twin on the same
inputs and no timing:

  * the histogram of clusters listed and of clusters swept per bundle (swept:
    before every ray of the bundle is done by the kernel's own early-exit
    rule);
  * for each way of dealing a bundle's 1,024 rays to parts (a warp's four
    rows interleaved 8 apart, as the first kernel dealt them; four adjacent
    rows; two adjacent rows; one row), over every (part, swept cluster):
    the share in which no ray of the part passes any slot (what skipping
    by part can save at most), and how many are left to test after each
    rule a part can apply by itself: stop once all its rays are done; skip
    a cluster its rays' bounds cannot reach (``rt_accel``'s slab test on
    the part's own bounds); skip a cluster it cannot enter before every
    ray's best hit (best t times 64 below the part's entry time quantized
    x64 with floor, the early exit's rule).  A rule that would drop a sweep in which a ray passes
    (for the first and the last rule: in which a ray's result would
    change) is counted as ``wrong``: it must be 0.

Prints one JSON object; with --out also writes it to DIR/sweep_study.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import torch

BIG = torch.finfo(torch.float32).max

# name -> rays per part; "interleaved" deals rows w, w+8, w+16, w+24 of the
# 32x32 bundle to part w.
LAYOUTS = (("interleaved rows, 128 rays", 128, True),
           ("4 adjacent rows, 128 rays", 128, False),
           ("2 adjacent rows, 64 rays", 64, False),
           ("1 row, 32 rays", 32, False))


def capture_casts(eng, uniforms, params, cap):
    """[(args, kwargs)] of the frame's K4 casts and the accel they ran on."""
    from softwarerenderer_tpu_torch.ops import rt_sweep
    from softwarerenderer_tpu_torch.ops.raytrace import render_frame_raytraced
    calls, accels = [], []
    build = rt_sweep.build_rt_accel_pl

    def build_and_keep(world):
        accels.append(build(world))
        return accels[-1]

    def sweep(*args, **kwargs):
        calls.append((args, kwargs))
        return rt_sweep.rt_sweep(*args, **kwargs)

    rt_sweep.build_rt_accel_pl = build_and_keep
    try:
        render_frame_raytraced(eng.scene, uniforms, params, cluster_cap=cap,
                               sweep=sweep)
    finally:
        rt_sweep.build_rt_accel_pl = build
    return calls, accels[0]


def cluster_best_t(args, kwargs, swept):
    """(B, J, R) f32: each ray's nearest passing t in the j-th cluster its
    bundle swept (float max where none passes, and past swept[b]), by the
    plain twin on one (bundle, cluster) pair at a time."""
    from softwarerenderer_tpu_torch.ops import rt_sweep
    rays, stream, lists, counts, t0q = args
    B, _, R = rays.shape
    J = max(1, int(swept.max()))
    dev = rays.device
    mask = torch.arange(J, device=dev)[None] < swept[:, None]
    pb, pj = torch.nonzero(mask, as_tuple=True)
    out = torch.full((B, J, R), BIG, device=dev)
    for c0 in range(0, pb.numel(), 2048):
        b, j = pb[c0:c0 + 2048], pj[c0:c0 + 2048]
        one = lists[b, j][:, None].contiguous()
        t, _ = rt_sweep.rt_sweep_plain(
            rays[b], stream, one, torch.ones_like(b, dtype=torch.int32),
            torch.zeros_like(one), any_hit=False,
            face_mask=kwargs["face_mask"])
        out[b, j] = t
    return out, mask


def study_cast(args, kwargs, accel) -> Dict:
    from softwarerenderer_tpu_torch.ops import rt_accel, rt_sweep
    rays, stream, lists, counts, t0q = args
    B, _, R = rays.shape
    if R != rt_sweep.GROUP_RAYS:
        raise ValueError(f"the study deals {rt_sweep.GROUP_RAYS} rays a "
                         f"bundle, got {R}")
    dev = rays.device
    any_hit = kwargs["any_hit"]
    swept = torch.zeros_like(counts)
    rt_sweep.rt_sweep(*args, **kwargs, swept=swept)
    tj, mask = cluster_best_t(args, kwargs, swept)
    J = tj.shape[1]
    passes = tj < BIG                                        # (B, J, R)
    first = torch.full((B, 1, R), BIG, device=dev)
    before = torch.cat([first, torch.cummin(tj, 1).values[:, :-1]], 1)
    if any_hit:
        done = before < BIG
    else:
        done = before * 64.0 < t0q[:, :J, None].to(torch.float32)
    nc = stream.shape[1] // rt_sweep.GROUP
    boxes = {"cl_lo": accel["cl_lo"], "cl_hi": accel["cl_hi"],
             "n_clusters": nc, "group": rt_sweep.GROUP}
    o = rays[:, 0:3].transpose(1, 2)
    d = rays[:, 3:6].transpose(1, 2)
    r = torch.arange(R, device=dev)
    out = {"mode": "any_hit" if any_hit else "nearest", "bundles": B,
           "clusters": nc, "listed_pairs": int(counts.sum()),
           "swept_clusters": int(swept.sum()),
           "bundles_listing_none": int((counts == 0).sum()),
           "listed_per_bundle_histogram":
               torch.bincount(counts.long()).tolist(),
           "swept_per_bundle_histogram":
               torch.bincount(swept.long()).tolist(),
           "layouts": {}}
    for name, per, interleaved in LAYOUTS:
        P = R // per
        part = ((r % 256) // 32) if interleaved else r // per
        perm = torch.argsort(part, stable=True)

        def parts(x):                       # (B, J, R) -> (B, J, P, per)
            return x[..., perm].reshape(B, J, P, per)

        total = int(mask.sum()) * P
        pass_part = parts(passes).any(-1) & mask[..., None]
        # A ray's result changes where it passes and betters or ties its
        # best so far (nearest) or was clear so far (any-hit).
        changes = parts(passes & ~done if any_hit
                        else passes & (tj <= before)).any(-1)
        left = mask[..., None] & ~parts(done).all(-1)
        wrong_done = int((changes & mask[..., None] & ~left).sum())
        after_done = int(left.sum())
        alive, t0w = rt_accel._bundles_alive_entry(
            o[:, perm].reshape(B * P, per, 3),
            d[:, perm].reshape(B * P, per, 3), boxes, stream[10] > 0)
        at = lists[:, :J].long()[:, None, :].expand(B, P, J)
        alive_at = alive.reshape(B, P, nc).gather(2, at).transpose(1, 2)
        t0w_at = t0w.reshape(B, P, nc).gather(2, at).transpose(1, 2)
        wrong_slab = int((pass_part & ~alive_at).sum())
        left = left & alive_at
        after_slab = int(left.sum())
        row = {"parts": P, "part_sweeps": total,
               "no_ray_passes": total - int(pass_part.sum()),
               "left_after_part_done": after_done, "wrong_done": wrong_done,
               "left_after_slab": after_slab, "wrong_slab": wrong_slab}
        if not any_hit:
            behind = (parts(before) * 64.0
                      < torch.floor(t0w_at * 64.0)[..., None]).all(-1)
            row["wrong_entry"] = int((changes & behind & left).sum())
            left = left & ~behind
            row["left_after_entry"] = int(left.sum())
        row["left_that_pass"] = int((left & pass_part).sum())
        out["layouts"][name] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--cap", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("sweep_study: no CUDA device", file=sys.stderr)
        return 1
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.config import RenderParams
    from softwarerenderer_tpu_torch.engine import Engine
    params = RenderParams(a.width, a.height)
    eng = Engine(scenes.bench_scene(), params, device=a.device)
    result = {"size": [a.width, a.height], "cluster_cap": a.cap,
              "device": torch.cuda.get_device_name(0)
              if a.device == "cuda" else "cpu", "views": {}}
    views = {"bench view": scenes.camera_uniforms(eng.uniforms, 0),
             "origin": dict(eng.uniforms)}
    for view, u in views.items():
        calls, accel = capture_casts(eng, u, params, a.cap)
        result["views"][view] = {
            cast: study_cast(args, kwargs, accel)
            for (args, kwargs), cast in zip(calls, ("primary", "shadow"))}
    text = json.dumps(result, indent=1)
    if a.out:
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out, "sweep_study.json"), "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
