"""The benchmark's harness: one run of one cell.

A cell (``cells/<name>.json``) names its configuration
(``configs/<config>.json`` and ``configs/<config>.py``), its camera path,
its present depth, how many frames it checks and traces, and the limits
of its comparison.  The metrics are files of their own
(``metrics/<name>.py``), found by the names in ``BENCHMARK.json``.

A run: set-up (import the program, make the inputs from the seed, build
the program's engine, warm up on the cell's own path), then the window: ``Engine.render`` once a frame along the
path, each frame read back as a client presents it (``to_rgb8`` on the
device, a non-blocking copy into one of present_depth + 1 pinned buffers,
a CUDA event after the copy; before frame i the client waits for the
event of frame i - present_depth).  Frames still in flight when the
window closes are drained and not counted.  With ``--trace 1`` the
window is a profiled run of the cell's trace_frames frames instead, read
by the per-layer metrics.  Then the comparison: a sample of the window's
frames, drawn from the seed, against the plain reference
(``portbench/reference``), once the program's state is freed.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "softwarerenderer_tpu")
# The program's frame spans: each kernel goes to the innermost of these
# that holds it, and the metrics read their kernel time.
SPANS = ("frame.camera_cull", "frame.vertex_updates", "frame.geom_cap",
         "frame.geometry", "frame.extras", "frame.active_cap",
         "tile.bin_pack", "tile.fold", "tile.shade", "frame.ssaa_resolve",
         "post.sky", "post.ssao", "post.bloom", "post.tonemap", "post.fxaa",
         "post.callable")
# The program's own kernels, by a part of their names.
KERNELS = {"K1": "tile_raster_kernel"}


class Unavailable(RuntimeError):
    """The machine lacks what the cell needs: no result is printed."""


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _modname(kind: str, name: str) -> str:
    return f"portbench_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)


def benchmark() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_of(name: str) -> Dict:
    """The cell's file, with its configuration's module as "module"."""
    cell = load_json(os.path.join(HERE, "cells", f"{name}.json"))
    cell["name"] = name
    cell["module"] = load_module(
        os.path.join(HERE, "configs", f"{cell['config']}.py"),
        _modname("config", cell["config"]))
    return cell


def metric(name: str):
    return load_module(os.path.join(HERE, "metrics", f"{name}.py"),
                       _modname("metric", name))


def metrics_of(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The entries of BENCHMARK.json's `kind` list that this cell
    reports."""
    return [m for m in bench.get(kind, [])
            if "workloads" not in m or cell in m["workloads"]]


# --- the camera path -------------------------------------------------------

def path_index(cam: Dict, start: int, i: int) -> int:
    """k of frame i: a triangle wave 0 .. span .. 0 from `start`."""
    span = int(cam["k_span"])
    m = (start + i) % (2 * span)
    return m if m <= span else 2 * span - m


def camera_at(cam: Dict, k: int) -> Dict:
    """The camera at path position k: each of yaw, pitch and fov_degrees
    is base + step . k, the rest as the cell gives them."""
    from portbench import gen
    yaw = cam["yaw"][0] + cam["yaw"][1] * k
    pitch = cam["pitch"][0] + cam["pitch"][1] * k
    out = {"position": np.asarray(cam["position"], np.float32),
           "rotation": gen.quat_from_yaw_pitch(yaw, pitch),
           "fov_degrees": np.float32(cam["fov_degrees"][0]
                                     + cam["fov_degrees"][1] * k)}
    for key in ("near_clip", "far_clip", "fog_start", "fog_end"):
        out[key] = np.float32(cam[key])
    return out


def frame_uniforms(base: Dict, cam: Dict) -> Dict:
    """The program's frame uniforms: its defaults with the camera's
    pose, field of view, clip planes and fog."""
    u = dict(base, camera_position=cam["position"],
             camera_rotation=cam["rotation"])
    for k in ("fov_degrees", "near_clip", "far_clip", "fog_start",
              "fog_end"):
        u[k] = cam[k]
    return u


# --- the client's side: clock, present and sample ---------------------------

class Clock:
    """Frame completion on the card (CUDA events against one start
    event), or on the CPU (host time after the synchronous frame)."""

    def __init__(self, torch, cuda: bool):
        self.torch, self.cuda = torch, cuda

    def start(self):
        if self.cuda:
            self.torch.cuda.synchronize()
            self.t0_event = self.torch.cuda.Event(enable_timing=True)
            self.t0_event.record()
        self.t0 = time.perf_counter()

    def now_ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1e3

    def mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return self.now_ms()

    def wait(self, mark):
        if self.cuda:
            mark.synchronize()

    def drain(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def ms(self, mark) -> float:
        return self.t0_event.elapsed_time(mark) if self.cuda else mark


class Present:
    """The client's present_depth + 1 host buffers (pinned on the card)
    for frames of `shape`, made once at set-up."""

    def __init__(self, torch, shape, depth: int, cuda: bool):
        self.depth = depth
        self.bufs = [torch.zeros(shape, dtype=torch.uint8, pin_memory=cuda)
                     for _ in range(depth + 1)]


class Sample:
    """A reservoir of `k` frames drawn from the seed among those offered
    in order, copied into host buffers made (and touched) at set-up."""

    def __init__(self, torch, k: int, seed: int, shape):
        from portbench.gen import rng_of
        self.rng = rng_of(seed, 7)
        self.slots = [torch.zeros(shape, dtype=torch.uint8)
                      for _ in range(k)]
        self.index: List[Optional[int]] = [None] * k
        self.seen = 0

    def offer(self, index: int, rgb) -> None:
        j, k = self.seen, len(self.slots)
        self.seen += 1
        slot = j if j < k else int(self.rng.integers(0, j + 1))
        if slot < k:
            self.slots[slot].copy_(rgb)
            self.index[slot] = index

    @property
    def frames(self) -> Dict[int, np.ndarray]:
        return {i: s.numpy() for i, s in zip(self.index, self.slots)
                if i is not None}


def drive(torch, prog, cams: Callable[[int], Dict], present: Present,
          cuda: bool, seconds: Optional[float] = None,
          frames: Optional[int] = None, span: bool = False,
          sample: Optional[Sample] = None) -> Dict:
    """The pipelined frame loop, for `seconds` or for `frames` frames.
    Returns the frames dispatched, their host entry times and completion
    times (ms from the start), the window's end (ms), and the frames
    completed inside the window; offers those to `sample`."""
    ctx = torch.profiler.record_function if span else None
    clock = Clock(torch, cuda)
    depth, bufs = present.depth, present.bufs
    marks, entered = [], []
    clock.start()
    i = 0
    while True:
        if frames is not None and i >= frames:
            break
        if seconds is not None and clock.now_ms() >= seconds * 1e3:
            break
        if i >= depth:
            clock.wait(marks[i - depth])
            if sample is not None:
                sample.offer(i - depth, bufs[(i - depth) % (depth + 1)])
        entered.append(clock.now_ms())
        with (ctx("portbench.dispatch") if ctx else
              contextlib.nullcontext()):
            rgb = prog.to_rgb8(prog.render(cams(i)))
            bufs[i % (depth + 1)].copy_(rgb, non_blocking=cuda)
            marks.append(clock.mark())
        i += 1
    end = clock.now_ms()
    clock.drain()
    done = [clock.ms(m) for m in marks]
    n = sum(1 for t in done if t <= end)
    if sample is not None:
        for j in range(max(0, i - depth), n):
            sample.offer(j, bufs[j % (depth + 1)])
    return {"dispatched": i, "entered_ms": entered, "done_ms": done,
            "end_ms": end, "counted": n}


def window_stats(w: Dict) -> Dict:
    """The window's frame times: all frames completed inside it."""
    n = w["counted"]
    done = np.asarray(w["done_ms"][:n])
    lat = done - np.asarray(w["entered_ms"][:n])
    return {"frames": n, "window_ms": w["end_ms"],
            "frame_ms": w["end_ms"] / max(n, 1),
            "intervals_ms": np.diff(done).tolist(),
            "latency_ms": lat.tolist()}


# --- the comparison ----------------------------------------------------------

CHECKS = ("px_off_pct", "mean_abs")


def compare(got: np.ndarray, ref) -> Dict[str, float]:
    """px_off_pct: the share of pixels with a channel more than 2 levels
    off, in %; mean_abs: the mean absolute difference of the channels in
    levels of 255."""
    ref = ref.cpu().numpy() if hasattr(ref, "cpu") else np.asarray(ref)
    if got.shape != ref.shape:
        return {"px_off_pct": 100.0, "mean_abs": 255.0}
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    return {"px_off_pct": float((d.max(-1) > 2).mean() * 100.0),
            "mean_abs": float(d.mean())}


def check(ref, frames: Dict[int, np.ndarray], cam_of) -> Dict:
    """The worst of each number over the sampled frames, and the frames
    whose numbers pass the limits given later."""
    per = {i: compare(rgb, ref.frame(cam_of(i)))
           for i, rgb in sorted(frames.items())}
    worst = {k: max((p[k] for p in per.values()), default=float("inf"))
             for k in CHECKS}
    return {"worst": worst, "per_frame": per}


# --- one run -----------------------------------------------------------------

def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", chips: int = 1, over: Optional[Dict] = None,
        fault: Optional[Callable] = None):
    """One run of a cell; returns the result line's object and each
    compared frame's numbers.  device "cpu" runs the same steps on the
    host (the tests); over replaces configuration entries (the tests'
    small sizes); fault wraps the program (the tests' broken timed
    paths)."""
    took = {"start_s": process_age_s()}
    cuda = device == "cuda"
    base = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    import torch
    took["import_s"] = process_age_s() - took["start_s"]
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < chips):
        raise Unavailable(f"the cell needs {chips} CUDA device(s); "
                          f"{torch.cuda.device_count()} available")
    took["cuda_s"] = process_age_s() - took["start_s"] - took["import_s"]
    bench = benchmark()
    cell = cell_of(cell_name)
    cfg = cell["module"]
    t_in = time.perf_counter()
    inputs = cfg.make_inputs(seed, over)
    from portbench.gen import rng_of
    cam_spec = cell["camera"]
    start = int(rng_of(seed, 5).integers(0, 2 * int(cam_spec["k_span"])))

    def cam_of(i):
        return camera_at(cam_spec, path_index(cam_spec, start, i))

    took["inputs_s"] = time.perf_counter() - t_in
    t = time.perf_counter()
    prog = cfg.Program(inputs, device)
    if fault is not None:
        prog = fault(prog)
    took["program_s"] = time.perf_counter() - t
    t = time.perf_counter()
    # Warm-up: the cell's own shapes, on frames spread over its path
    # (both ends hold its extreme sizes); the present's and the
    # sample's buffers are made before the window.
    span, n_warm = int(cam_spec["k_span"]), int(cell["warmup_frames"])

    def warm_cam(i):
        return camera_at(cam_spec, round(i * span / max(1, n_warm - 1)))
    shape = tuple(prog.to_rgb8(prog.render(warm_cam(0))).shape)
    present = Present(torch, shape, int(cell["present_depth"]), cuda)
    sample = Sample(torch, int(cell["check_frames"]), seed, shape)
    drive(torch, prog, warm_cam, present, cuda, frames=n_warm)
    took["warmup_s"] = time.perf_counter() - t
    setup_s = process_age_s()

    if not trace:
        w = drive(torch, prog, cam_of, present, cuda, seconds=seconds,
                  sample=sample)
        stats = window_stats(w)
        stats["setup_s"] = setup_s
        values = {m["name"]: metric(m["name"]).read_window(stats, cell)
                  for m in metrics_of(bench, cell_name, "end_to_end")}
    else:
        n = int(cell["trace_frames"])
        path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")[1]
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            with torch.profiler.profile(activities=acts) as prof:
                w = drive(torch, prog, cam_of, present, cuda, frames=n,
                          span=True, sample=sample)
            prof.export_chrome_trace(path)
            from portbench import tracesum
            summary = tracesum.summarize(load_json(path), n, SPANS, KERNELS)
        finally:
            os.unlink(path)
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    mods = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if mods:
        raise RuntimeError(f"the process holds {mods} after the window")
    dispatched = w["dispatched"]
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = cfg.Reference(inputs, device)
    if trace:
        summary["counts"] = [ref.counts(cam_of(i)) for i in range(n)]
        summary["k1_size"] = ref.k1_size()
        summary["config"] = inputs["config"]
        values = {}
        for m in metrics_of(bench, cell_name, "per_layer"):
            v = metric(m["name"]).read(summary, cell)
            if v is not None:
                values[m["name"]] = v
    judged = check(ref, sample.frames, cam_of)
    took["reference_s"] = time.perf_counter() - t
    limits = cell["limits"]
    # Every frame completed in the window, up to check_frames of them.
    due = min(int(cell["check_frames"]), w["counted"])
    ok = due > 0 and len(judged["per_frame"]) == due and all(
        judged["worst"][k] <= limits[k] for k in CHECKS)
    failed = sum(1 for p in judged["per_frame"].values()
                 if any(p[k] > limits[k] for k in CHECKS))
    units = {m["name"]: m["unit"] for k in ("end_to_end", "per_layer")
             for m in bench.get(k, [])}
    result = {"correct": ok, "attempted": dispatched, "failed": failed,
              "metrics": {k: {"value": v, "unit": units.get(k, "")}
                          for k, v in values.items()},
              "device": device_info(torch, cuda, chips, peak)}
    if trace:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {
        **{f"{k}_worst": {"value": judged["worst"][k], "limit": limits[k]}
           for k in CHECKS},
        "frames_compared": {"value": len(judged["per_frame"]),
                            "limit": due}}
    print("portbench: seconds " + ", ".join(
        f"{k} {v:.3f}" for k, v in took.items()) + f", setup_s {setup_s:.3f}",
        file=sys.stderr)
    return result, judged["per_frame"]


def device_info(torch, cuda: bool, chips: int, peak: int) -> Dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": peak}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info
