"""Reduction of a torch.profiler Chrome trace to what the per-layer
metrics read.

The attribution of kernels to spans is a frozen copy of the program's
``utils/profiling.trace_summary``: each kernel goes to the innermost GPU
span (``gpu_user_annotation``) whose interval holds the kernel's
midpoint.  Added here: the harness's own host span around each frame's
calls (``portbench.dispatch``), the runtime calls counted inside it, the
union of device intervals over the traced window (so overlapping kernels
count once), the window itself, the longest kernels by name and the idle
gaps by what the host was doing.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

DISPATCH = "portbench.dispatch"
# Device activity: kernels, copies and fills on the card.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals: List[Tuple[float, float]]):
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _inside(t: float, spans: List[Tuple[float, float, str]]) -> List:
    return [(hi - lo, name) for lo, hi, name in spans if lo <= t <= hi]


def _label_gaps(gaps, host_spans, runtime):
    """(label, us) of each idle gap: the innermost host span and the
    runtime call under way at the gap's midpoint ("-" and "python" where
    none)."""
    gaps = [(lo, hi) for lo, hi in gaps if hi > lo]
    if not gaps:
        return []
    t = np.asarray([(lo + hi) / 2 for lo, hi in gaps])
    out_span = ["-"] * len(gaps)
    if host_spans:
        lo = np.asarray([s[0] for s in host_spans])
        hi = np.asarray([s[1] for s in host_spans])
        inside = (lo[None] <= t[:, None]) & (hi[None] >= t[:, None])
        dur = np.where(inside, (hi - lo)[None], np.inf)
        best = dur.argmin(1)
        out_span = [host_spans[b][2] if inside[g, b] else "-"
                    for g, b in enumerate(best)]
    out_call = ["python"] * len(gaps)
    if runtime:
        rt = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in runtime)
        starts = np.asarray([r[0] for r in rt])
        j = np.searchsorted(starts, t, "right") - 1
        out_call = [rt[k][2] if k >= 0 and rt[k][1] >= tt else "python"
                    for k, tt in zip(j, t)]
    return [(f"{s} / {c}", hi - lo) for s, c, (lo, hi)
            in zip(out_span, out_call, gaps)]


def summarize(trace: Dict, frames: int, spans: Tuple[str, ...],
              kernel_names: Dict[str, str]) -> Dict:
    """Per-frame numbers of a trace of `frames` frames.

    spans: the program's span names whose kernel time is reported;
    kernel_names: label -> substring of a kernel's name, whose kernel time
    is reported by label (a kernel of the program's own)."""
    ev = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    kernels = [e for e in ev if e.get("cat") == "kernel"]
    device = [e for e in ev if e.get("cat") in DEVICE_CATS]
    gpu_spans, host_spans, dispatch = [], [], []
    for e in ev:
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if e.get("cat") == "gpu_user_annotation" and e["name"] in spans:
            gpu_spans.append((lo, hi, e["name"]))
        elif e.get("cat") == "user_annotation":
            host_spans.append((lo, hi, e["name"]))
            if e["name"] == DISPATCH:
                dispatch.append((lo, hi))
    by_span = {s: 0.0 for s in spans}
    for k in kernels:
        inside = _inside(k["ts"] + k["dur"] / 2, gpu_spans)
        if inside:
            by_span[min(inside)[1]] += k["dur"]
    by_label = {lab: sum(k["dur"] for k in kernels if sub in k["name"])
                for lab, sub in kernel_names.items()}
    runtime = [e for e in ev if e.get("cat") in ("cuda_runtime",
                                                 "cuda_driver")]

    def in_dispatch(e):
        return any(lo <= e["ts"] <= hi for lo, hi in dispatch)
    launches = sum(1 for e in runtime if ("LaunchKernel" in e["name"]
                                          or e["name"] == "cuLaunchKernel")
                   and in_dispatch(e))
    syncs = sum(1 for e in runtime if "Synchronize" in e["name"]
                and in_dispatch(e))

    # The window: from the second frame's dispatch (the first one's host
    # work runs before the card has anything queued) to the last device
    # activity; busy: the union of device intervals inside it.
    busy_us, window_us, gaps = 0.0, 0.0, []
    if dispatch and device:
        w0 = sorted(lo for lo, _ in dispatch)[min(1, len(dispatch) - 1)]
        w1 = max(e["ts"] + e["dur"] for e in device)
        merged = _union([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                         for e in device if e["ts"] + e["dur"] > w0])
        busy_us = sum(hi - lo for lo, hi in merged)
        window_us = w1 - w0
        edges = [w0] + [x for iv in merged for x in iv] + [w1]
        gaps = _label_gaps(list(zip(edges[0::2], edges[1::2])), host_spans,
                           runtime)
    per_name: Dict[str, float] = {}
    for k in kernels:
        per_name[k["name"]] = per_name.get(k["name"], 0.0) + k["dur"]
    per_gap: Dict[str, float] = {}
    for name, dur in gaps:
        per_gap[name] = per_gap.get(name, 0.0) + dur
    per = 1e-3 / frames
    host_ms = sum(hi - lo for lo, hi in dispatch) * per
    return {
        "frames": frames,
        "span_kernel_ms": {s: v * per for s, v in by_span.items()},
        "kernel_ms_by_label": {k: v * per for k, v in by_label.items()},
        "kernel_ms": sum(k["dur"] for k in kernels) * per,
        "launches": launches / frames,
        "syncs": syncs / frames,
        "dispatch_ms": host_ms,
        "busy_s": busy_us * 1e-6,
        "window_s": window_us * 1e-6,
        "device_ops": sorted(([n[:120], v * 1e-6] for n, v in
                              per_name.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([n[:120], v * 1e-6] for n, v in
                             per_gap.items()), key=lambda x: -x[1])[:10],
    }
