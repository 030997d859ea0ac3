"""The port's host spans and the JAX module's timing helpers.

The program's spans are ``span`` objects (``with span("frame.geometry")``
or ``@span("sim.agents")``).  Off, a span reads one flag and does nothing
else.  While the torch profiler runs (``trace(dir)`` or any
``torch.profiler.profile``) a span is a ``record_function`` on the
trace's clock; while the profiler runs or inside ``recording()`` it adds
its calls, host time and self time (host time less that of the spans
opened inside it) to ``span_totals()``, which ``reset_span_totals()``
clears.  ``engine.render`` holds one frame of ``Engine.render``; each
``sync.<what>`` span holds a place where the host waits for the card (a
pageable copy to it, or a read of a device value).

The JAX module's public names, on torch: ``FrameStats``, the game's
rolling frame counters (host only); ``trace`` (a torch.profiler trace
written as Chrome JSON) and ``annotate`` (``span``); ``hard_sync`` (one
data-dependent scalar read that waits for every queued launch, with a
watchdog that raises ``DeviceSyncTimeout``); ``timed_frames`` (pipelined
frames timed between two hard syncs); ``arm_watchdog`` / ``watchdog`` (a
thread dump and ``os._exit`` when a stage overruns).

This module imports nothing of the package: every layer imports it.
"""

from __future__ import annotations

import collections
import contextlib
import faulthandler
import functools
import os
import sys
import threading
import time
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


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
