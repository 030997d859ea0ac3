"""The port's host spans (utils/profiling.span) on the CPU: off they keep
nothing, under torch.profiler they are the trace's user annotations and
add to span_totals(), a parent's self time leaves out its children's, and
the profiler flag they read follows the profiler; the module imports
nothing of the package.  Also the card test's search for unnamed waits,
on a synthetic trace."""

import ast
import json
import time

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler

from softwarerenderer_tpu_torch.config import RenderParams
from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.models import primitives
from softwarerenderer_tpu_torch.models.scene import (MeshInstance,
                                                     build_scene_buffers)
from softwarerenderer_tpu_torch.utils import profiling
from softwarerenderer_tpu_torch.utils.profiling import span
from tests.test_torch_sync_spans import unnamed_waits

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def clean_totals():
    profiling.reset_span_totals()
    yield
    profiling.reset_span_totals()


@pytest.fixture(scope="module")
def engine():
    scene = build_scene_buffers([MeshInstance(
        primitives.cube(1.0), np.asarray(
            [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, -3, 1]],
            np.float32))])
    return Engine(scene, RenderParams(64, 48), device="cpu")


def test_profiler_flag_follows_the_profiler():
    """span() reads this private flag: a torch without it, or one where it
    no longer follows the profiler, must fail here, not lose every
    span."""
    assert autograd_profiler._is_profiler_enabled is False
    with torch.profiler.profile(activities=CPU):
        assert autograd_profiler._is_profiler_enabled is True
    assert autograd_profiler._is_profiler_enabled is False


def test_off_records_nothing(engine):
    with span("test.off"):
        pass
    engine.render()
    assert profiling.span_totals() == {}


def test_frame_spans_in_trace_and_totals(engine, tmp_path):
    with torch.profiler.profile(activities=CPU) as prof:
        for _ in range(2):
            engine.render()
    totals = profiling.span_totals()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    names = {e["name"] for e in ev if e.get("cat") == "user_annotation"}
    assert names == set(totals)
    assert {"engine.render", "sync.uniforms", "frame.camera_cull",
            "frame.geometry", "tile.fold"} <= names
    assert totals["engine.render"]["calls"] == 2
    for v in totals.values():
        assert 0.0 <= v["self_ms"] <= v["host_ms"]
    inner = sum(v["host_ms"] for k, v in totals.items()
                if k.startswith(("frame.", "tile.")))
    assert totals["engine.render"]["self_ms"] <= (
        totals["engine.render"]["host_ms"] - inner + 1e-6)


def test_child_time_leaves_parent_self_time():
    with profiling.recording():
        with span("test.parent"):
            time.sleep(0.01)
            with span("test.child"):
                time.sleep(0.03)
    t = profiling.span_totals()
    parent, child = t["test.parent"], t["test.child"]
    assert child["self_ms"] == child["host_ms"] >= 30.0
    assert parent["host_ms"] >= parent["self_ms"] + child["host_ms"] - 1e-6
    assert 10.0 <= parent["self_ms"] < 30.0


def test_decorator_recording_and_reset():
    @span("test.decorated")
    def twice(x):
        """Doubles x."""
        return 2 * x

    assert twice.__name__ == "twice" and twice.__doc__ == "Doubles x."
    assert twice(3) == 6
    assert profiling.span_totals() == {}
    with profiling.recording():
        with profiling.recording():
            twice(1)
        twice(2)
    twice(4)
    assert profiling.span_totals()["test.decorated"]["calls"] == 2
    profiling.reset_span_totals()
    assert profiling.span_totals() == {}


def test_annotate_is_span():
    assert profiling.annotate is span


def test_profiling_imports_nothing_of_the_package():
    """utils/profiling is the bottom layer: every layer imports it, so it
    imports no module of the package (at module level or inside a
    function) and runs nothing as a script."""
    with open(profiling.__file__) as f:
        tree = ast.parse(f.read())
    pkg = "softwarerenderer_tpu_torch"
    named = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            named += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            named.append("." * node.level + (node.module or ""))
    assert named and not [m for m in named if m.startswith(".")
                          or m == pkg or m.startswith(pkg + ".")], named
    mains = [node for node in ast.walk(tree) if isinstance(node, ast.Compare)
             and any(isinstance(c, ast.Constant) and c.value == "__main__"
                     for c in node.comparators)]
    assert not mains


def _x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def test_unnamed_waits_finds_waits_outside_sync_spans():
    ev = [_x("user_annotation", "engine.render", 0, 100),
          _x("user_annotation", "frame.camera_cull", 0, 40),
          _x("user_annotation", "sync.uniforms", 5, 10),
          _x("cuda_runtime", "cudaStreamSynchronize", 8, 2),
          _x("cuda_runtime", "cudaStreamSynchronize", 30, 2),
          _x("cuda_runtime", "cudaMemcpy", 60, 2),
          _x("cuda_runtime", "cudaMemcpyAsync", 70, 2),
          _x("cuda_runtime", "cudaLaunchKernel", 80, 2),
          # outside the frame, and a wait of another thread
          _x("cuda_runtime", "cudaStreamSynchronize", 150, 2),
          _x("user_annotation", "sync.other", 0, 100, tid=2),
          _x("cuda_runtime", "cudaDeviceSynchronize", 50, 1, tid=2)]
    found = unnamed_waits({"traceEvents": ev})
    assert found["waits"] == 3
    assert found["unnamed"] == [("cudaStreamSynchronize",
                                 "frame.camera_cull"),
                                ("cudaMemcpy", "engine.render")]
