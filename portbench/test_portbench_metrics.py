"""The metrics' arithmetic on synthetic inputs."""

import numpy as np
import pytest
import torch

from portbench import harness, tracesum
from portbench.reference import raster


def _window(done, entered, end):
    n = sum(1 for t in done if t <= end)
    return harness.window_stats({"counted": n, "done_ms": done,
                                 "entered_ms": entered, "end_ms": end})


def test_frame_rate_counts_frames_completed_in_the_window():
    done = [10.0 * (i + 1) for i in range(12)]          # 10 ms a frame
    s = _window(done, [d - 25.0 for d in done], 100.0)
    assert s["frames"] == 10
    assert harness.metric("frame_ms").read_window(s, {}) == 10.0
    assert harness.metric("latency_ms_p95").read_window(s, {}) == \
        pytest.approx(25.0)


def test_p95_moves_with_a_single_stall():
    """Over 20 intervals one stall is more than 5 % of them."""
    done = list(np.cumsum([10.0] * 21))
    stalled = list(np.cumsum([10.0] * 10 + [200.0] + [10.0] * 10))
    p95 = harness.metric("frame_ms_p95")
    a = p95.read_window(_window(done, [0.0] * 21, 1e9), {})
    b = p95.read_window(_window(stalled, [0.0] * 21, 1e9), {})
    assert a == pytest.approx(10.0)
    assert b > 15.0
    # a median of the same intervals does not move
    assert np.median(np.diff(stalled)) == 10.0


def _trace(kernels, dispatch, runtime=()):
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": t, "dur": d}
          for n, t, d in kernels]
    ev += [{"ph": "X", "cat": "user_annotation", "name": tracesum.DISPATCH,
            "ts": t, "dur": d} for t, d in dispatch]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": n, "ts": t, "dur": d}
           for n, t, d in runtime]
    return {"traceEvents": ev}


def test_idle_share_counts_overlapping_kernels_once():
    # window 0..100 us; kernels 10-50 and 30-60 overlap: 50 us busy
    tr = _trace([("a", 10, 40), ("b", 30, 30), ("c", 90, 10)],
                [(0, 5)], [("cudaLaunchKernel", 1, 1),
                           ("cudaStreamSynchronize", 2, 1)])
    s = tracesum.summarize(tr, 1, (), {"K1": "b"})
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(60e-6)
    assert harness.metric("device_idle_pct").read(s, {}) == \
        pytest.approx(40.0)
    assert s["kernel_ms"] == pytest.approx(0.08)
    assert s["kernel_ms_by_label"]["K1"] == pytest.approx(0.03)
    assert s["launches"] == 1 and s["syncs"] == 1
    assert sum(v for _, v in s["idle_gaps"]) == pytest.approx(40e-6)


def test_kernels_go_to_the_innermost_span():
    ev = _trace([("k", 20, 2), ("k", 60, 2)], [(0, 5)])["traceEvents"]
    ev += [{"ph": "X", "cat": "gpu_user_annotation", "name": n, "ts": t,
            "dur": d} for n, t, d in (("frame.geometry", 10, 80),
                                      ("tile.bin_pack", 55, 10))]
    s = tracesum.summarize({"traceEvents": ev}, 1,
                           ("frame.geometry", "tile.bin_pack"), {})
    assert s["span_kernel_ms"] == {"frame.geometry": pytest.approx(0.002),
                                   "tile.bin_pack": pytest.approx(0.002)}


def test_k1_count_on_a_hand_made_triangle():
    """A right triangle with legs of 8 pixels, drawn facing the camera,
    covers the pixel centres (x, y) with x + y <= 8 of its corner: 45."""
    w = h = 64
    cam = {"position": [0, 0, 0], "rotation": [0, 0, 0, 1],
           "fov_degrees": 90.0, "near_clip": 0.1, "far_clip": 100.0}
    # at depth 32 one world unit is one pixel (tan 45 = 1, 64 px high)
    z = -32.0
    px = [(16, 16), (24, 16), (16, 24)]            # screen corners
    pos = np.float32([[(x - 32), (32 - y), z] for x, y in px])
    mesh = {"position": pos, "normal": np.zeros((3, 3), np.float32),
            "color": np.ones((3, 4), np.float32),
            "uv": np.zeros((3, 2), np.float32),
            "indices": np.int32([[0, 2, 1]])}
    sc = raster.pack([{"mesh": mesh, "matrix": np.eye(4, dtype=np.float32)}],
                     "cpu", torch.float32)
    c = raster.counts(sc, cam, w, h)
    assert c["valid_slots"] == 1
    assert c["covered_pairs"] == 45 and c["covered_pixels"] == 45
    k1 = harness.metric("k1_roofline")
    ops = 45 * k1.TEST_OPS + 45 * k1.INTERP_OPS
    nbytes = k1.SLOT_FLOATS * 4 + w * h * 16 * 4
    assert k1.bound_s([c], (w, h), 16) == pytest.approx(
        max(ops / k1.PEAK_FLOPS, nbytes / k1.PEAK_BYTES))
    s = {"kernel_ms_by_label": {"K1": 1.0}, "frames": 1, "counts": [c],
         "k1_size": (w, h), "config": {"k1_gbuffer_channels": 16}}
    assert k1.read(s, {}) == pytest.approx(
        100.0 * k1.bound_s([c], (w, h), 16) / 1e-3)
    assert k1.read(dict(s, kernel_ms_by_label={}), {}) is None


def test_reservoir_is_seeded_and_bounded():
    a, b = (harness.Sample(torch, 4, 5, (2,)) for _ in range(2))
    for i in range(100):
        a.offer(i, torch.full((2,), i, dtype=torch.uint8))
        b.offer(i, torch.full((2,), i, dtype=torch.uint8))
    assert sorted(a.frames) == sorted(b.frames) and len(a.frames) == 4
    assert all((v == i).all() for i, v in a.frames.items())
    assert max(a.frames) > 10                     # later frames get in
