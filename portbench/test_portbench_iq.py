"""The lodcrowd-iq-1080p configuration and its cell at a test's size, on
the CPU: the inputs are the seed's alone; the bfloat16 control and every
planted fault (portbench.control.FAULTS) read over the cell's limits; the
post chain's metrics read their spans, and read nothing on the sweep
cell."""

import numpy as np
import pytest
import torch

from portbench import control, harness

CELL = "lodcrowd-iq-1080p.pan"
SMALL = {"grid": 4, "width": 192, "height": 108,
         "textures": {"count": 2, "size": 64, "lattice": [4, 16, 32]},
         "sky": {"height": 32, "width": 64, "lattice": [4, 8]}}
SWEEP_SMALL = {"grid": 4, "width": 192, "height": 108}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tf32_restored():
    """The reference turns TF32 off for its whole process: give the two
    flags back to the tests that run after these in the same worker."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _arrays(inputs):
    return [inputs["offsets"], inputs["sky"]] + list(inputs["textures"])


def test_inputs_are_the_seeds():
    cfg = harness.cell_of(CELL)["module"]
    a, b = (cfg.make_inputs(2 ** 40 + 9, SMALL) for _ in range(2))
    other = cfg.make_inputs(2 ** 40 + 10, SMALL)
    assert all(np.array_equal(x, y) for x, y in zip(_arrays(a), _arrays(b)))
    assert not any(np.array_equal(x, y)
                   for x, y in zip(_arrays(a), _arrays(other)))
    assert len(a["textures"]) == 2 and a["textures"][0].dtype == np.uint8
    assert (a["textures"][0][..., 3] == 255).all()
    assert a["sky"].shape == (32, 64, 4)


def test_full_size_config():
    cfg = harness.cell_of(CELL)["module"]
    c = cfg.CONFIG
    assert (c["width"], c["height"], c["grid"]) == (1920, 1080, 32)
    assert c["textures"]["count"] == 11 and c["textures"]["size"] == 2048
    assert (c["sky"]["height"], c["sky"]["width"]) == (256, 512)
    assert c["reduced"] == [] and c["render_params"]["ssaa"] == 2
    ref = cfg.Reference(cfg.make_inputs(1, SMALL), "cpu")
    assert ref.k1_size() == (384, 216)


def test_bfloat16_control_fails():
    limits = harness.cell_of(CELL)["limits"]
    got = control.control_reading(CELL, 11, "cpu", SMALL)
    assert any(got[k] > limits[k] for k in harness.CHECKS), got


@pytest.mark.parametrize("fault", [None] + sorted(control.FAULTS))
def test_run_is_correct_only_when_sound(fault):
    r, frames = harness.run(CELL, 2 ** 35 + 7, 1.0, False, device="cpu",
                            over=SMALL, fault=control.FAULTS.get(fault))
    assert len(frames) == r["checks"]["frames_compared"]["value"] > 0
    assert r["correct"] is (fault is None), r["checks"]


def test_traced_run_reports_the_post_host_split():
    r, _ = harness.run(CELL, 2 ** 33 + 1, 0.0, True, device="cpu",
                       over=SMALL)
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert r["correct"] is True
    assert 0.0 < m["post_host_ms"] < m["host_issue_ms"] + m["sync_wait_ms"]


def test_post_gpu_ms_reads_the_post_spans():
    read = harness.metric("post_gpu_ms").read
    spans = {"post.sky": 1.0, "post.ssao": 2.0, "post.bloom": 0.5,
             "post.tonemap": 0.25, "post.fxaa": 0.125,
             "frame.ssaa_resolve": 0.0625, "tile.shade": 8.0}
    assert read({"span_kernel_ms": spans}, {}) == pytest.approx(3.9375)
    sweep = {k: (0.0 if k.startswith("post.") or k == "frame.ssaa_resolve"
                 else v) for k, v in spans.items()}
    assert read({"span_kernel_ms": sweep}, {}) is None


def _post_host_after(cell, over):
    from softwarerenderer_tpu_torch.utils import profiling
    c = harness.cell_of(cell)
    prog = c["module"].Program(c["module"].make_inputs(3, over), "cpu")
    profiling.reset_span_totals()
    try:
        with profiling.recording():
            prog.render(harness.camera_at(c["camera"], 0))
        return harness.metric("post_host_ms").read({}, {})
    finally:
        profiling.reset_span_totals()


def test_post_host_ms_reads_nothing_on_the_sweep_cell():
    assert _post_host_after("lodcrowd-4k.sweep", SWEEP_SMALL) is None
    assert _post_host_after(CELL, SMALL) > 0.0
