"""A whole run of each cell on the CPU at a tiny size, past the look for
a card: sound it comes out correct, and with the timed path broken
underneath (portbench.control.FAULTS: a render that returns its first
frame again, half of each frame left out, every frame altered where it
is produced) it comes out not correct."""

import pytest
import torch

from portbench import control, harness

SMALL = {"lodcrowd-4k.sweep": {"grid": 4, "width": 192, "height": 108}}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("fault", [None] + sorted(control.FAULTS))
def test_run_is_correct_only_when_sound(cell, fault):
    r, frames = harness.run(cell, 2 ** 35 + 1, 1.5, False, device="cpu",
                            over=SMALL[cell],
                            fault=control.FAULTS.get(fault))
    assert list(r)[-1] == "checks"
    assert len(frames) == r["checks"]["frames_compared"]["value"] > 0
    assert r["correct"] is (fault is None), r["checks"]


def test_traced_run_reports_its_metrics():
    r, _ = harness.run("lodcrowd-4k.sweep", 3, 0.0, True,
                       device="cpu", over=SMALL["lodcrowd-4k.sweep"])
    assert r["correct"] is True
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "dispatch_ms" in r["metrics"]
