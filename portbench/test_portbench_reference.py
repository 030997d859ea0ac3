"""The plain reference against the program on a tiny scene of each
configuration, on the CPU (the program's plain twins), and the control:
the reference in bfloat16 must fail the cell's limits."""

import pytest
import torch

from portbench import control, harness

# Tiny sizes of each configuration, and a camera of each path.
SMALL = {"lodcrowd-4k.sweep": {"grid": 5, "width": 256, "height": 144}}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("k", [0, 37])
def test_reference_matches_the_program(cell, k):
    c = harness.cell_of(cell)
    cfg = c["module"]
    inputs = cfg.make_inputs(2 ** 40 + 3, SMALL[cell])
    cam = harness.camera_at(c["camera"], k)
    got = cfg.Program(inputs, "cpu")
    rgb = got.to_rgb8(got.render(cam)).numpy()
    ref = cfg.Reference(inputs, "cpu").frame(cam)
    d = harness.compare(rgb, ref)
    assert d["px_off_pct"] <= c["limits"]["px_off_pct"]
    assert d["mean_abs"] <= c["limits"]["mean_abs"]
    assert (rgb != 127).any()                     # something was drawn


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_bfloat16_control_fails(cell):
    c = harness.cell_of(cell)
    got = control.control_reading(cell, 11, "cpu", SMALL[cell])
    assert any(got[k] > c["limits"][k] for k in harness.CHECKS), got

