"""On the card: one short run of each cell comes out correct, and the
bfloat16 control at the cell's own size comes out not correct.

    python3 -m pytest portbench/test_portbench_card.py -q

Skips without a CUDA card."""

import json
import os
import subprocess
import sys

import pytest

from portbench import control, harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", str(2 ** 33 + 5), "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_full_size(card, cell):
    limits = harness.cell_of(cell)["limits"]
    got = control.control_reading(cell, 2 ** 33 + 7)
    assert any(got[k] > limits[k] for k in harness.CHECKS), got
