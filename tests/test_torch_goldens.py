"""The port renders golden configs 1 and 2 (tests/goldens/) within the
rule of tests/test_goldens.py, through its CPU path."""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")


def render_golden_torch(n):
    """scripts/make_goldens.render_golden(n) through the port's Engine."""
    import bench
    from scripts.make_goldens import GOLDEN_SIZES
    from softwarerenderer_tpu.models import scene as scene_mod
    from softwarerenderer_tpu_torch import RenderParams
    from softwarerenderer_tpu_torch.engine import Engine

    w, h = GOLDEN_SIZES[n]
    insts, _, _, ufn, ekw = bench.config_workload(n)
    assert ufn is None and not ekw       # the default shaders and uniforms
    eng = Engine(scene_mod.build_scene_buffers(insts),
                 RenderParams(width=w, height=h), device="cpu")
    return eng.present(dict(eng.uniforms))


@pytest.mark.parametrize("n", [1, 2])
def test_golden_config_torch(n):
    from PIL import Image
    golden = np.asarray(Image.open(os.path.join(GOLDEN_DIR,
                                                f"config{n}.png")))
    got = render_golden_torch(n)
    assert got.shape == golden.shape
    diff = np.abs(got.astype(np.int32) - golden.astype(np.int32))
    frac_off = float(np.mean(np.any(diff > 2, axis=-1)))
    assert frac_off < 2e-3, f"config{n}: {frac_off:.4%} pixels off by >2"
    assert float(np.mean(diff)) < 0.5
