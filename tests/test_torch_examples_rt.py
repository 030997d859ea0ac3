"""The port's ray-traced demo (softwarerenderer_tpu_torch.examples.
raytraced) on the CPU at its JAX demo's size, 480x320 twice: it writes
the JAX demo's side-by-side image.  On the CPU its bundle casts go
through the sweep kernel's plain twin, which tests every listed cluster
against every ray (eight shadow samples a pixel): the demo alone is most
of this file's time, so it has a file of its own.  Torch runs on one
thread."""

import pytest
import torch

from torch_examples_common import check_outputs, run_port_demo


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (tests/test_torch_dust2.py:
    workers sharing the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_raytraced_writes_jax_demos_file(tmp_path, monkeypatch):
    """The side-by-side image: the raster half and the ray-traced half
    each cover the scene (neither is the clear colour everywhere)."""
    (img,) = check_outputs("raytraced", str(tmp_path),
                           run_port_demo("raytraced", str(tmp_path),
                                         monkeypatch))
    raster, rt = img[:, :480], img[:, 480:]
    for half in (raster, rt):
        assert (half != half[0, 0]).any(-1).mean() > 0.3
