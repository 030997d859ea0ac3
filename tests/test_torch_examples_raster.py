"""The port's raster demos (softwarerenderer_tpu_torch.examples) on the
CPU, each at its JAX demo's size: every one writes its JAX demo's files
(the same names, non-empty images of the same shapes, the AVI's frame
count) and returns what it wrote.  Three of them, the cheapest for JAX to
compile, are held against the images of the JAX demo's own main(), run
in the same test, by tests/test_goldens.py's rule: under 0.2 % of pixels
off by more than 2/255.  The file runs torch on one thread."""

import importlib

import pytest
import torch

from softwarerenderer_tpu_torch.examples import DEMOS as ALL_DEMOS
from torch_examples_common import (check_outputs, redirect, run_jax_demo,
                                   run_port_demo, share_off)

GOLDEN_OFF_MAX = 2e-3
DEMOS = ("spinning_cube", "custom_shader", "translucency_kbuffer",
         "shadowed_scene", "point_light_shadows", "pbr_materials",
         "sky_environment", "normal_mapping", "mesh_lod", "morph_targets",
         "skeletal_animation", "skinned_crowd", "render_to_texture",
         "split_screen", "showcase")
AGAINST_JAX = ("spinning_cube", "translucency_kbuffer", "shadowed_scene")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: the demos' frames are
    many small ops, which torch's default pool slows down when the
    suite's workers share the cores (tests/test_torch_dust2.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", DEMOS)
def test_demo_writes_jax_demos_files(name, tmp_path, monkeypatch):
    """The demo runs on the CPU and writes what its JAX demo writes; the
    three of AGAINST_JAX also match the JAX demo's images."""
    port_dir = tmp_path / "port"
    port_dir.mkdir()
    got = check_outputs(name, str(port_dir),
                        run_port_demo(name, str(port_dir), monkeypatch))
    if name not in AGAINST_JAX:
        return
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    run_jax_demo(name, str(jax_dir), monkeypatch)
    want = check_outputs(name, str(jax_dir))
    for i, (g, w) in enumerate(zip(got, want)):
        off = share_off(g, w)
        assert off < GOLDEN_OFF_MAX, (name, i, off)


@pytest.mark.parametrize("name", ALL_DEMOS)
def test_demo_raises_without_a_card(name, tmp_path, monkeypatch):
    """main(device="cuda") (the default) raises where there is no card,
    before it writes anything: no demo renders on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(
        f"softwarerenderer_tpu_torch.examples.{name}")
    monkeypatch.chdir(tmp_path)
    if hasattr(mod, "OUT"):         # restored after the test
        monkeypatch.setattr(mod, "OUT", mod.OUT)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(**redirect(mod, str(tmp_path)))
    assert not list(tmp_path.iterdir())
