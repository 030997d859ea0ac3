"""The port's demos that step a simulation or a process group, on the
CPU at their JAX demos' sizes: particle_fountain, ai_agents and
multichip_render write their JAX demos' files; ai_agents' crowd, built
and stepped as the demo does (``crowd_setup``, ``crowd_step``), holds the
JAX demo's crowd on the same seeds within tests/test_torch_sim.py's
bounds for its jitted agents step; multichip_render, a one-rank gloo
group, renders Engine.render's frame of its scene.  The file runs torch
on one thread."""

import importlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.examples import ai_agents, multichip_render
from softwarerenderer_tpu_torch.models.convert import (state_to_numpy,
                                                      state_to_torch)
from torch_examples_common import REPO, check_outputs, run_port_demo

jagents = importlib.import_module("softwarerenderer_tpu.sim.agents")
jchar = importlib.import_module("softwarerenderer_tpu.sim.character")
jray = importlib.import_module("softwarerenderer_tpu.sim.raycast")
from softwarerenderer_tpu.models import scene as jscene  # noqa: E402

# tests/test_torch_sim.py's bounds for one jitted JAX agents step.
JIT_RTOL = 1e-5
JIT_ATOL = 1e-6
CROWD_STEPS = 30


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs (tests/test_torch_dust2.py:
    many small ops, workers sharing the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["particle_fountain", "ai_agents",
                                  "multichip_render"])
def test_demo_writes_jax_demos_files(name, tmp_path, monkeypatch):
    check_outputs(name, str(tmp_path),
                  run_port_demo(name, str(tmp_path), monkeypatch))


def _jax_arena():
    """examples/ai_agents.py's arena(), from the JAX demo itself."""
    spec = importlib.util.spec_from_file_location(
        "jax_example_ai_agents", os.path.join(REPO, "examples",
                                              "ai_agents.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.arena(), mod.N_AGENTS


def assert_states(want, got, tag=""):
    """tests/test_torch_sim.py's comparison at its jitted-step bounds:
    float leaves within JIT_RTOL / JIT_ATOL, the rest equal."""
    for k, w in want.items():
        if isinstance(w, dict):
            assert_states(w, got[k], f"{tag}{k}.")
            continue
        w, g = np.asarray(w), np.asarray(got[k])
        assert w.shape == g.shape and w.dtype == g.dtype, tag + k
        if w.dtype == np.float32:
            np.testing.assert_allclose(g, w, rtol=JIT_RTOL, atol=JIT_ATOL,
                                       err_msg=tag + k)
        else:
            np.testing.assert_array_equal(w, g, err_msg=tag + k)


def test_ai_agents_crowd_holds_jax_demos_crowd():
    """The demo's arena, routing table and first state equal the JAX
    demo's (prng key 7 drawn as jax.random.PRNGKey(7)); then each of
    CROWD_STEPS steps, from JAX's state of the step before, within the
    jitted step's bounds, and the crowd fires."""
    insts, n = _jax_arena()
    sc = jscene.build_scene_buffers(insts)
    port_sc = jscene.build_scene_buffers(ai_agents.arena())
    for k in sc:
        np.testing.assert_array_equal(port_sc[k], sc[k], err_msg=k)
    n_static = len(insts) - n
    crowd = ai_agents.crowd_setup(port_sc, n_static, torch.device("cpu"))

    # The JAX demo's main, up to its step.
    world = jray.build_collision_world(sc)
    static_tris = np.asarray(sc["tri_mesh_id"]) < n_static
    wps = ai_agents.WAYPOINTS
    next_hop = jagents.build_waypoint_graph(world, wps, tri_mask=static_tris)
    np.testing.assert_array_equal(crowd["next_hop"].numpy(), next_hop)
    cp = jchar.default_character_params()
    br = jagents.default_brain_params()
    rngpos = np.random.default_rng(3)
    starts = np.stack([
        wps[i % len(wps)][:3] + np.asarray(
            [rngpos.uniform(-1, 1), 0.6, rngpos.uniform(-1, 1)], np.float32)
        for i in range(n)])
    js = jagents.initial_agents_state(starts, key=jax.random.PRNGKey(7),
                                      waypoint_idx=np.arange(n) % len(wps))
    ids = np.arange(n, dtype=np.int32)

    @jax.jit
    def step(s, dt):
        return jagents.agents_step(
            s, dt, wps, world, cp, br, tri_mask=static_tris,
            next_hop=next_hop, targets=s["char"]["position"],
            target_ids=ids, self_ids=ids)

    want = jax.device_get(js)
    assert_states(want, state_to_numpy(crowd["state"]), "state 0: ")
    fired = 0
    for i in range(CROWD_STEPS):
        ts = ai_agents.crowd_step(state_to_torch(want, "cpu"), crowd)
        js = step(js, ai_agents.DT)
        want = jax.device_get(js)
        assert_states(want, state_to_numpy(ts), f"step {i}: ")
        fired += int(np.asarray(want["fire"]).sum())
    assert fired > 0 and isinstance(js["key"], jnp.ndarray)


def test_multichip_render_is_engine_frame(tmp_path, monkeypatch):
    """The one-rank gloo group's sharded frame equals Engine.render's
    frame of the same scene on every RGB8 value, and the group is gone
    after main."""
    import torch.distributed as dist
    monkeypatch.setattr(multichip_render, "OUT",
                        str(tmp_path / "multichip.png"))
    got = multichip_render.main(device="cpu")
    assert not dist.is_initialized()
    sc, params, u = multichip_render.frame_inputs()
    want = Engine(sc, params, device="cpu").present(u)
    np.testing.assert_array_equal(got, want)
