"""The port's simulation (sim.character, sim.particles, sim.agents, the
waypoint helpers, utils.checkpoint) held against the JAX package's on
the CPU, from the same states (models.convert.state_to_torch).

Run op by op (jax.disable_jit) the JAX steps compute what the port does
operation for operation, so the character's states are held equal on
every value: roots correctly rounded on both sides (ml.sqrt_rn), sums
left to right, the same draws (sim.prng).  Jitted, XLA contracts
multiply-adds, so a jitted step from the same state is held at a
tolerance; the agents' step is held so, as JAX takes tens of seconds a
step for it op by op on the CPU.  The particles' normal draws are held
at prng's bound.  Each tolerance is stated beside its measured value."""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softwarerenderer_tpu.models import primitives
from softwarerenderer_tpu.models import scene as scene_mod
from softwarerenderer_tpu.utils import mathlib as jml
from softwarerenderer_tpu_torch.models.convert import (scene_to_torch,
                                                       state_to_numpy,
                                                       state_to_torch)
from softwarerenderer_tpu_torch.utils import checkpoint

# The JAX package's sim/__init__ exports a function named `raycast`, so
# its modules are taken by path.
jchar = importlib.import_module("softwarerenderer_tpu.sim.character")
jagents = importlib.import_module("softwarerenderer_tpu.sim.agents")
jparts = importlib.import_module("softwarerenderer_tpu.sim.particles")
jray = importlib.import_module("softwarerenderer_tpu.sim.raycast")
tchar = importlib.import_module("softwarerenderer_tpu_torch.sim.character")
tagents = importlib.import_module("softwarerenderer_tpu_torch.sim.agents")
tparts = importlib.import_module("softwarerenderer_tpu_torch.sim.particles")
tray = importlib.import_module("softwarerenderer_tpu_torch.sim.raycast")

F32 = np.float32
EYE = np.eye(4, dtype=F32)
DT = F32(1.0 / 60.0)
# One jitted step from the same state: XLA contracts multiply-adds;
# measured ≤ 9.7e-7 relative on velocities, 3.3e-7 on aim, 8.5e-8 on the
# facing quaternion (atan2, sin, cos).
JIT_RTOL = 1e-5
JIT_ATOL = 1e-6
# Particles: only the normal draws (new velocities, and the positions
# they move) may differ, by prng's bound; measured ≤ 1.2e-7 relative on
# velocities and 1.7e-7 on positions.
PARTICLE_RTOL = 2e-6


def worlds(meshes_and_mats):
    """The same collision world in both packages (the port's with its
    correctly rounded roots)."""
    sc = scene_mod.build_scene_buffers(
        [scene_mod.MeshInstance(m, mat) for m, mat in meshes_and_mats])
    return (jray.build_collision_world(sc),
            tray.build_collision_world(scene_to_torch(sc, "cpu")))


def floor_plane(y=0.0, size=50.0):
    return (primitives.plane(size, y=y), EYE)


def assert_states(want, got, tag="", loose=None, rtol=0.0, atol=0.0):
    """want (JAX's, numpy) against got (the port's, numpy): float leaves
    named in `loose` within their (rtol, atol), the other float leaves
    within rtol / atol (bit for bit when both are 0), the rest equal."""
    loose = loose or {}
    for k, w in want.items():
        if isinstance(w, dict):
            assert_states(w, got[k], f"{tag}{k}.", loose, rtol, atol)
            continue
        w, g = np.asarray(w), np.asarray(got[k])
        assert w.shape == g.shape and w.dtype == g.dtype, (tag + k, w, g)
        tol = loose.get(k, (rtol, atol))
        if w.dtype == np.float32 and any(tol):
            np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1],
                                       err_msg=tag + k)
        elif w.dtype == np.float32:
            np.testing.assert_array_equal(w.view(np.int32), g.view(np.int32),
                                          err_msg=tag + k)
        else:
            np.testing.assert_array_equal(w, g, err_msg=tag + k)


# ---------------------------------------------------------------------------
# Character controller
# ---------------------------------------------------------------------------

# Every scene is a floor and one cube (14 triangles), so JAX's op-by-op
# primitives compile once for all of them: a wall (front face at z = -2),
# a ceiling slab (underside at y = 0.8), or a cube far off.
WALL = (primitives.cube(4.0), jml.translation([0.0, 2.0, -4.0]))
CEILING = (primitives.cube(2.0), (np.diag(F32([20.0, 0.1, 20.0, 1.0]))
                                  @ jml.translation([0.0, 0.9, 0.0]))
           .astype(F32))
FAR_CUBE = (primitives.cube(1.0), jml.translation([40.0, 0.0, 40.0]))
FLOOR = [floor_plane(), FAR_CUBE]
# name: (world, start, move, jumps a step, noclip).  A few steps each:
# JAX op by op takes about 0.3 s a step.
CHARACTER_CASES = {
    "fall_and_land": (FLOOR, [0.0, 0.3, 0.0], (0, 0, 0), [False] * 6,
                      False),
    "walk": (FLOOR, [0.0, 0.25, 0.0], (0, 0, -1), [False] * 4, False),
    "jump": (FLOOR, [0.0, 0.25, 0.0], (0.3, 0, 0),
             [False, True, True] + [False] * 3, False),
    "wall_slide": ([floor_plane(), WALL], [0.0, 0.25, -1.84], (-0.3, 0, -1),
                   [False] * 5, False),
    "ceiling": ([floor_plane(), CEILING], [0.0, 0.25, 0.0], (0, 0, 0),
                [False, True, True] + [False] * 4, False),
    "noclip": (FLOOR, [0.0, 0.2, 0.0], (0, -1, 0), [False] * 3, True),
}


def run_character(case, steps=None):
    """Both packages' steps of a CHARACTER_CASES case, op by op; returns
    the JAX states (numpy) after each step, having held the port's equal
    to them on every value."""
    mm, start, move, jumps, noclip = CHARACTER_CASES[case]
    jw, tw = worlds(mm)
    p = jchar.default_character_params()
    js = jchar.initial_character_state(start)
    js["noclip"] = jnp.asarray(noclip)
    ts = state_to_torch(jax.device_get(js), "cpu")
    move = np.float32(move)
    out = []
    with jax.disable_jit():
        for i, jump in enumerate(jumps[:steps]):
            js = jchar.character_step(js, move, jump, DT, jw, p)
            ts = tchar.character_step(ts, move, jump, DT, tw, p)
            want = jax.device_get(js)
            assert_states(want, state_to_numpy(ts, single=True),
                          f"{case} step {i}: ")
            out.append(want)
    return out


@pytest.mark.parametrize("case", sorted(CHARACTER_CASES))
def test_character_step_equals_jax_op_by_op(case):
    """Falling and landing, walking, jumping, the wall slide, the ceiling
    and noclip on tests/test_sim.py's scenes: every leaf of every step
    equal to JAX's step run op by op, and the case's event seen."""
    states = run_character(case)
    last = states[-1]
    if case == "fall_and_land":
        assert last["grounded"] and abs(last["position"][1] - 0.25) < 0.02
    elif case == "walk":
        assert last["grounded"] and last["position"][2] < -0.02
    elif case == "jump":
        assert max(s["velocity"][1] for s in states) > 2.0
        assert not states[-1]["grounded"]
    elif case == "wall_slide":
        assert -2.0 < last["position"][2] < -1.8
    elif case == "ceiling":
        assert any(s["ceiling"] for s in states)
        assert max(s["position"][1] for s in states) < 0.8
    else:
        assert last["position"][1] < 0.0


def test_character_step_near_jitted_jax():
    """One jitted JAX step from the same mid-slide state, within JIT_RTOL
    / JIT_ATOL (XLA contracts multiply-adds inside a jit)."""
    mm, start, move, _, _ = CHARACTER_CASES["wall_slide"]
    jw, tw = worlds(mm)
    p = jchar.default_character_params()
    move = np.float32(move)
    step = jax.jit(lambda s: jchar.character_step(s, move, False, DT, jw, p))
    js = jchar.initial_character_state(start)
    for _ in range(6):
        js = step(js)
    ts = tchar.character_step(state_to_torch(jax.device_get(js), "cpu"),
                              move, False, DT, tw, p)
    assert_states(jax.device_get(step(js)), state_to_numpy(ts, single=True),
                  rtol=JIT_RTOL, atol=JIT_ATOL)


def test_batched_step_equals_single_steps():
    """Three characters stepped as one batch equal each stepped alone:
    falling, sliding along the wall, jumping."""
    _, tw = worlds([floor_plane(), WALL])
    p = jchar.default_character_params()
    starts = np.float32([[0, 0.6, 0], [0, 0.25, -1.6], [1, 0.25, 0]])
    moves = np.float32([[0, 0, 0], [-0.3, 0, -1], [0, 0, 1]])
    batch = tchar.initial_character_state(starts, device="cpu")
    singles = [tchar.initial_character_state(s, device="cpu")
               for s in starts]
    for i in range(20):
        jump = torch.tensor([False, False, i in (4, 5)])
        batch = tchar.character_step(batch, torch.from_numpy(moves), jump,
                                     DT, tw, p)
        singles = [tchar.character_step(s, moves[j], bool(jump[j]), DT, tw, p)
                   for j, s in enumerate(singles)]
    for j, s in enumerate(singles):
        for k, v in s.items():
            assert torch.equal(batch[k][j:j + 1], v), (j, k)


# ---------------------------------------------------------------------------
# Particles
# ---------------------------------------------------------------------------

def test_particle_step_equals_jax():
    """15 steps of a 24-slot emitter at 300 particles/s with at most 5 a
    step (the ring recycles its oldest slots) falling onto a bounce
    plane, op by op from the same state: ages, lifetimes, cursor,
    accumulator and key equal; velocities and positions within
    PARTICLE_RTOL (normal draws); the render channels likewise."""
    em = jparts.default_emitter_params()
    em.update(origin=F32([0, 1, 0]), base_velocity=F32([0, -3, 0]),
              rate=F32(300.0), floor_y=F32(0.9), spread=F32(1.0),
              lifetime=np.float32([0.2, 0.5]))
    js = jparts.initial_particle_state(24, seed=5)
    ts = state_to_torch(jax.device_get(js), "cpu")
    loose = {"position": (PARTICLE_RTOL, 1e-6),
             "velocity": (PARTICLE_RTOL, 1e-6)}
    bounced = wrapped = False
    with jax.disable_jit():
        for i in range(15):
            js = jparts.particle_step(js, em, DT, max_emit=5)
            ts = tparts.particle_step(ts, em, DT, max_emit=5)
            want = jax.device_get(js)
            assert_states(want, state_to_numpy(ts), f"step {i}: ", loose)
            bounced |= bool(((want["position"][:, 1] == F32(0.9))
                             & (want["velocity"][:, 1] > 0)).any())
            wrapped |= i > 0 and int(want["cursor"]) < 5
        ju = jax.device_get(jparts.particle_uniforms(js, em))
    tu = {k: v.numpy() for k, v in tparts.particle_uniforms(ts, em).items()}
    assert_states(ju, tu, "uniforms: ",
                  {"particle_centers": loose["position"]})
    assert bounced and wrapped


# ---------------------------------------------------------------------------
# Agents
# ---------------------------------------------------------------------------

FLOOR80 = [(primitives.plane(80.0, y=0.0), EYE), FAR_CUBE]
# tests/test_agents.py's walled world: a wall through x = 0 with a gap at
# z > 8, and its three waypoints.
WALLED = FLOOR80 + [(primitives.cube(2.0), (
    np.diag(F32([0.25, 3.0, 8.0, 1.0])) @ jml.translation(F32([0, 1, 0])))
    .astype(F32))]
WALLED_WPS = F32([[-6, 0, 0], [6, 0, 0], [0, 0, 12]])
# A wall between agent 0 and its target (test_agents' line-of-sight case).
LOS_WALL = FLOOR80 + [(primitives.cube(2.0), (
    np.diag(F32([4.0, 3.0, 0.25, 1.0])) @ jml.translation(F32([0, 1, -5])))
    .astype(F32))]
# The unstick case's wall of cubes across the route.
STUCK_WALL = FLOOR80 + [(primitives.cube(2.0), (
    jml.translation(F32([2.0, 0.5, 0.0]))
    @ np.diag(F32([0.5, 4.0, 40.0, 1.0]))).astype(F32))]

EXTRA_TARGET = F32([[-12, 0.3, 3]])
AGENT_CASES = {
    # patrol, separation and the unstick jump: agent 0 walks into a wall
    # of cubes across its route and jumps; agents 1 and 2, dropped at one
    # point with the same goal, spread apart; agent 3 arrives at its
    # waypoint and advances.
    "patrol": dict(
        world=STUCK_WALL, starts=[[0, 0.5, 0], [0, 0.5, 10],
                                  [0.05, 0.5, 10], [-5, 0.5, 3]],
        wps=[[20, 0, 0], [-5.2, 0, 3.2], [-5, 0, -20]], seed=5,
        waypoint_idx=[0, 0, 0, 1]),
    # routing through the gap (next_hop), dt 1/30.
    "route_through_gap": dict(
        world=WALLED, starts=[[-6, 0.5, 0]], wps=WALLED_WPS, seed=0,
        hop=True, dt=F32(1 / 30), goal=1),
    # combat: the agents and one more target, ids never their own; agent
    # 0's nearest enemy (agent 1) is behind the wall, the extra target
    # farther but in the open.
    "combat": dict(
        world=LOS_WALL, starts=[[0, 0.3, 0], [0, 0.3, -10], [6, 0.3, -9]],
        wps=[[0, 0, 0]], seed=1, combat=True),
}


def agent_case(case):
    """(JAX world, port world, JAX step(state, dt), port step(state, dt),
    initial JAX state) of an AGENT_CASES case."""
    c = AGENT_CASES[case]
    jw, tw = worlds(c["world"])
    cp = jchar.default_character_params()
    br = jagents.default_brain_params()
    wps = np.asarray(c["wps"], F32)
    n = len(c["starts"])
    kw = {}
    if c.get("hop"):
        kw["next_hop"] = jagents.build_waypoint_graph(jw, wps)
    combat = c.get("combat")
    ids = np.arange(n, dtype=np.int32)
    tids = np.arange(n + 1, dtype=np.int32)

    def targets(pos):
        return np.concatenate([np.asarray(pos), EXTRA_TARGET])

    def jstep(s, dt):
        if combat:
            kw.update(targets=jnp.concatenate(
                [s["char"]["position"], jnp.asarray(EXTRA_TARGET)]),
                target_alive=np.ones(n + 1, bool), target_ids=tids,
                self_ids=ids)
        return jagents.agents_step(s, dt, wps, jw, cp, br, **kw)

    def tstep(s, dt):
        tkw = dict(kw)
        if combat:
            tkw.update(targets=torch.from_numpy(targets(
                s["char"]["position"].numpy())), target_ids=tids,
                self_ids=ids)
        return tagents.agents_step(s, dt, wps, tw, cp, br, **tkw)

    js = jagents.initial_agents_state(
        np.asarray(c["starts"], F32), key=jax.random.PRNGKey(c["seed"]),
        waypoint_idx=np.asarray(c.get("waypoint_idx", [0] * n), np.int32))
    if "goal" in c:
        nxt = kw["next_hop"]
        js["goal"] = jnp.asarray([c["goal"]], jnp.int32)
        js["waypoint"] = jnp.asarray([int(nxt[0, c["goal"]])], jnp.int32)
    return jstep, tstep, js, c.get("dt", DT)


AGENT_STEPS = {"patrol": 80, "route_through_gap": 25, "combat": 15}


@pytest.mark.parametrize("case", sorted(AGENT_STEPS))
def test_agents_step_near_jitted_jax(case):
    """Each step of a run, from JAX's state of the step before, against
    JAX's jitted step: floats within JIT_RTOL / JIT_ATOL, the rest
    equal; and the case's behaviour seen: the stuck agent jumps,
    separation spreads a pack and an arrival advances, the route takes
    the flank, combat fires past a blocked nearer enemy at a visible
    farther one.  (Run op by op, JAX's agents step equals the port's on
    every value but rotation, 6e-8 off, at tens of seconds a step.)"""
    jstep, tstep, js, dt = agent_case(case)
    jstep = jax.jit(jstep)
    history = []
    for i in range(AGENT_STEPS[case]):
        ts = tstep(state_to_torch(jax.device_get(js), "cpu"), dt)
        js = jstep(js, dt)
        want = jax.device_get(js)
        assert_states(want, state_to_numpy(ts), f"{case} step {i}: ",
                      rtol=JIT_RTOL, atol=JIT_ATOL)
        history.append(want)
    pos = np.stack([h["char"]["position"] for h in history])
    if case == "patrol":
        vy = np.stack([h["char"]["velocity"][0, 1] for h in history])
        assert (vy > 0.5).any() and pos[-1, 0, 0] < 2.0
        d = np.linalg.norm(pos[:, 1, (0, 2)] - pos[:, 2, (0, 2)], axis=-1)
        assert d[-1] > 4 * d[0]
        assert history[-1]["waypoint"][3] != 1
    elif case == "route_through_gap":
        assert pos[-1, 0, 2] > 1.0
    elif case == "combat":
        fired = np.stack([h["fire"] for h in history])
        aim = np.stack([h["aim"] for h in history])
        assert fired.any(0).all()
        # agent 0 shoots the visible extra target (-x), not agent 1.
        assert (aim[fired[:, 0], 0, 0] < -0.5).all()


def test_combat_never_targets_itself():
    """A lone agent given only itself as a target never fights: it never
    fires and keeps its patrol clock running."""
    _, tw = worlds(FLOOR80)
    st = tagents.initial_agents_state(F32([[0, 0.3, 0]]), device="cpu")
    cp = jchar.default_character_params()
    br = jagents.default_brain_params()
    for i in range(5):
        st = tagents.agents_step(st, DT, F32([[5, 0, 0]]), tw, cp, br,
                                 targets=st["char"]["position"],
                                 target_ids=[7], self_ids=[7])
        assert not st["fire"].any()
        assert float(st["wp_age"][0]) == pytest.approx((i + 1) * DT)


def test_waypoint_helpers_equal_jax():
    """scatter_waypoints_on_floor and build_waypoint_graph equal JAX's:
    the floor points bit for bit, the routing table entry for entry
    (16 rays each, so JAX compiles its raycast once)."""
    jw, tw = worlds([(primitives.plane(80.0, y=1.5), EYE), FAR_CUBE])
    centers = F32([[0, 1.5, 0], [10, 1.5, 5]])
    want = jagents.scatter_waypoints_on_floor(jw, centers, 8, seed=7)
    got = tagents.scatter_waypoints_on_floor(tw, centers, 8, seed=7)
    np.testing.assert_array_equal(want, got)
    jw, tw = worlds(WALLED)
    wps = np.concatenate([WALLED_WPS, F32([[0, 0, -12]])])
    want = jagents.build_waypoint_graph(jw, wps)
    np.testing.assert_array_equal(want, tagents.build_waypoint_graph(tw, wps))
    assert want[0, 1] == 2


def test_respawn_agent_equals_jax():
    js = jagents.initial_agents_state(F32([[0, 1, 0], [2, 1, 0]]),
                                      key=jax.random.PRNGKey(4))
    ts = state_to_torch(jax.device_get(js), "cpu")
    want = jax.device_get(jagents.respawn_agent(js, 1, F32([5, 2, 5])))
    got = tagents.respawn_agent(ts, 1, F32([5, 2, 5]))
    assert_states(want, state_to_numpy(got))


# ---------------------------------------------------------------------------
# Checkpoints and the steps' host reads
# ---------------------------------------------------------------------------

def test_checkpoint_replay_equals_unbroken_run(tmp_path):
    """A character, a crowd and an emitter saved after 3 steps, loaded,
    and stepped 3 more equal the unbroken 6-step run on every value."""
    _, tw = worlds(FLOOR80)
    cp = jchar.default_character_params()
    br = jagents.default_brain_params()
    em = jparts.default_emitter_params()
    wps = F32([[5, 0, 0], [0, 0, 5]])

    def step(s):
        return {"player": tchar.character_step(s["player"], F32([0, 0, -1]),
                                               False, DT, tw, cp),
                "bots": tagents.agents_step(s["bots"], DT, wps, tw, cp, br),
                "sparks": tparts.particle_step(s["sparks"], em, DT),
                "frame": s["frame"] + 1, "name": s["name"]}

    s = {"player": tchar.initial_character_state([0, 0.4, 0], device="cpu"),
         "bots": tagents.initial_agents_state(F32([[1, 0.4, 1], [2, 0.4, 2]]),
                                              device="cpu"),
         "sparks": tparts.initial_particle_state(16, seed=3, device="cpu"),
         "frame": 0, "name": "replay"}
    for _ in range(3):
        s = step(s)
    path = os.path.join(tmp_path, "ck", "state.npz")
    checkpoint.save(path, s)
    r = checkpoint.load(path, device="cpu")
    assert r["name"] == "replay" and int(r["frame"]) == 3
    for _ in range(3):
        s, r = step(s), step(r)
    assert_states(state_to_numpy({k: s[k] for k in ("player", "bots",
                                                     "sparks")}),
                  state_to_numpy({k: r[k] for k in ("player", "bots",
                                                     "sparks")}))


def test_steps_read_nothing_back(monkeypatch):
    """character_step, agents_step (with routing and combat) and
    particle_step with tensor inputs make no host read: none calls
    bool(), item(), tolist() or numpy() on a tensor (each is a sync on
    the card)."""
    _, tw = worlds(WALLED)
    cp = {k: torch.as_tensor(v) for k, v in
          jchar.default_character_params().items()}
    br = {k: torch.as_tensor(v) for k, v in
          jagents.default_brain_params().items()}
    em = {k: torch.as_tensor(v) for k, v in
          jparts.default_emitter_params().items()}
    wps = torch.from_numpy(WALLED_WPS)
    hop = torch.from_numpy(jagents.build_waypoint_graph(
        worlds(WALLED)[0], WALLED_WPS))
    ch = tchar.initial_character_state([0, 0.4, 0], device="cpu")
    bots = tagents.initial_agents_state(F32([[-6, 0.4, 0], [-5, 0.4, 1]]),
                                        device="cpu")
    sparks = tparts.initial_particle_state(16, device="cpu")
    ids = torch.arange(2, dtype=torch.int32)
    dt = torch.tensor(DT)

    def fail(*a, **k):
        raise AssertionError("a host read in a step")
    for name in ("__bool__", "item", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, fail)
    for _ in range(2):
        ch = tchar.character_step(ch, torch.zeros(3), torch.tensor(False),
                                  dt, tw, cp)
        bots = tagents.agents_step(bots, dt, wps, tw, cp, br, next_hop=hop,
                                   targets=bots["char"]["position"],
                                   target_ids=ids, self_ids=ids)
        sparks = tparts.particle_step(sparks, em, dt)
