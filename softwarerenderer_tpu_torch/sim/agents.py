"""Batched AI agents: N characters and their brains stepped together.

Counterpart of ``softwarerenderer_tpu/sim/agents.py``: each agent is the
kinematic capsule controller (``sim.character``) plus a waypoint-seeking
brain, all masked arithmetic:

  * patrol toward ``waypoints[waypoint]`` on the XZ plane, a random next
    waypoint on arrival, or with a ``next_hop`` table from
    ``build_waypoint_graph`` the next hop toward a random goal; give up a
    waypoint after ``patience`` seconds;
  * combat (with ``targets``): the nearest enemy in line of sight (one
    raycast wave of N·M rays) within ``sight_range`` is pursued to
    ``standoff`` and strafed; ``fire`` and ``aim`` report the shots, with
    random aim spread and cooldown jitter;
  * crowd separation: pairwise XZ repulsion inside ``separation_radius``;
  * the unstick jump after ``stuck_time`` seconds of little real motion;
  * facing as a yaw quaternion;
  * then one ``character_step`` for all N agents: each probe and slide is
    one raycast wave over every agent's rays (the JAX package ``vmap``s a
    one-character step).

Each agent carries its own key (``sim.prng``, JAX's threefry streams), so
its draws do not depend on the batch it rides in, and a state steps as
the JAX package's does from the same state: positions, velocities, keys,
waypoints, goals, fire and cooldowns equal on the CPU, ``aim`` within the
normal draws' bound, ``rotation`` within what ``atan2``, ``sin`` and
``cos`` may differ by.  Sums over agents are added left to right (a
reduction's order differs between devices), so the CPU and the card step
the same states.  The step makes no host read.

``scatter_waypoints_on_floor`` and ``build_waypoint_graph`` are host
set-up helpers (numpy's ``default_rng``, a host Floyd–Warshall) that cast
through ``raycast_batch`` on the world's device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from softwarerenderer_tpu_torch.utils.profiling import span

from softwarerenderer_tpu_torch.models.convert import tree_to_torch
from softwarerenderer_tpu_torch.sim import prng
from softwarerenderer_tpu_torch.sim.character import (
    DEFAULT_SLIDE_H_RAYS,
    DEFAULT_SLIDE_V_STEPS,
    as_scalar,
    cast,
    character_step,
    initial_character_state,
)
from softwarerenderer_tpu_torch.sim.raycast import BIG, raycast_batch
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = torch.float32
I32 = torch.int32


def default_brain_params() -> Dict:
    """Steering tunables, as numpy values (the JAX package's)."""
    return {
        "arrive_radius": np.float32(1.2),    # waypoint reached within this
        "stuck_speed": np.float32(0.35),     # XZ speed below this = stuck
        "stuck_time": np.float32(0.5),       # seconds below it before a jump
        "move_scale": np.float32(1.0),       # 0..1 throttle on move_input
        "patience": np.float32(6.0),         # give up a waypoint after this
        "separation_radius": np.float32(1.2),  # repel inside this (XZ)
        "separation_gain": np.float32(1.0),    # steering weight
        "sight_range": np.float32(30.0),       # acquire LOS targets within
        "fire_range": np.float32(25.0),        # shoot within
        "standoff": np.float32(6.0),           # keep this distance, strafe
        "fire_cooldown": np.float32(0.9),      # seconds between shots
        "aim_spread": np.float32(0.035),       # radians of aim noise
        "eye_height": np.float32(0.15),        # eye/chest offset above feet
    }


def initial_agents_state(positions, key=None, waypoint_idx=None,
                         device=None) -> Dict:
    """The state of N agents at positions (N, 3), on positions' device
    when a tensor, else on `device` ("cuda" unless given).  `key` (a
    prng key, prng_key(0) by default) is split into one key per agent;
    `waypoint_idx` (N,) is each agent's first waypoint (default 0)."""
    char = initial_character_state(positions, device)
    dev = char["position"].device
    n = char["position"].shape[0]
    key = prng.prng_key(0, dev) if key is None else key.to(dev)
    waypoint = torch.zeros(n, dtype=I32, device=dev) if waypoint_idx is None \
        else torch.as_tensor(waypoint_idx, dtype=I32, device=dev)

    def tile(row):
        return torch.tensor(row, dtype=F32, device=dev).expand(n, len(row))

    return {
        "char": char,
        "waypoint": waypoint,
        # The route's destination (the waypoint until a next_hop table
        # routes through intermediate hops).
        "goal": waypoint,
        "wp_age": torch.zeros(n, dtype=F32, device=dev),
        "slow_time": torch.zeros(n, dtype=F32, device=dev),
        "key": prng.split(key, n),                          # (N, 2)
        # Yaw-only facing quaternion [x, y, z, w].
        "rotation": tile([0.0, 0.0, 0.0, 1.0]),
        # Combat outputs of the last step (ignored as inputs).
        "cooldown": torch.zeros(n, dtype=F32, device=dev),
        "strafe": 1.0 - 2.0 * (torch.arange(n, dtype=F32, device=dev) % 2),
        "fire": torch.zeros(n, dtype=torch.bool, device=dev),
        "aim": tile([0.0, 0.0, -1.0]),
    }


def _norm(v: torch.Tensor) -> torch.Tensor:
    return ml.sqrt_rn(ml.dot(v, v))


def _xz(v: torch.Tensor) -> torch.Tensor:
    """v (..., 3) with y = 0."""
    return torch.stack([v[..., 0], torch.zeros_like(v[..., 1]), v[..., 2]],
                       -1)


@span("sim.agents")
def agents_step(state: Dict, dt, waypoints, world: Dict,
                char_params: Dict, brain: Dict, tri_mask=None,
                next_hop=None, targets=None, target_alive=None,
                target_ids=None, self_ids=None,
                slide_v_steps: int = DEFAULT_SLIDE_V_STEPS,
                slide_h_rays: int = DEFAULT_SLIDE_H_RAYS) -> Dict:
    """Advance every agent one tick; returns the new state.

    waypoints: (W, 3) patrol targets shared by all agents.  next_hop:
    optional (W, W) int32 routing table (build_waypoint_graph).  targets:
    optional (M, 3) enemy feet positions, with target_alive (M,) bool,
    target_ids (M,) and self_ids (N,) ints (an agent never targets its
    own id); they turn on combat.  Tensors on the state's device pass as
    they are; host arrays are copied there.  The rest as character_step."""
    pos = state["char"]["position"]                            # (N, 3)
    dev = pos.device
    n = pos.shape[0]
    b = tree_to_torch(brain, dev)
    dt = as_scalar(dt, dev)
    waypoints = torch.as_tensor(waypoints, dtype=F32, device=dev)
    n_wp = waypoints.shape[0]
    up = torch.eye(3, dtype=F32, device=dev)[1]

    # --- patrol steering --------------------------------------------------
    delta = _xz(waypoints[state["waypoint"].long()] - pos)
    dist = _norm(delta)                                        # (N,)
    arrived = dist < b["arrive_radius"]

    # Each agent's key splits into its six streams.
    split6 = prng.split(state["key"], 6)                       # (N, 6, 2)
    key, k_adv, k_jump, k_aim = (split6[:, i] for i in range(4))
    # The three uniform draws in one hash: strafe flip, cooldown, jump.
    u_strafe, u_cd, u_jump = prng.uniform(
        torch.stack([split6[:, 4], split6[:, 5], k_jump]))     # (3, N)

    # --- combat sensing ---------------------------------------------------
    in_combat = torch.zeros(n, dtype=torch.bool, device=dev)
    if targets is not None:
        tpos = torch.as_tensor(targets, dtype=F32, device=dev)  # (M, 3)
        m = tpos.shape[0]
        alive = torch.ones(m, dtype=torch.bool, device=dev) \
            if target_alive is None \
            else torch.as_tensor(target_alive, dtype=torch.bool, device=dev)
        if target_ids is not None and self_ids is not None:
            not_self = (torch.as_tensor(target_ids, device=dev)[None, :]
                        != torch.as_tensor(self_ids, device=dev)[:, None])
        else:
            not_self = torch.ones((n, m), dtype=torch.bool, device=dev)
        eye = pos + up * b["eye_height"]
        chest = tpos + up * b["eye_height"]
        tdelta = chest[None, :, :] - eye[:, None, :]           # (N, M, 3)
        tdist = _norm(tdelta)                                  # (N, M)
        cand = alive[None, :] & not_self & (tdist < b["sight_range"])
        # Line of sight: one wave of N·M rays; a hit closer than the
        # target blocks it.
        los = cast(eye[:, None, :].expand(n, m, 3).reshape(-1, 3),
                   tdelta.reshape(-1, 3), world, tri_mask)
        blocked = (los["hit"] & (los["distance"] < torch.clamp_min(
            tdist.reshape(-1) - 0.3, 0.0))).reshape(n, m)
        visible = cand & ~blocked
        tsel = torch.argmin(torch.where(visible, tdist, BIG), dim=1)
        in_combat = visible.any(1)
        sel_delta = torch.take_along_dim(tdelta, tsel[:, None, None],
                                         dim=1)[:, 0]          # (N, 3)
        sel_dist = torch.take_along_dim(tdist, tsel[:, None], dim=1)[:, 0]

        # Pursue to standoff range, then strafe around the target (the
        # strafe sign flips with a small probability so orbits vary).
        to_enemy = _xz(sel_delta)
        to_enemy = to_enemy / torch.clamp_min(_norm(to_enemy), 1e-6)[:, None]
        side = torch.stack([-to_enemy[:, 2], torch.zeros_like(to_enemy[:, 1]),
                            to_enemy[:, 0]], 1)
        flip = u_strafe < dt * 0.4
        strafe = torch.where(flip, -state["strafe"], state["strafe"])
        close = sel_dist < b["standoff"]
        combat_move = torch.where(close[:, None],
                                  side * strafe[:, None] - 0.3 * to_enemy,
                                  to_enemy)
        # Fire control: in range and off cooldown, with aim noise.
        cooldown = torch.clamp_min(state["cooldown"] - dt, 0.0)
        fire = in_combat & (sel_dist < b["fire_range"]) & (cooldown <= 0)
        noise = prng.normal(k_aim, 3)                          # (N, 3)
        aim = sel_delta / torch.clamp_min(_norm(sel_delta), 1e-6)[:, None]
        aim = aim + noise * b["aim_spread"] * torch.clamp_min(
            sel_dist[:, None] / b["fire_range"], 0.2)
        aim = aim / torch.clamp_min(_norm(aim), 1e-6)[:, None]
        cooldown = torch.where(
            fire, b["fire_cooldown"] * (0.75 + 0.5 * u_cd), cooldown)
    else:
        strafe = state["strafe"]
        cooldown = torch.clamp_min(state["cooldown"] - dt, 0.0)
        fire = torch.zeros(n, dtype=torch.bool, device=dev)
        aim = state["aim"]
        combat_move = torch.zeros((n, 3), dtype=F32, device=dev)
        sel_delta = combat_move

    # --- waypoint advance / routing (suspended while fighting) ------------
    age = state["wp_age"] + dt * (1.0 - in_combat.to(F32))
    gave_up = age > b["patience"]
    switch = (arrived | gave_up) & ~in_combat
    if n_wp > 1:
        advance = prng.randint(k_adv, (), 1, n_wp)             # 1..W-1
        rand_wp = (state["waypoint"] + advance) % n_wp
    else:
        rand_wp = state["waypoint"]
    if next_hop is not None:
        hop = torch.as_tensor(next_hop, dtype=I32, device=dev)  # (W, W)
        at_goal = state["waypoint"] == state["goal"]
        # Reached the goal (or gave up): a fresh random goal; else keep
        # routing toward the current one.
        goal = torch.where(switch & (at_goal | gave_up), rand_wp,
                           state["goal"])
        waypoint = torch.where(
            switch, hop[state["waypoint"].long(), goal.long()],
            state["waypoint"])
    else:
        waypoint = torch.where(switch, rand_wp, state["waypoint"])
        goal = waypoint
    wp_age = torch.where(switch, 0.0, age)

    move_dir = delta / torch.clamp_min(dist, 1e-6)[:, None]   # unit XZ
    patrol_move = torch.where(arrived[:, None], 0.0,
                              move_dir * b["move_scale"])
    move_input = torch.where(in_combat[:, None], combat_move, patrol_move)

    # --- crowd separation: pairwise XZ repulsion --------------------------
    if n > 1:
        pd = _xz(pos[:, None, :] - pos[None, :, :])           # (N, N, 3)
        pdist = _norm(pd)
        w = torch.clamp(1.0 - pdist / b["separation_radius"], 0.0, 1.0)
        w = w * (1.0 - torch.eye(n, dtype=F32, device=dev))
        push = pd / torch.clamp_min(pdist, 1e-6)[:, :, None] * w[:, :, None]
        rep = torch.zeros_like(pos)
        for j in range(n):                     # left to right, as XLA's
            rep = rep + push[:, j]
        move_input = move_input + rep * b["separation_gain"]
        norm = _norm(move_input)[:, None]
        move_input = torch.where(norm > 1.0,
                                 move_input / torch.clamp_min(norm, 1e-6),
                                 move_input)

    # Unstick: below stuck_speed of real motion for stuck_time seconds →
    # jump, dithered so a wall-hugging crowd does not jump in step.
    stuck = ~arrived & (state["slow_time"] >= b["stuck_time"])
    jump = stuck & (u_jump < 0.5)

    # Facing: [0, 0, -1] turned by the yaw to the move direction (or to
    # the combat target).
    face = torch.where(in_combat[:, None], sel_delta, move_dir)
    half = 0.5 * torch.atan2(-face[:, 0], -face[:, 2])
    zero = torch.zeros_like(half)
    quat = torch.stack([zero, torch.sin(half), zero, torch.cos(half)], 1)
    rotation = torch.where((arrived & ~in_combat)[:, None],
                           state["rotation"], quat)

    # --- physics: every agent's controller in one batched step ------------
    char = character_step(state["char"], move_input, jump, dt, world,
                          char_params, tri_mask=tri_mask,
                          slide_v_steps=slide_v_steps,
                          slide_h_rays=slide_h_rays)

    # The stuck streak from the step's real XZ displacement.
    disp = char["position"] - pos
    speed_xz = ml.sqrt_rn(disp[:, 0] * disp[:, 0] + disp[:, 2] * disp[:, 2]) \
        / torch.clamp_min(dt, 1e-6)
    slow_now = char["grounded"] & ~arrived & (speed_xz < b["stuck_speed"])
    slow_time = torch.where(slow_now & ~jump, state["slow_time"] + dt, 0.0)

    return {"char": char, "waypoint": waypoint, "goal": goal,
            "wp_age": wp_age, "slow_time": slow_time, "key": key,
            "rotation": rotation, "cooldown": cooldown, "strafe": strafe,
            "fire": fire, "aim": aim}


def respawn_agent(state: Dict, index, position) -> Dict:
    """Teleport agent `index` (a bot's respawn after a kill): zero its
    velocity and place it at `position`.  Out of place, as JAX's."""
    char = state["char"]
    dev = char["position"].device
    idx = torch.as_tensor(index, device=dev).long().reshape(1)
    position = torch.as_tensor(position, dtype=F32, device=dev).reshape(1, 3)
    zero = torch.zeros((), dtype=F32, device=dev)
    return {**state,
            "char": {**char,
                     "position": char["position"].index_put((idx,),
                                                            position),
                     "velocity": char["velocity"].index_put((idx,), zero)},
            "wp_age": state["wp_age"].index_put((idx,), zero),
            "slow_time": state["slow_time"].index_put((idx,), zero)}


def _host_cast(world: Dict, origins: np.ndarray, dirs: np.ndarray, tri_mask):
    """raycast_batch of host rays on the world's device, read back."""
    dev = world["v0"].device
    res = raycast_batch(torch.from_numpy(origins.astype(np.float32)).to(dev),
                        torch.from_numpy(dirs.astype(np.float32)).to(dev),
                        world, tri_mask=tri_mask)
    return {k: v.cpu().numpy() for k, v in res.items()}


def scatter_waypoints_on_floor(world: Dict, centers, n_points: int,
                               seed: int = 0, height: float = 30.0,
                               radius: float = 12.0,
                               tri_mask=None) -> np.ndarray:
    """A walkable waypoint set: `n_points` XZ offsets (numpy's
    default_rng(seed)) around each center, dropped straight down onto the
    map in one raycast wave; the hits, after the centers themselves.
    Host set-up; returns (W, 3) float32 on the host."""
    centers = np.atleast_2d(np.asarray(centers, np.float32))
    rng = np.random.default_rng(seed)
    offs = rng.uniform(-radius, radius, size=(len(centers), n_points, 2))
    starts = np.repeat(centers[:, None, :], n_points, axis=1).copy()
    starts[..., 0] += offs[..., 0]
    starts[..., 2] += offs[..., 1]
    starts[..., 1] += height
    origins = starts.reshape(-1, 3)
    dirs = np.tile(np.asarray([[0.0, -1.0, 0.0]], np.float32),
                   (len(origins), 1))
    res = _host_cast(world, origins, dirs, tri_mask)
    floor = res["point"][res["hit"]]
    return np.concatenate([centers, np.asarray(floor, np.float32)], axis=0)


def build_waypoint_graph(world: Dict, waypoints, tri_mask=None,
                         eye_height: float = 0.4,
                         max_edge: float = 18.0,
                         max_climb: float = 1.5) -> np.ndarray:
    """All-pairs shortest-path routing table over a waypoint set.

    Edges join pairs within `max_edge` whose eye-height sightline is
    clear (one W² raycast wave) and whose heights differ by at most
    `max_climb`, kept symmetric.  Returns next_hop (W, W) int32:
    next_hop[i, g] is the neighbor to walk to from i toward g (host
    Floyd–Warshall); unreachable pairs beeline, next_hop[i, g] = g."""
    wps = np.asarray(waypoints, np.float32)
    w = len(wps)
    eye = wps + np.asarray([0, eye_height, 0], np.float32)
    delta = eye[None, :, :] - eye[:, None, :]                 # (W, W, 3)
    dist = np.linalg.norm(delta, axis=2)
    origins = np.repeat(eye, w, axis=0)                       # (W², 3)
    dirs = delta.reshape(-1, 3)
    dirs[np.linalg.norm(dirs, axis=1) < 1e-6] = [0, 1, 0]     # self rows
    res = _host_cast(world, origins, dirs, tri_mask)
    blocked = (res["hit"] & (res["distance"]
                             < dist.reshape(-1) - 1e-3)).reshape(w, w)
    edge = ((dist <= max_edge)
            & (np.abs(wps[None, :, 1] - wps[:, None, 1]) <= max_climb)
            & ~blocked & ~np.eye(w, dtype=bool))
    edge = edge | edge.T                                      # symmetric

    # Floyd–Warshall with path reconstruction, in float64 as JAX's (a
    # float64 inf promotes the float32 distances; numpy keeps float32
    # for a Python float's).
    d = np.where(edge, dist, np.float64(np.inf))
    np.fill_diagonal(d, 0.0)
    nxt = np.where(edge, np.arange(w)[None, :], -1).astype(np.int32)
    np.fill_diagonal(nxt, np.arange(w))
    for k in range(w):
        alt = d[:, k, None] + d[None, k, :]
        better = alt < d
        d = np.where(better, alt, d)
        nxt = np.where(better, nxt[:, k, None], nxt)
    nxt = np.where(nxt < 0, np.arange(w)[None, :], nxt)       # beeline
    return nxt.astype(np.int32)
