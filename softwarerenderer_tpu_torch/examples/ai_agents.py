"""AI agent crowd: N characters patrol a walled arena and fight — the
whole crowd (steering, waypoint-graph routing, combat sensing, every
capsule controller) advances with one step a frame on the device
(sim/agents.py), drawing JAX's own random streams (sim.prng), and the
arena renders through the same engine.  Beyond the reference (it has no
AI — Renderer.cs:62-70 only tracks human ConnectedPlayers); dust2 exposes
this as `--bots N`.

    python -m softwarerenderer_tpu_torch.examples.ai_agents [out.png]
        [--device cpu]
"""

import numpy as np
import torch
from PIL import Image

from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.examples import cli, demo_device
from softwarerenderer_tpu_torch.models import primitives, scene
from softwarerenderer_tpu_torch.models.convert import (scene_to_torch,
                                                      tree_to_torch)
from softwarerenderer_tpu_torch.ops import texture
from softwarerenderer_tpu_torch.sim import (
    agents_step,
    build_collision_world,
    build_waypoint_graph,
    default_brain_params,
    default_character_params,
    initial_agents_state,
    prng,
)
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = np.float32
N_AGENTS = 6
# 0/1: the two courts (beeline blocked by the wall), 2: the gap
# flank, 3/4: patrol extras deep in each court
WAYPOINTS = np.asarray([[-8, 0, -4], [8, 0, -4], [0, 0, 8],
                        [-8, 0, -10], [8, 0, -10]], F32)
STEPS = 240                                  # 8 s of crowd life
DT = np.float32(1 / 30)


def arena():
    """A floor split by a center wall whose gap is at +z: the beeline
    between the two courts is blocked, so the waypoint graph must route
    cross-court traffic through the flank waypoint at the gap."""
    checker = np.asarray(texture.checkerboard(64, 8)["data"])
    wall_tex = np.asarray(texture.checkerboard(
        32, 4, (0.75, 0.3, 0.25, 1.0), (0.5, 0.2, 0.18, 1.0))["data"])
    insts = [scene.MeshInstance(primitives.plane(40.0), np.eye(4, dtype=F32),
                                texture=checker)]
    # wall at x=0, z from -12 to 4, 2.4 m tall (unjumpable)
    m = (np.diag(np.asarray([0.3, 1.2, 8.0, 1.0], F32))
         @ ml.translation(np.asarray([0.0, 1.2, -4.0], F32)))
    insts.append(scene.MeshInstance(primitives.cube(2.0),
                                    m.astype(F32), texture=wall_tex))
    # one marker cube per agent (the "player model")
    for i in range(N_AGENTS):
        insts.append(scene.MeshInstance(primitives.cube(1.0),
                                        np.eye(4, dtype=F32)))
    return insts


def crowd_setup(sc, n_static, device):
    """The crowd over the packed arena `sc` (its first n_static meshes
    static): the collision world, the routing table over WAYPOINTS (it
    must flank through the gap), the tunables on the device, and the
    agents' first state (numpy's seed 3 for the starts, prng key 7)."""
    world = build_collision_world(scene_to_torch(sc, device))
    static_tris = torch.as_tensor(np.asarray(sc["tri_mesh_id"]) < n_static,
                                  device=device)
    next_hop = build_waypoint_graph(world, WAYPOINTS, tri_mask=static_tris)
    print("next_hop table:\n", next_hop)
    if not (next_hop[0, 1] == 2 and next_hop[1, 0] == 2):
        raise RuntimeError("cross-court routes must flank through the gap")

    rngpos = np.random.default_rng(3)
    starts = np.stack([
        WAYPOINTS[i % len(WAYPOINTS)][:3] + np.asarray(
            [rngpos.uniform(-1, 1), 0.6, rngpos.uniform(-1, 1)], F32)
        for i in range(N_AGENTS)])
    state = initial_agents_state(
        starts, key=prng.prng_key(7, device),
        waypoint_idx=np.arange(N_AGENTS) % len(WAYPOINTS), device=device)
    ids = torch.arange(N_AGENTS, dtype=torch.int32, device=device)
    return {"world": world, "tri_mask": static_tris,
            "next_hop": torch.as_tensor(next_hop, device=device),
            "waypoints": torch.as_tensor(WAYPOINTS, device=device),
            "cp": tree_to_torch(default_character_params(), device),
            "br": tree_to_torch(default_brain_params(), device),
            "ids": ids, "state": state}


def crowd_step(state, crowd, dt=DT):
    """One step of the crowd; every agent is everyone else's combat
    target (FFA)."""
    return agents_step(
        state, dt, crowd["waypoints"], crowd["world"], crowd["cp"],
        crowd["br"], tri_mask=crowd["tri_mask"],
        next_hop=crowd["next_hop"], targets=state["char"]["position"],
        target_ids=crowd["ids"], self_ids=crowd["ids"])


def main(out="/tmp/ai_agents.png", device="cuda"):
    device = demo_device(device)
    insts = arena()
    sc = scene.build_scene_buffers(insts)
    n_static = len(insts) - N_AGENTS
    crowd = crowd_setup(sc, n_static, device)

    st = crowd["state"]
    shots = 0
    for _ in range(STEPS):
        st = crowd_step(st, crowd)
        shots += int(st["fire"].sum())
    pos = st["char"]["position"].cpu().numpy()
    print(f"{N_AGENTS} agents, {shots} shots fired, "
          f"positions:\n{np.round(pos, 2)}")

    # render the final state: marker cubes at agent positions
    eng = Engine(sc, RenderParams(width=640, height=360), device=device)
    u = dict(eng.uniforms)
    mats = np.asarray(sc["mesh_matrices"]).copy()
    for i in range(N_AGENTS):
        mats[n_static + i] = ml.translation(
            pos[i] + np.asarray([0, 0.25, 0], F32)).astype(F32)
    eng.mesh_matrices.copy_(torch.from_numpy(mats))
    u["camera_position"] = np.float32([0.0, 7.0, 10.0])
    u["camera_rotation"] = np.asarray(ml.quat_from_yaw_pitch_roll(
        0.0, -0.5, 0.0), F32)
    rgb = eng.present(u)
    Image.fromarray(rgb).save(out)
    print("wrote", out)
    return rgb


if __name__ == "__main__":
    cli(main, str)
