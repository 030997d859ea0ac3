"""Particle system: emission, integration, the ring of slots and the
camera-facing billboards.

Counterpart of ``softwarerenderer_tpu/sim/particles.py``.  An emitter has
a fixed CAPACITY of slots: each step emits k new particles into the next
k slots of a ring (k from the emission rate, at most ``max_emit``),
recycling the oldest; a particle dies at ``lifetime = 0``, never by a
shape change.  Randomness is a key carried in the state and drawn through
``sim.prng``, JAX's own threefry streams, so a trajectory equals the JAX
package's from the same state (its normal draws within ``prng``'s bound)
and is the same on the CPU and the card.  The step makes no host read.

A packed scene reserves 4·N vertices for an emitter of N particle slots
(``MeshInstance(particles_mesh(N), particles=N)``); each frame
``apply_billboards`` writes camera-facing quad corners for the particle
uniforms ``particle_centers`` (P, 3), ``particle_size`` (P,) and
``particle_color`` (P, 4) that ``particle_uniforms`` makes, P the
scene's slots in instance order.  Dead slots carry size 0 and alpha 0:
zero-area quads the raster drops.

    state = initial_particle_state(512, seed=0)      # on the card
    em = tree_to_torch(default_emitter_params(), "cuda")
    state = particle_step(state, em, dt)
    uniforms.update(particle_uniforms(state, em))
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np
import torch
from softwarerenderer_tpu_torch.utils.profiling import span

from softwarerenderer_tpu_torch.models.convert import tree_to_torch
from softwarerenderer_tpu_torch.sim import prng
from softwarerenderer_tpu_torch.sim.character import as_scalar

F32 = torch.float32

# Quad corner offsets, in (right, up) units of one particle size; order
# matches particles_mesh's uv/index layout.
_CORNERS = np.asarray([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]],
                      np.float32)


def default_emitter_params() -> Dict:
    """Fountain-ish defaults, as numpy values (the JAX package's)."""
    return {
        "origin": np.zeros(3, np.float32),
        "base_velocity": np.asarray([0.0, 5.0, 0.0], np.float32),
        "spread": np.float32(1.2),          # isotropic velocity jitter (m/s)
        "rate": np.float32(120.0),          # particles / second
        "gravity": np.asarray([0.0, -9.8, 0.0], np.float32),
        "drag": np.float32(0.1),            # 1/s velocity damping
        "lifetime": np.asarray([1.2, 2.0], np.float32),   # [min, max] s
        "size": np.asarray([0.12, 0.02], np.float32),     # start → end (m)
        "color0": np.asarray([1.0, 0.9, 0.5, 1.0], np.float32),
        "color1": np.asarray([1.0, 0.25, 0.05, 0.0], np.float32),
        "floor_y": np.float32(-1e9),        # bounce plane (-1e9 = off)
        "restitution": np.float32(0.4),
    }


def initial_particle_state(capacity: int, seed: int = 0,
                           device="cuda") -> Dict:
    """All `capacity` slots dead, the key prng.prng_key(seed)."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=F32, device=device)
    return {
        "position": zeros(capacity, 3),
        "velocity": zeros(capacity, 3),
        "age": zeros(capacity),
        "lifetime": zeros(capacity),              # 0 = dead slot
        "cursor": torch.zeros((), dtype=torch.int32, device=device),
        "accum": zeros(),                         # fractional emissions
        "key": prng.prng_key(seed, device),
    }


@functools.lru_cache(maxsize=None)
def _slot_iota(m: int, device: torch.device) -> torch.Tensor:
    return torch.arange(m, dtype=torch.int32, device=device)


@span("sim.particles")
def particle_step(state: Dict, emitter: Dict, dt,
                  max_emit: Optional[int] = None) -> Dict:
    """One step: age and kill, integrate (gravity, drag, the optional
    floor bounce), emit into the ring.  `max_emit` bounds the emissions
    of a step (default the capacity).  Runs on the state's device."""
    n = state["position"].shape[0]
    m = n if max_emit is None else min(int(max_emit), n)
    dev = state["position"].device
    e = tree_to_torch(emitter, dev)
    dt = as_scalar(dt, dev)

    age = state["age"] + dt
    lifetime = torch.where(age >= state["lifetime"], 0.0, state["lifetime"])

    vel = state["velocity"] + e["gravity"] * dt
    vel = vel * torch.clamp_min(1.0 - e["drag"] * dt, 0.0)
    pos = state["position"] + vel * dt

    # Optional floor bounce (masked arithmetic).
    floor = e["floor_y"]
    hit = (pos[:, 1] < floor) & (vel[:, 1] < 0)
    vel = torch.stack([vel[:, 0], torch.where(
        hit, -e["restitution"] * vel[:, 1], vel[:, 1]), vel[:, 2]], 1)
    pos = torch.stack([pos[:, 0], torch.where(hit, floor, pos[:, 1]),
                       pos[:, 2]], 1)

    # Ring-buffer emission: k new particles into slots cursor..cursor+k.
    budget = state["accum"] + e["rate"] * dt
    k = torch.clamp_max(torch.floor(budget), float(m)).to(torch.int32)
    accum = budget - k.to(F32)
    keys = prng.split(state["key"], 4)
    iota = _slot_iota(m, dev)
    slots = ((state["cursor"] + iota) % n).long()
    live = iota < k
    new_vel = e["base_velocity"] + e["spread"] * prng.normal(keys[1], (m, 3))
    # keys 2 and 3 draw the same shape: one hash for both.
    u = prng.uniform(keys[2:4], (m,))
    lt = e["lifetime"]
    new_lt = lt[0] + (lt[1] - lt[0]) * u[0]
    # Sub-step scatter so a burst doesn't stack at one point: each new
    # particle advances a random fraction of dt along its own velocity.
    new_pos = e["origin"] + new_vel * (u[1][:, None] * dt)

    def put(arr, new, mask):
        return arr.index_put((slots,), torch.where(mask, new, arr[slots]))

    lm = live[:, None]
    return {
        "position": put(pos, new_pos, lm),
        "velocity": put(vel, new_vel, lm),
        "age": put(age, torch.zeros_like(new_lt), live),
        "lifetime": put(lifetime, new_lt, live),
        "cursor": (state["cursor"] + k) % n,
        "accum": accum,
        "key": keys[0],
    }


def particle_uniforms(state: Dict, emitter: Dict,
                      prefix: str = "particle_") -> Dict:
    """The render channels of a state: centers, and the size and color
    faded by age; dead slots get size 0 and alpha 0."""
    e = tree_to_torch(emitter, state["age"].device)
    alive = state["lifetime"] > 0
    t = torch.clamp(state["age"] / torch.clamp_min(state["lifetime"], 1e-6),
                    0.0, 1.0)
    sz = e["size"]
    size = torch.where(alive, sz[0] + (sz[1] - sz[0]) * t, 0.0)
    color = e["color0"] + (e["color1"] - e["color0"]) * t[:, None]
    color = color * torch.where(alive, 1.0, 0.0)[:, None]
    return {prefix + "centers": state["position"],
            prefix + "size": size,
            prefix + "color": color}


def particles_mesh(capacity: int, extent: float = 50.0) -> Dict:
    """Placeholder billboard mesh: 4·N vertices and 2·N triangles at the
    origin until apply_billboards writes a frame's corners.  The
    instance's model matrix stays identity (corners are in world space);
    `extent` is the culling radius the emitter must stay inside."""
    n = int(capacity)
    quad_uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    # A camera-facing quad is front-facing (area < 0 after the viewport's
    # Y flip) under BACK culling.
    tri = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    base = 4 * np.arange(n, dtype=np.int32)[:, None, None]
    return {
        "name": f"particles[{n}]",
        "position": np.zeros((4 * n, 3), np.float32),
        "uv": np.tile(quad_uv, (n, 1)),
        "normal": np.tile(np.asarray([[0, 0, 1]], np.float32), (4 * n, 1)),
        "color": np.ones((4 * n, 4), np.float32),
        "indices": (base + tri[None]).reshape(-1, 3),
        "bounds_center": np.zeros(3, np.float32),
        "bounds_radius": float(extent),
    }


def soft_disc_texture(res: int = 32, hardness: float = 2.0) -> np.ndarray:
    """Radial-falloff sprite: white with alpha (1 - r²)^hardness."""
    y, x = np.mgrid[0:res, 0:res]
    r2 = (((x + 0.5) / res - 0.5) ** 2
          + ((y + 0.5) / res - 0.5) ** 2) * 4.0
    a = np.clip(1.0 - r2, 0.0, 1.0) ** hardness
    tex = np.ones((res, res, 4), np.float32)
    tex[..., 3] = a
    return tex


def apply_billboards(vin: Dict, scene: Dict[str, torch.Tensor],
                     uniforms: Dict, view: torch.Tensor) -> Dict:
    """A copy of vin with the reserved slots' positions, normals and
    colors written: corners center + (cx·s)·right + (cy·s)·up, the normal
    toward the camera.  With the row-vector view V, right = V[:3, 0], up
    = V[:3, 1] and V[:3, 2] points from the scene to the camera."""
    dev = view.device
    idx = scene["particle_vert_index"].long()
    pidx = scene["particle_vert_pidx"].long()
    corner = scene["particle_corner"]
    centers, size, color = (
        torch.as_tensor(uniforms[k], dtype=torch.float32, device=dev)
        for k in ("particle_centers", "particle_size", "particle_color"))
    s = size[pidx][:, None]
    pos = centers[pidx] + (corner[:, 0:1] * s) * view[:3, 0] \
        + (corner[:, 1:2] * s) * view[:3, 1]
    out = dict(vin)
    out["position"] = vin["position"].index_put((idx,), pos)
    out["normal"] = vin["normal"].index_put((idx,),
                                            view[:3, 2].expand(pos.shape))
    out["color"] = vin["color"].index_put((idx,), color[pidx])
    return out
