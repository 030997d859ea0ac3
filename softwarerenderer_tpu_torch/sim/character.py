"""Quake-style kinematic character controller, batched over N characters.

Counterpart of ``softwarerenderer_tpu/sim/character.py`` (the reference's
CharacterController.cs as a pure step): the 9-ray ground and ceiling
probes (CheckPlane) and the capsule ray shell of the ≤ 3-deep slide
(MoveWithSlide) are batched raycast waves, and every branch (jump, ground
snap, ceiling bonk, friction against air acceleration, noclip) is masked
arithmetic.  Where the JAX package steps one character and ``vmap``s it
for a crowd, every state leaf here has a leading N axis (N = 1 for the
player), and each probe or slide is one ``raycast_batch`` wave over all N
characters' rays: the two probes share one wave, and the slide's loop is
three unrolled iterations with a done mask.

The step makes no host read: no ``.item()``, no branch on a tensor, every
divisor a tensor on the state's device (a host-scalar divisor becomes a
multiply by its reciprocal on CUDA), host constants uploaded once per
device.  Roots go through ``ml.sqrt_rn``, and the ring's cosines and the
probe directions are host tables, so a step on the card equals the same
step on the CPU on every value, and on the CPU equals the JAX step run op
by op (``jax.disable_jit``; jitted XLA contracts multiply-adds).
``argmin`` takes the lowest index on ties, as JAX's does, and a probe's
miss distance is float32's max.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import numpy as np
import torch
from softwarerenderer_tpu_torch.utils.profiling import span

from softwarerenderer_tpu_torch.models.convert import tree_to_torch
from softwarerenderer_tpu_torch.sim.raycast import BIG, raycast_batch
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = torch.float32

# CheckPlane's 3×3 ring of probe offsets (CharacterController.cs:238-249).
_PROBE_OFFSETS = np.array(
    [[0, 0, 0], [-1, 0, 0], [1, 0, 0], [0, 0, -1], [0, 0, 1],
     [-1, 0, -1], [-1, 0, 1], [1, 0, -1], [1, 0, 1]], dtype=np.float32)

# Default capsule → default ray-shell shape (CharacterController.cs:330-331
# with Height = 0.5, radius = Radius + 0.001 = 0.151).
DEFAULT_SLIDE_V_STEPS = max(1, int(0.5 / (0.151 * 2)))      # = 1
DEFAULT_SLIDE_H_RAYS = max(4, int(4 * math.pi * 0.151 / 0.1))  # = 18

# The two probes of a step: down to the ground, up to the ceiling.
_PROBES = (-1.0, 1.0)


def default_character_params() -> Dict:
    """Reference tunables (CharacterController.cs:21-33) as numpy values;
    a caller that steps every frame converts them once
    (models.convert.tree_to_torch)."""
    return {
        "gravity": np.asarray([0.0, -14.0, 0.0], np.float32),
        "height": np.float32(0.5),
        "radius": np.float32(0.15),
        "step_size": np.float32(0.3),
        "move_speed": np.float32(5.0),
        "jump_force": np.float32(4.0),
        "ground_acceleration": np.float32(3.5),
        "air_acceleration": np.float32(0.35),
        "max_air_speed": np.float32(6.0),
        "ground_friction": np.float32(6.0),
        "air_control": np.float32(0.2),
        "cam_offset": np.asarray([0.0, 0.15, 0.0], np.float32),
    }


def initial_character_state(position, device=None) -> Dict:
    """The state of N characters at `position` ((3,) or (N, 3)), at rest
    and airborne; on position's device when it is a tensor, else on
    `device` ("cuda" unless given)."""
    if isinstance(position, torch.Tensor):
        pos = position.to(F32)
    else:
        pos = torch.as_tensor(np.asarray(position, np.float32),
                              device=device or "cuda")
    pos = pos.reshape(-1, 3)
    n, dev = pos.shape[0], pos.device
    false = torch.zeros(n, dtype=torch.bool, device=dev)
    return {
        "position": pos,
        "velocity": torch.zeros((n, 3), dtype=F32, device=dev),
        "grounded": false,
        "ceiling": false,
        "jump_cooldown": torch.zeros(n, dtype=F32, device=dev),
        "actual_step": torch.full((n,), 0.03, dtype=F32, device=dev),
        "noclip": false,
    }


def as_scalar(x, device) -> torch.Tensor:
    """A float32 0-d tensor on `device`: a tensor moved, a host number
    filled on the device (no host-to-device copy)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=F32)
    return torch.full((), float(np.float32(x)), dtype=F32, device=device)


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device, v_steps: int, h_rays: int) -> Dict:
    """The step's host tables on `device`, uploaded once: the probes'
    unit offsets, the shell's height fractions, and its ring's cosines
    and sines (float64 rounded to float32, which is XLA's value at these
    angles)."""
    f32 = np.float32
    sq = (_PROBE_OFFSETS * _PROBE_OFFSETS).sum(-1)
    inv = np.where(sq > 0, f32(1.0) / np.sqrt(np.where(sq > 0, sq, f32(1))),
                   f32(0))
    angles = np.float32(2.0 * np.pi) * np.arange(h_rays, dtype=np.float32) \
        / np.float32(h_rays)
    tables = {
        "probe": _PROBE_OFFSETS * inv.astype(np.float32)[:, None],
        "vi": np.arange(v_steps + 1, dtype=np.float32)
        / np.float32(max(1, v_steps)),
        "cos": np.cos(angles.astype(np.float64)).astype(np.float32),
        "sin": np.sin(angles.astype(np.float64)).astype(np.float32),
        "up": np.asarray([0.0, 1.0, 0.0], np.float32),
        "probe_dirs": np.asarray(_PROBES, np.float32),
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
            .to(device) for k, v in tables.items()}


def _with_y(v: torch.Tensor, y) -> torch.Tensor:
    """v (N, 3) with its y column replaced by y: (N,), 0-d or a number."""
    y = y.expand(v.shape[0]) if isinstance(y, torch.Tensor) \
        else torch.full_like(v[:, 1], y)
    return torch.stack([v[:, 0], y, v[:, 2]], dim=1)


def cast(origins: torch.Tensor, directions: torch.Tensor, world: Dict,
         tri_mask=None) -> Dict:
    """A raycast wave of the simulation, under the span sim.raycast."""
    with span("sim.raycast"):
        return raycast_batch(origins, directions, world, tri_mask=tri_mask)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return ml.sqrt_rn(ml.dot(v, v))


def _pick(x: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """x[..., best, :] along the ray axis (dim -2 of (..., R, C), or -1
    of (..., R))."""
    if x.dim() == best.dim() + 1:
        return torch.take_along_dim(x, best[..., None], dim=-1)[..., 0]
    return torch.take_along_dim(x, best[..., None, None], dim=-2)[..., 0, :]


def _project_on_plane(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """CharacterController.ProjectOnPlane (:142-155): v - (v·n)n/|n|², v
    where |n|² < 1e-6."""
    nsq = ml.dot(n, n)
    dot = ml.dot(v, n)
    proj = v - dot[..., None] * n / torch.where(nsq == 0, 1.0, nsq)[..., None]
    return torch.where((nsq < 1e-6)[..., None], v, proj)


def _check_plane(pos, velocity, dt, world, params, tri_mask, consts):
    """The vertical probes (CheckPlane, :228-306) of N characters, down
    and up (_PROBES), as one raycast wave of 2 × N × 9 rays.  Returns
    (any_hit (2, N), point (2, N, 3), normal (2, N, 3)): the nearest
    valid hit within |velocity.y · dt| + height, else (False, -inf, up)."""
    up = consts["up"]
    norm_off = consts["probe"] * (params["radius"] - 0.01)          # (9, 3)
    height_off = (up * consts["probe_dirs"][:, None]) \
        * (params["height"] * 0.5 - 0.01)                             # (2, 3)
    frame_delta = up * velocity[:, 1:2] * dt                         # (N, 3)
    starts = (pos[:, None] + norm_off)[None] - height_off[:, None, None]
    ends = ((pos + frame_delta)[:, None] + norm_off)[None] \
        + height_off[:, None, None]                             # (2, N, 9, 3)
    dirs = ends - starts
    ray_ok = ml.dot(dirs, dirs) >= 1e-4
    out = cast(starts.reshape(-1, 3), dirs.reshape(-1, 3), world, tri_mask)
    shape = ray_ok.shape
    max_distance = frame_delta[:, 1].abs() + params["height"]        # (N,)
    valid = out["hit"].reshape(shape) & ray_ok \
        & (out["distance"].reshape(shape) <= max_distance[:, None])
    dist = torch.where(valid, out["distance"].reshape(shape), BIG)
    best = torch.argmin(dist, dim=-1)                                # (2, N)
    any_hit = valid.any(-1)
    point = _pick(out["point"].reshape(shape + (3,)), best)
    normal = _pick(out["normal"].reshape(shape + (3,)), best)
    point = torch.where(any_hit[..., None], point, float("-inf"))
    normal = torch.where(any_hit[..., None], normal, up)
    return any_hit, point, normal


def _move_with_slide(current, desired, radius, actual_step, world, params,
                     tri_mask, consts):
    """The recursive slide (MoveWithSlide, :308-393) of N characters as 3
    unrolled iterations with a done mask, each one raycast wave of the
    capsule shells: (v_steps + 1) height levels lerped from -h/2 +
    actual_step to h/2, × h_rays points on the radius circle."""
    half_h = params["height"] * 0.5
    bottom = -half_h + actual_step                                   # (N,)
    heights = bottom[:, None] + (half_h - bottom)[:, None] * consts["vi"]
    n, v = heights.shape
    h = consts["cos"].shape[0]
    shell = torch.stack([
        (radius * consts["cos"]).expand(n, v, h),
        heights[:, :, None].expand(n, v, h),
        (radius * consts["sin"]).expand(n, v, h)], dim=-1).reshape(n, v * h, 3)

    cur, des = current, desired
    done = torch.zeros(n, dtype=torch.bool, device=cur.device)
    for _ in range(3):
        move = des - cur
        move_dist = _norm(move)
        direction = move / torch.where(move_dist == 0, 1.0, move_dist)[:, None]
        origins = cur[:, None] + shell                          # (N, R, 3)
        dirs = direction[:, None].expand_as(origins)
        out = cast(origins.reshape(-1, 3), dirs.reshape(-1, 3), world,
                   tri_mask)
        r = origins.shape[1]
        distance = out["distance"].reshape(n, r)
        hit_ok = out["hit"].reshape(n, r) & (distance < move_dist[:, None])
        dist = torch.where(hit_ok, distance, BIG)
        best = torch.argmin(dist, dim=1)
        collided = hit_ok.any(1) & (move_dist > 0)
        nearest = torch.where(collided, _pick(dist, best), move_dist)
        hit_normal = ml.safe_normalize(
            _pick(out["normal"].reshape(n, r, 3), best))

        safe_stop = cur + direction * (nearest - 0.001)[:, None]
        remaining = des - safe_stop
        blocked = ml.dot(direction, hit_normal).abs() > 0.9
        slide_dir = ml.cross(hit_normal, ml.cross(remaining, hit_normal))
        slide_zero = (slide_dir == 0).all(1)
        slide_target = safe_stop + ml.safe_normalize(slide_dir) \
            * _norm(remaining)[:, None]

        # No collision → arrive; blocked or zero slide → stop at the safe
        # point; else slide on in the next iteration.  After the third,
        # the reference returns the current position (:320-322): cur.
        stop = (done | ~collided | blocked | slide_zero)[:, None]
        new_cur = torch.where(done[:, None], cur,
                              torch.where(collided[:, None], safe_stop, des))
        des = torch.where(stop, new_cur, slide_target)
        cur = new_cur
        done = stop[:, 0]
    return cur


@span("sim.character")
def character_step(state: Dict, move_input, jump_requested, dt,
                   world: Dict, params: Dict, tri_mask=None,
                   slide_v_steps: int = DEFAULT_SLIDE_V_STEPS,
                   slide_h_rays: int = DEFAULT_SLIDE_H_RAYS) -> Dict:
    """One controller update of N characters (CharacterController.Update,
    :50-140).  move_input: (3,) or (N, 3); jump_requested: a bool or (N,)
    bools; dt: seconds (a number or a 0-d tensor); world:
    sim.raycast.build_collision_world's; params: default_character_params'
    keys, numpy or tensors.  Runs on the state's device."""
    pos0 = state["position"]
    vel0 = state["velocity"]
    dev = pos0.device
    n = pos0.shape[0]
    p = tree_to_torch(params, dev)
    consts = _constants(dev, slide_v_steps, slide_h_rays)
    dt = as_scalar(dt, dev)
    move_input = torch.as_tensor(move_input, dtype=F32, device=dev) \
        .expand(n, 3)
    if isinstance(jump_requested, torch.Tensor):
        jump_requested = jump_requested.to(dev, torch.bool).expand(n)
    else:
        jump_requested = torch.full((n,), bool(jump_requested), device=dev)

    # --- noclip branch (:52-61), selected at the end -----------------------
    nc_len = _norm(move_input)
    nc_dir = torch.where(
        (nc_len > 1)[:, None],
        move_input / torch.where(nc_len == 0, 1.0, nc_len)[:, None],
        move_input)
    nc_vel = nc_dir * p["move_speed"]
    nc_pos = pos0 + nc_vel * dt

    # --- physics path ------------------------------------------------------
    mi = _with_y(move_input, 0.0)
    vel = vel0 + p["gravity"] * dt
    cd0 = state["jump_cooldown"]
    cooldown = torch.where(cd0 > 0, cd0 - dt, cd0)
    do_jump = jump_requested & state["grounded"] & (cooldown <= 0)
    vel = torch.where(do_jump[:, None], _with_y(vel, p["jump_force"]), vel)
    cooldown = torch.where(do_jump, 0.25, cooldown)

    # The reference sets IsGrounded = False on a jump, then recomputes it
    # from CheckPlane (:85-87): only the recompute persists.
    hits, points, normals = _check_plane(pos0, vel, dt, world, p, tri_mask,
                                         consts)
    grounded, ground_point, ground_normal = hits[0], points[0], normals[0]
    ceiling = hits[1]

    movement = vel * dt
    move_xz = _project_on_plane(_with_y(movement, 0.0), ground_normal)

    # Ground response (:93-108)
    radius = p["radius"] + 0.001
    snap_cond = grounded & (ground_point != float("-inf")).all(1) \
        & (cooldown <= 0)
    snap_target = _with_y(pos0, ground_point[:, 1] + p["height"] * 0.5)
    snapped = _move_with_slide(pos0, snap_target, radius,
                               state["actual_step"], world, p, tri_mask,
                               consts)
    pos = torch.where(snap_cond[:, None], snapped, pos0)
    vel = torch.where((snap_cond & (vel[:, 1] < 0))[:, None],
                      _with_y(vel, 0.0), vel)
    actual_step = torch.where(snap_cond, p["step_size"], 0.0)

    # Ceiling response (:111-115)
    bonk = ceiling & (vel[:, 1] > 0)
    vel = torch.where(bonk[:, None], _with_y(vel, 0.0), vel)
    cooldown = torch.where(bonk, 0.0, cooldown)

    # Horizontal slide (:118) + vertical integration (:121)
    pos = _move_with_slide(pos, pos + move_xz, radius, actual_step, world,
                           p, tri_mask, consts)
    pos = pos + consts["up"] * vel[:, 1:2] * dt

    # Acceleration (:124-139)
    wish_dir = _project_on_plane(mi, ground_normal)
    wish_speed = _norm(wish_dir)
    wish_dir = torch.where(
        (wish_speed > 1)[:, None],
        wish_dir / torch.where(wish_speed == 0, 1.0, wish_speed)[:, None],
        wish_dir)
    wish_speed = wish_speed * p["move_speed"]
    zero = torch.zeros_like(wish_speed)

    def horizontal(x, y, z):
        return torch.stack([x, y, z], dim=1)

    speed = _norm(_with_y(vel, 0.0))

    # ApplyFriction (:160-175)
    drop = speed * p["ground_friction"] * dt
    new_speed = torch.clamp_min(speed - drop, 0.0)
    scale = new_speed / torch.where(speed == 0, 1.0, speed)
    still = speed < 0.1
    fric_vel = horizontal(torch.where(still, 0.0, vel[:, 0] * scale),
                          vel[:, 1],
                          torch.where(still, 0.0, vel[:, 2] * scale))

    # GroundAccelerate (:177-187) on the post-friction velocity
    add_g = wish_speed - ml.dot(_with_y(fric_vel, 0.0), wish_dir)
    accel_g = torch.minimum(p["ground_acceleration"] * wish_speed * dt, add_g)
    ground_vel = torch.where(
        (add_g > 0)[:, None],
        fric_vel + horizontal(wish_dir[:, 0] * accel_g, zero,
                              wish_dir[:, 2] * accel_g),
        fric_vel)

    # AirAccelerate (:189-209)
    ah = _with_y(vel, 0.0)
    add_a = wish_speed - ml.dot(ah, wish_dir)
    accel_a = torch.minimum(p["air_acceleration"] * wish_speed * dt, add_a)
    projected = ah + wish_dir * accel_a[:, None]
    over = _norm(projected) > p["max_air_speed"]
    proj_clamped = ml.safe_normalize(projected) \
        * p["max_air_speed"]
    air_vel = torch.where(
        (add_a > 0)[:, None],
        torch.where(over[:, None],
                    horizontal(proj_clamped[:, 0], vel[:, 1],
                               proj_clamped[:, 2]),
                    vel + horizontal(wish_dir[:, 0] * accel_a, zero,
                                     wish_dir[:, 2] * accel_a)),
        vel)

    # AirControlFunc (:211-226)
    k = p["air_control"] * dt
    ac_apply = (ml.dot(wish_dir, wish_dir) >= 0.001) \
        & (_norm(_with_y(air_vel, 0.0)) >= 0.1)
    air_vel = torch.where(
        ac_apply[:, None],
        air_vel + horizontal(wish_dir[:, 0] * k, zero, wish_dir[:, 2] * k),
        air_vel)

    # ClampAirSpeed (:199-209 via :137)
    ch = _with_y(air_vel, 0.0)
    clamped = ml.safe_normalize(ch) * p["max_air_speed"]
    air_vel = torch.where(
        (_norm(ch) > p["max_air_speed"])[:, None],
        horizontal(clamped[:, 0], air_vel[:, 1], clamped[:, 2]), air_vel)

    vel = torch.where(grounded[:, None], ground_vel, air_vel)

    noclip = state["noclip"]
    nc = noclip[:, None]
    return {
        "position": torch.where(nc, nc_pos, pos),
        "velocity": torch.where(nc, nc_vel, vel),
        "grounded": torch.where(noclip, state["grounded"], grounded),
        "ceiling": torch.where(noclip, state["ceiling"], ceiling),
        "jump_cooldown": torch.where(noclip, state["jump_cooldown"],
                                     cooldown),
        "actual_step": torch.where(noclip, state["actual_step"],
                                   actual_step),
        "noclip": noclip,
    }
