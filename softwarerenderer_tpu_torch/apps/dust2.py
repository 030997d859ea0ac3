"""The Dust2 multiplayer FPS demo on the port: the JAX package's
``apps/dust2.py`` in PyTorch, headless or windowed, on a CUDA card.

The game is the JAX package's, host loop and all: Quake-style movement on
the Dust2 map, hitscan shooting with health and respawn, UDP multiplayer
with the reference's RPC vocabulary, the view-model gun with sway and
recoil, nametags, HUD, live-tunable fog and light, noclip, AI bots,
bullet-hole decals and impact sparks.  Its frame is one call,
``fused_step(scene, sim, ctl, uniforms, ...)`` (the JAX app's jitted
``fused``, ``apps/dust2.py:1431-1495``): the character step, the bots,
the particle step, the gun matrix, the frame through the engine (the tile
kernel K1 on the default route) and the RGB8 convert, with the host's
aux values (the character's position, the bots' poses, fire and aim)
packed as bytes below the image.  It makes no host read, so a CUDA graph
can capture it later.

Around it, each frame:

  * the frame's host inputs (move, jump, dt, the emitter, the camera and
    gun, the mesh matrices, the bots' targets, the character tunables and
    the render uniforms) go to the card in one pinned, non-blocking copy
    (``utils.staging.upload``);
  * the packed frame is copied into one of ``present_depth + 1`` pinned
    host buffers without blocking and a CUDA event recorded; the frame
    submitted ``present_depth`` frames ago is joined on its event, its aux
    applied (the host pose, the bots' roster and shots) and its image
    presented, as the JAX app's fetcher threads do;
  * a shot (``shoot``, and a bot volley in ``_bot_fire``) rebuilds the
    collision world from the current mesh matrices, casts, and reads the
    hit back in one blocking read, so the hit lands on the frame of the
    click, as in the JAX app.

Run headless on the CPU or the card:

    python -m softwarerenderer_tpu_torch.apps.dust2 --headless --offline \\
        --frames 3 --out frame.png [--device cpu]

The JAX app's flags are taken (``--bots N``, ``--dedicated``, ``--kbuffer
K``, ``--raytrace [CAP]``, ``--mirror``, ``--burn-hud``, ``--record
PATH.avi``, ``--config``, networking), plus ``--device`` (default
``cuda``; the game raises without a card, it never renders on the CPU
instead).  ``--mirror`` renders the frame through
``engine.render_frame_pip``, a rear view inset at the top centre (two K1
launches in the fused step); ``--burn-hud`` burns the HUD into the frame
with the ``ops.text`` post-FX stage, its strings packed on the host and
uploaded with the frame's inputs; ``--record`` writes every presented
frame to an uncompressed AVI (``utils.video``), the in-flight frames
flushed on close, so N steps record N frames.  Without the Dust2 assets
the game plays on the JAX app's fallback arena (an 80 m plane and 12
cubes).
"""

from __future__ import annotations

import argparse
import functools
import math
import os
import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from softwarerenderer_tpu_torch.utils.profiling import span

from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import Engine, camera_matrices, to_rgb8
from softwarerenderer_tpu_torch.io_host import audio, model_loader
from softwarerenderer_tpu_torch.io_host.networking import Networking
from softwarerenderer_tpu_torch.io_host.ui import Hud, project_nametag
from softwarerenderer_tpu_torch.io_host.window import make_window
from softwarerenderer_tpu_torch.models import primitives, scene as scene_mod
from softwarerenderer_tpu_torch.models.convert import (state_to_numpy,
                                                       state_to_torch,
                                                       tree_to_torch)
from softwarerenderer_tpu_torch.ops import texture as tex_ops
from softwarerenderer_tpu_torch.sim import (
    agents_step,
    build_collision_world,
    build_waypoint_graph,
    character_step,
    default_brain_params,
    default_character_params,
    initial_agents_state,
    initial_character_state,
    raycast_batch,
    respawn_agent,
    scatter_waypoints_on_floor,
)
from softwarerenderer_tpu_torch.sim import particles as particles_mod
from softwarerenderer_tpu_torch.sim import prng
from softwarerenderer_tpu_torch.utils import hostmath as ml
from softwarerenderer_tpu_torch.utils import mathlib as tml
from softwarerenderer_tpu_torch.utils.staging import upload

F32 = np.float32

DEFAULT_ASSETS = os.environ.get("SRT_ASSETS", "Assets")

SPAWN_1 = np.asarray([-16.4, 1.5, 6.5], F32)      # Renderer.cs:30
SPAWN_2 = np.asarray([-16.5, 0.6, -23.0], F32)    # Renderer.cs:31
MAP_SCALE = 0.5                                    # Renderer.cs:32
SHOT_COOLDOWN = 0.25                               # Renderer.cs:60
SHOT_DAMAGE = 10.0                                 # Renderer.cs:223
SHOT_RANGE = 100.0                                 # Renderer.cs:176
MOUSE_SENSITIVITY = 0.1                            # Camera.cs:10
BOT_ID_BASE = 10000          # bot player ids live far above host-assigned

def bench_input(i: int) -> dict:
    """bench.py's scripted game-loop input for frame i (bench.py:129-137):
    strafe right then left every 45 frames, a slow look sweep, a jump
    every 120 frames and a shot every 90."""
    keys = {"w", "d"} if (i // 45) % 2 == 0 else {"w", "a"}
    if i % 120 == 15:
        keys = keys | {"space"}
    return {"quit": False, "keys": keys,
            "mouse_delta": (1.5 if (i // 90) % 2 == 0 else -1.5, 0.2),
            "mouse_down": i % 90 == 5, "chars": "", "gamepad": None}


def _ray_capsule_t(origin, direction, cap_a, cap_b, radius):
    """Distance along the ray (origin, unit direction) to a vertical
    capsule [cap_a, cap_b] of `radius`, or None on a miss: the host-side
    hit test of the local player, who has no mesh in the local scene
    (the JAX app's, in numpy)."""
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    d = d / max(np.linalg.norm(d), 1e-12)
    a = np.asarray(cap_a, np.float64)
    b = np.asarray(cap_b, np.float64)
    ab = b - a

    def seg_dist(t):
        p = o + d * t
        s = np.clip(np.dot(p - a, ab) / max(np.dot(ab, ab), 1e-12), 0, 1)
        return np.linalg.norm(p - (a + ab * s))
    # 64 samples over SHOT_RANGE, then a ternary refine of the closest.
    ts = np.linspace(0.0, SHOT_RANGE, 64)
    p = o[None, :] + d[None, :] * ts[:, None]
    s = np.clip((p - a) @ ab / max(float(ab @ ab), 1e-12), 0.0, 1.0)
    dd = np.linalg.norm(p - (a[None, :] + ab[None, :] * s[:, None]),
                        axis=1)
    k = int(np.argmin(dd))
    lo = ts[max(k - 1, 0)]
    hi = ts[min(k + 1, len(ts) - 1)]
    for _ in range(24):
        m1 = lo + (hi - lo) / 3
        m2 = hi - (hi - lo) / 3
        if seg_dist(m1) <= seg_dist(m2):
            hi = m2
        else:
            lo = m1
    t_best = 0.5 * (lo + hi)
    if seg_dist(t_best) > radius:
        return None
    # walk back to the entry point (first t whose distance == radius)
    while t_best > 0 and seg_dist(max(t_best - 0.01, 0.0)) <= radius:
        t_best = max(t_best - 0.01, 0.0)
    return float(t_best)


class ConnectedPlayer:
    """Renderer.cs:63-70."""

    def __init__(self, pid: int, name: str):
        self.id = pid
        self.name = name
        self.position = np.zeros(3, F32)
        self.local_position = np.zeros(3, F32)
        self.rotation = ml.QUAT_IDENTITY.copy()
        self.health = 100.0
        self.kills = 0
        self.deaths = 0


def load_player_name(path: str = "./Playername.txt") -> str:
    """Renderer.LoadPlayerNameFromFile (:86-110)."""
    try:
        with open(path) as f:
            name = f.read().strip()
        return name or "Player"
    except OSError:
        return "Player"


def _fallback_map():
    """Procedural arena when the Dust2 assets are unavailable."""
    checker = np.asarray(tex_ops.checkerboard(
        64, 8, (0.8, 0.75, 0.6, 1.0), (0.55, 0.5, 0.4, 1.0))["data"])
    meshes = [dict(primitives.plane(80.0), material=scene_mod.Material(),
                   bounds_center=np.zeros(3, F32), bounds_radius=60.0)]
    rng = np.random.default_rng(7)
    for _ in range(12):
        cube = primitives.cube(3.0)
        offs = rng.uniform(-30, 30, 3).astype(F32)
        offs[1] = 1.5
        cube["position"] = cube["position"] + offs
        c, r = scene_mod.bounding_sphere(cube["position"])
        meshes.append(dict(cube, material=scene_mod.Material(),
                           bounds_center=c, bounds_radius=r))
    model = model_loader.Model(meshes=meshes)
    return model, checker


def fused_step(scene: Dict[str, torch.Tensor], sim: Dict, ctl: Dict,
               uniforms: Dict, *, engine: Engine, world: Dict,
               tri_mask: torch.Tensor, gun_slice: tuple,
               bots: Optional[Dict] = None):
    """One game frame on the device: (sim', packed, tail), as the JAX
    app's fused step returns them.

    sim: {"char": a character state of N = 1 (its noclip set for this
    frame), "particles": the spark pool, "bots": the crowd, when there
    are bots}.  ctl: the frame's inputs as tensors on the scene's device
    (move, jump, dt, sim_dt, emitter, char_params, cam_follow,
    cam_position, gun_off, gun_rot_m, mesh_matrices; with bots
    bot_targets, bot_alive and bot_tids).  uniforms: the render uniforms,
    host values or tensors on the device (engine.frame_fn takes either,
    through engine.renderer.device_uniforms).  world and tri_mask: the
    map's collision world and its triangles; gun_slice: the gun's mesh
    ids; bots: {"waypoints", "next_hop", "brain", "ids"} on the device, or
    None.

    The character steps, the camera follows its new position (or
    ctl["cam_position"] while spectating), the gun's rows of an
    out-of-place copy of the mesh matrices take gun_rot_m translated to
    the camera, the bots step at max(dt, 1e-4), the sparks step at sim_dt
    and feed their billboards, and the frame renders through
    engine.frame_fn with the engine's shaders and params.  packed is the
    RGB8 image (H, W, 3) with the aux floats [character position, bot
    positions, rotations, fire, aim] bit-cast to bytes in rows below it;
    tail is its last image row and the aux rows.  No host read happens
    here."""
    with span("game.fused"):
        dev = scene["position"].device
        cp = ctl["char_params"]
        char = character_step(sim["char"], ctl["move"], ctl["jump"],
                              ctl["dt"], world, cp, tri_mask=tri_mask)
        new_sim = {"char": char}
        aux = [char["position"][0]]
        cam_pos = torch.where(ctl["cam_follow"],
                              char["position"][0] + cp["cam_offset"],
                              ctl["cam_position"])
        # The gun's rotation factor is host math (sway and recoil); its
        # translation rides the fresh camera (row-vector: row 3).
        eye = torch.eye(4, dtype=torch.float32, device=dev)
        trans = torch.cat([eye[:3], torch.cat([
            cam_pos + ctl["gun_off"], eye[3, 3:]])[None]])
        gun_m = tml.mat4_mul(ctl["gun_rot_m"], trans)
        gs0, gs1 = gun_slice
        mm = ctl["mesh_matrices"]
        mm = torch.cat([mm[:gs0], gun_m.expand(gs1 - gs0, 4, 4), mm[gs1:]])
        if bots is not None:
            bdt = torch.clamp_min(ctl["dt"], 1e-4)
            b = agents_step(sim["bots"], bdt, bots["waypoints"], world, cp,
                            bots["brain"], tri_mask=tri_mask,
                            next_hop=bots["next_hop"],
                            targets=ctl["bot_targets"],
                            target_alive=ctl["bot_alive"],
                            target_ids=ctl["bot_tids"],
                            self_ids=bots["ids"])
            new_sim["bots"] = b
            aux += [b["char"]["position"].reshape(-1),
                    b["rotation"].reshape(-1),
                    b["fire"].to(torch.float32), b["aim"].reshape(-1)]
        parts = particles_mod.particle_step(sim["particles"], ctl["emitter"],
                                            ctl["sim_dt"])
        new_sim["particles"] = parts
        u = dict(uniforms)
        u.update(particles_mod.particle_uniforms(parts, ctl["emitter"]))
        u["camera_position"] = cam_pos
        color = engine.frame_fn(dict(scene, mesh_matrices=mm), u,
                                params=engine.params,
                                vertex_shader=engine.vertex_shader,
                                fragment_shader=engine.fragment_shader)[0]
        rgb = to_rgb8(color)
        # aux as bytes in rows below the image, so one transfer carries
        # both (little-endian float32, as the JAX app's bitcast lays it).
        au8 = torch.cat([a.to(torch.float32).reshape(-1)
                         for a in aux]).view(torch.uint8)
        w = rgb.shape[1]
        rb = w * 3
        rows = -(-au8.numel() // rb)
        au8 = torch.cat([au8, au8.new_zeros(rows * rb - au8.numel())])
        packed = torch.cat([rgb, au8.reshape(rows, w, 3)], 0)
        return new_sim, packed, packed[rgb.shape[0] - 1:]


class _HostEvent:
    """A CUDA event's record/synchronize for a game on the CPU, where the
    copy into the host buffer has finished when copy_ returns."""

    def record(self) -> None:
        pass

    def synchronize(self) -> None:
        pass


class Dust2Game:
    def __init__(self, server: str = "127.0.0.1", port: int = 7777,
                 width: int = 800, height: int = 600,
                 render_scale: float = 0.25, headless: bool = False,
                 assets_dir: str = DEFAULT_ASSETS,
                 player_name: Optional[str] = None,
                 max_players: int = 8, out: Optional[str] = None,
                 offline: bool = False, seed: Optional[int] = None,
                 reliable: bool = False, migrate: bool = False,
                 net_batch: float = 0.0, upnp: bool = False,
                 bots: int = 0, bot_skill: str = "normal",
                 burn_hud: bool = False, record: Optional[str] = None,
                 record_fps: float = 30.0, mirror: bool = False,
                 kbuffer: int = 1, raytrace: int = 0, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Dust2Game(device='cuda') needs a CUDA device "
                               "and none is available")
        self.window = make_window(width, height, render_scale,
                                  headless=headless or None, out_path=out)
        # The HUD burned into the frame on the device (ops.text's post-FX
        # stage), so headless captures and recordings carry it; the host
        # overlay still draws for a window.
        self.burn_hud = burn_hud
        self._recorder = None
        if record:
            from softwarerenderer_tpu_torch.utils.video import AviWriter
            self._recorder = AviWriter(record, fps=record_fps)
        # Rear-view mirror: a second camera as a top-centre inset of the
        # same frame (engine.render_frame_pip).
        self.mirror = mirror
        self._frame_fn = None
        if mirror:
            from softwarerenderer_tpu_torch.engine import render_frame_pip
            self._frame_fn = render_frame_pip
        self._raytraced = bool(raytrace)
        if raytrace:
            if mirror:
                raise SystemExit("--raytrace and --mirror both own the "
                                 "frame program; pick one")
            from softwarerenderer_tpu_torch.ops.raytrace import (
                render_frame_raytraced,
            )
            self._frame_fn = functools.partial(
                render_frame_raytraced, cluster_cap=int(raytrace))
        # Ordered translucency: K-layer depth-peeled frames.
        self.kbuffer = max(1, int(kbuffer))
        self.hud = Hud()
        self.layout_path = "hud_layout.json"
        self.hud.load_layout(self.layout_path)
        self.max_players = max_players
        self.player_name = player_name or load_player_name()
        self.assets_dir = assets_dir
        self.rng = random.Random(seed)
        self.reliable = reliable

        self._load_scene()
        self._init_state()

        # Networking bootstrap (Renderer.cs:75-82).
        self.net = Networking()
        self.net.rpc_batch_window = max(0.0, net_batch)
        self.net.upnp_enabled = upnp
        if migrate:
            # Host migration: the callback runs on the migration thread
            # and only queues the signal; the main loop consumes it.
            self.net.peer_timeout = 2.0
            self.net.enable_host_migration = True
            self._migrated_signal: Optional[bool] = None
            self.net.on_migrated.append(
                lambda is_host: setattr(self, "_migrated_signal", is_host))
        if not offline:
            self.net.log = lambda s: None
            if not self.net.connect(server, port):
                raise SystemExit(1)  # Renderer.cs:115-118
            self.net.send_rpc(
                "ConnectedPlayer",
                [str(self.net.client_id), self.player_name],
                buffer_rpc=True, reliable=self.reliable)
        self.players: List[ConnectedPlayer] = []
        self._init_bots(bots, bot_skill)

    def _on_migrated(self, is_host: bool) -> None:
        """Landed in the migrated session (main thread): drop the old
        roster and re-announce."""
        self.players = []
        self.hud.add_chat("* host migrated"
                          + (" (you are the new host)" if is_host else ""))
        self.net.send_rpc(
            "ConnectedPlayer",
            [str(self.net.client_id), self.player_name],
            buffer_rpc=True, reliable=self.reliable)

    # The burned-in HUD text's fixed shape (ops.text): slots x chars.
    HUD_TEXT_SLOTS = 16
    HUD_TEXT_CHARS = 48

    def _burn_hud_entries(self, tags):
        """The host HUD's key elements (crosshair, health, fps, chat, the
        spectator banner, nametags; Renderer.cs:310-656) packed as the
        text overlay's uniforms (ops.text.pack_text).  tags: the frame's
        nametags."""
        from softwarerenderer_tpu_torch.ops import text as text_ops
        p = self.engine.params
        # The post chain runs on the supersampled frame: lay out there.
        rw, rh = p.width * p.ssaa, p.height * p.ssaa
        f = self._hud_font
        cw, chh = int(f["cell_w"]), int(f["cell_h"])
        hs = self.hud.state
        entries = [("+", (rw // 2 - cw // 2, rh // 2 - chh // 2),
                    (1.0, 1.0, 1.0, 0.9))]
        entries.append((f"hp {max(0, int(hs.health))}",
                        (4, rh - chh - 4), (0.35, 1.0, 0.35)))
        fps = self.stats.counters()["fps"]
        fps_s = f"{fps:5.1f} fps"
        entries.append((fps_s, (rw - len(fps_s) * cw - 4, 4),
                        (1.0, 1.0, 0.4)))
        row = 4
        if hs.spectating:
            entries.append((f"spectating {hs.spectating}", (4, row),
                            (1.0, 0.75, 0.2)))
            row += chh + 2
        for msg in hs.chat_messages[-4:]:
            entries.append((msg, (4, row), (1.0, 1.0, 1.0, 0.85)))
            row += chh + 1
        # Nametags project at window resolution; rescale to render pixels.
        sx = rw / max(1, self.window.width)
        sy = rh / max(1, self.window.height)
        for tx, ty, name in tags:
            entries.append((name,
                            (int(tx * sx - len(name) * cw * 0.5),
                             int(ty * sy - chh)), (0.9, 0.9, 1.0)))
        return text_ops.pack_text(entries, max_strings=self.HUD_TEXT_SLOTS,
                                  max_chars=self.HUD_TEXT_CHARS)

    # -- AI bots (sim/agents.py) --------------------------------------------

    # Difficulty presets: brain tunables only (no speed cheats).
    BOT_SKILLS = {
        "easy":   {"aim_spread": 0.09, "fire_cooldown": 1.6,
                   "sight_range": 18.0, "fire_range": 15.0},
        "normal": {},                            # default_brain_params
        "hard":   {"aim_spread": 0.012, "fire_cooldown": 0.45,
                   "sight_range": 40.0, "fire_range": 32.0},
    }

    def _init_bots(self, n: int, skill: str = "normal") -> None:
        """Spawn n host-owned AI bots: one batched agent crowd stepped in
        the fused step, announced to peers as ordinary players."""
        self._bot_ids: List[int] = []
        self._bots_state = None
        self._bots_dev = None
        if n <= 0:
            return
        if self.net.is_connected and not self.net.is_host:
            self.hud.add_chat("* --bots ignored (this peer is not host)")
            return
        n = min(n, max(0, self.max_players - 1))
        if n <= 0:
            return
        self._bot_brain = default_brain_params()
        for k, v in self.BOT_SKILLS.get(skill, {}).items():
            self._bot_brain[k] = np.float32(v)
        # Patrol targets: the two spawns plus points dropped onto the map
        # floor around them, routed by a shortest-path waypoint graph.
        self._bot_waypoints = scatter_waypoints_on_floor(
            self.world, [SPAWN_1, SPAWN_2], n_points=16,
            seed=self.rng.randrange(1 << 30),
            tri_mask=self._map_tri_mask_dev)
        self._bot_next_hop = build_waypoint_graph(
            self.world, self._bot_waypoints, tri_mask=self._map_tri_mask_dev)
        starts, wp0 = [], []
        for i in range(n):
            base = SPAWN_1 if i % 2 == 0 else SPAWN_2
            starts.append(base + np.asarray(
                [self.rng.uniform(-1.5, 1.5), 0.0,
                 self.rng.uniform(-1.5, 1.5)], F32))
            wp0.append(self.rng.randrange(len(self._bot_waypoints)))
        # The bots' key draws JAX's stream from the same seed, so a port
        # game and a JAX game from one seed spawn the same crowd.
        self._bots_state = initial_agents_state(
            np.stack(starts),
            key=prng.prng_key(self.rng.randrange(1 << 30), self.device),
            waypoint_idx=np.asarray(wp0, np.int32), device=self.device)
        self._bot_ids_arr = np.asarray([BOT_ID_BASE + i for i in range(n)],
                                       np.int32)
        for i in range(n):
            bid = BOT_ID_BASE + i
            self._bot_ids.append(bid)
            bot = ConnectedPlayer(bid, f"BOT {i + 1}")
            bot.position = np.asarray(starts[i], F32)
            self.players.append(bot)
            if self.net.is_connected:
                self.net.send_rpc("ConnectedPlayer", [str(bid), bot.name],
                                  buffer_rpc=True, reliable=self.reliable)
        if not self.net.is_connected:
            # Offline practice range: a roster entry for the local player.
            self.players.append(
                ConnectedPlayer(self.net.client_id, self.player_name))

    def _bots_static(self) -> Optional[Dict]:
        """The crowd's fixed inputs on the device, made at the first step
        (as the JAX app reads self._bot_brain at its first trace: retune
        it before the first step)."""
        if self._bots_state is None:
            return None
        if self._bots_dev is None:
            self._bots_dev = {
                "waypoints": torch.from_numpy(self._bot_waypoints).to(
                    self.device),
                "next_hop": torch.from_numpy(self._bot_next_hop).to(
                    self.device),
                "brain": tree_to_torch(self._bot_brain, self.device),
                "ids": torch.from_numpy(self._bot_ids_arr).to(self.device)}
        return self._bots_dev

    def _bot_ctl(self) -> dict:
        """The crowd's per-frame inputs as fixed-shape arrays (a varying
        roster changes no shape): slot 0 = the local player, then every
        rendered ConnectedPlayer."""
        m = self.max_players + 1
        tpos = np.zeros((m, 3), F32)
        talive = np.zeros((m,), bool)
        tids = np.full((m,), -1, np.int32)
        # The local player's pipelined host pose, not a blocking read.
        tpos[0] = self.cam_position \
            - np.asarray(self.char_params["cam_offset"])
        talive[0] = self.spectate_idx < 0       # spectators are ghosts
        tids[0] = self.net.client_id
        for i, p in enumerate(self.players[:self.max_players]):
            if p.id == self.net.client_id:
                continue    # slot 0 already carries us, live position
            tpos[1 + i] = np.asarray(p.position)
            talive[1 + i] = True
            tids[1 + i] = p.id
        return {"bot_targets": tpos, "bot_alive": talive, "bot_tids": tids}

    def _apply_bot_aux(self, pos, rot, fire, aim) -> None:
        """Publish the joined crowd poses to the roster and the wire, then
        turn the step's fire/aim outputs into hitscan shots."""
        by_id = {p.id: p for p in self.players}
        for i, bid in enumerate(self._bot_ids):
            p = by_id.get(bid)
            if p is None:
                continue
            p.position = pos[i]
            p.rotation = rot[i]
            if self.net.is_connected:
                self.net.send_rpc("Update", [
                    str(bid),
                    repr(float(pos[i, 0])), repr(float(pos[i, 1])),
                    repr(float(pos[i, 2])),
                    repr(float(rot[i, 0])), repr(float(rot[i, 1])),
                    repr(float(rot[i, 2])), repr(float(rot[i, 3]))])
        if fire.any():
            eye = pos[fire] + np.asarray(
                [0, float(self._bot_brain["eye_height"]), 0], F32)
            self._bot_fire(eye, aim[fire],
                           [b for b, f in zip(self._bot_ids, fire) if f])

    def _shot_targets(self):
        """(active remote slots {index: player}, the hitscan's triangle
        mask: the map plus their models)."""
        active_slots = {}
        for i, p in enumerate(self.players):
            if p.id == self.net.client_id or i >= self.max_players:
                continue
            active_slots[i] = p
        shoot_mask = self._map_tri_mask.copy()
        tri_mesh = self._tri_mesh
        for slot in active_slots:
            lo, hi = self.player_slices[slot]
            shoot_mask |= (tri_mesh >= lo) & (tri_mesh < hi)
        return active_slots, shoot_mask

    def _shoot_rays(self, origins: np.ndarray, dirs: np.ndarray,
                    shoot_mask: np.ndarray) -> Dict[str, np.ndarray]:
        """The hitscan: the collision world rebuilt from the current mesh
        matrices, one raycast wave, and its hits read back in one blocking
        read (the rays, mask and matrices go up in one non-blocking
        copy)."""
        with span("game.shot"):
            d = upload({"o": origins.astype(F32), "d": dirs.astype(F32),
                        "mask": shoot_mask, "mm": self._mesh_matrices},
                       self.device)
            world = build_collision_world(dict(self.engine.scene,
                                               mesh_matrices=d["mm"]))
            out = raycast_batch(d["o"], d["d"], world, tri_mask=d["mask"])
            packed = torch.cat([
                out["hit"].to(torch.float32)[:, None],
                out["distance"][:, None], out["point"], out["normal"],
                out["tri"].view(torch.float32)[:, None]], 1)
            host = packed.cpu().numpy()
        self.shot_reads += 1
        return {"hit": host[:, 0] > 0.5, "distance": host[:, 1],
                "point": host[:, 2:5], "normal": host[:, 5:8],
                "tri": np.ascontiguousarray(host[:, 8]).view(np.int32)}

    def _bot_fire(self, origins: np.ndarray, dirs: np.ndarray,
                  bot_ids: List[int]) -> None:
        """Resolve bot shots through the same batched hitscan as human
        shots, plus an analytic capsule test for the local player (who
        has no model in their own scene)."""
        active_slots, shoot_mask = self._shot_targets()
        tri_mesh = self._tri_mesh
        # (A bot never hits itself: its own model's triangles are all
        # backfaces from within, culled by the hitscan.)
        out = self._shoot_rays(origins, dirs, shoot_mask)
        hits, dists = out["hit"], out["distance"]
        points, normals, tris = out["point"], out["normal"], out["tri"]

        # Local-player capsule (axis = char position ± height/2).
        h = float(self.char_params["height"])
        my_pos = np.asarray(self._char_pos_host, F32)
        cap_a = my_pos - np.asarray([0, h * 0.5, 0], F32)
        cap_b = my_pos + np.asarray([0, h * 0.5, 0], F32)
        cap_r = h * 0.35

        for k, bid in enumerate(bot_ids):
            hit_dist = float(dists[k]) if hits[k] else float("inf")
            t_cap = (_ray_capsule_t(origins[k], dirs[k], cap_a, cap_b,
                                    cap_r)
                     if self.spectate_idx < 0 else None)
            if self.net.is_connected:
                self.net.send_rpc("Shoot", [          # muzzle report
                    repr(float(origins[k][0])), repr(float(origins[k][1])),
                    repr(float(origins[k][2]))])
            if t_cap is not None and t_cap < min(hit_dist, SHOT_RANGE):
                # bot shot us: same PlayerHit path a human shooter uses
                if self.net.is_connected:
                    self.net.send_rpc("PlayerHit", [
                        str(self.net.client_id), str(bid),
                        str(SHOT_DAMAGE)], reliable=self.reliable)
                else:
                    self._handle_player_hit(self.net.client_id,
                                            SHOT_DAMAGE, attacker_id=bid)
                continue
            if not hits[k] or hit_dist >= SHOT_RANGE:
                continue
            mesh_id = int(tri_mesh[int(tris[k])])
            hit_player = None
            for slot, p in active_slots.items():
                lo, hi = self.player_slices[slot]
                if lo <= mesh_id < hi:
                    hit_player = p
                    break
            if hit_player is not None:
                if self.net.is_connected:
                    self.net.send_rpc("PlayerHit", [
                        str(hit_player.id), str(bid),
                        str(SHOT_DAMAGE)], reliable=self.reliable)
                else:
                    self._handle_player_hit(hit_player.id, SHOT_DAMAGE,
                                            attacker_id=bid)
            elif mesh_id < self.n_map:
                if self.net.is_connected:
                    self.net.send_rpc("LevelHit", [
                        str(bid),
                        repr(float(points[k][0])), repr(float(points[k][1])),
                        repr(float(points[k][2])),
                        repr(float(normals[k][0])),
                        repr(float(normals[k][1])),
                        repr(float(normals[k][2]))])
                else:
                    self._place_decal(points[k], normals[k])

    # -- scene assembly -------------------------------------------------------

    def _load_scene(self):
        fallback_tex = np.asarray(tex_ops.checkerboard(
            64, 8, (0.8, 0.75, 0.6, 1.0), (0.55, 0.5, 0.4, 1.0))["data"])
        dust2_path = os.path.join(self.assets_dir, "dust2", "scene.gltf")
        gun_path = os.path.join(self.assets_dir, "Gun", "scene.gltf")
        player_path = os.path.join(self.assets_dir, "gordon_freeman",
                                   "scene.gltf")
        self.map_matrix = ml.scale(MAP_SCALE)
        if os.path.exists(dust2_path):
            # rigid_animation=False: the map's packed vertices feed the
            # collision world and the hitscan
            map_model = model_loader.load_model(dust2_path,
                                                rigid_animation=False)
        else:
            map_model, fallback_tex = _fallback_map()
            self.map_matrix = np.eye(4, dtype=F32)

        insts = model_loader.model_instances(
            map_model, self.map_matrix, fallback_texture=fallback_tex)
        self.n_map = len(insts)

        # View-model gun (Renderer.cs:33, 476-477).
        self.gun_base = (ml.scale(0.02)
                         @ ml.matrix_from_yaw_pitch_roll(
                             -90 * math.pi / 180, 0.0, 0.0)).astype(F32)
        if os.path.exists(gun_path):
            gun_model = model_loader.load_model(gun_path)
        else:
            gun_model = model_loader.Model(meshes=[dict(
                primitives.cube(1.0), material=scene_mod.Material(),
                bounds_center=np.zeros(3, F32), bounds_radius=1.0)])
            self.gun_base = ml.scale(0.1).astype(F32)
        gun_insts = model_loader.model_instances(
            gun_model, np.eye(4, dtype=F32), fallback_texture=fallback_tex)
        self.gun_slice = (len(insts), len(insts) + len(gun_insts))
        insts += gun_insts

        # MAX_PLAYERS player-model slots.
        if os.path.exists(player_path):
            player_model = model_loader.load_model(player_path,
                                                   rigid_animation=False)
        else:
            player_model = model_loader.Model(meshes=[dict(
                primitives.cube(1.0), material=scene_mod.Material(),
                bounds_center=np.zeros(3, F32), bounds_radius=1.0)])
        self.player_slices = []
        for _ in range(self.max_players):
            pinsts = model_loader.model_instances(
                player_model, np.eye(4, dtype=F32),
                fallback_texture=fallback_tex)
            self.player_slices.append((len(insts), len(insts) + len(pinsts)))
            insts += pinsts

        # Bullet-hole decal slots: pre-packed hidden quads; placing one
        # rewrites a mesh matrix and the visibility mask.
        self.n_decals = 24
        decal_tex = np.zeros((16, 16, 4), F32)
        yy, xx = np.mgrid[0:16, 0:16]
        inside = (yy - 7.5) ** 2 + (xx - 7.5) ** 2 <= 7.5 ** 2
        decal_tex[..., :3] = 0.06
        decal_tex[..., 3] = np.where(inside, 0.85, 0.0)
        self.decal_slice = (len(insts), len(insts) + self.n_decals)
        for _ in range(self.n_decals):
            insts.append(scene_mod.MeshInstance(
                primitives.plane(0.1), np.eye(4, dtype=F32),
                texture=decal_tex))
        self._decal_next = 0
        self._decal_used = 0

        # Impact sparks: one shared billboard pool; each bullet impact
        # queues a one-frame emitter burst at the hit point.
        self.n_particles = 256
        insts.append(scene_mod.MeshInstance(
            particles_mod.particles_mesh(self.n_particles, extent=1000.0),
            np.eye(4, dtype=F32),
            texture=particles_mod.soft_disc_texture(16),
            particles=self.n_particles))

        # Flip-book animation sources: one entry per animated mesh
        # instance, the host Model whose clock drives its frame index.
        srcs = ([map_model] * self.n_map
                + [gun_model] * (self.gun_slice[1] - self.gun_slice[0])
                + [player_model] * (len(insts) - self.gun_slice[1]))
        self._anim_sources = [src for inst, src in zip(insts, srcs)
                              if inst.animation_positions is not None]

        self.scene = scene_mod.build_scene_buffers(insts)
        self.n_meshes = self.scene["mesh_matrices"].shape[0]

        params = RenderParams(*self.window.render_size,
                              kbuffer=self.kbuffer)
        if self.burn_hud:
            from softwarerenderer_tpu_torch.ops import text as text_ops
            from softwarerenderer_tpu_torch.utils import font as font_mod
            self._hud_font = font_mod.build_font(cell_h=14)
            # In params, so every engine rebuild keeps the stage.
            params = params.replace(post_fx=params.post_fx + (
                text_ops.text_overlay_fx(self._hud_font),))
        self.engine = Engine(self.scene, params, frame_fn=self._frame_fn,
                             device=self.device)
        u = self.engine.uniforms
        if self.mirror:
            u["pip_view"] = {
                "camera_position": np.zeros(3, F32),
                "camera_rotation": ml.QUAT_IDENTITY.copy(),
                "mesh_visible": np.ones(self.n_meshes, bool),
            }
        if self.burn_hud:
            u["hud_text"] = text_ops.pack_text(
                [], max_strings=self.HUD_TEXT_SLOTS,
                max_chars=self.HUD_TEXT_CHARS)
        # The game's live-tuned defaults (Renderer.cs:39-46).
        u["fog_start"] = np.float32(1.0)
        u["fog_end"] = np.float32(25.0)
        u["fog_color"] = np.asarray([1.0, 0.62, 0.5, 1.0], F32)
        u["light_direction"] = np.asarray(
            ml.euler_degrees_to_direction([-45.0, -45.0, 0.0]), F32)
        u["light_color"] = np.ones(4, F32)
        u["clear_color"] = np.asarray([0.9137, 0.7098, 0.6588, 1.0], F32)
        u["fov_degrees"] = np.float32(90.0)
        u["near_clip"] = np.float32(0.1)
        u["far_clip"] = np.float32(1000.0)
        u["mesh_visible"] = np.ones(self.n_meshes, bool)

        # Collision world: the map only (Renderer.cs:438 passes Dust2Model).
        self._tri_mesh = np.asarray(self.scene["tri_mesh_id"])
        self._map_tri_mask = self._tri_mesh < self.n_map
        self._map_tri_mask_dev = torch.from_numpy(self._map_tri_mask).to(
            self.device)
        self.world = build_collision_world(self.engine.scene)

    def _init_state(self):
        self.char_params = default_character_params()
        spawn_first = self.rng.random() > 0.5   # Renderer.cs:426-436
        spawn = SPAWN_1 if spawn_first else SPAWN_2
        self.cam_rotation = (ml.QUAT_IDENTITY.copy() if spawn_first else
                             ml.quat_from_axis_angle(
                                 np.asarray([0, 1, 0], F32), math.pi))
        self.char = initial_character_state(spawn, device=self.device)
        self.cam_position = spawn + self.char_params["cam_offset"]
        self.weapon_sway = ml.QUAT_IDENTITY.copy()
        self.recoil = ml.QUAT_IDENTITY.copy()
        self.time = 0.0
        self.last_shot = -10.0
        self.mouse_locked = True
        self.window.set_mouse_capture(True)
        self.noclip = False
        self.spectate_idx = -1          # -1 = own view; else players[] index
        self._prev_keys = set()
        self._tune_idx = 0
        self._drag_row = None           # active pointer-dragged slider
        self.mouse_sensitivity = MOUSE_SENSITIVITY  # Camera.cs:10, tunable
        # Right-stick look rate: mouse-pixel-equivalents/s at full
        # deflection.
        self.stick_look_speed = 600.0
        self.wireframe = False
        self._wire_engine = None
        # The pipelined present: each frame's packed output is copied to
        # one of present_depth + 1 host buffers without blocking and
        # joined present_depth frames later, so the presented frame and
        # the host pose trail the simulation by that many steps (the
        # simulation state itself stays exact).  Entries: (event, host
        # buffer, rgb fetched, image rows, aux floats).
        self._out_q: List = []
        self._rings: Dict = {}
        self._frame_i = 0
        self.present_depth = int(os.environ.get("SRT_PRESENT_DEPTH", 2))
        # Test hook: fetch the rgb frame only every Nth step (the aux rows
        # always come back).
        self._present_nth = 1
        self._blank_frame = None
        # Blocking reads of shot results (shoot and the bots' volleys).
        self.shot_reads = 0
        # Host cache of the character's position (the fused step's aux
        # output, present_depth frames stale).
        self._char_pos_host = np.asarray(spawn, F32)
        # live-tuned light euler (Renderer.cs:42 LightEulerDegrees)
        self.light_euler = {"light_yaw": np.float32(-45.0),
                            "light_pitch": np.float32(-45.0)}
        from softwarerenderer_tpu_torch.utils.profiling import FrameStats
        self.stats = FrameStats()
        self._mesh_matrices = np.asarray(
            self.scene["mesh_matrices"]).copy()
        # Impact sparks: quiet emitter (rate 0) until a burst is queued.
        self._particles = particles_mod.initial_particle_state(
            self.n_particles, seed=0, device=self.device)
        em = particles_mod.default_emitter_params()
        em.update(rate=np.float32(0.0),
                  base_velocity=np.zeros(3, F32),
                  spread=np.float32(2.2),
                  lifetime=np.asarray([0.25, 0.6], F32),
                  size=np.asarray([0.05, 0.01], F32),
                  color0=np.asarray([1.0, 0.85, 0.4, 1.0], F32),
                  color1=np.asarray([1.0, 0.3, 0.05, 0.0], F32))
        self._emitter = em
        self._bursts: List[tuple] = []

    # -- per-frame ------------------------------------------------------------

    def step(self, dt: float, inputs: Optional[dict] = None) -> None:
        """One frame: input → net → sim → render → present
        (Renderer.Update ordering, :258-268)."""
        with span("game.step"):
            self._step(dt, inputs)

    def _step(self, dt: float, inputs: Optional[dict]) -> None:
        self.time += dt
        inp = inputs if inputs is not None else self.window.poll()
        if inp["quit"]:
            self.window.should_close = True

        self._update_mouse_look(inp, dt)
        # weapon sway/recoil (Renderer.cs:261-262)
        self.weapon_sway = np.asarray(ml.quat_slerp(
            self.weapon_sway, self.cam_rotation, 15.0 * dt), F32)
        self.recoil = np.asarray(ml.quat_slerp(
            self.recoil, ml.QUAT_IDENTITY, 5.0 * dt), F32)

        # Join the step submitted present_depth frames ago: updates the
        # host pose cache and the bot roster and yields the frame to
        # present below.
        joined_rgb = self._join_fused()
        self._update_network()
        self._update_character(dt, inp)   # host staging for the fused step
        self._update_toggles(inp)
        self._update_pointer(inp)
        # Scoreboard (hold Tab).
        self.hud.state.show_scoreboard = "tab" in inp["keys"] \
            and not self.hud.state.chat_active
        if self.hud.state.show_scoreboard:
            self.hud.state.scoreboard = [
                (q.name, q.kills, q.deaths, q.health)
                for q in sorted(self.players,
                                key=lambda q: (-q.kills, q.deaths))]
        # Edge-trigger the gamepad fire (semi-auto, like the mouse).
        gp_held = bool(inp.get("gamepad") and inp["gamepad"]["fire"])
        gp_fire = gp_held and not getattr(self, "_gp_fire_held", False)
        self._gp_fire_held = gp_held
        if (inp["mouse_down"] or gp_fire) and self.mouse_locked \
                and self.spectate_idx < 0 \
                and self.time - self.last_shot >= SHOT_COOLDOWN:
            self.shoot()
            self.last_shot = self.time

        self._render(dt, joined_rgb)
        self.hud.tick(dt)

    def _update_mouse_look(self, inp, dt: float = 0.0):
        """HandleMouseMovement (Renderer.cs:140-161), plus right-stick
        look at `stick_look_speed` mouse-pixel-equivalents per second."""
        if not self.mouse_locked:
            return
        dx, dy = inp["mouse_delta"]
        gp = inp.get("gamepad")
        if gp is not None:
            dx += gp["look"][0] * self.stick_look_speed * dt
            dy += gp["look"][1] * self.stick_look_speed * dt
        if dx == 0 and dy == 0:
            return
        euler = np.asarray(ml.quat_to_euler_degrees(self.cam_rotation))
        yaw = euler[1] - dx * self.mouse_sensitivity
        pitch = float(np.clip(euler[0] - dy * self.mouse_sensitivity,
                              -89, 89))
        self.cam_rotation = np.asarray(ml.quat_from_yaw_pitch_roll(
            yaw * math.pi / 180, pitch * math.pi / 180,
            euler[2] * math.pi / 180), F32)

    def _update_network(self):
        """Pose RPC every frame (Renderer.cs:270-287) + inbound handling."""
        if not self.net.is_connected:
            return
        euler = np.asarray(ml.quat_to_euler_degrees(self.cam_rotation))
        rot = ml.quat_from_yaw_pitch_roll(euler[1] * math.pi / 180, 0.0, 0.0)
        # The pipelined host pose, not a read of the device state.
        pos = self._char_pos_host
        self.net.send_rpc("Update", [
            str(self.net.client_id),
            repr(float(pos[0])), repr(float(pos[1])), repr(float(pos[2])),
            repr(float(rot[0])), repr(float(rot[1])),
            repr(float(rot[2])), repr(float(rot[3]))])
        sig = getattr(self, "_migrated_signal", None)
        if sig is not None:
            self._migrated_signal = None
            self._on_migrated(sig)       # main thread: safe to touch state
        for method, params, sender in self.net.poll_rpcs():
            self._handle_rpc(method, params)

    def _handle_rpc(self, method: str, params: List[str]):
        """The game's RPC switch (Renderer.cs:866-965)."""
        try:
            if method == "ConnectedPlayer" and len(params) >= 2:
                pid = int(params[0])
                if not any(p.id == pid for p in self.players):
                    self.players.append(ConnectedPlayer(pid, params[1]))
                self.hud.add_chat(f"{params[1]} has joined the game!")
            elif method == "Update" and len(params) >= 8:
                pid = int(params[0])
                p = next((x for x in self.players if x.id == pid), None)
                if p is not None:
                    p.position = np.asarray(
                        [float(params[1]), float(params[2]),
                         float(params[3])], F32)
                    p.rotation = np.asarray(
                        [float(params[4]), float(params[5]),
                         float(params[6]), float(params[7])], F32)
            elif method in ("DisconnectedPlayer", "ClientDisconnected") \
                    and len(params) >= 1:
                pid = int(params[0])
                p = next((x for x in self.players if x.id == pid), None)
                if p is not None:
                    self.players.remove(p)
            elif method == "ChatMessage" and len(params) >= 2:
                self.hud.add_chat(f"{params[0]}: {params[1]}")
            elif method == "PlayerHit" and len(params) >= 3:
                self._handle_player_hit(int(params[0]), float(params[2]),
                                        attacker_id=int(params[1]))
            elif method == "LevelHit" and len(params) >= 7:
                self._place_decal(
                    np.asarray([float(params[1]), float(params[2]),
                                float(params[3])], F32),
                    np.asarray([float(params[4]), float(params[5]),
                                float(params[6])], F32))
            elif method == "Shoot" and len(params) >= 3:
                shot_pos = np.asarray([float(params[0]), float(params[1]),
                                       float(params[2])], F32)
                dist = float(np.linalg.norm(self.cam_position - shot_pos))
                wav = os.path.join(self.assets_dir, "pistol.wav")
                # stereo pan by the shot's bearing
                right = np.asarray(ml.quat_rotate(
                    np.asarray([1, 0, 0], F32), self.cam_rotation), F32)
                audio.play_sound(
                    wav, audio.shot_volume(dist),
                    pan=audio.direction_pan(self.cam_position, right,
                                            shot_pos))
        except (ValueError, IndexError):
            pass

    def _handle_player_hit(self, pid: int, damage: float,
                           attacker_id: int = -1):
        """PlayerHit: damage, kill message, respawn, heal (Renderer.cs:
        911-950), kill feed and scoreboard counters."""
        p = next((x for x in self.players if x.id == pid), None)
        if p is None:
            return
        p.health = max(0.0, p.health - damage)
        if pid == self.net.client_id:
            self.hud.state.health = p.health
        if p.health <= 0:
            self.hud.add_chat(f"{p.name} was killed!")
            attacker = next((x for x in self.players
                             if x.id == attacker_id), None)
            self.hud.add_kill(attacker.name if attacker else "?", p.name)
            if attacker is not None and attacker is not p:
                attacker.kills += 1
            p.deaths += 1
            if pid == self.net.client_id:
                spawn_first = self.rng.random() > 0.5
                spawn = SPAWN_1 if spawn_first else SPAWN_2
                self.char["position"] = upload(spawn.reshape(1, 3),
                                               self.device)
                self.cam_rotation = (
                    ml.QUAT_IDENTITY.copy() if spawn_first else
                    np.asarray(ml.quat_from_axis_angle(
                        np.asarray([0, 1, 0], F32), math.pi), F32))
            elif pid in self._bot_ids and self._bots_state is not None:
                # This peer owns the bot: respawn it (remote peers just
                # heal it and wait for the owner's next Update).
                spawn = SPAWN_1 if self.rng.random() > 0.5 else SPAWN_2
                d = upload({"index": np.int32(self._bot_ids.index(pid)),
                            "position": spawn}, self.device)
                self._bots_state = respawn_agent(
                    self._bots_state, d["index"], d["position"])
                p.position = np.asarray(spawn, F32)
            p.health = 100.0
            if pid == self.net.client_id:
                self.hud.state.health = 100.0
            if not self.net.is_connected:
                return                      # offline: nobody to notify
            self.net.send_rpc("Update", [
                str(p.id),
                repr(float(p.position[0])), repr(float(p.position[1])),
                repr(float(p.position[2])),
                repr(float(p.rotation[0])), repr(float(p.rotation[1])),
                repr(float(p.rotation[2])), repr(float(p.rotation[3]))])

    def _update_character(self, dt: float, inp):
        """UpdateCharacterController (Renderer.cs:356-383), host side:
        this frame's move and jump from the input and the camera basis
        (the step runs in fused_step; noclip rides the frame's upload)."""
        keys = inp["keys"]
        front = np.asarray(ml.quat_rotate(
            np.asarray([0, 0, -1], F32), self.cam_rotation))
        right = np.asarray(ml.normalize(np.cross(front, [0.0, 1.0, 0.0])))
        front[1] = 0
        n = np.linalg.norm(front)
        front = front / n if n > 0 else front
        right[1] = 0
        n = np.linalg.norm(right)
        right = right / n if n > 0 else right

        move = np.zeros(3, F32)
        gp = inp.get("gamepad")
        gp_jump = bool(gp and gp["jump"])
        if not self.hud.state.chat_active and self.spectate_idx < 0:
            if "w" in keys:
                move += front
            if "s" in keys:
                move -= front
            if "a" in keys:
                move -= right
            if "d" in keys:
                move += right
            if gp is not None:
                # left stick: analog strafing/advance
                move += right * F32(gp["move"][0]) \
                    + front * F32(gp["move"][1])
            if "space" in keys or gp_jump:
                move[1] += 1
            if "shift" in keys:
                move[1] -= 1
        jump = ("space" in keys or gp_jump) \
            and not self.hud.state.chat_active and self.spectate_idx < 0

        self._move = move.astype(F32)
        self._jump = np.bool_(jump)

    # Live-tunable parameters: the reference's debug panel
    # (Renderer.cs:690-817).  kind grammar: "u"=scalar uniform,
    # "u:key:i"=uniform vector component, "c"=character scalar,
    # "c:key:i"=character vector component, "l"=light euler,
    # "rot:i"=camera euler (pitch/yaw/roll), "pos:i"=player position
    # component, "s:attr"=app attribute, "w"=render scale.
    # name -> (kind, step, lo, hi)
    TUNABLES = [
        ("near_clip", "u", 0.01, 0.001, 1.0),            # Renderer.cs:690
        ("far_clip", "u", 10.0, 0.001, 5000.0),
        ("cam_pitch", "rot:0", 1.0, -89.0, 89.0),        # :700-707
        ("cam_yaw", "rot:1", 1.0, -360.0, 360.0),
        ("cam_roll", "rot:2", 1.0, -180.0, 180.0),
        ("mouse_sensitivity", "s:mouse_sensitivity", 0.01, 0.01, 1.0),
        ("fov_degrees", "u", 1.0, 1.0, 179.0),
        ("pos_x", "pos:0", 0.5, -500.0, 500.0),          # :712
        ("pos_y", "pos:1", 0.5, -500.0, 500.0),
        ("pos_z", "pos:2", 0.5, -500.0, 500.0),
        ("cam_offset_x", "c:cam_offset:0", 0.05, -2.0, 2.0),
        ("cam_offset_y", "c:cam_offset:1", 0.05, -2.0, 2.0),
        ("cam_offset_z", "c:cam_offset:2", 0.05, -2.0, 2.0),
        ("move_speed", "c", 0.25, 0.5, 20.0),            # :724-744
        ("max_air_speed", "c", 0.25, 0.5, 30.0),
        ("jump_force", "c", 0.25, 0.5, 20.0),
        ("radius", "c", 0.01, 0.05, 1.0),
        ("height", "c", 0.05, 0.2, 3.0),
        ("ground_acceleration", "c", 0.25, 0.1, 20.0),
        ("air_acceleration", "c", 0.05, 0.0, 20.0),
        ("ground_friction", "c", 0.25, 0.0, 20.0),
        ("air_control", "c", 0.05, 0.0, 2.0),
        ("step_size", "c", 0.05, 0.05, 3.0),
        ("gravity_x", "c:gravity:0", 0.5, -20.0, 20.0),
        ("gravity_y", "c:gravity:1", 0.5, -20.0, 20.0),
        ("gravity_z", "c:gravity:2", 0.5, -20.0, 20.0),
        ("render_scale", "w", 0.05, 0.1, 1.0),           # :795
        ("fog_start", "u", 0.5, 0.0, 100.0),             # :800-802
        ("fog_end", "u", 0.5, 1.0, 500.0),
        ("fog_r", "u:fog_color:0", 0.05, 0.0, 1.0),
        ("fog_g", "u:fog_color:1", 0.05, 0.0, 1.0),
        ("fog_b", "u:fog_color:2", 0.05, 0.0, 1.0),
        ("fog_a", "u:fog_color:3", 0.05, 0.0, 1.0),
        ("light_yaw", "l", 5.0, -180.0, 180.0),          # :803-804
        ("light_pitch", "l", 5.0, -89.0, 89.0),
        ("light_r", "u:light_color:0", 0.05, 0.0, 4.0),
        ("light_g", "u:light_color:1", 0.05, 0.0, 4.0),
        ("light_b", "u:light_color:2", 0.05, 0.0, 4.0),
        ("light_a", "u:light_color:3", 0.05, 0.0, 4.0),
        ("clear_r", "u:clear_color:0", 0.05, 0.0, 1.0),
        ("clear_g", "u:clear_color:1", 0.05, 0.0, 1.0),
        ("clear_b", "u:clear_color:2", 0.05, 0.0, 1.0),
        ("clear_a", "u:clear_color:3", 0.05, 0.0, 1.0),
    ]

    def _update_toggles(self, inp):
        """Esc mouse-capture + V noclip edge toggles (Renderer.cs:385-402),
        the debug panel and [-/=] live tuning."""
        keys = inp["keys"]
        if "escape" in keys and "escape" not in self._prev_keys:
            self.mouse_locked = not self.mouse_locked
            self.window.set_mouse_capture(self.mouse_locked)
        if "v" in keys and "v" not in self._prev_keys \
                and not self.hud.state.chat_active:
            self.noclip = not self.noclip
        if "b" in keys and "b" not in self._prev_keys \
                and not self.hud.state.chat_active:
            # Spectator mode: B cycles through the other players, then
            # back to the own view.
            others = self._spectate_targets()
            if others:
                self.spectate_idx += 1
                if self.spectate_idx >= len(others):
                    self.spectate_idx = -1
            else:
                self.spectate_idx = -1
        # debug panel + tuning via typed characters
        for ch in inp["chars"]:
            if self.hud.state.chat_active:
                break
            if ch == "`":
                self.hud.state.show_debug = not self.hud.state.show_debug
            elif ch == "p":
                # wireframe debug mode (Renderer.cs:799-804)
                self.wireframe = not self.wireframe
            elif ch == "o":
                p = self.engine.params                     # SSAA 2x
                self._swap_params(p.replace(ssaa=2 if p.ssaa == 1 else 1))
            elif ch == "k":
                p = self.engine.params                     # SSAO
                self._swap_params(p.replace(ssao=not p.ssao))
            elif ch == "j":
                p = self.engine.params                     # bloom
                self._swap_params(p.replace(bloom=not p.bloom))
            elif ch == "u":
                p = self.engine.params                     # FXAA
                self._swap_params(p.replace(fxaa=not p.fxaa))
            elif ch == "m":
                p = self.engine.params                     # mip-mapping
                self._swap_params(p.replace(
                    use_mipmaps=not bool(p.use_mipmaps)))
            elif ch == "n" and "tangent" in self.scene:
                # normal-mapped shading (only when a loaded asset carries
                # tangents; the fallback arena has none)
                self.normal_mapped = not getattr(self, "normal_mapped",
                                                 False)
                from softwarerenderer_tpu_torch.ops import normalmap as _nm
                kw = {}
                if self.normal_mapped:
                    kw = dict(vertex_shader=_nm.normal_mapped_vertex_shader,
                              fragment_shader=_nm.
                              normal_mapped_fragment_shader)
                self._rebuild_engine(self.engine.params, **kw)
            elif ch == "[":
                self._tune_idx = (self._tune_idx - 1) % len(self.TUNABLES)
            elif ch == "]":
                self._tune_idx = (self._tune_idx + 1) % len(self.TUNABLES)
            elif ch in "-=":
                name, kind, step, lo, hi = self.TUNABLES[self._tune_idx]
                delta = step if ch == "=" else -step
                self._tunable_adjust(name, kind, delta, lo, hi)
        # chat input (T to open, Renderer.cs:587-656 simplified)
        hs = self.hud.state
        if hs.chat_active:
            hs.chat_input += inp["chars"]
            if "return" in keys and "return" not in self._prev_keys:
                text = hs.chat_input.strip()
                if text and self.net.is_connected:
                    me = next((p for p in self.players
                               if p.id == self.net.client_id), None)
                    self.net.send_rpc("ChatMessage",
                                      [me.name if me else self.player_name,
                                       text], reliable=self.reliable)
                hs.chat_input = ""
                hs.chat_active = False
        elif "t" in keys and "t" not in self._prev_keys:
            hs.chat_active = True
            hs.chat_input = ""
        self._prev_keys = set(keys)

    # -- engine rebuilds ------------------------------------------------------

    def _rebuild_engine(self, params, **shaders) -> None:
        """A new engine on the same scene tensors (no re-upload) with new
        params or shaders; the uniforms carry over."""
        old = self.engine
        self.engine = Engine(old.scene, params, frame_fn=self._frame_fn,
                             device=self.device, **shaders)
        self.engine.uniforms = old.uniforms
        self._wire_engine = None

    def _swap_params(self, params):
        """Rebuild the engine with new RenderParams (the toggles)."""
        self._rebuild_engine(params, vertex_shader=self.engine.vertex_shader,
                             fragment_shader=self.engine.fragment_shader)

    def _rebuild_engine_for_scale(self):
        """Render-scale change = new framebuffer shapes
        (UpdateRenderScale, MainWindow.cs:268-274)."""
        new_size = self.window.render_size
        if new_size == (self.engine.params.width,
                        self.engine.params.height):
            return
        self._swap_params(self.engine.params.replace(width=new_size[0],
                                                     height=new_size[1]))

    def _tunable_value(self, name: str, kind: str) -> float:
        parts = kind.split(":")
        if parts[0] == "u":
            return float(self.engine.uniforms[name] if len(parts) == 1
                         else self.engine.uniforms[parts[1]][int(parts[2])])
        if parts[0] == "c":
            return float(self.char_params[name] if len(parts) == 1
                         else self.char_params[parts[1]][int(parts[2])])
        if parts[0] == "l":
            return float(self.light_euler[name])
        if parts[0] == "rot":
            return float(np.asarray(
                ml.quat_to_euler_degrees(self.cam_rotation))[int(parts[1])])
        if parts[0] == "pos":
            # pipelined host copy: the debug panel redraws every frame
            return float(self._char_pos_host[int(parts[1])])
        if parts[0] == "s":
            return float(getattr(self, parts[1]))
        return float(self.window.render_scale)

    def _tunable_adjust(self, name: str, kind: str, delta: float,
                        lo: float, hi: float) -> None:
        """Apply one keyed debug-panel step (Renderer.cs:690-817)."""
        self._tunable_set(name, kind,
                          self._tunable_value(name, kind) + delta, lo, hi)

    def _tunable_set(self, name: str, kind: str, value: float,
                     lo: float, hi: float) -> None:
        """Write one tunable's absolute value (keyed steps and pointer
        slider drags); only the render scale rebuilds the engine."""
        v = min(hi, max(lo, float(value)))
        parts = kind.split(":")
        if parts[0] == "w":
            self.window.render_scale = v
            self._rebuild_engine_for_scale()
            return
        if parts[0] == "s":
            setattr(self, parts[1], np.float32(v))
            return
        if parts[0] == "rot":
            euler = np.asarray(ml.quat_to_euler_degrees(self.cam_rotation))
            euler[int(parts[1])] = v
            self.cam_rotation = np.asarray(ml.quat_from_yaw_pitch_roll(
                euler[1] * math.pi / 180, euler[0] * math.pi / 180,
                euler[2] * math.pi / 180), F32)
            return
        if parts[0] == "pos":
            i = int(parts[1])
            pos = self.char["position"].cpu().numpy()[0].copy()
            pos[i] = v
            self.char["position"] = upload(pos.reshape(1, 3), self.device)
            # keep the panel's pipelined readback coherent immediately
            self._char_pos_host = pos.astype(F32)
            return
        if parts[0] == "l":
            self.light_euler[name] = np.float32(v)
            self.engine.uniforms["light_direction"] = np.asarray(
                ml.euler_degrees_to_direction(
                    [self.light_euler["light_pitch"],
                     self.light_euler["light_yaw"], 0.0]), F32)
            return
        tgt = self.engine.uniforms if parts[0] == "u" else self.char_params
        if len(parts) == 1:
            tgt[name] = np.float32(v)
        else:
            key, i = parts[1], int(parts[2])
            vec = np.asarray(tgt[key], F32).copy()
            vec[i] = v
            tgt[key] = vec

    def _update_pointer(self, inp) -> None:
        """Pointer interaction with the HUD while the cursor is released
        (Esc): drag the tunables panel's sliders, click the chat row to
        focus it (io_host.ui's panel geometry)."""
        from softwarerenderer_tpu_torch.io_host import ui as ui_mod
        pos = inp.get("mouse_pos")
        if self.mouse_locked or pos is None:
            self._drag_row = None
            return
        held = bool(inp.get("mouse_held"))
        clicked = bool(inp.get("mouse_down"))
        hs = self.hud.state
        w, h = self.window.width, self.window.height
        panel = ui_mod._anchor(self.hud.layout.panel_pos, w, h)
        if clicked:
            if hs.show_debug:
                row = ui_mod.panel_hit_row(panel, len(self.TUNABLES), pos)
                if row is not None:
                    self._drag_row = row
                    self._tune_idx = row
            if ui_mod.point_in_rect(pos, ui_mod.chat_input_rect(
                    self.hud.layout.chat_pos, len(hs.chat_messages),
                    hs.max_chat_lines, w, h)):
                hs.chat_active = True
        if held and self._drag_row is not None and hs.show_debug:
            name, kind, _step, lo, hi = self.TUNABLES[self._drag_row]
            self._tunable_set(name, kind, ui_mod.slider_value(
                panel, self._drag_row, pos[0], lo, hi), lo, hi)
        if not held:
            self._drag_row = None

    # -- shooting -------------------------------------------------------------

    def _player_matrix(self, p: ConnectedPlayer) -> np.ndarray:
        """CreatePlayerMatrix (Renderer.cs:251-256)."""
        h = float(self.char_params["height"])
        flip = ml.quat_from_axis_angle(np.asarray([0, 1, 0], F32), math.pi)
        rot = ml.quat_mul(p.rotation, flip)
        return (ml.scale(h / 2)
                @ ml.matrix_from_quaternion(rot)
                @ ml.translation(p.local_position
                                 - np.asarray([0, h / 2, 0], F32))
                ).astype(F32)

    def shoot(self):
        """Hitscan (Renderer.cs:172-249): one batched raycast against the
        packed soup, the winner classified map or player by mesh id; the
        hit is read back before this frame renders."""
        origin = self.cam_position.astype(F32)
        direction = np.asarray(ml.quat_rotate(
            np.asarray([0, 0, -1], F32), self.cam_rotation), F32)
        active_slots, shoot_mask = self._shot_targets()
        out = self._shoot_rays(origin[None], direction[None], shoot_mask)
        hit = bool(out["hit"][0])
        dist = float(out["distance"][0])
        point = out["point"][0]
        normal = out["normal"][0]
        mesh_id = int(self._tri_mesh[int(out["tri"][0])]) if hit else -1

        if self.net.is_connected:
            self.net.send_rpc("Shoot", [repr(float(origin[0])),
                                        repr(float(origin[1])),
                                        repr(float(origin[2]))])
        if hit and dist < SHOT_RANGE:
            hit_player = None
            for slot, p in active_slots.items():
                lo, hi = self.player_slices[slot]
                if lo <= mesh_id < hi:
                    hit_player = p
                    break
            if self.net.is_connected:
                if hit_player is not None:
                    self.net.send_rpc("PlayerHit", [
                        str(hit_player.id), str(self.net.client_id),
                        str(SHOT_DAMAGE)], reliable=self.reliable)
                elif mesh_id < self.n_map:
                    self.net.send_rpc("LevelHit", [
                        str(self.net.client_id),
                        repr(float(point[0])), repr(float(point[1])),
                        repr(float(point[2])),
                        repr(float(normal[0])), repr(float(normal[1])),
                        repr(float(normal[2]))])
                    # (send_rpc's local echo places our own decal)
            elif hit_player is not None:
                # Offline: no RPC loop to echo the hit; apply directly.
                self._handle_player_hit(hit_player.id, SHOT_DAMAGE,
                                        attacker_id=self.net.client_id)
            elif mesh_id < self.n_map:
                self._place_decal(point, normal)
        # recoil kick (Renderer.cs:248): 45 is in radians in the reference.
        self.recoil = np.asarray(ml.quat_mul(
            self.recoil, ml.quat_from_yaw_pitch_roll(0.0, 45.0, 0.0)), F32)

    def _place_decal(self, point: np.ndarray, normal: np.ndarray) -> None:
        """A bullet-hole quad at a LevelHit: the plane's +y onto the
        surface normal, offset slightly along it (a ring of pre-packed
        slots; the oldest holes recycle), and a spark burst there."""
        n = np.asarray(normal, F32)
        ln = float(np.linalg.norm(n))
        if ln < 1e-6:
            return
        n = n / ln
        a = np.asarray([0, 1, 0], F32) if abs(n[1]) < 0.9 \
            else np.asarray([1, 0, 0], F32)
        t = np.cross(a, n)
        t = t / np.linalg.norm(t)
        b = np.cross(n, t)
        m = np.eye(4, dtype=F32)
        m[0, :3], m[1, :3], m[2, :3] = t, n, b
        m[3, :3] = np.asarray(point, F32) + n * F32(0.01)
        slot = self.decal_slice[0] + self._decal_next
        self._mesh_matrices[slot] = m
        self._decal_next = (self._decal_next + 1) % self.n_decals
        self._decal_used = min(self._decal_used + 1, self.n_decals)
        self._bursts.append((np.asarray(point, F32) + n * F32(0.02),
                             n * F32(2.0)))

    # -- render ---------------------------------------------------------------

    def _spectate_targets(self) -> List["ConnectedPlayer"]:
        """Other connected players, in scoreboard order (stable cycling)."""
        return [p for p in self.players if p.id != self.net.client_id]

    def _fetch(self, entry):
        """Wait for a submitted frame's copy; returns (rgb or None, aux)."""
        event, buf, with_rgb, rh, n_aux = entry
        event.synchronize()
        host = buf.numpy()
        if not with_rgb:
            return None, host[1:].ravel()[:4 * n_aux].view(np.float32).copy()
        aux = host[rh:].ravel()[:4 * n_aux].view(np.float32).copy()
        return host[:rh].copy(), aux

    def _join_fused(self):
        """Pop the frame submitted `present_depth` frames ago and apply
        its aux outputs (pose cache, bot roster + fire).  Returns a
        (rgb8_or_None,) 1-tuple, rgb8 None when that frame's image was
        skipped (_present_nth), or None while the pipeline is still
        filling (the bootstrap case)."""
        if len(self._out_q) < max(1, self.present_depth):
            return None
        with span("game.join"):
            rgb, aux = self._fetch(self._out_q.pop(0))
        self._apply_aux(aux)
        return (rgb,)

    def _apply_aux(self, aux: np.ndarray) -> None:
        self._char_pos_host = np.asarray(aux[:3], F32).copy()
        self.cam_position = self._char_pos_host \
            + np.asarray(self.char_params["cam_offset"])
        if self._bot_ids:
            n = len(self._bot_ids)
            k = 3
            pos = aux[k:k + 3 * n].reshape(n, 3)
            k += 3 * n
            rot = aux[k:k + 4 * n].reshape(n, 4)
            k += 4 * n
            fire = aux[k:k + n] > 0.5
            k += n
            aim = aux[k:k + 3 * n].reshape(n, 3)
            self._apply_bot_aux(pos, rot, fire, aim)

    def _host_buffer(self, src: torch.Tensor) -> torch.Tensor:
        """The next of present_depth + 1 host buffers of src's shape
        (pinned on the card), in turn: a buffer is written again only
        after its frame was joined and its image copied out."""
        n = max(1, self.present_depth) + 1
        key = tuple(src.shape)
        ring = self._rings.get(key)
        if ring is None or len(ring["bufs"]) != n:
            ring = {"bufs": [torch.empty(key, dtype=torch.uint8,
                                         pin_memory=src.is_cuda)
                             for _ in range(n)], "next": 0}
            self._rings[key] = ring
        buf = ring["bufs"][ring["next"] % n]
        ring["next"] += 1
        return buf

    def _submit(self, src: torch.Tensor, with_rgb: bool, rh: int,
                n_aux: int) -> None:
        """Copy a frame's packed output (or its tail) to a host buffer
        without blocking, and queue it with an event for the join."""
        buf = self._host_buffer(src)
        buf.copy_(src, non_blocking=True)
        event = torch.cuda.Event() if src.is_cuda else _HostEvent()
        event.record()
        self._out_q.append((event, buf, with_rgb, rh, n_aux))

    def _render(self, dt: float, joined_rgb=None):
        """RenderScene (Renderer.cs:404-419): update matrices + one frame."""
        mm = self._mesh_matrices
        visible = np.ones(self.n_meshes, bool)
        # Unplaced decal slots stay hidden.
        visible[self.decal_slice[0] + self._decal_used:
                self.decal_slice[1]] = False

        # Spectator camera: watch through the target's eyes; hide the gun
        # and the target's own model.
        spectated = None
        if self.spectate_idx >= 0:
            others = self._spectate_targets()
            if self.spectate_idx < len(others):
                spectated = others[self.spectate_idx]
            else:
                self.spectate_idx = -1
        self.hud.state.spectating = spectated.name if spectated else ""

        # Gun matrix (Renderer.cs:476-477).
        sway_recoil = ml.quat_mul(self.weapon_sway, self.recoil)
        gun_off = ml.quat_rotate(np.asarray(
            [0.05, -0.05, -0.15 + abs(float(self.recoil[0]) / 5)], F32),
            self.cam_rotation)
        gun_m = (self.gun_base @ ml.matrix_from_quaternion(sway_recoil)
                 @ ml.translation(self.cam_position + gun_off)).astype(F32)
        for i in range(*self.gun_slice):
            mm[i] = gun_m

        # Remote players: interpolation + slot matrices (Renderer.cs:503-540).
        factor = 1.0 - math.exp(-12.0 * dt)
        used = set()
        for i, p in enumerate(self.players):
            p.local_position = p.local_position \
                + (p.position - p.local_position) * F32(factor)
            if p.id == self.net.client_id or i >= self.max_players:
                continue
            pm = self._player_matrix(p)
            lo, hi = self.player_slices[i]
            for j in range(lo, hi):
                mm[j] = pm
            used.add(i)
        for slot in range(self.max_players):
            if slot not in used:
                lo, hi = self.player_slices[slot]
                visible[lo:hi] = False

        u = self.engine.uniforms
        cam_pos, cam_rot = self.cam_position, self.cam_rotation
        if spectated is not None:
            cam_pos = np.asarray(spectated.local_position, F32) \
                + np.asarray(self.char_params["cam_offset"], F32)
            cam_rot = np.asarray(spectated.rotation, F32)
            for i in range(*self.gun_slice):        # no view weapon
                visible[i] = False
            si = self.players.index(spectated)
            if si < self.max_players:               # not our own eyes' body
                lo, hi = self.player_slices[si]
                visible[lo:hi] = False
        u["camera_position"] = np.asarray(cam_pos, F32)
        u["camera_rotation"] = np.asarray(cam_rot, F32)
        u["mesh_visible"] = visible
        if self.mirror:
            # Rear view: the same eye turned 180 degrees (pitch kept), the
            # view-model gun hidden.
            e = np.asarray(ml.quat_to_euler_degrees(cam_rot))
            rear = ml.quat_from_yaw_pitch_roll(
                (e[1] + 180.0) * math.pi / 180, e[0] * math.pi / 180,
                e[2] * math.pi / 180)
            vis2 = visible.copy()
            vis2[self.gun_slice[0]:self.gun_slice[1]] = False
            u["pip_view"] = {"camera_position": np.asarray(cam_pos, F32),
                             "camera_rotation": np.asarray(rear, F32),
                             "mesh_visible": vis2}

        # Impact sparks: pop one queued burst into this step's emitter.
        em = dict(self._emitter)
        sim_dt = np.float32(max(dt, 1e-3))
        if self._bursts:
            origin, vel = self._bursts.pop(0)
            em["origin"] = origin
            em["base_velocity"] = vel
            em["rate"] = np.float32(24.0) / sim_dt
        if self._anim_sources:
            # Advance each distinct model's flip-book clock once.
            for m in {id(m): m for m in self._anim_sources}.values():
                m.advance_animation(dt)
            u["anim_frame"] = np.asarray(
                [m._frame_index for m in self._anim_sources], np.int32)
        if self.wireframe:
            if self._wire_engine is None:
                from softwarerenderer_tpu_torch.config import DebugMode
                self._wire_engine = Engine(
                    self.engine.scene,
                    self.engine.params.replace(
                        debug_mode=DebugMode.WIREFRAME),
                    frame_fn=self._frame_fn, device=self.device)
                self._wire_engine.uniforms = self.engine.uniforms
            eng = self._wire_engine
        else:
            eng = self.engine
        tags = self._nametags()
        if self.burn_hud:
            u["hud_text"] = self._burn_hud_entries(tags)
        ctl = {
            "move": self._move, "jump": self._jump,
            "dt": np.float32(dt if dt > 0 else 1 / 60),
            "sim_dt": sim_dt, "emitter": em,
            "char_params": self.char_params,
            "cam_follow": np.bool_(spectated is None),
            "cam_position": np.asarray(cam_pos, F32),
            "gun_off": np.asarray(gun_off, F32),
            "gun_rot_m": (self.gun_base
                          @ ml.matrix_from_quaternion(sway_recoil)
                          ).astype(F32),
            "mesh_matrices": mm,
        }
        if self._bots_state is not None:
            ctl.update(self._bot_ctl())
        # One upload a frame: ctl, noclip and, on the raster routes, the
        # render uniforms with the mirror's pip_view and the HUD's text
        # (the ray-traced frame computes its camera on the host, so its
        # uniforms stay host values).
        staged = {"ctl": ctl, "noclip": np.asarray([self.noclip])}
        if not self._raytraced:
            staged["uniforms"] = u
        with span("game.upload"):
            d = upload(staged, self.device)
        sim = {"char": dict(self.char, noclip=d["noclip"]),
               "particles": self._particles}
        if self._bots_state is not None:
            sim["bots"] = self._bots_state
        new_sim, packed_dev, tail_dev = fused_step(
            eng.scene, sim, d["ctl"], d.get("uniforms", u), engine=eng,
            world=self.world, tri_mask=self._map_tri_mask_dev,
            gun_slice=self.gun_slice, bots=self._bots_static())
        self.char = new_sim["char"]
        self._particles = new_sim["particles"]
        if "bots" in new_sim:
            self._bots_state = new_sim["bots"]

        self._frame_i += 1
        fetch_rgb = (self._present_nth <= 1
                     or self._frame_i % self._present_nth == 0)
        n_aux = 3 + 11 * len(self._bot_ids)
        with span("game.present_copy"):
            self._submit(packed_dev if fetch_rgb else tail_dev, fetch_rgb,
                         eng.params.height, n_aux)
        if joined_rgb is None:
            # Bootstrap: repeat the first frame while the pipeline fills
            # (a present-only peek; its aux applies when it pops).
            rgb = self._fetch(self._out_q[0])[0]
        else:
            rgb = joined_rgb[0]
        if rgb is None:          # rgb fetch skipped (_present_nth > 1)
            if self._blank_frame is None or \
                    self._blank_frame.shape[:2] != self.window.render_size[::-1]:
                rw, rh = self.window.render_size
                self._blank_frame = np.zeros((rh, rw, 3), np.uint8)
            rgb = self._blank_frame
        if self._recorder is not None and joined_rgb is not None:
            # Bootstrap repeats are not recorded; close() flushes the
            # frames in flight, so an N-step run records frames 0..N-1.
            self._recorder.add(rgb)
        self.hud.state.rendered_meshes = int(visible.sum())
        self.hud.state.nametags = tags
        rw, rh = self.window.render_size
        n_tris = self.scene["indices"].shape[0]
        self.stats.frame(pixels=rw * rh, triangles=n_tris)
        if self.hud.state.show_debug:
            lines = self.stats.debug_lines()
            p = self.engine.params
            lines.append(f"ssaa [o]: {p.ssaa}x   mips [m]: "
                         f"{bool(p.use_mipmaps)}   wire [p]: "
                         f"{self.wireframe}   nmap [n]: "
                         f"{getattr(self, 'normal_mapped', False)}   "
                         f"ssao [k]: {p.ssao}   bloom [j]: {p.bloom}   "
                         f"fxaa [u]: {p.fxaa}")
            self.hud.state.debug_lines = lines
            self.hud.state.tunables = [
                (name, self._tunable_value(name, kind), lo, hi)
                for name, kind, _step, lo, hi in self.TUNABLES]
            self.hud.state.tune_selected = self._tune_idx
        self.window.present(rgb, overlay=self.hud)

    def _nametags(self):
        """Renderer.RenderPlayerNametags (:544-585); the camera on the
        host, from the host uniforms."""
        view, proj = camera_matrices(
            {k: self.engine.uniforms[k] for k in
             ("camera_position", "camera_rotation", "fov_degrees",
              "near_clip", "far_clip")},
            self.window.width, self.window.height)
        view, proj = view.numpy(), proj.numpy()
        tags = []
        for p in self.players:
            if p.id == self.net.client_id:
                continue
            xy = project_nametag(p.local_position, view, proj,
                                 self.window.width, self.window.height)
            if xy is not None:
                tags.append((xy[0], xy[1], p.name))
        return tags

    # -- main loop ------------------------------------------------------------

    def run(self, frames: Optional[int] = None):
        last = time.perf_counter()
        n = 0
        try:
            while not self.window.should_close:
                now = time.perf_counter()
                dt = min(now - last, 0.1)
                last = now
                self.step(dt if dt > 0 else 1 / 60)
                n += 1
                if frames is not None and n >= frames:
                    break
        finally:
            self.close()

    def save_state(self, path: str) -> None:
        """Checkpoint the deterministic simulation state (utils.checkpoint),
        in the JAX app's layout (a character of its own, keys as uint32):
        a restored checkpoint replays the same input script equally."""
        from softwarerenderer_tpu_torch.utils import checkpoint
        checkpoint.save(path, {
            "char": state_to_numpy(self.char, single=True),
            "cam_rotation": np.asarray(self.cam_rotation),
            "cam_position": np.asarray(self.cam_position),
            "weapon_sway": np.asarray(self.weapon_sway),
            "recoil": np.asarray(self.recoil),
            "time": np.float64(self.time),
            "last_shot": np.float64(self.last_shot),
            "noclip": np.asarray(self.noclip),
            "char_params": {k: np.asarray(v)
                            for k, v in self.char_params.items()},
            "particles": state_to_numpy(self._particles),
            # The bots' state (keys included), or a replay would diverge
            # the moment an agent steps.
            "bots": (None if self._bots_state is None
                     else state_to_numpy(self._bots_state)),
        })

    def load_state(self, path: str) -> None:
        from softwarerenderer_tpu_torch.utils import checkpoint
        st = checkpoint.load(path)
        self.char = state_to_torch(st["char"], self.device)
        self.cam_rotation = np.asarray(st["cam_rotation"], F32)
        self.cam_position = np.asarray(st["cam_position"], F32)
        self.weapon_sway = np.asarray(st["weapon_sway"], F32)
        self.recoil = np.asarray(st["recoil"], F32)
        self.time = float(st["time"])
        self.last_shot = float(st["last_shot"])
        self.noclip = bool(st["noclip"])
        self.char_params = dict(st["char_params"])
        if "particles" in st:       # absent in pre-particle checkpoints
            self._particles = state_to_torch(st["particles"], self.device)
        if st.get("bots") is not None and self._bots_state is not None:
            # Only meaningful when this run spawned the same crowd.
            self._bots_state = state_to_torch(st["bots"], self.device)
        # Drop the in-flight frames: they belong to the pre-restore
        # timeline; the pipeline refills (bootstrap) from the restored
        # state.
        self._out_q = []
        self._char_pos_host = np.asarray(st["char"]["position"], F32)
        self.cam_position = np.asarray(st["cam_position"], F32)

    def close(self):
        if self._recorder is not None:
            for entry in self._out_q:
                # The frames still in flight (see _render).
                rgb = self._fetch(entry)[0]
                if rgb is None:
                    continue
                try:
                    self._recorder.add(rgb)
                except ValueError:
                    pass                      # size changed mid-recording
            self._recorder.close()
            self._recorder = None
        try:
            self.hud.save_layout(self.layout_path)
        except OSError:
            pass
        self._out_q = []
        if self.net.is_connected:
            self.net.send_rpc("DisconnectedPlayer",
                              [str(self.net.client_id)])
            self.net.close()
        audio.cleanup()
        self.window.close()


def serve(port: int = 7777, net_batch: float = 0.0, quiet: bool = False,
          stop_event=None, poll_hz: float = 100.0) -> None:
    """Dedicated relay server: host a session with no scene, renderer,
    physics or player slot (the JAX app's, on the port's networking).
    Binds the port, assigns client ids, replays buffered joins to late
    joiners, relays Update/chat/hit traffic and serves reliable-delivery
    acks.  Blocks until `stop_event` (a threading.Event) is set; with the
    default None it serves until interrupted."""
    net = Networking()
    net.rpc_batch_window = max(0.0, net_batch)
    # Without a player host, client→client relay is the server's job.
    net.relay_client_rpcs = True
    # late joiners must learn of earlier clients: buffer their joins
    net.buffer_relayed_methods = {"ConnectedPlayer"}
    # a playerless host expires crashed clients itself
    net.peer_timeout = 10.0
    if quiet:
        net.log = lambda s: None
    # Direct bind, no election: the server answers pings once it returns.
    if not net.host(port):
        raise SystemExit(f"port {port} is unavailable "
                         f"(already hosting a session?)")
    if not quiet:
        print(f"dedicated server on :{port}")
    try:
        while stop_event is None or not stop_event.is_set():
            net.poll_rpcs()     # drain + flush batch windows / resends
            time.sleep(1.0 / poll_hz)
    except KeyboardInterrupt:
        pass
    finally:
        net.close()


def apply_config_tunables(game: "Dust2Game", cfg) -> None:
    """Apply an AppConfig's uniform and physics tunables to a constructed
    game: the JSON/env config path for every value the debug panel can
    tune live."""
    u = game.engine.uniforms
    u["fov_degrees"] = np.float32(cfg.fov_degrees)
    u["near_clip"] = np.float32(cfg.near_clip)
    u["far_clip"] = np.float32(cfg.far_clip)
    u["fog_start"] = np.float32(cfg.fog_start)
    u["fog_end"] = np.float32(cfg.fog_end)
    u["fog_color"] = np.asarray(cfg.fog_color, F32)
    u["light_color"] = np.asarray(cfg.light_color, F32)
    u["clear_color"] = np.asarray(cfg.clear_color, F32)
    u["light_direction"] = np.asarray(
        ml.euler_degrees_to_direction(list(cfg.light_euler_degrees)), F32)
    game.light_euler = {"light_yaw": np.float32(cfg.light_euler_degrees[1]),
                        "light_pitch":
                            np.float32(cfg.light_euler_degrees[0])}
    game.mouse_sensitivity = float(cfg.sensitivity)
    cp = dict(game.char_params)
    cp.update(
        gravity=np.asarray([0.0, cfg.gravity_y, 0.0], F32),
        height=np.float32(cfg.char_height),
        radius=np.float32(cfg.char_radius),
        step_size=np.float32(cfg.step_size),
        move_speed=np.float32(cfg.move_speed),
        jump_force=np.float32(cfg.jump_force),
        ground_acceleration=np.float32(cfg.ground_acceleration),
        air_acceleration=np.float32(cfg.air_acceleration),
        max_air_speed=np.float32(cfg.max_air_speed),
        ground_friction=np.float32(cfg.ground_friction),
        air_control=np.float32(cfg.air_control))
    game.char_params = cp


def main(argv=None):
    from softwarerenderer_tpu_torch.utils import appconfig

    # --config pre-parse: the config's values become argparse defaults,
    # so explicit CLI flags win over JSON/env.
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default=None)
    pre_args, _ = pre.parse_known_args(argv)
    cfg = appconfig.load(pre_args.config)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("server", nargs="?", default=cfg.server)
    ap.add_argument("--port", type=int, default=cfg.port)
    ap.add_argument("--width", type=int, default=cfg.width)
    ap.add_argument("--height", type=int, default=cfg.height)
    ap.add_argument("--render-scale", type=float,
                    default=cfg.render_scale)
    ap.add_argument("--headless", action="store_true")
    ap.add_argument("--reliable", action="store_true",
                    help="acked/resent delivery for join/hit/chat RPCs "
                         "(all peers must run this framework)")
    ap.add_argument("--migrate", action="store_true",
                    help="host migration: if the host vanishes, the "
                         "lowest-id client takes over the session "
                         "(all peers must run this framework)")
    ap.add_argument("--net-batch", type=float, default=0.0,
                    metavar="SECONDS",
                    help="coalesce outgoing RPCs within this window into "
                         "one datagram per peer (0 = off; all peers must "
                         "run this framework)")
    ap.add_argument("--bots", type=int, default=0,
                    help="host-owned AI bots (batched agent crowd; "
                         "ignored when joining as a client)")
    ap.add_argument("--bot-skill", choices=sorted(Dust2Game.BOT_SKILLS),
                    default="normal",
                    help="bot difficulty preset (brain tunables only; "
                         "bot physics match human players)")
    ap.add_argument("--upnp", action="store_true",
                    help="map the session UDP port on the LAN gateway "
                         "when hosting (UPnP IGD)")
    ap.add_argument("--offline", action="store_true",
                    help="skip networking entirely")
    ap.add_argument("--dedicated", action="store_true",
                    help="run a dedicated relay server on --port (no "
                         "scene, no rendering, no player slot, no card)")
    ap.add_argument("--config", default=None, metavar="PATH.json",
                    help="JSON config (utils/appconfig; ./srt.json is "
                         "auto-loaded, SRT_* env vars override; explicit "
                         "CLI flags win over both)")
    ap.add_argument("--mirror", action="store_true",
                    help="rear-view mirror: a second camera rendered as "
                         "a picture-in-picture inset of the frame")
    ap.add_argument("--kbuffer", type=int, default=1, metavar="K",
                    help="K-layer ordered translucency (depth-peeled "
                         "tile-kernel passes); 1 = single winner "
                         "(default)")
    ap.add_argument("--raytrace", type=int, nargs="?", const=24,
                    default=0, metavar="CAP",
                    help="render through the ray tracer (primary rays and "
                         "hard shadows through the ray-bundle sweep "
                         "kernel); CAP = per-bundle cluster budget "
                         "(default 24)")
    ap.add_argument("--burn-hud", action="store_true",
                    help="burn the HUD into the frame on the device, so "
                         "headless captures and recordings carry it")
    ap.add_argument("--record", default=None, metavar="PATH.avi",
                    help="record presented frames to an uncompressed AVI")
    ap.add_argument("--record-fps", type=float, default=30.0,
                    help="playback rate stamped into the recording")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default=None, help="headless PNG output path")
    ap.add_argument("--assets", default=cfg.assets_dir or DEFAULT_ASSETS)
    ap.add_argument("--name", default=cfg.player_name)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the game (default cuda; cpu "
                         "runs the kernels' plain twins)")
    args = ap.parse_args(argv)

    if args.dedicated:
        serve(port=args.port, net_batch=args.net_batch)
        return

    game = Dust2Game(server=args.server, port=args.port, width=args.width,
                     height=args.height, render_scale=args.render_scale,
                     headless=args.headless, assets_dir=args.assets,
                     player_name=args.name, out=args.out,
                     offline=args.offline, reliable=args.reliable,
                     migrate=args.migrate, net_batch=args.net_batch,
                     upnp=args.upnp, bots=args.bots,
                     bot_skill=args.bot_skill, burn_hud=args.burn_hud,
                     record=args.record, record_fps=args.record_fps,
                     mirror=args.mirror, kbuffer=args.kbuffer,
                     raytrace=args.raytrace, device=args.device)
    apply_config_tunables(game, cfg)
    game.run(frames=args.frames)


if __name__ == "__main__":
    main()
