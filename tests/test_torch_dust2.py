"""The port's Dust2 game (softwarerenderer_tpu_torch.apps.dust2) on the
CPU, against the JAX package's game and on its own.

One JAX game and one port game, both offline and headless at 160x120
from seed 1 with 2 bots, spawn the same player, bots, waypoints and routes;
JAX's fused step, captured on each of the 30 frames of a script (a look
down, a jump, a shot that places a decal and bursts sparks, a bot
volley), equals the port's fused_step on the same inputs within a jitted
step's bounds; and the two whole games, stepped on the same inputs, keep
the same host pose, recoil, decals and roster.  The rest holds the
behaviours of tests/test_dust2_app.py on the port's game, its toggles,
checkpoints, CLI, refusals and a loopback two-player session."""

import os
import socket
import time

import jax
import numpy as np
import pytest
import torch

from softwarerenderer_tpu.apps import dust2 as jax_dust2
from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.apps import dust2
from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.models.convert import (state_to_numpy,
                                                       state_to_torch,
                                                       tree_to_torch)
from softwarerenderer_tpu_torch.utils import hostmath as ml

F32 = np.float32
SIZE = (160, 120)
SEED, BOTS = 1, 2
DT = 1.0 / 60.0
GAME_FRAMES = 30
SHOT_FRAME = 5
# Space held from bench.py's jump frame until the falling spawn has landed.
JUMP_FRAMES = range(15, 20)
# One jitted step from the same state: XLA contracts multiply-adds, the
# port does not (tests/test_torch_sim.py's bounds for a jitted step).
# Measured over the 30 frames: 2.5e-7 relative on velocities, aim 1.2e-7
# and rotation 6e-8 absolute, the rest equal.
JIT_RTOL = 1e-5
JIT_ATOL = 1e-6
# Frame against JAX's frame: the share of pixels off by more than 2 in a
# channel; measured at most 1.6e-4 (3 of 19,200 pixels, on edges where
# the two compilers round a vertex differently).
RGB_OFF_MAX = 3.2e-4
# The whole games, 30 frames, in metres: the host pose (the pipelined
# aux) measured equal on every frame; the bots' roster positions 6e-8
# apart but on one frame, where the jitted JAX step snaps a bot onto the
# floor a frame before the port does (1.0e-3, then equal again).
POSE_ATOL = 1e-4
BOT_ATOL = 2e-3


def scripted(i):
    """bench.py's game-loop input (strafe right then left, a slow look
    sweep), with a look down over the first frames so the shot on
    SHOT_FRAME lands on the floor, and space held over JUMP_FRAMES."""
    keys = {"w", "d"} if (i // 45) % 2 == 0 else {"w", "a"}
    if i in JUMP_FRAMES:
        keys = keys | {"space"}
    return {"quit": False, "keys": keys,
            "mouse_delta": (1.5 if (i // 90) % 2 == 0 else -1.5,
                            40.0 if i < 4 else 0.2),
            "mouse_down": i == SHOT_FRAME, "chars": "", "gamepad": None}


def make_game(offline=True, **kw):
    kw.setdefault("width", 64)
    kw.setdefault("height", 48)
    kw.setdefault("render_scale", 1.0)
    kw.setdefault("headless", True)
    kw.setdefault("seed", 1)
    kw.setdefault("device", "cpu")
    return dust2.Dust2Game(server="127.0.0.1", offline=offline, **kw)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: a game step is thousands
    of small ops, which the default pool of one thread a core slows down
    when the suite's workers share the cores (the threads wait on each
    other at every op)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _in_tmp(tmp_path, monkeypatch):
    """close() writes hud_layout.json into the working directory."""
    monkeypatch.chdir(tmp_path)


def _roster(game):
    return [(p.name, p.health, p.kills, p.deaths,
             np.asarray(p.position, F32).copy()) for p in game.players]


def _host_state(game):
    return {"pose": game._char_pos_host.copy(), "recoil": game.recoil.copy(),
            "decals": game._decal_used, "roster": _roster(game),
            "health": game.hud.state.health}


@pytest.fixture(scope="module")
def games(tmp_path_factory):
    """Both games, stepped GAME_FRAMES frames on scripted(i): their spawn,
    JAX's fused-step inputs and outputs of every frame, and each game's
    host state after every frame."""
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("games"))
    kw = dict(width=SIZE[0], height=SIZE[1], render_scale=1.0,
              headless=True, offline=True, seed=SEED, bots=BOTS)
    jg = jax_dust2.Dust2Game(**kw)
    pg = dust2.Dust2Game(device="cpu", **kw)
    try:
        spawn = {"jax": (np.asarray(jg.char["position"]), jg.cam_rotation,
                         jax.device_get(jg._bots_state),
                         jg._bot_waypoints, jg._bot_next_hop),
                 "port": (state_to_numpy(pg.char, single=True)["position"],
                          pg.cam_rotation, state_to_numpy(pg._bots_state),
                          pg._bot_waypoints, pg._bot_next_hop)}
        captured = []
        get_fused = jg._get_fused

        def capture(eng):
            fn = get_fused(eng)

            def fused(scene, sim, ctl, uniforms):
                # host arrays are copied: the app rewrites them in place
                inputs = jax.tree_util.tree_map(
                    np.array, (jax.device_get(sim), ctl, uniforms))
                out = fn(scene, sim, ctl, uniforms)
                captured.append((inputs, jax.device_get(out)))
                return out
            return fused
        jg._get_fused = capture
        hosts = {"jax": [], "port": []}
        for i in range(GAME_FRAMES):
            for name, g in (("jax", jg), ("port", pg)):
                g.step(DT, scripted(i))
                hosts[name].append(_host_state(g))
        yield {"jax": jg, "port": pg, "spawn": spawn, "captured": captured,
               "hosts": hosts}
    finally:
        jg.close()
        pg.close()
        os.chdir(cwd)


def assert_tree(want, got, tag, rtol=0.0, atol=0.0):
    """JAX's tree (numpy) against the port's: float leaves within
    rtol / atol (bit for bit when both are 0), the rest equal."""
    for k, w in want.items():
        if isinstance(w, dict):
            assert_tree(w, got[k], f"{tag}{k}.", rtol, atol)
            continue
        w, g = np.asarray(w), np.asarray(got[k])
        assert w.shape == g.shape and w.dtype == g.dtype, (tag + k, w, g)
        if w.dtype == np.float32 and (rtol or atol):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=tag + k)
        elif w.dtype == np.float32:
            np.testing.assert_array_equal(w.view(np.int32),
                                          g.view(np.int32), err_msg=tag + k)
        else:
            np.testing.assert_array_equal(w, g, err_msg=tag + k)


def port_sim(sim):
    """A JAX sim tree as the port's: the character given its N = 1 axis,
    the crowd and the sparks as they are."""
    return {k: state_to_torch(v, "cpu") for k, v in sim.items()}


def numpy_sim(sim):
    """The port's sim tree in the JAX package's layout."""
    return {k: state_to_numpy(v, single=k == "char") for k, v in sim.items()}


def test_same_spawn(games):
    """Both games from one seed spawn the same player pose, the same bots
    (their keys included: the port draws JAX's threefry stream), the same
    waypoints and the same next-hop table, exactly."""
    (jpos, jrot, jbots, jwp, jhop) = games["spawn"]["jax"]
    (ppos, prot, pbots, pwp, phop) = games["spawn"]["port"]
    np.testing.assert_array_equal(ppos, jpos)
    np.testing.assert_array_equal(prot, jrot)
    assert_tree(jbots, pbots, "bots.")
    np.testing.assert_array_equal(pwp, jwp)
    np.testing.assert_array_equal(phop, jhop)


def test_fused_step_matches_jax(games):
    """Each of the GAME_FRAMES frames: JAX's fused step's inputs
    (sim, ctl, uniforms), converted, through the port's fused_step give
    the same new states within a jitted step's bounds, an image with at
    most RGB_OFF_MAX of its pixels off by more than 2, and aux rows that
    decode to the same pose and bot poses, shots and aim.  The frames
    hold a jump from the ground, a spark burst and a bot volley."""
    pg = games["port"]
    h = SIZE[1]
    n_aux = 3 + 11 * BOTS
    seen = {"jump": False, "burst": False, "volley": False}
    for k, ((sim, ctl, u), (jsim, jpacked, jtail)) in \
            enumerate(games["captured"]):
        new, packed, tail = dust2.fused_step(
            pg.engine.scene, port_sim(sim), tree_to_torch(ctl, "cpu"), u,
            engine=pg.engine, world=pg.world,
            tri_mask=pg._map_tri_mask_dev, gun_slice=pg.gun_slice,
            bots=pg._bots_static())
        assert_tree(jsim, numpy_sim(new), f"frame {k}: ", JIT_RTOL,
                    JIT_ATOL)
        got, want = packed.numpy(), np.asarray(jpacked)
        assert got.shape == want.shape and got.dtype == np.uint8
        off = np.abs(got[:h].astype(int) - want[:h].astype(int)).max(-1)
        assert (off > 2).mean() <= RGB_OFF_MAX, (k, (off > 2).mean())
        np.testing.assert_array_equal(tail.numpy(), got[h - 1:])
        aux = got[h:].ravel()[:4 * n_aux].view(F32)
        jaux = want[h:].ravel()[:4 * n_aux].view(F32)
        np.testing.assert_allclose(aux, jaux, rtol=JIT_RTOL, atol=JIT_ATOL)
        fire = slice(3 + 7 * BOTS, 3 + 8 * BOTS)
        np.testing.assert_array_equal(aux[fire], jaux[fire])
        np.testing.assert_array_equal(aux[:3], new["char"]["position"][0])
        seen["jump"] |= bool(ctl["jump"] and sim["char"]["grounded"]
                             and jsim["char"]["velocity"][1] > 1.0)
        seen["burst"] |= bool(ctl["emitter"]["rate"] > 0)
        seen["volley"] |= bool(jsim["bots"]["fire"].any())
    assert len(games["captured"]) == GAME_FRAMES and all(seen.values()), \
        seen


def test_whole_game_matches_jax(games):
    """The two games stepped GAME_FRAMES frames on the same input: after
    every frame the same recoil and decal count, host poses within
    POSE_ATOL, and the same roster (names, health, kills, deaths) with bot
    positions within BOT_ATOL.  The script's shot placed a decal and a
    bot volley hit the local player in both."""
    for i, (j, p) in enumerate(zip(games["hosts"]["jax"],
                                   games["hosts"]["port"])):
        np.testing.assert_allclose(p["pose"], j["pose"], atol=POSE_ATOL,
                                   err_msg=f"frame {i}")
        np.testing.assert_array_equal(p["recoil"], j["recoil"])
        assert p["decals"] == j["decals"] and p["health"] == j["health"], i
        assert [r[:4] for r in p["roster"]] == [r[:4] for r in j["roster"]]
        for rp, rj in zip(p["roster"], j["roster"]):
            np.testing.assert_allclose(rp[4], rj[4], atol=BOT_ATOL,
                                       err_msg=f"frame {i} {rp[0]}")
    last = games["hosts"]["port"][-1]
    assert last["decals"] >= 1 and last["health"] < 100.0, last


def test_offline_headless_frames(games):
    """The port's game presents frames of the scene, not a uniform clear
    color, at the window's render size."""
    frame = games["port"].window.last_frame
    assert frame is not None and frame.shape == (SIZE[1], SIZE[0], 3)
    assert len(np.unique(frame.reshape(-1, 3), axis=0)) > 10


def test_character_stays_on_map():
    g = make_game()
    try:
        for _ in range(30):
            g.step(1 / 30)
        pos = g.char["position"].numpy()
        assert pos.shape == (1, 3) and np.isfinite(pos).all()
        assert pos[0, 1] > -10.0   # did not fall through the world
    finally:
        g.close()


def test_noclip_falls_through_floor():
    g = make_game()
    try:
        g.noclip = True
        inp = {"keys": {"shift"}, "mouse_delta": (0.0, 0.0),
               "mouse_down": False, "chars": "", "quit": False}
        y0 = float(g.char["position"][0, 1])
        for _ in range(30):
            g.step(1 / 30, inputs=inp)
        assert bool(g.char["noclip"].all())
        assert float(g.char["position"][0, 1]) < y0 - 2.0
    finally:
        g.close()


def test_shot_kicks_recoil_and_places_decal():
    """A shot at the floor kicks the recoil, places a decal the next
    frames show, and the decal ring recycles its slots."""
    g = make_game(width=SIZE[0], height=SIZE[1])
    try:
        g.cam_rotation = np.asarray(
            ml.quat_from_axis_angle([1.0, 0.0, 0.0], -np.pi / 2), F32)
        g.step(1 / 60)
        g.step(1 / 60)
        before = g.window.last_frame.copy()
        r0 = g.recoil.copy()
        assert g._decal_used == 0 and g.shot_reads == 0
        g.shoot()
        assert not np.allclose(g.recoil, r0)
        assert g._decal_used == 1 and g.shot_reads == 1
        assert np.isfinite(g._mesh_matrices[g.decal_slice[0]]).all()
        for _ in range(3):      # present trails by present_depth frames
            g.step(1 / 60)
        after = g.window.last_frame
        assert (np.abs(before.astype(int) - after.astype(int)).max(-1)
                > 10).sum() > 3
        for _ in range(g.n_decals + 3):
            g._place_decal(np.asarray([0, 0, 0], F32),
                           np.asarray([0, 1, 0], F32))
        assert g._decal_used == g.n_decals
    finally:
        g.close()


def test_sparks_burst_and_decay():
    """A level hit queues a burst: the next step has live sparks, and
    with no more shots they all die within 0.85 s (lifetimes 0.25-0.6)."""
    g = make_game()
    try:
        assert g.scene["particle_vert_index"].shape[0] == 4 * g.n_particles
        g.cam_rotation = np.asarray(
            ml.quat_from_axis_angle([1.0, 0.0, 0.0], -np.pi / 2), F32)
        g.step(1 / 60)
        assert int((g._particles["lifetime"] > 0).sum()) == 0
        g.shoot()
        g.step(1 / 60)
        alive = g._particles["lifetime"] > 0
        assert int(alive.sum()) > 0
        assert bool(torch.isfinite(g._particles["position"][alive]).all())
        for _ in range(50):
            g.step(1 / 60)
        assert int((g._particles["lifetime"] > 0).sum()) == 0
    finally:
        g.close()


def test_practice_range_bots():
    """--offline --bots 2: the bots join the roster, patrol (positions
    change, stay finite, stay on the map), and a kill through the shared
    hit handler respawns one at a spawn point, roster and crowd state
    agreeing."""
    g = make_game(bots=2)
    try:
        bots = [p for p in g.players if p.id >= dust2.BOT_ID_BASE]
        assert {b.name for b in bots} == {"BOT 1", "BOT 2"}
        p0 = {b.id: np.asarray(b.position).copy() for b in bots}
        for _ in range(30):
            g.step(1 / 30)
        moved = 0.0
        for b in bots:
            assert np.isfinite(b.position).all() and b.position[1] > -10.0
            moved += float(np.linalg.norm(b.position - p0[b.id]))
        assert moved > 0.05, "bots never moved"
        b = bots[0]
        g._handle_player_hit(b.id, 100.0, attacker_id=g.net.client_id)
        assert b.health == 100.0 and b.deaths == 1
        spawn_dist = min(float(np.linalg.norm(b.position - s))
                         for s in (dust2.SPAWN_1, dust2.SPAWN_2))
        assert spawn_dist < 1e-4, b.position
        np.testing.assert_allclose(
            b.position, g._bots_state["char"]["position"][0].numpy(),
            atol=1e-5)
        g.step(1 / 30)
    finally:
        g.close()


def test_bot_hits_local_player():
    """The local player has no mesh in their own scene: a bot's shot at
    us resolves through the capsule test and lands on the HUD health and
    our roster row."""
    g = make_game(bots=1)
    try:
        g._bot_brain["aim_spread"] = np.float32(0.0)
        g._bot_brain["fire_cooldown"] = np.float32(0.1)
        me = g.char["position"].numpy()[0]
        g._bots_state = dust2.respawn_agent(
            g._bots_state, 0, me + np.asarray([0, 0, 3.0], F32))
        for _ in range(90):
            g.step(1 / 30)
            if g.hud.state.health < 100.0:
                break
        assert g.hud.state.health < 100.0
        mine = next(p for p in g.players if p.id == g.net.client_id)
        assert mine.health < 100.0 and g.shot_reads >= 1
    finally:
        g.close()


def test_checkpoint_replay_is_deterministic(tmp_path):
    """Save mid-run, play a scripted tail with a shot, restore and replay
    it: the character and the sparks land on the same values, and the
    checkpoint holds the JAX app's layout (one character, uint32 keys).
    (Without bots, as the JAX app's test: their targets come from the
    host roster and the pipelined aux, which a checkpoint does not hold,
    in either package.)"""
    g = make_game(seed=3)
    try:
        def script(i):
            keys = {"w"} if i % 3 else {"w", "a"}
            if i % 7 == 0:
                keys.add("space")
            return {"keys": keys, "mouse_delta": (2.0, 1.0),
                    "mouse_down": i == 8, "chars": "", "quit": False}

        for i in range(6):
            g.step(1 / 60, script(i))
        ckpt = str(tmp_path / "mid.npz")
        g.save_state(ckpt)
        for i in range(6, 12):
            g.step(1 / 60, script(i))
        end = numpy_sim({"char": g.char, "particles": g._particles})
        assert (end["particles"]["lifetime"] > 0).any()
        end_rot = g.cam_rotation.copy()
        g.load_state(ckpt)
        assert g._out_q == []
        for i in range(6, 12):
            g.step(1 / 60, script(i))
        assert_tree(end, numpy_sim({"char": g.char,
                                    "particles": g._particles}), "replay ")
        np.testing.assert_array_equal(g.cam_rotation, end_rot)
        from softwarerenderer_tpu_torch.utils import checkpoint
        st = checkpoint.load(ckpt)
        assert st["char"]["position"].shape == (3,)
        assert st["particles"]["key"].dtype == np.uint32
    finally:
        g.close()


def test_present_pipeline_trails_by_depth():
    """The host pose is the aux of the frame submitted present_depth
    frames before, for depths 1 to 3; the first frames bootstrap."""
    for depth in (1, 2, 3):
        g = make_game()
        try:
            g.present_depth = depth
            states = []
            for i in range(6):
                g.step(1 / 60, {"keys": {"w"}, "mouse_delta": (0, 0),
                                "mouse_down": False, "chars": "",
                                "quit": False})
                states.append(g.char["position"].numpy()[0].copy())
                assert g.window.last_frame is not None
                if i >= depth:
                    np.testing.assert_array_equal(g._char_pos_host,
                                                  states[i - depth])
                assert len(g._out_q) == min(i + 1, depth)
        finally:
            g.close()


def test_skipped_images_still_apply_aux():
    """With _present_nth = 2 (the image fetched every 2nd frame, the aux
    rows every frame) the skipped frames present the blank frame and the
    host pose still follows the simulation frame by frame."""
    g = make_game()
    try:
        g._present_nth = 2
        states, blank = [], 0
        for i in range(8):
            g.step(1 / 60, {"keys": {"w"}, "mouse_delta": (0, 0),
                            "mouse_down": False, "chars": "",
                            "quit": False})
            states.append(g.char["position"].numpy()[0].copy())
            blank += int(not g.window.last_frame.any())
            if i >= g.present_depth:
                np.testing.assert_array_equal(
                    g._char_pos_host, states[i - g.present_depth])
        # frames 1, 3, 5, 7 fetch their image (every 2nd of the count
        # from 1): steps 0-1 bootstrap on frame 0 and steps 2, 4, 6 join
        # frames 0, 2, 4, all without one
        assert blank == 5
    finally:
        g.close()


def test_apply_config_tunables(tmp_path):
    """The JSON config path (utils/appconfig) drives the debug panel's
    tunables: uniforms, light euler, sensitivity, the character's
    parameters; a frame still renders with them."""
    from softwarerenderer_tpu_torch.utils import appconfig
    p = str(tmp_path / "srt.json")
    appconfig.AppConfig(
        fov_degrees=75.0, fog_start=2.5, fog_end=40.0,
        sensitivity=0.25, gravity_y=-20.0, move_speed=7.5,
        jump_force=5.5, light_euler_degrees=(-30.0, -60.0, 0.0),
        clear_color=(0.1, 0.2, 0.3, 1.0)).save(p)
    cfg = appconfig.load(p, env=False)
    g = make_game()
    try:
        dust2.apply_config_tunables(g, cfg)
        u = g.engine.uniforms
        assert float(u["fov_degrees"]) == 75.0
        assert float(u["fog_start"]) == 2.5 and float(u["fog_end"]) == 40.0
        np.testing.assert_allclose(u["clear_color"], [0.1, 0.2, 0.3, 1.0])
        assert g.mouse_sensitivity == 0.25
        assert float(g.light_euler["light_yaw"]) == -60.0
        cp = g.char_params
        assert float(cp["gravity"][1]) == -20.0
        assert float(cp["move_speed"]) == 7.5
        assert float(cp["jump_force"]) == 5.5
        g.step(1 / 60)
    finally:
        g.close()


def test_full_tuning_panel_surface():
    """Every tunable of the debug panel moves its readback and a frame
    renders after all of them (render_scale rebuilds the engine)."""
    g = make_game()
    try:
        for name, kind, step, lo, hi in g.TUNABLES:
            before = g._tunable_value(name, kind)
            g._tunable_adjust(name, kind, step, lo, hi)
            after = g._tunable_value(name, kind)
            if before < hi - 1e-6:
                assert after != before or abs(before - hi) < step + 1e-6, \
                    name
        g.step(1 / 60)
        assert g.window.last_frame is not None
    finally:
        g.close()


@pytest.mark.parametrize("chars,param,value", [
    ("o", "ssaa", 2), ("k", "ssao", True), ("j", "bloom", True),
    ("u", "fxaa", True), ("m", "use_mipmaps", True),
    ("p", None, None)])
def test_toggle_rebuilds_engine_on_same_buffers(chars, param, value):
    """Each toggle builds a new engine (the wireframe engine for 'p') on
    the very tensors of the first engine's scene: nothing is uploaded
    again, and a frame renders."""
    g = make_game()
    try:
        ptrs = {k: v.data_ptr() for k, v in g.engine.scene.items()}
        first = g.engine
        g.step(1 / 60, {"keys": set(), "mouse_delta": (0.0, 0.0),
                        "mouse_down": False, "chars": chars, "quit": False})
        eng = g._wire_engine if param is None else g.engine
        assert eng is not first and eng is not None
        if param is not None:
            assert getattr(eng.params, param) == value
        assert {k: v.data_ptr() for k, v in eng.scene.items()} == ptrs
        assert eng.uniforms is first.uniforms
        g.step(1 / 60)
        assert g.window.last_frame.shape == (48, 64, 3)
    finally:
        g.close()


def test_engine_rebuilt_from_tensors_shares_buffers():
    """Engine(old.scene, ...) takes the device tensors as they are: the
    new engine's buffers are the old one's (same data_ptr) and it renders
    the same frame."""
    from softwarerenderer_tpu_torch import scenes
    eng = Engine(scenes.bench_scene(), RenderParams(48, 32), device="cpu")
    again = Engine(eng.scene, eng.params, device="cpu")
    assert {k: v.data_ptr() for k, v in again.scene.items()} == \
        {k: v.data_ptr() for k, v in eng.scene.items()}
    u = scenes.camera_uniforms(eng.uniforms, 0)
    np.testing.assert_array_equal(again.present(u), eng.present(u))


@pytest.mark.parametrize("flag", sorted(dust2.NOT_PORTED))
def test_unported_modes_raise_by_name(flag):
    """--mirror, --burn-hud and --record need modules the port does not
    have yet: the game refuses them by name before building anything."""
    value = "clip.avi" if flag == "record" else True
    with pytest.raises(NotImplementedError, match="--" + flag.replace(
            "_", "-")) as e:
        make_game(**{flag: value})
    assert "A6.7" in str(e.value)


def test_needs_a_card(monkeypatch):
    """The game runs on "cuda" unless asked for the CPU, and raises
    without a card (it never falls back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dust2.Dust2Game(headless=True, offline=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        dust2.main(["--headless", "--offline", "--frames", "1"])


def test_cli_writes_a_frame(tmp_path):
    """python -m softwarerenderer_tpu_torch.apps.dust2 --headless
    --offline --frames 3 --out frame.png --device cpu writes a frame of
    the scene."""
    from PIL import Image
    out = str(tmp_path / "frame.png")
    dust2.main(["--headless", "--offline", "--frames", "3", "--out", out,
                "--width", "96", "--height", "64", "--render-scale", "1",
                "--device", "cpu"])
    frame = np.asarray(Image.open(out))
    assert frame.shape == (64, 96, 3)
    assert len(np.unique(frame.reshape(-1, 3), axis=0)) > 10
    assert os.path.exists(str(tmp_path / "hud_layout.json"))


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_player_session():
    """Two port games on one loopback session: the host elects itself,
    the client joins with id 1, and each sees the other's join and pose
    (polled, at most 5 s)."""
    port = _free_port()
    host = make_game(offline=False, port=port, player_name="HostP")
    client = None
    try:
        assert host.net.is_host
        client = make_game(offline=False, port=port, player_name="ClientP")
        assert not client.net.is_host and client.net.client_id == 1

        def names(g):
            return {p.name for p in g.players}
        t0 = time.monotonic()
        while time.monotonic() - t0 < 5.0:
            host.step(1 / 30)
            client.step(1 / 30)
            cp = next((p for p in host.players if p.name == "ClientP"), None)
            if "HostP" in names(client) and cp is not None \
                    and np.linalg.norm(cp.position) > 0:
                break
        assert "ClientP" in names(host) and "HostP" in names(client)
        np.testing.assert_allclose(cp.position, client._char_pos_host,
                                   atol=0.5)
    finally:
        if client is not None:
            client.close()
        host.close()


IDLE = {"quit": False, "keys": set(), "chars": "", "mouse_delta": (0, 0),
        "mouse_down": False, "gamepad": None}


@pytest.mark.parametrize("mode", [{"kbuffer": 4}, {"raytrace": 6}])
def test_render_modes(mode):
    """--kbuffer 4 (the depth-peeled route) and --raytrace (the bundle
    sweep's twin on the CPU) render the game's frames, the step and
    gameplay unchanged."""
    g = make_game(**mode)
    try:
        for _ in range(4):
            g.step(1 / 60, inputs=dict(IDLE, keys={"w"},
                                       mouse_delta=(1.0, 0.0)))
        frame = g.window.last_frame
        assert frame.shape == (48, 64, 3)
        assert len(np.unique(frame.reshape(-1, 3), axis=0)) > 10
        assert bool(torch.isfinite(g.char["velocity"]).all())
    finally:
        g.close()


def test_kill_feed_and_scoreboard():
    """PlayerHit kills feed the kill feed and the Tab scoreboard (the
    attacker's kill, the victim's death)."""
    g = make_game()
    try:
        me, foe = dust2.ConnectedPlayer(0, "me"), dust2.ConnectedPlayer(1,
                                                                        "foe")
        g.players += [me, foe]
        for _ in range(10):
            g._handle_rpc("PlayerHit", ["1", "0", "10"])
        assert me.kills == 1 and foe.deaths == 1 and foe.health == 100.0
        assert "foe" in g.hud.state.kill_feed[-1][1]
        g.step(1 / 60, inputs=dict(IDLE, keys={"tab"}))
        assert g.hud.state.show_scoreboard
        assert g.hud.state.scoreboard[0][:2] == ("me", 1)
    finally:
        g.close()


def test_spectator_mode():
    """B cycles the view through the other players: the camera takes the
    target's pose, the gun hides, shooting is off; past the last target
    the own view returns."""
    g = make_game()
    try:
        foe = dust2.ConnectedPlayer(1, "foe")
        foe.position = np.float32([3.0, 1.0, -5.0])
        foe.local_position = foe.position.copy()
        g.players += [dust2.ConnectedPlayer(0, "me"), foe]

        def press(key):
            g.step(1 / 60, inputs=dict(IDLE, keys={key}))
            g.step(1 / 60, inputs=IDLE)
        press("b")
        assert g.spectate_idx == 0 and g.hud.state.spectating == "foe"
        cam = np.asarray(g.engine.uniforms["camera_position"])
        np.testing.assert_allclose(
            cam, foe.local_position + g.char_params["cam_offset"], atol=0.3)
        lo, hi = g.gun_slice
        assert not g.engine.uniforms["mesh_visible"][lo:hi].any()
        before = g.last_shot
        g.step(1 / 60, inputs=dict(IDLE, mouse_down=True))
        assert g.last_shot == before
        press("b")
        assert g.spectate_idx == -1 and g.hud.state.spectating == ""
        assert g.engine.uniforms["mesh_visible"][lo:hi].all()
    finally:
        g.close()


def test_gamepad_drives_game():
    """Left stick walks, right stick turns, the trigger fires, through
    the same step as keyboard and mouse."""
    g = make_game()
    try:
        g.step(1 / 60)
        rot0 = g.cam_rotation.copy()
        p0 = g.char["position"].numpy()[0].copy()
        pad = {"move": (0.0, 1.0), "look": (0.0, 0.0), "jump": False,
               "fire": False}
        for _ in range(8):
            g.step(1 / 30, inputs=dict(IDLE, gamepad=pad))
        p1 = g.char["position"].numpy()[0]
        assert np.linalg.norm((p1 - p0)[[0, 2]]) > 0.05
        np.testing.assert_allclose(g.cam_rotation, rot0)
        g.step(1 / 30, inputs=dict(IDLE, gamepad=dict(pad, move=(0, 0),
                                                     look=(1.0, 0.0))))
        assert not np.allclose(g.cam_rotation, rot0)
        r0 = g.recoil.copy()
        g.time = g.last_shot + 10.0
        g.step(1 / 30, inputs=dict(IDLE, gamepad=dict(pad, move=(0, 0),
                                                     fire=True)))
        assert not np.allclose(g.recoil, r0)
    finally:
        g.close()


def test_pointer_slider_drag_and_chat_focus():
    """With the cursor released, dragging a tunables slider sets its value
    from the pointer and clicking the chat row focuses chat; while the
    mouse is captured, clicks never touch the panel."""
    from softwarerenderer_tpu_torch.io_host import ui as ui_mod
    g = make_game(width=160, height=120)
    try:
        g.step(1 / 60)
        g.mouse_locked = False
        g.hud.state.show_debug = True
        w, h = g.window.width, g.window.height
        panel = ui_mod._anchor(g.hud.layout.panel_pos, w, h)
        row = next(i for i, t in enumerate(g.TUNABLES)
                   if t[0] == "fov_degrees")
        rx, ry, rw, rh = ui_mod.panel_slider_rect(panel, row)
        x = rx + (rw - 1) // 2
        drag = dict(IDLE, mouse_down=True, mouse_held=True,
                    mouse_pos=(x, ry + 1))
        g.step(1 / 60, inputs=drag)
        _, _, _, lo, hi = g.TUNABLES[row]
        want = ui_mod.slider_value(panel, row, x, lo, hi)
        assert abs(float(g.engine.uniforms["fov_degrees"]) - want) < 1e-3
        g.step(1 / 60, inputs=dict(drag, mouse_down=False,
                                   mouse_pos=(rx + rw, ry + 1)))
        assert float(g.engine.uniforms["fov_degrees"]) == hi
        g.step(1 / 60, inputs=dict(drag, mouse_down=False, mouse_held=False,
                                   mouse_pos=(0, 0)))
        assert g._drag_row is None
        cr = ui_mod.chat_input_rect(g.hud.layout.chat_pos,
                                    len(g.hud.state.chat_messages),
                                    g.hud.state.max_chat_lines, w, h)
        g.step(1 / 60, inputs=dict(drag, mouse_pos=(cr[0] + 2, cr[1] + 2)))
        assert g.hud.state.chat_active
        g.hud.state.chat_active = False
        g.mouse_locked = True
        fov = float(g.engine.uniforms["fov_degrees"])
        g.step(1 / 60, inputs=drag)
        assert float(g.engine.uniforms["fov_degrees"]) == fov
    finally:
        g.close()
