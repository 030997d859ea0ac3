"""The per-frame vertex updates of the port (ops.morph, ops.skinning, the
flip-book frames and sim.particles' billboards, engine.apply_vertex_updates)
against the JAX package's functions, run eagerly on the same numpy inputs
(fixed seeds), all on one scene (``rig``) so that JAX compiles each
eager operation once.  The animated frames are held against JAX's in
tests/test_torch_package.py (test_unsupported_scene_keys_raise) and
tests/test_torch_shadows.py.

The vertex functions are held at rtol 1e-6 / atol 1e-6 (each test states
its measured difference): the port writes its sums left to right where
XLA's einsum and sum pick their own order.  Gathers, lerps and the cast
cases are exact."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softwarerenderer_tpu.engine import renderer as jr
from softwarerenderer_tpu.ops import morph as jmorph
from softwarerenderer_tpu.ops import skinning as jskin
from softwarerenderer_tpu.sim import particles as jpart
from softwarerenderer_tpu_torch import RenderParams, scenes
from softwarerenderer_tpu_torch.engine import Engine, renderer
from softwarerenderer_tpu_torch.models import primitives
from softwarerenderer_tpu_torch.models import scene as scene_mod
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import morph, skinning
from softwarerenderer_tpu_torch.sim import particles
from softwarerenderer_tpu_torch.utils import mathlib as ml
from tests.test_skinning import arm_mesh, two_bone_skin

F32 = np.float32
RTOL = ATOL = 1e-6
VIN_KEYS = ("position", "uv", "normal", "color")


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               equal_nan=True)


def _jax_scene(sc):
    return {k: jnp.asarray(v) for k, v in sc.items()}


def _vin(sc):
    return {k: sc[k] for k in VIN_KEYS}


def _uniforms_t(u):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in u.items()}


def _quad():
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], F32)
    return {"position": pos, "uv": np.zeros((4, 2), F32),
            "normal": np.tile(np.asarray([[0, 0, 1]], F32), (4, 1)),
            "color": np.ones((4, 4), F32),
            "indices": np.asarray([[0, 1, 2], [2, 1, 3]], np.int32)}


@functools.lru_cache(maxsize=None)
def rig():
    """(packed scene, skins): one scene of every vertex update, so that
    JAX compiles each eager operation once for all tests: the two-bone arm
    of tests/test_skinning.py and a three-bone tentacle (two skins), a
    morphing quad with K = 2, normal deltas and a 3-key weight track at 2
    keys/s, one with K = 1 and no track, flip-book cubes of 3 and 5 frames
    around a static one, a normal-mapped quad and a 12-slot emitter."""
    rng = np.random.default_rng(3)
    arm = arm_mesh()
    arm_skin = two_bone_skin(arm["position"])
    tent = scenes.tentacle_mesh(rings=6, sides=5)
    tent_skin = scenes.tentacle_skin(tent["position"])
    m1 = {"pos": rng.normal(size=(2, 4, 3)).astype(F32),
          "nrm": rng.normal(size=(2, 4, 3)).astype(F32) * 0.3,
          "weights": np.asarray([0.25, 0.5], F32),
          "weight_track": rng.uniform(0, 1, (3, 2)).astype(F32),
          "rate": 2.0}
    m2 = {"pos": rng.normal(size=(1, 4, 3)).astype(F32), "nrm": None,
          "weights": np.asarray([0.75], F32), "weight_track": None}
    cube = primitives.cube(1.0)

    def frames(n):
        return (cube["position"][None] + rng.normal(
            size=(n,) + cube["position"].shape) * 0.1).astype(F32)

    nm = scenes.bumps_normal_map(8, 2)
    insts = [scene_mod.MeshInstance(arm, skin=arm_skin),
             scene_mod.MeshInstance(tent, ml.translation([3, 0, 0]),
                                    skin=tent_skin),
             scene_mod.MeshInstance(_quad(), morph=m1),
             scene_mod.MeshInstance(_quad(), ml.translation([2, 0, 0]),
                                    morph=m2),
             scene_mod.MeshInstance(cube, animation_positions=frames(3)),
             scene_mod.MeshInstance(cube, ml.translation([2, 0, 0])),
             scene_mod.MeshInstance(cube, ml.translation([4, 0, 0]),
                                    animation_positions=frames(5),
                                    animation_normals=frames(5)),
             scene_mod.MeshInstance(_quad(), normal_texture=nm),
             scene_mod.MeshInstance(particles.particles_mesh(12),
                                    particles=12)]
    return scene_mod.build_scene_buffers(insts), (arm_skin, tent_skin)


def rig_uniforms(seed=11, **extra):
    """Seeded particle uniforms and a turned camera, with `extra`."""
    rng = np.random.default_rng(seed)
    u = dict(renderer.default_frame_uniforms(64, 48),
             camera_rotation=ml.quat_from_yaw_pitch_roll(
                 np.float32(0.7), np.float32(-0.3), np.float32(0.1)),
             particle_centers=rng.normal(size=(12, 3)).astype(F32),
             particle_size=rng.uniform(0, 0.5, 12).astype(F32),
             particle_color=rng.uniform(0, 1, (12, 4)).astype(F32))
    u.update(extra)
    return u


MORPH_CASES = {
    # No clock: the tracked slot at its key 0, the other at its defaults.
    "defaults": {},
    "override": {"morph_weights": np.asarray([[1.0, -0.5]], F32)},
    "scalar_clock": {"anim_time": F32(1.9)},
    "slot_clock": {"morph_time": np.asarray([0.7, 1.3], F32),
                   "anim_time": F32(5.0)},
    # anim_time as the per-skin clock vector of 3 (neither 1 nor S = 2):
    # every morph slot reads its first element.
    "skin_clock": {"anim_time": np.asarray([0.2, 0.9, 1.4], F32)},
}


@pytest.mark.parametrize("case", sorted(MORPH_CASES))
def test_morph_matches_jax(case):
    """morph_weights and apply_morphs (measured: weights equal, positions
    and normals within 1.2e-7)."""
    u = MORPH_CASES[case]
    sc, _ = rig()
    st = scene_to_torch(sc, "cpu")
    w = morph.morph_weights(st, _uniforms_t(u))
    jw = jmorph.morph_weights(_jax_scene(sc), u, xp=jnp)
    _close(w, jw, rtol=0, atol=0)
    out = morph.apply_morphs(_vin(st), st, _uniforms_t(u))
    jout = jmorph.apply_morphs({k: jnp.asarray(sc[k]) for k in VIN_KEYS},
                               _jax_scene(sc), u, xp=jnp)
    for k in ("position", "normal"):
        _close(out[k], jout[k])
    assert not torch.equal(out["position"], st["position"])


def test_morph_clock_casts_like_xla():
    """A NaN, huge or negative clock: the key index casts as XLA's convert
    does (NaN to 0, saturating), floor modulo; the weights equal JAX's,
    NaN where its are."""
    sc, _ = rig()
    st = scene_to_torch(sc, "cpu")
    for t in (np.nan, 1e30, -1e30, -0.75, -3.2, 3e9):
        u = {"morph_time": np.asarray([t, -t], F32)}
        _close(morph.morph_weights(st, _uniforms_t(u)),
               jmorph.morph_weights(_jax_scene(sc), u, xp=jnp), 0, 0)


def test_xla_int32_matches_jax_convert():
    x = np.asarray([np.nan, np.inf, -np.inf, 1e30, -1e30, 2.0 ** 31,
                    -2.0 ** 31, 2147483520.0, -7.9, 7.9, -0.0], F32)
    got = ml.xla_int32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.asarray(x).astype(
        jnp.int32)))


SKIN_CASES = {"t0": 0.0, "t0.25": 0.25, "t0.5": 0.5, "t1": 1.0,
              "t1.75": 1.75, "per_skin": np.asarray([0.3, 1.1], F32)}


@pytest.mark.parametrize("case", sorted(SKIN_CASES))
def test_skinning_matches_jax(case):
    """skin_matrices and apply_skinning on the arm rig and a tentacle at
    five shared times and with one clock a skin (measured: matrices
    within 2.4e-7, positions within 4.8e-7, normals within 1.2e-7)."""
    t = SKIN_CASES[case]
    sc, _ = rig()
    st = scene_to_torch(sc, "cpu")
    u = {"anim_time": t}
    _close(skinning.skin_matrices(st, _uniforms_t(u)),
           jskin.skin_matrices(_jax_scene(sc), u, xp=jnp))
    out = skinning.apply_skinning(_vin(st), st, _uniforms_t(u))
    jout = jskin.apply_skinning({k: jnp.asarray(sc[k]) for k in VIN_KEYS},
                                _jax_scene(sc), u, xp=jnp)
    for k in ("position", "normal"):
        _close(out[k], jout[k])
    if case == "t1":
        # The hand-computed pose of tests/test_skinning.py's arm.
        _close(out["position"][[1, 3]], [[1, 1, 0], [0, 1, 0]], 0, 1e-5)


def test_skinning_pieces_match_jax():
    """quat_matrices, compose_trs and sample_tracks on the rig's tracks at
    seeded frames in [-20, 20] over seeded clip lengths (measured: within
    2.4e-7)."""
    sc, _ = rig()
    rng = np.random.default_rng(5)
    tracks = [sc[k] for k in ("skin_trans", "skin_rot", "skin_scale")]
    J = tracks[0].shape[1]
    q = rng.normal(size=(J, 4)).astype(F32)
    _close(skinning.quat_matrices(torch.from_numpy(q)),
           jskin.quat_matrices(jnp.asarray(q), xp=jnp))
    args = (tracks[0][0], q, tracks[2][0] * F32(1.5))
    _close(skinning.compose_trs(*map(torch.from_numpy, args)),
           jskin.compose_trs(*map(jnp.asarray, args), xp=jnp))
    frame = rng.uniform(-20, 20, J).astype(F32)
    nf = rng.integers(1, tracks[0].shape[0] + 1, J).astype(np.int32)
    _close(skinning.sample_tracks(*map(torch.from_numpy,
                                       tracks + [frame, nf])),
           jskin.sample_tracks(*map(jnp.asarray, tracks + [frame, nf]),
                               xp=jnp))


def test_skin_clock_casts_like_xla():
    """NaN, ±1e30 and negative anim_time: the frame indices cast as XLA's
    convert does and wrap by floor modulo; skin matrices equal JAX's
    within the tolerance, NaN where its are."""
    sc, _ = rig()
    st = scene_to_torch(sc, "cpu")
    for t in ([np.nan, 0.4], [1e30, -1e30], [-0.75, -3.2], [-1e30, 2e9]):
        u = {"anim_time": np.asarray(t, F32)}
        _close(skinning.skin_matrices(st, _uniforms_t(u)),
               jskin.skin_matrices(_jax_scene(sc), u, xp=jnp))


def _random_skeleton(J=17, seed=7):
    """tests/test_skinning.py's branched skeleton: parents, locals and the
    level table."""
    rng = np.random.default_rng(seed)
    parent = np.full(J, -1, np.int32)
    for j in range(1, J):
        parent[j] = rng.integers(-1, j)
    local = np.asarray(rng.normal(size=(J, 4, 4)), F32)
    local[:, :, 3] = [0, 0, 0, 1]
    depth = np.zeros(J, np.int32)
    for j in range(J):
        if parent[j] >= 0:
            depth[j] = depth[parent[j]] + 1
    width = max(int((depth == d).sum()) for d in range(depth.max() + 1))
    levels = np.full((int(depth.max()) + 1, width), J, np.int32)
    for d in range(levels.shape[0]):
        ids = np.nonzero(depth == d)[0].astype(np.int32)
        levels[d, :ids.shape[0]] = ids
    return local, parent, levels


def test_level_fk_matches_sequential_fk():
    """forward_kinematics_levels equals forward_kinematics bit for bit
    (the same ordered products; the pad rows dropped), and both JAX's
    sequential FK (measured: within 9.5e-7 on entries up to 20)."""
    local, parent, levels = map(torch.from_numpy, _random_skeleton())
    lv = skinning.forward_kinematics_levels(local, parent, levels)
    seq = skinning.forward_kinematics(local, parent)
    assert torch.equal(lv, seq)
    want = jskin.forward_kinematics(*map(np.asarray, _random_skeleton()[:2]),
                                    xp=np)
    _close(lv, want, rtol=1e-6, atol=4e-6)


@pytest.mark.parametrize("anim_frame", [
    np.int32(2), np.asarray([4, 1], np.int32), np.int32(-7),
    np.asarray([-1, -6], np.int32)], ids=["scalar", "vector", "negative",
                                          "negative_vector"])
def test_flipbook_matches_jax(anim_frame):
    """The whole update chain (tangents, flip-book, morph, skin,
    billboards) against JAX's apply_vertex_updates with the same view,
    each flip-book mesh at anim_frame modulo its frame count (floor
    modulo: -7 is frame 2 of 3 and 3 of 5) (measured: within 4.8e-7)."""
    sc, _ = rig()
    st = scene_to_torch(sc, "cpu")
    u = rig_uniforms(anim_frame=anim_frame, anim_time=F32(0.6))
    du = renderer.device_uniforms(u, 64, 48, "cpu")
    out = renderer.frame_vertices(st, du)
    view, _ = jr.camera_matrices(u, 64, 48)
    jout = jr.apply_vertex_updates(
        {k: jnp.asarray(sc[k]) for k in VIN_KEYS}, _jax_scene(sc), u, view)
    assert sorted(out) == sorted(jout) == sorted(VIN_KEYS + ("tangent",))
    for k in out:
        _close(out[k], jout[k])
    f = np.broadcast_to(anim_frame, (2,)) % np.asarray([3, 5])
    vidx = sc["anim_vert_index"]
    nv = primitives.cube(1.0)["position"].shape[0]
    np.testing.assert_array_equal(out["position"][vidx[:nv]].numpy(),
                                  sc["anim_positions"][f[0], :nv])
    np.testing.assert_array_equal(out["normal"][vidx[nv:]].numpy(),
                                  sc["anim_normals"][f[1], nv:])


def test_billboards_match_jax():
    """apply_billboards on the 12-slot emitter under a turned camera,
    seeded centers, sizes and colors (measured: exact)."""
    sc, _ = rig()
    st = scene_to_torch(sc, "cpu")
    u = rig_uniforms()
    view, _ = renderer.camera_matrices(u, 64, 48)
    pu = {k: v for k, v in u.items() if k.startswith("particle_")}
    out = particles.apply_billboards(_vin(st), st, _uniforms_t(pu), view)
    jout = jpart.apply_billboards(
        {k: jnp.asarray(sc[k]) for k in VIN_KEYS}, _jax_scene(sc), pu,
        jnp.asarray(view.numpy()), xp=jnp)
    for k in VIN_KEYS:
        _close(out[k], jout[k], 0, 0)
    # The quads face the camera: each normal is the view's z column.
    idx = torch.from_numpy(sc["particle_vert_index"]).long()
    _close(out["normal"][idx], view[:3, 2].expand(48, 3), 0, 0)


def test_vertex_updates_never_write_the_scene():
    """Rendering anim_time a, then b, then a again gives the first frame
    again, and the Engine's buffers still hold the packed arrays: every
    update is out of place."""
    sc, _ = rig()
    eng = Engine(sc, RenderParams(48, 36, cull_mode=0), device="cpu")
    u = dict(rig_uniforms(), camera_position=F32([1.5, 0.5, 6.0]),
             camera_rotation=F32([0, 0, 0, 1]))
    f0, _ = eng.render(dict(u, anim_time=F32(0.3), anim_frame=1))
    f1, _ = eng.render(dict(u, anim_time=F32(0.8), anim_frame=2))
    f2, _ = eng.render(dict(u, anim_time=F32(0.3), anim_frame=1))
    assert torch.equal(f0, f2) and not torch.equal(f0, f1)
    for k in ("position", "normal", "color", "tangent"):
        np.testing.assert_array_equal(eng.scene[k].numpy(), sc[k], k)
