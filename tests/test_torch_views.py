"""Split screen, picture-in-picture and render to texture in the port
(engine.render_frame_multiview, render_frame_pip, engine.rtt) against the
JAX package on the CPU, on small seeded scenes.

Each multiview tile and the pip inset are render_frame calls at their own
size, so they equal those views rendered alone on every pixel; the pip
and rtt frames are held against JAX's under tests/test_torch_engine.py's
limit.  The atlas write quantizes and builds mips as the pack does, so
its bytes equal JAX's write and the port's static pack of the same
image."""

import jax
import numpy as np
import pytest
import torch

from softwarerenderer_tpu import RenderParams
from softwarerenderer_tpu.engine import renderer as jr
from softwarerenderer_tpu.engine import rtt as jrtt
from softwarerenderer_tpu.models import primitives
from softwarerenderer_tpu.models import scene as jscene
from softwarerenderer_tpu.ops import texture as tex_np
from softwarerenderer_tpu.utils import mathlib as ml
from softwarerenderer_tpu_torch.engine import Engine, render_frame
from softwarerenderer_tpu_torch.engine import renderer as tr
from softwarerenderer_tpu_torch.engine import rtt as trtt
from softwarerenderer_tpu_torch.models import scene as tscene
from softwarerenderer_tpu_torch.models.convert import scene_to_torch

# tests/test_torch_engine.py's limit for a simple scene: the share of
# pixels whose depth, or colour in some channel, is more than 1e-5 off.
# As there, the cameras sit off the positions whose pixel centres fall on
# the floor checker's texel edges (camera height over distance 0.5),
# where one ulp of XLA's contraction picks the other texel.
OFF_MAX = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its frames are many small
    ops, which torch's default pool slows down when the suite's workers
    share the cores (tests/test_torch_dust2.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cube_scene():
    """tests/test_engine.py's multiview scene: a textured cube on a
    plane."""
    checker = np.asarray(tex_np.checkerboard(16, 4)["data"])
    return jscene.build_scene_buffers([
        jscene.MeshInstance(primitives.cube(1.0),
                            ml.translation([0.0, 0.0, -3.0]),
                            texture=checker),
        jscene.MeshInstance(primitives.plane(8.0),
                            ml.translation([0.0, -1.0, 0.0]),
                            texture=checker)])


VIEWS = (
    {"camera_position": np.float32([0.03, 0.02, 1.07])},
    {"camera_position": np.float32([2.03, 1.02, 1.07]),
     "camera_rotation": np.asarray(ml.quat_from_yaw_pitch_roll(
         0.5, -0.2, 0.0), np.float32)},
)


def near_jax(got, want):
    c, d = (x.numpy() for x in got[:2])
    jc, jd = (np.asarray(x) for x in want[:2])
    assert c.shape == jc.shape and np.isfinite(c).all()
    assert (np.abs(d - jd) > 1e-5).mean() <= OFF_MAX
    assert (np.abs(c - jc).max(-1) > 1e-5).mean() <= OFF_MAX


@pytest.mark.parametrize("layout", ["h", "v"])
def test_multiview_tiles_equal_single_views(layout):
    """Each tile equals its view rendered alone at the tile's size, on
    every pixel; the frame is JAX's multiview frame within the limit."""
    scene = cube_scene()
    st = scene_to_torch(scene, "cpu")
    params = RenderParams(width=128, height=64)
    u = tr.default_frame_uniforms(128, 64)
    c, d = tr.render_frame_multiview(st, u, params, VIEWS, layout=layout)
    assert c.shape == (64, 128, 4) and d.shape == (64, 128)
    vp = params.replace(width=64) if layout == "h" \
        else params.replace(height=32)
    for i, ov in enumerate(VIEWS):
        ci, di = render_frame(st, {**u, **ov}, vp)
        tile = (slice(None), slice(64 * i, 64 * (i + 1))) if layout == "h" \
            else (slice(32 * i, 32 * (i + 1)),)
        assert torch.equal(c[tile], ci) and torch.equal(d[tile], di)
    assert (c[tile] != c[:32] if layout == "v" else
            c[:, :64] != c[:, 64:]).any()
    want = jax.jit(lambda s, u, v: jr.render_frame_multiview(
        s, u, params, v, layout=layout))(scene, u, VIEWS)
    near_jax((c, d), want)


def test_multiview_rejects_bad_layouts():
    st = scene_to_torch(cube_scene(), "cpu")
    params = RenderParams(width=128, height=64)
    u = tr.default_frame_uniforms(128, 64)
    with pytest.raises(ValueError, match="divisible"):
        tr.render_frame_multiview(st, u, params, VIEWS + VIEWS[:1])
    with pytest.raises(ValueError, match="layout"):
        tr.render_frame_multiview(st, u, params, VIEWS, layout="grid")
    with pytest.raises(ValueError, match="non-empty"):
        tr.render_frame_multiview(st, u, params, ())


@pytest.mark.parametrize("corner", ["tc", "br"])
def test_pip_inset_and_jax(corner):
    """The inset is the pip camera's frame alone at (W, H) / 4, mirrored,
    over a 2-pixel dark border in the corner; hud_text is stripped from
    it; depth is the main view's; the whole frame is JAX's pip frame
    within the limit."""
    scene = cube_scene()
    st = scene_to_torch(scene, "cpu")
    W, H = 96, 64
    params = RenderParams(width=W, height=H)
    u = tr.default_frame_uniforms(W, H)
    u["camera_position"] = np.float32([0.03, 0.52, 2.07])
    u["pip_view"] = {
        "camera_position": np.float32([1.03, 0.52, 2.07]),
        "camera_rotation": np.asarray(
            ml.quat_from_yaw_pitch_roll(np.pi, 0.0, 0.0), np.float32)}
    seen = []

    def spy(color, depth, uniforms):
        seen.append("hud_text" in uniforms)
        return color, depth
    pfx = params.replace(post_fx=(spy,))
    c, d = tr.render_frame_pip(st, dict(u, hud_text=np.zeros(1, np.int32)),
                               pfx, corner=corner)
    assert seen == [True, False]          # main view, then the inset
    pw, ph = W // 4, H // 4
    solo, _ = render_frame(st, {**u, **u["pip_view"]},
                           params.replace(width=pw, height=ph))
    y0, x0 = (2, (W - pw) // 2) if corner == "tc" \
        else (H - ph - 2, W - pw - 2)
    assert torch.equal(c[y0:y0 + ph, x0:x0 + pw], solo.flip(1))
    border = torch.tensor(tr.PIP_BORDER_COLOR)
    assert (c[y0 - 2, x0 - 2:x0 + pw + 2] == border).all()
    main_c, main_d = render_frame(st, u, params)
    assert torch.equal(d, main_d)
    outside = torch.ones((H, W), dtype=torch.bool)
    outside[y0 - 2:y0 + ph + 2, x0 - 2:x0 + pw + 2] = False
    assert torch.equal(c[outside], main_c[outside])
    want = jax.jit(lambda s, uu: jr.render_frame_pip(
        s, uu, params, corner=corner))(scene, u)
    near_jax((c, d), want)


def test_pip_through_engine_frame_fn():
    """Engine(frame_fn=render_frame_pip) renders the pip frame, the way the
    game's --mirror does."""
    scene = cube_scene()
    params = RenderParams(width=96, height=64)
    eng = Engine(scene, params, device="cpu", frame_fn=tr.render_frame_pip)
    u = dict(eng.uniforms, camera_position=np.float32([0.0, 0.5, 2.0]),
             pip_view={"camera_position": np.float32([0.0, 0.5, 2.0])})
    c, _ = eng.render(u)
    assert torch.equal(c, tr.render_frame_pip(eng.scene, u, params)[0])
    assert not torch.equal(c, render_frame(eng.scene, u, params)[0])


# ---- render to texture -------------------------------------------------------

def screen_quad(w=2.0, h=1.5):
    """tests/test_rtt.py's monitor surface."""
    return {
        "position": np.asarray([[-w / 2, -h / 2, 0], [w / 2, -h / 2, 0],
                                [w / 2, h / 2, 0], [-w / 2, h / 2, 0]],
                               np.float32),
        "uv": np.asarray([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32),
        "normal": np.tile(np.float32([0, 0, 1]), (4, 1)),
        "color": np.ones((4, 4), np.float32),
        "indices": np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
    }


def slot_and_static(img, pkg):
    """Two scenes of package `pkg`'s scene module differing only in how
    `img` reaches the atlas: a placeholder slot, or the image packed
    statically; and the slot's atlas id."""
    rtt = jrtt if pkg is jscene else trtt
    slot = rtt.rtt_slot(*img.shape[:2])
    m_quad = np.eye(4, dtype=np.float32)
    m_quad[3, 2] = -3.0
    m_cube = np.eye(4, dtype=np.float32)
    m_cube[3, 0], m_cube[3, 2] = 5.0, -4.0
    cube = primitives.cube(1.0)
    a = [pkg.MeshInstance(screen_quad(), m_quad, texture=slot),
         pkg.MeshInstance(cube, m_cube)]
    b = [pkg.MeshInstance(screen_quad(), m_quad, texture=img),
         pkg.MeshInstance(cube, m_cube)]
    return (pkg.build_scene_buffers(a), rtt.atlas_id_of(a, slot),
            pkg.build_scene_buffers(b))


@pytest.mark.parametrize("shape,exact", [((16, 12), True), ((13, 9), False),
                                         ((40, 33), False)])
def test_write_atlas_equals_static_pack_and_jax(shape, exact):
    """write_atlas_texture gives the bytes of the port's static pack of the
    same image, base level and every mip, and JAX's write: on values m/256
    (every box mean exact) and on arbitrary floats, where the box filter's
    summation order decides a rounding."""
    rng = np.random.default_rng(sum(shape))
    img = (rng.integers(0, 257, shape + (4,)) / 256.0 if exact
           else rng.random(shape + (4,))).astype(np.float32)
    sc_a, tid, sc_b = slot_and_static(img, tscene)
    got = trtt.write_atlas_texture(scene_to_torch(sc_a, "cpu"), tid,
                                   torch.from_numpy(img))["atlas_data"]
    np.testing.assert_array_equal(got.numpy(), sc_b["atlas_data"])
    ja, jtid, _ = slot_and_static(img, jscene)
    assert jtid == tid
    want = jrtt.write_atlas_texture(jax.device_put(ja), tid, img)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want["atlas_data"]))


def test_write_atlas_clamps_offsets_as_dynamic_update_slice():
    """A slot whose offset would run past the atlas is written where
    dynamic_update_slice clamps it: flush with the atlas's edge."""
    atlas = torch.zeros((8, 8, 4), dtype=torch.uint8)
    sc = {"atlas_data": atlas, "atlas_offsets": torch.tensor([[6, 7]])}
    img = torch.ones((3, 2, 4))
    out = trtt.write_atlas_texture(sc, 0, img)["atlas_data"]
    assert (out[5:8, 6:8] == 255).all() and int(out.sum()) == 255 * 24
    assert int(atlas.sum()) == 0               # the scene's atlas is kept


def rtt_setup():
    """tests/test_rtt.py's two-pass scene: a monitor quad showing a far
    cube through a 32x32 slot."""
    slot = jrtt.rtt_slot(32, 32)
    m_quad = np.eye(4, dtype=np.float32)
    m_quad[3, 2] = -3.0
    m_tri = np.eye(4, dtype=np.float32)
    m_tri[3, 0], m_tri[3, 2] = 40.0, -44.0
    inst = [jscene.MeshInstance(screen_quad(), m_quad, texture=slot),
            jscene.MeshInstance(primitives.cube(1.0), m_tri)]
    sc = jscene.build_scene_buffers(inst)
    pp = RenderParams(width=32, height=32, cull_mode=0)
    mp = RenderParams(width=96, height=64, cull_mode=0)
    pu = jr.default_frame_uniforms(32, 32)
    pu["camera_position"] = np.float32([40.0, 0.0, -40.0])
    pu["clear_color"] = np.float32([0.1, 0.2, 0.3, 1.0])
    pu["mesh_visible"] = np.asarray([False, True])
    mu = jr.default_frame_uniforms(96, 64)
    mu["clear_color"] = np.zeros(4, np.float32)
    mu["cam"] = pu
    return sc, jrtt.atlas_id_of(inst, slot), pp, mp, mu


def test_render_frame_rtt_matches_hand_composed_and_jax():
    """The pass renders into the slot and the main view samples it: equal
    on every pixel to rendering the pass, writing it and rendering the
    main view by hand; the atlas it returns is that write; the frame is
    JAX's render_frame_rtt within the limit (and the monitor shows the
    feed: another pass clear colour repaints it)."""
    sc, tid, pp, mp, mu = rtt_setup()
    st = scene_to_torch(sc, "cpu")
    passes = (trtt.RttPass(tex_id=tid, params=pp, uniforms_key="cam"),)
    c, d, atlas = trtt.render_frame_rtt(st, mu, mp, passes,
                                        return_atlas=True)
    feed, _ = render_frame(st, mu["cam"], pp)
    st2 = trtt.write_atlas_texture(st, tid, feed)
    assert torch.equal(atlas, st2["atlas_data"])
    want_c, want_d = render_frame(
        st2, {k: v for k, v in mu.items() if k != "cam"}, mp)
    assert torch.equal(c, want_c) and torch.equal(d, want_d)
    jpasses = (jrtt.RttPass(tex_id=tid, params=pp, uniforms_key="cam"),)
    near_jax((c, d), jax.jit(lambda s, u: jrtt.render_frame_rtt(
        s, u, mp, jpasses))(jax.device_put(sc), mu))
    mu_b = dict(mu, cam=dict(mu["cam"], clear_color=np.float32(
        [0.9, 0.8, 0.2, 1.0])))
    c_b, _ = trtt.render_frame_rtt(st, mu_b, mp, passes)
    assert int((c_b - c).abs().amax(-1).gt(1e-4).sum()) > 50


def test_engine_rtt_passes():
    """Engine(rtt_passes=...) fills each pass's uniforms with defaults and
    renders through render_frame_rtt; moving the pass camera changes only
    the monitor's colours; frame_fn does not combine with it (JAX's
    ValueError), nor stats with a pass."""
    sc, tid, pp, mp, mu = rtt_setup()
    passes = (trtt.RttPass(tex_id=tid, params=pp, uniforms_key="cctv"),)
    eng = Engine(sc, mp, device="cpu", rtt_passes=passes)
    assert set(eng.uniforms["cctv"]) == set(
        tr.default_frame_uniforms(32, 32))
    eng.uniforms["cctv"]["camera_position"] = np.float32([40, 0, -40])
    c0, d0 = eng.render()
    eng.uniforms["cctv"]["camera_position"] = np.float32([400, 0, -400])
    c1, d1 = eng.render()
    assert float((c1 - c0).abs().max()) > 0.05 and torch.equal(d0, d1)
    with pytest.raises(ValueError, match="frame_fn"):
        Engine(sc, mp, device="cpu", rtt_passes=passes,
               frame_fn=tr.render_frame_pip)
    with pytest.raises(ValueError, match="stats"):
        trtt.RttPass(tex_id=1, uniforms_key="x",
                     params=RenderParams(8, 8, active_cap_stats=True))


def test_atlas_id_of_matches_jax():
    imgs = [np.full((4, 4, 4), s / 4, np.float32) for s in range(3)]
    quad = screen_quad()

    def insts(pkg):
        return [pkg.MeshInstance(quad, texture=imgs[0]),
                pkg.MeshInstance(quad, texture=imgs[1],
                                 normal_texture=imgs[2]),
                pkg.MeshInstance(quad, texture=imgs[0])]
    for img in imgs:
        assert trtt.atlas_id_of(insts(tscene), img) \
            == jrtt.atlas_id_of(insts(jscene), img)
    with pytest.raises(ValueError, match="not used"):
        trtt.atlas_id_of(insts(tscene), np.zeros((4, 4, 4), np.float32))


def test_box_downsample_sums_in_pack_order():
    """The box filter's float32 rounding is the pack-time numpy mean's, on
    odd and even sizes."""
    rng = np.random.default_rng(3)
    for shape in ((9, 7, 4), (64, 64, 4), (3, 128, 4)):
        im = (rng.random(shape) * 3.7).astype(np.float32)
        np.testing.assert_array_equal(
            trtt.box_downsample(torch.from_numpy(im)).numpy(),
            tscene._box_downsample(im).astype(np.float32))
