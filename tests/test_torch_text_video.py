"""The port's burned-in text and video capture against the JAX package's:
utils/font.py and utils/video.py are copies pinned to their sources;
ops/text.py packs as JAX's does and its composite_text equals JAX's at
atol 1e-6, with every pixel no glyph covers bit for bit; the AVI bytes of
a recording equal those of the JAX package's writer."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softwarerenderer_tpu import RenderParams
from softwarerenderer_tpu.engine import renderer as jr
from softwarerenderer_tpu.models import primitives
from softwarerenderer_tpu.models import scene as scene_mod
from softwarerenderer_tpu.ops import text as jtext
from softwarerenderer_tpu.utils import font as jfont
from softwarerenderer_tpu.utils import mathlib as ml
from softwarerenderer_tpu.utils import video as jvideo
from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.ops import text as ttext
from softwarerenderer_tpu_torch.utils import font as tfont
from softwarerenderer_tpu_torch.utils import video as tvideo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FONT = tfont.build_font(cell_h=12)
GW = FONT["cell_w"]
TEXT_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this file runs: its frames are many small
    ops, which torch's default pool slows down when the suite's workers
    share the cores (tests/test_torch_dust2.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("rel", ["utils/font.py", "utils/video.py"])
def test_copy_equals_source(rel):
    """The copied numpy modules equal their JAX sources line for line but
    for the package name in module paths."""
    with open(os.path.join(REPO, "softwarerenderer_tpu", rel)) as f:
        want = f.read().replace("softwarerenderer_tpu.",
                                "softwarerenderer_tpu_torch.")
    with open(os.path.join(REPO, "softwarerenderer_tpu_torch", rel)) as f:
        assert f.read() == want


def test_font_atlas_equals_jax():
    j = jfont.build_font(cell_h=12)
    assert (FONT["cell_h"], FONT["cell_w"]) == (j["cell_h"], j["cell_w"])
    np.testing.assert_array_equal(FONT["bitmaps"], j["bitmaps"])


def test_pack_text_equals_jax():
    entries = [("hp 100", (3, 4)), ("red", (-1, 2), (1.0, 0.0, 0.0)),
               ("A \t\x01" + chr(200), (7, 9), (0.2, 0.3, 0.4, 0.5)),
               ("too long for eight", (0, 0)), ("dropped", (1, 1))]
    got = ttext.pack_text(entries, max_strings=4, max_chars=8)
    want = jtext.pack_text(entries, max_strings=4, max_chars=8)
    for k in ("glyphs", "pos", "color"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert ttext.text_size(FONT, "abc") == jtext.text_size(FONT, "abc")


# Each case: the entries and the frame size.  Strings on screen,
# overlapping, translucent, hidden, hanging off each edge and wholly off
# screen (they vanish: a clamp never drags them back into view).
COMPOSITE_CASES = {
    "on_screen": ([("hp 100", (2, 3), (0.0, 1.0, 0.0)),
                   ("fps", (40, 20), (1.0, 1.0, 0.4, 0.6)),
                   ("over", (4, 5), (0.0, 0.0, 1.0, 0.8))], (48, 96)),
    "edges": ([("W", (-(GW // 2), 4)), ("right", (90, 10)),
               ("top", (10, -5)), ("bottom", (20, 44))], (48, 96)),
    "off_screen": ([("W", (10_000, -50)), ("W", (-10_000, 5)),
                    ("W", (5, 10_000)), ("W", (-2 ** 30, 2 ** 30))],
                   (24, 40)),
    "hidden": ([], (24, 40)),
}


@pytest.mark.parametrize("case", sorted(COMPOSITE_CASES))
def test_composite_text_matches_jax(case):
    entries, (h, w) = COMPOSITE_CASES[case]
    rng = np.random.default_rng(len(entries))
    buf = rng.uniform(0.1, 0.9, (h, w, 4)).astype(np.float32)
    packed = ttext.pack_text(entries, max_strings=6, max_chars=8)
    want = np.asarray(jax.jit(lambda c, p: jtext.composite_text(
        c, FONT["bitmaps"], p))(jnp.asarray(buf), packed))
    got = ttext.composite_text(
        torch.from_numpy(buf), torch.from_numpy(FONT["bitmaps"]),
        {k: torch.from_numpy(v) for k, v in packed.items()}).numpy()
    assert got.shape == buf.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TEXT_ATOL)
    untouched = (want == buf).all(-1)
    np.testing.assert_array_equal(got[untouched], buf[untouched])
    if case in ("on_screen", "edges"):
        assert (~untouched).sum() > 20
    else:
        np.testing.assert_array_equal(got, buf)


def test_text_overlay_fx_in_render_frame_matches_jax():
    """text_overlay_fx as a callable post-FX stage: the port's frame with
    the HUD burned in equals its frame without it wherever no glyph
    covers, and JAX's burned-in frame within TEXT_ATOL there too."""
    sc = scene_mod.build_scene_buffers(
        [scene_mod.MeshInstance(primitives.cube(1.0),
                                ml.translation([0.0, 0.0, -3.0]))])
    params = RenderParams(width=64, height=48)
    u = jr.default_frame_uniforms(64, 48)
    u["hud_text"] = ttext.pack_text([("hp 100", (2, 2), (0.0, 1.0, 0.0)),
                                     ("+", (30, 20))],
                                    max_strings=2, max_chars=8)
    eng = Engine(sc, params.replace(post_fx=(ttext.text_overlay_fx(FONT),)),
                 device="cpu")
    got = eng.render(u)[0].numpy()
    base = Engine(sc, params, device="cpu").render(u)[0].numpy()
    want = np.asarray(jax.jit(lambda s, uu: jr.render_frame(
        s, uu, params.replace(post_fx=(jtext.text_overlay_fx(FONT),))))(
            sc, u)[0])
    jbase = np.asarray(jax.jit(lambda s, uu: jr.render_frame(
        s, uu, params))(sc, u)[0])
    covered = (want != jbase).any(-1)
    assert covered.sum() > 20
    np.testing.assert_array_equal(got[~covered], base[~covered])
    # over the pixels whose frame below the text is JAX's (all but edge
    # pixels of the cube, PARITY.md D5)
    same = np.abs(base - jbase).max(-1) <= TEXT_ATOL
    assert same.mean() > 0.99
    np.testing.assert_allclose(got[covered & same], want[covered & same],
                               rtol=0, atol=TEXT_ATOL)
    # without the key the stage passes the frame through
    u.pop("hud_text")
    np.testing.assert_array_equal(eng.render(u)[0].numpy(), base)


def _frames(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for _ in range(n)]


@pytest.mark.parametrize("h,w,fps", [(16, 24, 30.0), (9, 13, 24.0)])
def test_avi_bytes_equal_jax_writer(tmp_path, h, w, fps):
    """The same frames give the JAX writer's file byte for byte (odd
    widths pad rows to 4 bytes), and read back exactly."""
    frames = _frames(3, h, w)
    paths = []
    for mod in (tvideo, jvideo):
        p = str(tmp_path / f"{mod.__name__.split('.')[0]}.avi")
        with mod.AviWriter(p, fps=fps) as wr:
            for f in frames:
                wr.add(f)
        paths.append(p)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    back, got_fps = tvideo.read_avi(paths[0])
    np.testing.assert_array_equal(back, np.stack(frames))
    assert got_fps == pytest.approx(fps, abs=1e-3)
