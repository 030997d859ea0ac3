"""The port's model viewer against the JAX package's, on the CPU: framing
and orbit, the four debug views and the ray-traced mode against JAX's
frames, the engines sharing one device scene, F10's GLB export, --record
and the entry point.  The animation clock (time.monotonic) is pinned in
both packages, and torch runs on one thread.

Limits, frames of RGB8 pixels off by > 2 against JAX's jitted frame (each
about twice the share measured on the cube fixture at 160x120 on the CPU;
PERF.md §2): NONE, OVERDRAW and DEPTH 0 measured, held at the
simple-scene limit 0.1 %; WIREFRAME 0.41 % measured (line edges, where
XLA contracts the edge function), bound 0.8 %.  The ray-traced frame at
tests/test_torch_raytrace.py's limits on its float color and depth
(coverage flips on < 0.2 % of pixels, depth at atol 1e-5, color under
1e-3 on > 99 % of pixels; measured: 0 flips, depth within 6.0e-8, color
under 1e-3 everywhere) and by RGB8 share at 0.1 % (0 measured).
"""

import os

import numpy as np
import pytest
import torch

import softwarerenderer_tpu.ops.debugviz  # noqa: F401 (imported outside jit)
from softwarerenderer_tpu.apps import viewer as jax_viewer
from softwarerenderer_tpu.config import DebugMode as JaxDebugMode
from softwarerenderer_tpu.io_host import model_loader as jax_loader
from softwarerenderer_tpu_torch import DebugMode
from softwarerenderer_tpu_torch.apps import viewer
from softwarerenderer_tpu_torch.io_host import model_loader as port_loader
from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR
from softwarerenderer_tpu_torch.utils.video import read_avi
from tests.test_torch_io_host import assert_same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
W, H = 160, 120
CLOCK = 1234.5           # the pinned time.monotonic, in both packages
NO_INPUT = {"keys": set(), "mouse_delta": (0.0, 0.0)}
MODE_OFF_MAX = {"NONE": 1e-3, "WIREFRAME": 8e-3, "OVERDRAW": 1e-3,
                "DEPTH": 1e-3}
RT_FRAMES = {}           # the port's ray-traced (color, depth) by rt_cap


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def pinned_clock(monkeypatch):
    import time
    monkeypatch.setattr(time, "monotonic", lambda: CLOCK)


@pytest.fixture(scope="module")
def viewers():
    """The port's and the JAX package's viewer on cube.dae at 160x120,
    ray-traced mode at --rt-cap 24."""
    port_loader.clear_caches()
    jax_loader.clear_caches()
    path = os.path.join(FIXDIR, "cube.dae")
    kw = dict(width=W, height=H, render_scale=1.0, headless=True,
              rt_cap=(24,))
    pv = viewer.Viewer(path, device="cpu", **kw)
    jv = jax_viewer.Viewer(path, **kw)
    yield pv, jv
    pv.window.close()
    jv.window.close()


def _off_share(a, b):
    return float((np.abs(a.astype(np.int32) - b.astype(np.int32))
                  .max(-1) > 2).mean())


def _assert_rt_close(got, want, msg):
    """tests/test_torch_raytrace.py's limits for ray-traced frames."""
    (c, d), (jc, jd) = got, want
    flip = (d == DEPTH_CLEAR) != (jd == DEPTH_CLEAR)
    assert flip.mean() < 2e-3, (msg, flip.mean())
    cov = (jd != DEPTH_CLEAR) & ~flip
    assert cov.mean() > 0.05, msg                 # the cube is on screen
    np.testing.assert_allclose(d[cov], jd[cov], rtol=0, atol=1e-5,
                               err_msg=msg)
    diff = np.abs(c - jc).max(-1)
    assert (diff < 1e-3).mean() > 0.99, (msg, diff.max())


def _step_both(pv, jv, inputs=NO_INPUT):
    pv.step(1 / 60, inputs)
    jv.step(1 / 60, inputs)
    return pv.window.last_frame, jv.window.last_frame


def test_viewer_needs_card(monkeypatch):
    """Viewer(device="cuda") and the entry point's default raise without a
    card; neither carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = os.path.join(FIXDIR, "cube.fbx")
    with pytest.raises(RuntimeError, match="CUDA"):
        viewer.Viewer(path, width=32, height=24, headless=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        viewer.main([path, "--headless", "--frames", "1"])


def test_framing_orbit_and_keys_equal_jax(viewers):
    """Auto-frame (center, radius, distance), the camera, and the same
    inputs (a click capturing the mouse, a drag, zoom keys, 'f' presses)
    move both viewers alike."""
    pv, jv = viewers
    for k in ("center", "radius", "distance", "yaw", "pitch", "n_tris"):
        np.testing.assert_array_equal(getattr(pv, k), getattr(jv, k), k)
    for g, w in zip(pv._camera(), jv._camera()):
        np.testing.assert_array_equal(g, w)
    script = [{"keys": set(), "mouse_delta": (0.0, 0.0), "mouse_down": True},
              {"keys": {"w"}, "mouse_delta": (30.0, -12.0)},
              {"keys": {"w", "="}, "mouse_delta": (-4.0, 200.0)},
              {"keys": {"s"}, "mouse_delta": (0.0, 0.0), "mouse_down": True},
              {"keys": {"f"}, "mouse_delta": (9.0, 9.0)},
              {"keys": set(), "mouse_delta": (0.0, 0.0)},
              {"keys": {"f"}, "mouse_delta": (0.0, 0.0)}]
    modes = []
    for inp in script:
        _step_both(pv, jv, inp)
        for k in ("distance", "yaw", "pitch"):
            assert getattr(pv, k) == getattr(jv, k), k
        modes.append((pv.mode.name, jv.mode.name))
    assert [m for m, _ in modes] == [m for _, m in modes]
    assert modes[-1][0] == "OVERDRAW" and pv.window.mouse_captured is False
    for g, w in zip(pv._camera(), jv._camera()):
        np.testing.assert_array_equal(g, w)
    pv.mode, jv.mode = DebugMode.NONE, JaxDebugMode.NONE
    pv.yaw = jv.yaw = 0.6
    pv.pitch = jv.pitch = -0.3
    pv.distance = jv.distance = jv.radius * 2.2


@pytest.mark.parametrize("mode", sorted(MODE_OFF_MAX))
def test_debug_views_match_jax(viewers, mode):
    """Each debug view's frame against JAX's, within MODE_OFF_MAX."""
    pv, jv = viewers
    pv.mode, jv.mode = DebugMode[mode], JaxDebugMode[mode]
    got, want = _step_both(pv, jv)
    pv.mode, jv.mode = DebugMode.NONE, JaxDebugMode.NONE
    assert got.shape == want.shape == (H, W, 3) and got.dtype == np.uint8
    assert (want.std(-1) > 0).mean() > 0.05 or mode == "DEPTH"
    assert _off_share(got, want) <= MODE_OFF_MAX[mode], mode


@pytest.mark.parametrize("cap", [(24,), (8, 24), 24],
                         ids=["cap24", "ladder8_24", "int24"])
def test_raytraced_mode_matches_jax(viewers, cap):
    """'g' at --rt-cap 24 and the ladder 8 24: the bundle route, the same
    frame on every value whatever the cap, against JAX's (24,) frame at
    the ray-traced limits (float color and depth) and by RGB8 share."""
    pv, jv = viewers
    pv.rt_cap = cap
    pv.engines.pop((DebugMode.NONE, True), None)
    pv.raytrace = jv.raytrace = True
    try:
        got, want = _step_both(pv, jv)
        u = pv.frame_uniforms()
        pc, pd = pv._engine_for(DebugMode.NONE).render(u)
        jc, jd = jv._engine_for(JaxDebugMode.NONE).render(u)
        ref = pv.engines[(DebugMode.NONE, True)].frame_fn.keywords
    finally:
        pv.raytrace = jv.raytrace = False
    assert ref["cluster_cap"] == cap
    _assert_rt_close((pc.numpy(), pd.numpy()),
                     (np.asarray(jc), np.asarray(jd)), f"rt_cap={cap}")
    assert _off_share(got, want) <= 1e-3
    RT_FRAMES[cap] = (pc, pd)
    first = next(iter(RT_FRAMES.values()))
    assert torch.equal(first[0], pc) and torch.equal(first[1], pd)


def test_mode_engines_share_the_scene(viewers):
    """Every engine a mode creates holds the first engine's scene tensors,
    not a second copy."""
    pv, _ = viewers
    for mode in DebugMode:
        pv._engine_for(mode)
    first = pv.engines[(DebugMode.NONE, False)].scene
    assert len(pv.engines) >= 4
    for key, eng in pv.engines.items():
        for k, t in eng.scene.items():
            assert t.data_ptr() == first[k].data_ptr(), (key, k)


def test_export_glb_matches_jax(tmp_path, monkeypatch):
    """F10 in both viewers on cube.3ds: the GLBs reload (in either
    package) to equal models, with the source model's positions."""
    monkeypatch.chdir(tmp_path)
    path = os.path.join(FIXDIR, "cube.3ds")
    kw = dict(width=48, height=32, render_scale=1.0, headless=True)
    pv = viewer.Viewer(path, device="cpu", **kw)
    jv = jax_viewer.Viewer(path, **kw)
    press = {"keys": {"f10"}, "mouse_delta": (0.0, 0.0)}
    pv.step(1 / 60, press)
    os.rename("viewer_export_000.glb", "port.glb")
    jv.step(1 / 60, press)
    port_loader.clear_caches()
    jax_loader.clear_caches()
    got = port_loader.load_model("port.glb")
    want = jax_loader.load_model("viewer_export_000.glb")
    assert_same(got, want, "glb")
    assert_same(jax_loader.load_model("port.glb"), want, "glb in JAX")
    src = port_loader.load_model(path)
    assert len(got.meshes) == len(src.meshes) == 1
    np.testing.assert_array_equal(got.meshes[0]["position"],
                                  src.meshes[0]["position"])


def test_record_holds_the_presented_frames(tmp_path):
    """--record writes every presented frame at its fps: run(3) records
    3 frames, each the frame the window was given."""
    clip = str(tmp_path / "orbit.avi")
    v = viewer.Viewer(os.path.join(FIXDIR, "cube.dae"), width=96,
                      height=64, render_scale=1.0, headless=True,
                      record=clip, record_fps=12.0, device="cpu")
    shown = []
    present = v.window.present
    v.window.present = lambda rgb, overlay=None: (
        shown.append(rgb.copy()), present(rgb, overlay))
    v.run(frames=3)
    frames, fps = read_avi(clip)
    assert frames.shape == (3, 64, 96, 3)
    assert fps == pytest.approx(12.0, abs=1e-3)
    np.testing.assert_array_equal(frames, np.stack(shown))
    assert (frames[0].std(-1) > 0).sum() > 100


def test_main_headless_on_the_cpu(tmp_path):
    """The entry point with --device cpu renders --frames PNGs."""
    out = tmp_path / "v.png"
    viewer.main([os.path.join(FIXDIR, "cube.fbx"), "--headless",
                 "--frames", "3", "--width", "64", "--height", "48",
                 "--render-scale", "1", "--device", "cpu",
                 "--out", str(out)])
    names = sorted(os.listdir(tmp_path))
    assert names == ["v.png", "v_0001.png", "v_0002.png"]
    from PIL import Image
    assert np.asarray(Image.open(out)).shape == (48, 64, 3)


def test_lod_scene_equals_jax(tmp_path):
    """--lod on a single-mesh FBX sphere: the packed scene with its LOD
    levels equals the JAX viewer's, array for array."""
    from softwarerenderer_tpu_torch.io_host import fbx
    from softwarerenderer_tpu_torch.models import primitives
    sphere = primitives.uv_sphere(rings=8, sectors=16)
    path = str(tmp_path / "sphere.fbx")
    fbx.write_fbx(path, sphere["position"], sphere["indices"],
                  normals=sphere["normal"], uvs=sphere["uv"])
    port_loader.clear_caches()
    jax_loader.clear_caches()
    kw = dict(width=32, height=24, render_scale=1.0, headless=True,
              lod=True)
    pv = viewer.Viewer(path, device="cpu", **kw)
    jv = jax_viewer.Viewer(path, **kw)
    assert sorted(pv.scene) == sorted(jv.scene)
    for k in jv.scene:
        g, w = np.asarray(pv.scene[k]), np.asarray(jv.scene[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert pv.n_tris == jv.n_tris > 8 * 16 * 2
