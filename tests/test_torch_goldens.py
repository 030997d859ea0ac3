"""The port renders golden configs 1 to 5 and the feature goldens
(tests/goldens/) within the rule of tests/test_goldens.py, through its CPU
path (feature_mips against the JAX package's op-by-op frame)."""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")


def render_golden_torch(n):
    """scripts/make_goldens.render_golden(n) through the port's Engine."""
    import bench
    from scripts.make_goldens import GOLDEN_SIZES
    from softwarerenderer_tpu.models import scene as scene_mod
    from softwarerenderer_tpu_torch import RenderParams
    from softwarerenderer_tpu_torch.engine import Engine

    w, h = GOLDEN_SIZES[n]
    insts, _, _, ufn, ekw = bench.config_workload(n)
    assert ufn is None and not ekw       # the default shaders and uniforms
    eng = Engine(scene_mod.build_scene_buffers(insts),
                 RenderParams(width=w, height=h), device="cpu")
    return eng.present(dict(eng.uniforms))


@pytest.mark.parametrize("n", [1, 2])
def test_golden_config_torch(n):
    from PIL import Image
    golden = np.asarray(Image.open(os.path.join(GOLDEN_DIR,
                                                f"config{n}.png")))
    got = render_golden_torch(n)
    assert got.shape == golden.shape
    diff = np.abs(got.astype(np.int32) - golden.astype(np.int32))
    frac_off = float(np.mean(np.any(diff > 2, axis=-1)))
    assert frac_off < 2e-3, f"config{n}: {frac_off:.4%} pixels off by >2"
    assert float(np.mean(diff)) < 0.5


def _off_share(got, want):
    """tests/test_goldens.py's measure: the share of pixels off by > 2."""
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return float(np.mean(np.any(diff > 2, axis=-1)))


def test_golden_feature_wireframe_torch():
    """The port's own copy of the feature_wireframe scene (scenes.py),
    rendered by its Engine, against the PNG the JAX package rendered."""
    from PIL import Image
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.engine import Engine
    scene, params, u = scenes.wireframe_golden_frame()
    got = Engine(scene, params, device="cpu").present(u)
    golden = np.asarray(Image.open(os.path.join(
        GOLDEN_DIR, "feature_wireframe.png")))
    frac_off = _off_share(got, golden)
    assert frac_off < 2e-3, f"wireframe: {frac_off:.4%} pixels off by >2"


def test_golden_config4_torch():
    """config4 is the bench scene from the bench camera.  Its PNG was
    rendered from the Dust2 asset, which a checkout does not hold: without
    it bench.build_scene() falls back to the seeded soup, and the JAX
    package's own frame misses the PNG as far as the port's does.  So the
    port's frame is held, by the goldens' rule, against the frame
    scripts/make_goldens.render_golden(4) renders here, and against the PNG
    only where the asset exists."""
    import bench
    from PIL import Image
    from scripts.make_goldens import render_golden
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.engine import Engine
    scene, params, u = scenes.config4_golden_frame()
    got = Engine(scene, params, device="cpu").present(u)
    want = np.asarray(render_golden(4))
    frac_off = _off_share(got, want)
    assert frac_off < 2e-3, f"config4: {frac_off:.4%} pixels off by >2"
    golden = np.asarray(Image.open(os.path.join(GOLDEN_DIR, "config4.png")))
    if os.path.exists(bench.DUST2):
        assert _off_share(got, golden) < 2e-3
    else:
        # The same miss on both sides: the PNG shows another scene.
        assert abs(_off_share(got, golden) - _off_share(want, golden)) < 2e-3


@pytest.mark.parametrize("n", [3, 5])
def test_golden_config_own_scene_torch(n):
    """Config 3 (41 meshes under four lights, the lit shaders) and config
    5 (1,100 cubes, the game's shaders, far clip 300) from the port's own
    copies (scenes.golden_config, golden_uniforms, golden_shaders),
    through its Engine, against the PNGs the JAX package rendered.
    Config 3's camera puts floor pixel centres on texel edges: 0.143 % of
    its pixels are off by > 2 (the game's shader on the same scene misses
    the same pixels), under the rule's 0.2 %."""
    from PIL import Image
    from softwarerenderer_tpu_torch import RenderParams, scenes
    from softwarerenderer_tpu_torch.engine import Engine
    from softwarerenderer_tpu_torch.models.scene import build_scene_buffers
    w, h = scenes.GOLDEN_SIZES[n]
    eng = Engine(build_scene_buffers(scenes.golden_config(n)),
                 RenderParams(width=w, height=h), device="cpu",
                 **scenes.golden_shaders(n))
    got = eng.present(scenes.golden_uniforms(n, eng.uniforms))
    golden = np.asarray(Image.open(os.path.join(GOLDEN_DIR,
                                                f"config{n}.png")))
    frac_off = _off_share(got, golden)
    assert frac_off < 2e-3, f"config{n}: {frac_off:.4%} pixels off by >2"
    diff = np.abs(got.astype(np.int32) - golden.astype(np.int32))
    assert float(np.mean(diff)) < 0.5


@pytest.mark.parametrize("name", ["shadows", "point_shadows",
                                  "spot_shadows"])
def test_golden_feature_shadows_torch(name):
    """The three shadowed feature frames from the port's own copies
    (scenes.shadow_golden_frame), through the frame functions as
    scripts/make_goldens.py calls JAX's, against their PNGs."""
    from PIL import Image
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.engine import to_rgb8
    from softwarerenderer_tpu_torch.models.convert import scene_to_torch
    scene, params, u, frame_fn, _ = scenes.shadow_golden_frame(name)
    color, _ = frame_fn(scene_to_torch(scene, "cpu"), u, params)
    got = to_rgb8(color).numpy()
    golden = np.asarray(Image.open(os.path.join(
        GOLDEN_DIR, f"feature_{name}.png")))
    frac_off = _off_share(got, golden)
    assert frac_off < 2e-3, f"{name}: {frac_off:.4%} pixels off by >2"


@pytest.mark.parametrize("name", ["trilinear", "ssaa", "ssao"])
def test_golden_feature_filtering_torch(name):
    """feature_trilinear, feature_ssaa (ssaa=4: the frame at 1280x960)
    and feature_ssao from the port's own copies
    (scenes.feature_golden_frame), through its Engine, against the PNGs
    the JAX package rendered (measured: 0.0143 %, 0.1510 % and 0.0469 %
    of pixels off by > 2; the ssaa frame's floor puts sample centres on
    texel edges, test_golden_feature_mips_torch)."""
    from PIL import Image
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.engine import Engine
    scene, params, u, shaders = scenes.feature_golden_frame(name)
    got = Engine(scene, params, device="cpu", **shaders).present(u)
    golden = np.asarray(Image.open(os.path.join(
        GOLDEN_DIR, f"feature_{name}.png")))
    frac_off = _off_share(got, golden)
    assert frac_off < 2e-3, f"{name}: {frac_off:.4%} pixels off by >2"


def test_golden_feature_skinning_torch():
    """feature_skinning: a three-bone tentacle skinned at anim_time 0.6 s
    over a floor, from the port's own copy (scenes.feature_golden_frame),
    through its Engine, against the PNG the JAX package rendered, by the
    goldens' rule: 0.180 % of pixels off by > 2 (measured), the floor's
    texel-edge rows of the mips golden (XLA's jitted frame contracts the
    interpolation's FMAs).  The JAX package run op by op gives the port's
    frame on every pixel."""
    from PIL import Image
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.engine import Engine
    scene, params, u, shaders = scenes.feature_golden_frame("skinning")
    got = Engine(scene, params, device="cpu", **shaders).present(u)
    golden = np.asarray(Image.open(os.path.join(GOLDEN_DIR,
                                                "feature_skinning.png")))
    frac_off = _off_share(got, golden)
    assert frac_off < 2e-3, f"skinning: {frac_off:.4%} pixels off by >2"


def test_golden_feature_mips_torch():
    """feature_mips: receding floor strips with per-triangle mips and
    nearest sampling.  Its camera stands 1.5 over the floor with a 90°
    FOV at 320x240, and uv runs 16 times over 64 texels, so whole rows of
    pixel centres sit exactly on texel edges.  The PNG was rendered by
    XLA's jitted frame, which contracts the interpolation's multiply-adds
    into FMAs; one ulp of uv then picks the other texel on those rows.
    The JAX package run op by op, which rounds every operation once as
    the port does (and as the CUDA kernels do, built with -fmad=false),
    gives the port's frame and misses the PNG on the same 1.84 % of
    pixels.  So the port's frame is held by the goldens' rule against
    that frame (measured: 0 pixels off), its mips against the jitted
    frame's (tests/test_torch_texture_filtering.py), and its distance
    from the PNG must be the op-by-op frame's: the fault is the PNG's
    rounding, open in ROADMAP.md (queue C)."""
    import jax
    from PIL import Image
    from softwarerenderer_tpu import RenderParams as JaxRenderParams
    from softwarerenderer_tpu.engine import renderer as jr
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.engine import Engine
    scene, params, u, shaders = scenes.feature_golden_frame("mips")
    got = Engine(scene, params, device="cpu", **shaders).present(u)
    with jax.disable_jit():
        color, _ = jr.render_frame(scene, u, JaxRenderParams(
            width=320, height=240, use_mipmaps=True, binned=False,
            use_pallas=False))
    want = np.asarray(jr.to_rgb8(color))
    assert _off_share(got, want) < 2e-3
    golden = np.asarray(Image.open(os.path.join(GOLDEN_DIR,
                                                "feature_mips.png")))
    assert abs(_off_share(got, golden) - _off_share(want, golden)) < 2e-3
