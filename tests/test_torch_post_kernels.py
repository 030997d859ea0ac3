"""The post chain's CUDA kernels (csrc/post_fx.cu, ops/post_kernels.py)
against their plain twins.

On the card (marked ``card``; each test skips without one, the check made
in a fixture):

    python -m pytest tests/test_torch_post_kernels.py -q

each stage's kernel equals its eager twin by torch.equal at 3840 x 2160,
1920 x 1080 and four small or thin frames, on seeded frames with clear and
covered pixels, values above bloom's threshold and edges that FXAA blends
(the sky from a uint8 and a float32 panorama, bloom and the tone map with
float and device-scalar parameters); the five stages issued one after
another through engine/renderer.apply_post_fx make no hidden wait
(torch.cuda.set_sync_debug_mode("error")) and launch one kernel each; a
halo larger than the shared tile raises.

On the CPU every stage runs its twin and launches nothing, and the kernel
wrappers refuse what the kernels do not take."""

import functools

import numpy as np
import pytest
import torch

from softwarerenderer_tpu_torch import RenderParams
from softwarerenderer_tpu_torch.engine import renderer
from softwarerenderer_tpu_torch.ops import (bloom, fxaa, post_kernels, sky,
                                            ssao, tonemap)
from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR

# (H, W): the image-quality frame's supersampled and 1080p sizes, an odd
# size, one smaller than every halo, one row and one column.
SIZES = ((2160, 3840), (1080, 1920), (33, 65), (7, 5), (1, 64), (64, 1))
CHAIN = ("sky", "ssao", "bloom", "tonemap", "fxaa")
# Each case: (stage, parameter variant).
CASES = (("sky", "u8"), ("sky", "f32"), ("ssao", "default"),
         ("ssao", "radii"), ("bloom", "float"), ("bloom", "device"),
         ("tonemap", "aces"), ("tonemap", "aces_device"),
         ("tonemap", "reinhard"), ("fxaa", "default"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.cuda.get_device_name(0)


@functools.lru_cache(maxsize=2)
def _host_frame(h: int, w: int, seed: int):
    """A seeded (H, W, 4) color frame of flat blocks (edges FXAA blends)
    with noise, from -0.1 (the tone map clamps it) to 1.6 (above bloom's
    threshold), and a depth buffer of blocks with noise (creases SSAO
    darkens) and clear blocks."""
    g = np.random.default_rng(seed)
    bh, bw = max(1, h // 9), max(1, w // 13)
    blocks = g.uniform(-0.1, 1.6, ((h + bh - 1) // bh, (w + bw - 1) // bw, 4))
    color = np.repeat(np.repeat(blocks, bh, 0), bw, 1)[:h, :w]
    color = color + g.normal(0.0, 0.05, color.shape)
    near = -g.uniform(0.05, 0.999, ((h + 3) // 4, (w + 3) // 4))
    depth = np.repeat(np.repeat(near, 4, 0), 4, 1)[:h, :w] \
        + g.normal(0.0, 0.01, (h, w))
    depth = np.clip(depth, -1.0, 0.0)
    clear = g.uniform(size=(h // 3 + 1, w // 3 + 1)) < 0.3
    depth[np.repeat(np.repeat(clear, 3, 0), 3, 1)[:h, :w]] = DEPTH_CLEAR
    return color.astype(np.float32), depth.astype(np.float32)


def _frame(h, w, device, seed=0):
    color, depth = _host_frame(h, w, seed)
    return (torch.from_numpy(color).to(device),
            torch.from_numpy(depth).to(device))


def _panorama(dtype, device, seed=5):
    pano = np.random.default_rng(seed).integers(0, 256, (64, 128, 4))
    if dtype == "u8":
        return torch.from_numpy(pano.astype(np.uint8)).to(device)
    return torch.from_numpy(pano.astype(np.float32) / 200.0).to(device)


def _camera():
    """Host uniforms for the sky: a turned camera at 75 degrees."""
    return {"camera_rotation": np.float32([0.1, 0.2, 0.05, 0.97]),
            "fov_degrees": np.float32(75.0)}


def _stage_pair(stage: str, variant: str, device):
    """(stage(color, depth), twin(color, depth)) -> color: the dispatching
    function and its plain twin, with the case's parameters."""
    scalar = functools.partial(torch.tensor, dtype=torch.float32,
                               device=device)
    if stage == "sky":
        pano, cam = _panorama(variant, device), _camera()
        return (lambda c, d: sky.composite_sky(c, d, cam, pano)[0],
                lambda c, d: sky.composite_sky_plain(c, d, cam, pano)[0])
    if stage == "ssao":
        u = {"near_clip": scalar(0.1), "far_clip": scalar(200.0)}
        kw = {"radii": (1, 3, 16), "range_frac": 0.05, "bias_frac": 0.001,
              "strength": 0.6} if variant == "radii" else {}
        return (lambda c, d: ssao.apply_ssao(c, d, u, **kw)[0],
                lambda c, d: ssao.apply_ssao_plain(c, d, u, **kw)[0])
    if stage == "bloom":
        thr, st = (scalar(0.8), scalar(0.7)) if variant == "device" \
            else (0.8, 0.7)
        return (lambda c, d: bloom.apply_bloom(c, thr, st),
                lambda c, d: bloom.apply_bloom_plain(c, thr, st))
    if stage == "tonemap":
        mode = variant.split("_")[0]
        u = {"exposure": scalar(1.7)} if variant.endswith("device") else {}
        return (lambda c, d: tonemap.apply_tonemap(c, mode, u),
                lambda c, d: tonemap.apply_tonemap_plain(c, mode, u))
    return (lambda c, d: fxaa.apply_fxaa(c),
            lambda c, d: fxaa.apply_fxaa_plain(c))


def _post_uniforms(device):
    u = dict(_camera(), near_clip=np.float32(0.1), far_clip=np.float32(200.0),
             exposure=np.float32(1.3), bloom_threshold=np.float32(0.75),
             bloom_strength=np.float32(0.6),
             sky_panorama=_panorama("u8", "cpu").numpy())
    return u, renderer.post_uniforms(u, device)


def _chain(color, depth, u, pu, plain=False):
    """The five stages in order through apply_post_fx, or their twins."""
    params = RenderParams(depth.shape[1], depth.shape[0], ssao=True,
                          bloom=True, tonemap="aces", fxaa=True)
    if not plain:
        for fx in CHAIN:
            color, depth = renderer.apply_post_fx(fx, color, depth, u, pu,
                                                  params)
        return color
    color = sky.composite_sky_plain(color, depth, u, pu["sky_panorama"])[0]
    color = ssao.apply_ssao_plain(color, depth, pu)[0]
    color = bloom.apply_bloom_plain(color, pu["bloom_threshold"],
                                    pu["bloom_strength"])
    color = tonemap.apply_tonemap_plain(color, "aces", pu)
    return fxaa.apply_fxaa_plain(color)


# ---------------------------------------------------------------------------
# On the CPU


@pytest.mark.parametrize("stage,variant", CASES,
                         ids=[f"{s}-{v}" for s, v in CASES])
def test_cpu_stage_runs_its_twin(stage, variant):
    """On CPU tensors each stage is its plain twin and launches nothing."""
    post_kernels.LAUNCHES.update(dict.fromkeys(post_kernels.STAGES, 0))
    fn, twin = _stage_pair(stage, variant, "cpu")
    color, depth = _frame(33, 65, "cpu")
    assert torch.equal(fn(color, depth), twin(color, depth))
    assert post_kernels.LAUNCHES == dict.fromkeys(post_kernels.STAGES, 0)


def test_cpu_chain_launches_nothing():
    """The five stages through apply_post_fx on the CPU equal their twins
    in turn and leave every launch counter at 0."""
    post_kernels.LAUNCHES.update(dict.fromkeys(post_kernels.STAGES, 0))
    color, depth = _frame(40, 56, "cpu", seed=3)
    u, pu = _post_uniforms("cpu")
    got = _chain(color, depth, u, pu)
    assert torch.equal(got, _chain(color, depth, u, pu, plain=True))
    assert post_kernels.LAUNCHES == dict.fromkeys(post_kernels.STAGES, 0)


@pytest.mark.parametrize("call,limit", [
    (lambda c, d, u: post_kernels.ssao(c, d, u, u, radii=(1, 17)),
     "MAX_HALO = 16"),
    (lambda c, d, u: post_kernels.bloom(c, dilations=(8, 8, 1)),
     "MAX_HALO = 16"),
    (lambda c, d, u: post_kernels.bloom(c, dilations=(1,) * 9),
     "at most 8 values"),
], ids=["ssao-radius", "bloom-dilations", "bloom-taps"])
def test_oversized_halo_raises(call, limit):
    """A halo or a tap count the kernels' shared tile cannot hold raises a
    ValueError naming the limit, before anything else is checked."""
    color, depth = _frame(7, 5, "cpu")
    with pytest.raises(ValueError, match=limit):
        call(color, depth, torch.tensor(0.1))


@pytest.mark.parametrize("stage", post_kernels.STAGES)
def test_kernel_wrappers_refuse_cpu_tensors(stage):
    """The kernel wrappers take CUDA tensors only: there is no fallback to
    the twin inside them."""
    color, depth = _frame(7, 5, "cpu")
    near = torch.tensor(0.1)
    calls = {"sky": lambda: post_kernels.sky(
                 color, depth, torch.zeros(23), _panorama("u8", "cpu")),
             "ssao": lambda: post_kernels.ssao(color, depth, near, near),
             "bloom": lambda: post_kernels.bloom(color),
             "tonemap": lambda: post_kernels.tonemap(color, "aces"),
             "fxaa": lambda: post_kernels.fxaa(color)}
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        calls[stage]()


def test_ray_basis_is_what_pixel_ray_directions_combines():
    """The sky kernel's staged camera basis: front, up, right, th, tw, then
    the screen coordinates, from which the plain rays are combined."""
    cam = _camera()
    packed = sky.ray_basis(cam, 6, 4, "cpu")
    assert packed.shape == (11 + 6 + 4,) and packed.dtype == torch.float32
    d = sky.pixel_ray_directions(cam, 6, 4, "cpu")
    assert d.shape == (4, 6, 3)
    # pixel (3, 2) sits at the screen's centre: its ray is the front
    assert torch.allclose(d[2, 3], packed[0:3] / packed[0:3].norm(),
                          atol=1e-6)
    np.testing.assert_allclose(packed[11:17].numpy(),
                               np.arange(6) / 6 * 2 - 1, rtol=1e-6)


# ---------------------------------------------------------------------------
# On the card


@pytest.mark.card
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("stage,variant", CASES,
                         ids=[f"{s}-{v}" for s, v in CASES])
def test_kernel_equals_twin(card, stage, variant, size):
    """Each stage's kernel equals its eager twin on every value, and the
    call launches its one kernel."""
    h, w = size
    fn, twin = _stage_pair(stage, variant, "cuda")
    color, depth = _frame(h, w, "cuda", seed=h + w)
    n0 = post_kernels.LAUNCHES[stage]
    got = fn(color, depth)
    assert post_kernels.LAUNCHES[stage] == n0 + 1
    want = twin(color, depth)
    torch.cuda.synchronize()
    assert got.shape == want.shape == color.shape
    assert torch.equal(got, want), (
        f"{stage} {variant} {h}x{w}: {int((got != want).sum())} values "
        f"differ, max {float((got - want).abs().max()):.3g} [{card}]")
    if h * w >= 64 * 64:
        assert not torch.equal(got, color)


@pytest.mark.card
@pytest.mark.parametrize("size", SIZES[:3], ids=[f"{h}x{w}"
                                                  for h, w in SIZES[:3]])
def test_chain_makes_no_hidden_wait(card, size):
    """The five stages issued one after another through apply_post_fx on
    staged uniforms: no call waits for the card (sync debug mode "error"),
    each stage launches one kernel, and the frame equals the twins'."""
    h, w = size
    color, depth = _frame(h, w, "cuda", seed=7)
    u, pu = _post_uniforms("cuda")
    torch.cuda.synchronize()
    before = dict(post_kernels.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _chain(color, depth, u, pu)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert {k: post_kernels.LAUNCHES[k] - before[k] for k in CHAIN} \
        == dict.fromkeys(CHAIN, 1)
    assert torch.equal(got, _chain(color, depth, u, pu, plain=True))


@pytest.mark.card
@pytest.mark.parametrize("stage", ["ssao", "bloom"])
def test_oversized_halo_raises_on_card(card, stage):
    """Through the stage's own function on CUDA tensors, a halo past
    MAX_HALO raises before any launch."""
    color, depth = _frame(64, 64, "cuda")
    u = {"near_clip": torch.tensor(0.1, device="cuda"),
         "far_clip": torch.tensor(200.0, device="cuda")}
    n0 = dict(post_kernels.LAUNCHES)
    with pytest.raises(ValueError, match="MAX_HALO"):
        if stage == "ssao":
            ssao.apply_ssao(color, depth, u, radii=(1, 2, 32))
        else:
            bloom.apply_bloom(color, dilations=(4, 8, 16))
    assert post_kernels.LAUNCHES == n0
