"""The port's native asset library against the JAX package's: both built
from the same C++ source, the five entry points equal bit for bit on
seeded inputs, and the bakers' numpy fallback (io_host.hostops) equal to
the library, so a model loads the same with or without g++."""

import os
import subprocess
import sys

import numpy as np
import pytest

from softwarerenderer_tpu import native as jax_native
from softwarerenderer_tpu.io_host import model_loader as jax_loader
from softwarerenderer_tpu_torch import native as port_native
from softwarerenderer_tpu_torch.io_host import model_loader as port_loader
from softwarerenderer_tpu_torch.native import binding, build
from softwarerenderer_tpu_torch.utils import hostmath

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
F32 = np.float32
RNG = np.random.default_rng(17)
# (component type, numpy type, components, stride pad bytes, normalized)
ACCESSORS = [(5120, np.int8, 4, 0, True), (5120, np.int8, 3, 1, False),
             (5121, np.uint8, 4, 4, True), (5122, np.int16, 2, 2, True),
             (5123, np.uint16, 2, 4, True), (5123, np.uint16, 1, 0, False),
             (5125, np.uint32, 1, 4, False), (5126, np.float32, 3, 4, False)]


def _matrices():
    """A rotation-translation-scale world matrix and a singular one."""
    m = (hostmath.matrix_from_yaw_pitch_roll(0.4, 0.2, 0.1)
         @ hostmath.scale([1.0, 2.0, 1.5])
         @ hostmath.translation([1, 2, 3])).astype(F32)
    flat = hostmath.scale([1.0, 0.0, 1.0]) @ hostmath.translation([0, 5, 0])
    return [m, flat.astype(F32)]


def _points(n=257):
    p = RNG.normal(size=(n, 3)).astype(F32) * F32(50)
    p[:3] = 0.0                                     # zero normals too
    return p


def test_both_libraries_build():
    """g++ is in the image: the port's library builds into its own _build/
    directory, and both packages load theirs."""
    assert build.build()
    assert os.path.dirname(build.LIBRARY) == os.path.join(
        REPO, "softwarerenderer_tpu_torch", "_build")
    assert port_native.is_available() and jax_native.is_available()


def test_concurrent_builds_do_not_collide():
    """Processes building at once (xdist workers) each compile under a
    name of their own and rename into place: all succeed, no temporary
    file is left and the library loads."""
    code = ("import sys; from softwarerenderer_tpu_torch.native import "
            "build; sys.exit(0 if build.build(force=True) else 1)")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO)
             for _ in range(3)]
    assert [p.wait(timeout=300) for p in procs] == [0, 0, 0]
    left = [f for f in os.listdir(os.path.dirname(build.LIBRARY))
            if f.startswith("libsrt_native.so.")]
    assert not left, left
    assert port_native.is_available()


@pytest.mark.parametrize("ctype,dtype,ncomp,pad,normalized", ACCESSORS)
def test_accessor_to_f32_equals_jax(ctype, dtype, ncomp, pad, normalized):
    """Strided, typed accessors decode to the same float32 values."""
    count = 37
    info = np.iinfo(dtype) if dtype != np.float32 else None
    if info is None:
        vals = RNG.normal(size=(count, ncomp)).astype(dtype)
    else:
        vals = RNG.integers(info.min, info.max, size=(count, ncomp),
                            endpoint=True).astype(dtype)
    row = vals.dtype.itemsize * ncomp
    raw = b"".join(v.tobytes() + bytes(range(pad)) for v in vals)
    args = (raw, count, ncomp, ctype, row + pad, normalized)
    got, want = port_native.accessor_to_f32(*args), \
        jax_native.accessor_to_f32(*args)
    assert got.dtype == want.dtype == F32 and got.shape == (count, ncomp)
    np.testing.assert_array_equal(got, want)
    assert port_native.accessor_to_f32(raw, 1, 1, 9999, 4, False) is None


@pytest.mark.parametrize("which", [0, 1])
def test_bakers_equal_jax(which):
    """bake_positions and bake_normals equal the JAX package's library."""
    m, p = _matrices()[which], _points()
    for name in ("bake_positions", "bake_normals"):
        got = getattr(port_native, name)(p, m)
        want = getattr(jax_native, name)(p, m)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_scale_pcm16_and_sphere_equal_jax():
    """scale_pcm16 (clamped) and the Ritter bounding sphere."""
    s = RNG.integers(-32768, 32767, size=4099, endpoint=True) \
        .astype(np.int16)
    for vol in (0.0, 0.37, 1.0, 2.5):
        np.testing.assert_array_equal(port_native.scale_pcm16(s, vol),
                                      jax_native.scale_pcm16(s, vol))
    p = _points(1001) * F32([3, 1, 2])
    (gc, gr), (wc, wr) = port_native.bounding_sphere_native(p), \
        jax_native.bounding_sphere_native(p)
    np.testing.assert_array_equal(gc, wc)
    assert gr == wr


@pytest.fixture
def fallback(monkeypatch):
    """The port's native with its library out of reach, as without g++."""
    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.setattr(binding, "_tried", True)
    assert not port_native.is_available()


@pytest.mark.parametrize("which", [0, 1])
def test_fallback_bakers_equal_library(which, fallback):
    """Without the library the bakers take hostops's numpy forms, equal
    to the C++ on every value; the other entry points keep the JAX
    package's fallbacks."""
    m, p = _matrices()[which], _points()
    for name in ("bake_positions", "bake_normals"):
        got = getattr(port_native, name)(p, m)
        want = getattr(jax_native, name)(p, m)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert port_native.accessor_to_f32(b"\0" * 12, 1, 3, 5126, 12,
                                       False) is None
    assert port_native.bounding_sphere_native(p) is None
    s = np.asarray([100, -100, 30000, -30000], np.int16)
    assert port_native.scale_pcm16(s, 2.0).tolist() == \
        [200, -200, 32767, -32768]


@pytest.mark.parametrize("name", ["cube.dae", "cube.fbx", "cube.3ds",
                                  "cube.gltf"])
def test_fixture_loads_equal_without_library(name, tmp_path, monkeypatch):
    """Each loader bakes the same model with the library and without it,
    and equal to the JAX package's load."""
    from tests.test_torch_io_host import assert_same
    path = os.path.join(FIXDIR, name)
    if name == "cube.gltf":                       # a baked glTF node
        from softwarerenderer_tpu_torch.io_host import gltf
        path = str(tmp_path / name)
        src = port_loader.load_model(os.path.join(FIXDIR, "cube.fbx"))
        gltf.write_gltf(path, src.meshes)
        _move_node(path)
    port_loader.clear_caches()
    jax_loader.clear_caches()
    with_lib = port_loader.load_model(path)
    want = jax_loader.load_model(path)
    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.setattr(binding, "_tried", True)
    port_loader.clear_caches()
    without = port_loader.load_model(path)
    assert_same(with_lib, want, name)
    assert_same(without, want, name)


def _move_node(path):
    """Give the written glTF's mesh node a TRS, so the load bakes it."""
    import json
    with open(path) as f:
        doc = json.load(f)
    node = next(n for n in doc["nodes"] if "mesh" in n)
    node.update(translation=[1.0, -0.5, 2.0], scale=[1.5, 0.75, 1.25],
                rotation=[0.0, 0.38268343, 0.0, 0.9238795])
    with open(path, "w") as f:
        json.dump(doc, f)
