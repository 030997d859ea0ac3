"""The port's host layer against the JAX package's: the copied modules
(io_host/*, native/ and utils/slog, utils/appconfig) equal their sources
line for line but for the edits listed here, and the numpy math, the glTF
round trip, the packed scene of a loaded model and the COLLADA, FBX and
3DS fixtures' loads equal the JAX package's."""

import os
import re

import numpy as np
import pytest

from softwarerenderer_tpu.io_host import gltf as jax_gltf
from softwarerenderer_tpu.io_host import model_loader as jax_loader
from softwarerenderer_tpu.models import scene as jax_scene
from softwarerenderer_tpu.utils import mathlib as jax_ml
from softwarerenderer_tpu_torch.io_host import gltf as port_gltf
from softwarerenderer_tpu_torch.io_host import model_loader as port_loader
from softwarerenderer_tpu_torch.models import scene as port_scene
from softwarerenderer_tpu_torch.utils import hostmath

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "softwarerenderer_tpu")
PORT_PKG = os.path.join(REPO, "softwarerenderer_tpu_torch")

# The package-name substitution every copy takes: module paths only (the
# dot), so the "softwarerenderer_tpu" glTF extras key and the UPnP
# description stay what the JAX package writes and reads.
PACKAGE = ("softwarerenderer_tpu.", "softwarerenderer_tpu_torch.")
# and the reference's sources cited by file name alone, without the
# absolute directory the JAX package's docstrings give them.
REFERENCE_DIR = re.compile(r"/\w+/reference/")
# Past it, each copy's edits by name, (source text, copy's text):
HOSTMATH = ("from softwarerenderer_tpu_torch.utils import mathlib as ml",
            "from softwarerenderer_tpu_torch.utils import hostmath as ml")
COMPOSE_TRS = ("from softwarerenderer_tpu_torch.ops.skinning import "
               "compose_trs",
               "from softwarerenderer_tpu_torch.io_host.hostops import "
               "compose_trs")
# native/: the library built into the port's own _build/ directory under a
# name of the building process, and the bakers' fallback hostops's forms.
NATIVE_LIBRARY = (
    'LIBRARY = os.path.join(_DIR, "libsrt_native.so")',
    'LIBRARY = os.path.join(os.path.dirname(_DIR), "_build", '
    '"libsrt_native.so")')
NATIVE_BUILD_DOC = (
    '"""Build the native library: g++ -O3 -shared -fPIC srt_native.cpp."""',
    '"""Build the native library: g++ -O3 -shared -fPIC srt_native.cpp, '
    'into\nthe package\'s git-ignored _build/ directory."""')
NATIVE_BUILD_TMP = (
    """    cmd = [gxx, "-O3", "-std=c++17", "-shared", "-fPIC",
           "-o", LIBRARY + ".tmp", SOURCE]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(LIBRARY + ".tmp", LIBRARY)
        return True
    except (subprocess.SubprocessError, OSError):
        return False""",
    """    # A name of this process's own, so that processes building at once
    # never write one file; the rename into place is atomic.
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [gxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, SOURCE]
    try:
        os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIBRARY)
        return True
    except (subprocess.SubprocessError, OSError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False""")
HOSTOPS_BAKERS = (
    ("from softwarerenderer_tpu_torch.native.build import LIBRARY, build",
     "from softwarerenderer_tpu_torch.io_host import hostops\n"
     "from softwarerenderer_tpu_torch.native.build import LIBRARY, build"),
    ('    """p\' = p·M in place-sized copy; falls back to NumPy."""',
     '    """p\' = p·M in place-sized copy; falls back to NumPy (hostops\'s\n'
     '    form, equal to the library\'s on every value)."""'),
    ("        return (pos @ m[:3, :3] + m[3, :3]).astype(np.float32)",
     "        return hostops.bake_positions(pos, m)"),
    ("""        out = nrm @ m[:3, :3]
        n = np.linalg.norm(out, axis=-1, keepdims=True)
        return (out / np.where(n > 0, n, 1.0)).astype(np.float32)""",
     "        return hostops.bake_normals(nrm, m)"))


COPIES = {
    "io_host/__init__.py": (),
    "io_host/window.py": (),
    "io_host/ui.py": (HOSTMATH,),
    "io_host/audio.py": (),
    "io_host/upnp.py": (),
    "io_host/networking.py": (),
    "io_host/gltf.py": (HOSTMATH, COMPOSE_TRS),
    "io_host/model_loader.py": (),
    "io_host/collada.py": (),
    "io_host/fbx.py": (HOSTMATH, COMPOSE_TRS),
    "io_host/tds.py": (),
    "native/__init__.py": (),
    "native/build.py": (NATIVE_BUILD_DOC, NATIVE_LIBRARY, NATIVE_BUILD_TMP),
    "native/binding.py": HOSTOPS_BAKERS,
    "utils/slog.py": (),
    "utils/appconfig.py": (),
}


def expected_copy(rel: str) -> str:
    """The JAX package's module `rel` with the substitution and the
    listed edits applied: what the port's copy must hold."""
    with open(os.path.join(JAX_PKG, rel)) as f:
        text = REFERENCE_DIR.sub("", f.read().replace(*PACKAGE))
    for old, new in COPIES[rel]:
        assert text.count(old) >= 1, (rel, old)
        text = text.replace(old, new)
    return text


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copy_equals_source(rel):
    """Each copied host module equals its JAX source line for line, but
    for the package-name and reference-directory substitutions and the
    edits COPIES lists."""
    with open(os.path.join(PORT_PKG, rel)) as f:
        got = f.read().splitlines()
    want = expected_copy(rel).splitlines()
    diff = [(i + 1, g, w) for i, (g, w) in enumerate(zip(got, want))
            if g != w]
    assert len(got) == len(want) and not diff, diff[:5]


def test_native_source_is_a_byte_copy():
    """The port builds its native library from the JAX package's C++
    source, byte for byte."""
    with open(os.path.join(JAX_PKG, "native", "srt_native.cpp"), "rb") as f:
        want = f.read()
    with open(os.path.join(PORT_PKG, "native", "srt_native.cpp"), "rb") as f:
        assert f.read() == want


# ---------------------------------------------------------------------------
# Behaviour pins
# ---------------------------------------------------------------------------

F32 = np.float32
_RNG = np.random.default_rng(14)
_Q = _RNG.normal(size=(16, 4)).astype(F32)
_Q /= np.linalg.norm(_Q, axis=1, keepdims=True)
_V = _RNG.normal(size=(16, 3)).astype(F32)
_M = _RNG.normal(size=(16, 4, 4)).astype(F32)
_E = _RNG.uniform(-180, 180, size=(3,)).astype(F32)
# (function name, arguments): each called on both packages' numpy math.
MATH_CASES = {
    "scale": [(0.02,), ([0.5, 2.0, 3.0],)],
    "translation": [(_V[0],)],
    "dot": [(_V, _V[::-1])],
    "cross": [(_V, _V[::-1])],
    "length": [(_V,)],
    "normalize": [(_V,), (np.zeros(3, F32), 1e-6)],
    "transform": [(np.concatenate([_V, np.ones((16, 1), F32)], 1), _M)],
    "transform_normal": [(_V, _M)],
    "matrix_from_quaternion": [(_Q[0],), (_Q[1], np)],   # fbx passes xp
    "quat_from_axis_angle": [(np.asarray([0, 1, 0], F32), np.pi)],
    "quat_from_yaw_pitch_roll": [(0.3, -1.2, 0.05)],
    "matrix_from_yaw_pitch_roll": [(-np.pi / 2, 0.0, 0.0)],
    "quat_mul": [(_Q, _Q[::-1])],
    "quat_rotate": [(_V, _Q), (np.asarray([0, 0, -1], F32), _Q[3])],
    "quat_slerp": [(_Q, _Q[::-1], F32(0.25)), (_Q[2], _Q[2], F32(0.5)),
                   (_Q[4], -_Q[5], F32(15.0 / 60.0))],
    "quat_to_euler_degrees": [(_Q,), (np.asarray([0.7071068, 0, 0,
                                                  0.7071068], F32),)],
    "euler_degrees_to_direction": [(_E,), ([-45.0, -45.0, 0.0],)],
}


@pytest.mark.parametrize("name", sorted(MATH_CASES))
def test_hostmath_equals_jax_numpy(name):
    """utils/hostmath (the numpy math the game, ui and gltf call) equals
    the JAX package's utils/mathlib with xp=np on every value."""
    for args in MATH_CASES[name]:
        if name == "normalize" and len(args) == 2:
            got = hostmath.normalize(args[0], eps=args[1])
            want = jax_ml.normalize(args[0], eps=args[1])
        else:
            got = getattr(hostmath, name)(*args)
            want = getattr(jax_ml, name)(*args)
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(hostmath.QUAT_IDENTITY,
                                  jax_ml.QUAT_IDENTITY)


def _fields(obj):
    import dataclasses
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def assert_same(got, want, tag=""):
    """Two loaded trees (dicts, lists, dataclasses, arrays, scalars) equal
    value for value; the two packages' dataclasses compare by fields."""
    import dataclasses
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, tag
        return assert_same(_fields(got), _fields(want), tag)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (tag, sorted(got), sorted(want))
        for k in want:
            assert_same(got[k], want[k], f"{tag}.{k}")
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), tag
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{tag}[{i}]")
        return
    if isinstance(want, np.ndarray):
        g = np.asarray(got)
        assert g.dtype == want.dtype and g.shape == want.shape, tag
        np.testing.assert_array_equal(g, want, err_msg=tag)
        return
    assert got == want, (tag, got, want)


def _arena_and_tentacle():
    """The game's fallback arena (an 80 m plane and 12 cubes) and a
    skinned, animated tentacle, as load_gltf mesh records."""
    from softwarerenderer_tpu_torch import scenes
    from softwarerenderer_tpu_torch.apps.dust2 import _fallback_map
    model, _ = _fallback_map()
    tent = scenes.tentacle_mesh(height=3.0, rings=6, sides=5)
    tent["skin"] = scenes.tentacle_skin(tent["position"])
    tent["material"] = port_scene.Material(base_color=(0.3, 0.6, 0.2, 1.0))
    return list(model.meshes) + [tent]


def _animate_nodes(path):
    """Give the written glTF's first mesh node a TRS (baked on load) and
    its second one the first joint's rotation track (a rigid node
    animation, evaluated through a one-joint skin on load)."""
    import json
    with open(path) as f:
        doc = json.load(f)
    mesh_nodes = [i for i, n in enumerate(doc["nodes"]) if "mesh" in n]
    doc["nodes"][mesh_nodes[0]].update(
        translation=[1.0, -0.5, 2.0], scale=[1.5, 0.75, 1.25],
        rotation=[0.0, 0.38268343, 0.0, 0.9238795])
    anim = doc["animations"][0]
    rot = next(c for c in anim["channels"]
               if c["target"]["path"] == "rotation")
    anim["channels"].append({"sampler": rot["sampler"],
                             "target": {"node": mesh_nodes[1],
                                        "path": "rotation"}})
    with open(path, "w") as f:
        json.dump(doc, f)


def test_gltf_round_trip_equals_jax(tmp_path):
    """write_gltf of the fallback arena and a skinned, animated mesh
    writes the same file from either package; with a node's TRS and a
    rigid node animation added, the port's load_gltf and the JAX
    package's read back equal meshes, skins and lights."""
    meshes = _arena_and_tentacle()
    a, b = str(tmp_path / "port.gltf"), str(tmp_path / "jax.gltf")
    port_gltf.write_gltf(a, meshes)
    jax_gltf.write_gltf(b, meshes)
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()
    _animate_nodes(a)
    for rigid in (True, False):
        got = port_gltf.load_gltf(a, rigid_animation=rigid)
        want = jax_gltf.load_gltf(a, rigid_animation=rigid)
        assert len(want["meshes"]) == len(meshes)
        assert sum(m.get("skin") is not None
                   for m in want["meshes"]) == 1 + rigid
        assert_same(got, want, f"rigid={rigid}")


def test_model_instances_pack_as_jax(tmp_path):
    """The loaded arena through model_instances and build_scene_buffers:
    the port's packed scene equals the JAX package's, array for array."""
    path = str(tmp_path / "arena.glb")
    port_gltf.write_gltf(path, _arena_and_tentacle())
    checker = np.full((8, 8, 4), 0.5, F32)
    mat = hostmath.scale(0.5)
    port_loader.clear_caches()
    jax_loader.clear_caches()
    got = port_scene.build_scene_buffers(port_loader.model_instances(
        port_loader.load_model(path), mat, fallback_texture=checker))
    want = jax_scene.build_scene_buffers(jax_loader.model_instances(
        jax_loader.load_model(path), mat, fallback_texture=checker))
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert "skin_joints" in want and want["mesh_matrices"].shape[0] == 14


@pytest.mark.parametrize("ext", [".dae", ".fbx", ".3ds"])
def test_unported_formats_raise(ext):
    """The COLLADA, FBX and 3DS loaders, once refused with
    NotImplementedError, now load: model_loader.load_model of the cube
    fixture in the port equals the JAX package's load, array for array,
    materials included."""
    path = os.path.join(REPO, "tests", "fixtures", f"cube{ext}")
    port_loader.clear_caches()
    jax_loader.clear_caches()
    got = port_loader.load_model(path)
    want = jax_loader.load_model(path)
    assert len(want.meshes) == 1
    assert_same(got, want, ext)
