"""The port's COLLADA, FBX and 3DS loaders against the JAX package's: the
cube fixtures load to equal models and pack to equal scenes, the rigged
FBX and DAE load to equal skins and pose to the same vertices, the
writers write the same bytes, and malformed inputs raise the same
errors."""

import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softwarerenderer_tpu.io_host import collada as jax_collada
from softwarerenderer_tpu.io_host import fbx as jax_fbx
from softwarerenderer_tpu.io_host import model_loader as jax_loader
from softwarerenderer_tpu.io_host import tds as jax_tds
from softwarerenderer_tpu.models import scene as jax_scene
from softwarerenderer_tpu.ops import skinning as jax_skinning
from softwarerenderer_tpu_torch.io_host import collada, fbx, tds
from softwarerenderer_tpu_torch.io_host import model_loader as port_loader
from softwarerenderer_tpu_torch.models import scene as port_scene
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import skinning
from softwarerenderer_tpu_torch.ops.texture import checkerboard
from tests.test_import_formats import _dense_arm_rig, _rigged_dae
from tests.test_torch_io_host import assert_same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
FIXTURES = ["cube.dae", "cube.fbx", "cube.3ds"]
F32 = np.float32
# Posed vertices against JAX's apply_skinning: tests/test_torch_
# vertex_updates.py's limits (measured on these two rigs: 0, equal).
POSE_TOL = 1e-6
POSE_TIMES = (0.0, 0.7, 1.5)


@pytest.fixture(autouse=True)
def fresh_caches():
    port_loader.clear_caches()
    jax_loader.clear_caches()


def _load_both(path):
    return port_loader.load_model(path), jax_loader.load_model(path)


@pytest.mark.parametrize("name", FIXTURES)
@pytest.mark.parametrize("checker", [False, True], ids=["plain", "checker"])
def test_fixture_scene_equals_jax(name, checker):
    """Each fixture loads to the JAX package's Model and, through
    model_instances (with the viewer's fallback checker or none) and
    build_scene_buffers, packs to its scene, array for array."""
    got, want = _load_both(os.path.join(FIXDIR, name))
    assert_same(got, want, name)
    fallback = np.asarray(checkerboard(32, 4)["data"]) if checker else None
    gs = port_scene.build_scene_buffers(
        port_loader.model_instances(got, fallback_texture=fallback))
    ws = jax_scene.build_scene_buffers(
        jax_loader.model_instances(want, fallback_texture=fallback))
    assert sorted(gs) == sorted(ws)
    for k in ws:
        g, w = np.asarray(gs[k]), np.asarray(ws[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _posed(port_model, jax_model):
    """Skinned positions and normals of the loaded rig at each of
    POSE_TIMES, through each package's packed scene and apply_skinning."""
    ps = port_scene.build_scene_buffers(
        port_loader.model_instances(port_model))
    js = jax_scene.build_scene_buffers(
        jax_loader.model_instances(jax_model))
    keys = ("position", "uv", "normal", "color")
    st = scene_to_torch(ps, "cpu")
    jst = {k: jnp.asarray(v) for k, v in js.items()}
    for t in POSE_TIMES:
        got = skinning.apply_skinning(
            {k: st[k] for k in keys}, st,
            {"anim_time": torch.tensor(t, dtype=torch.float32)})
        want = jax_skinning.apply_skinning(
            {k: jst[k] for k in keys}, jst, {"anim_time": F32(t)}, xp=jnp)
        yield t, got, want


def _assert_rig_equal(path):
    got, want = _load_both(path)
    assert_same(got, want, path)
    (mesh,) = want.meshes
    assert mesh["skin"].parent.tolist() == [-1, 0]
    poses = []
    for t, g, w in _posed(got, want):
        for k in ("position", "normal"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=POSE_TOL, atol=POSE_TOL,
                                       err_msg=f"{k} at t={t}")
        poses.append(g["position"])
    # the child bone moves: the last time is not the rest pose
    assert not torch.equal(poses[0], poses[-1])


def test_fbx_rigged_matches_jax(tmp_path):
    """The dense arm rig written by the port's write_fbx (the same bytes
    as the JAX package's writer) loads to the JAX package's skin, joint
    tracks and bind matrices, and poses to its vertices."""
    mesh, skin = _dense_arm_rig()
    a, b = str(tmp_path / "port.fbx"), str(tmp_path / "jax.fbx")
    for write, path in ((fbx.write_fbx, a), (jax_fbx.write_fbx, b)):
        write(path, mesh["position"], mesh["indices"],
              normals=mesh["normal"], uvs=mesh["uv"], skin=skin)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    _assert_rig_equal(a)


def test_dae_rigged_matches_jax(tmp_path):
    """The hand-built rigged COLLADA (a <skin> controller and a
    <matrix>-channel animation): the same skin and posed vertices."""
    _assert_rig_equal(_rigged_dae(tmp_path))


def _mesh_args(seed, n):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (n, 3)).astype(F32)
    nrm = rng.normal(size=(n, 3)).astype(F32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    uv = rng.uniform(0, 1, (n, 2)).astype(F32)
    idx = np.arange(n, dtype=np.int32).reshape(-1, 3)
    return pos, idx, nrm, uv


WRITERS = {
    "fbx": lambda m, path, seed: m.write_fbx(
        path, *_mesh_args(seed, 12)[:2], normals=_mesh_args(seed, 12)[2],
        uvs=_mesh_args(seed, 12)[3], translation=(1.0, 2.0, 3.0),
        diffuse_color=(0.2, 0.4, 0.6)),
    "fbx_bare": lambda m, path, seed: m.write_fbx(
        path, *_mesh_args(seed, 9)[:2]),
    "3ds": lambda m, path, seed: m.write_3ds(
        path, *_mesh_args(seed, 15)[:2], uvs=_mesh_args(seed, 15)[3],
        diffuse_color=(0.2, 0.4, 0.6)),
    "3ds_bare": lambda m, path, seed: m.write_3ds(
        path, *_mesh_args(seed, 6)[:2]),
}


@pytest.mark.parametrize("case", sorted(WRITERS))
def test_writers_write_jax_bytes(case, tmp_path):
    """write_fbx and write_3ds write the JAX package's bytes, and the
    files load back to equal models."""
    ext = "." + case.split("_")[0]
    a, b = str(tmp_path / f"port{ext}"), str(tmp_path / f"jax{ext}")
    WRITERS[case](fbx if ext == ".fbx" else tds, a, 11)
    WRITERS[case](jax_fbx if ext == ".fbx" else jax_tds, b, 11)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    got, want = _load_both(a)
    assert_same(got, want, case)


def _face_groups_3ds(mod, path):
    """tests/test_import_formats.py's three triangles in two FACE_MATS
    groups and one ungrouped face, written with `mod`'s chunk writer."""
    pos = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                      [0, 0, 1], [1, 0, 1], [0, 1, 1],
                      [0, 0, 2], [1, 0, 2], [0, 1, 2]], "<f4")
    fr = np.zeros((3, 4), "<u2")
    fr[:, :3] = np.arange(9).reshape(3, 3)

    def group(name, ids):
        return mod._w_chunk(mod._FACE_MATS, name.encode() + b"\x00"
                            + struct.pack("<H", len(ids))
                            + np.asarray(ids, "<u2").tobytes())

    def material(name, rgb):
        return mod._w_chunk(mod._MATERIAL, mod._w_chunk(
            mod._MAT_NAME, name.encode() + b"\x00") + mod._w_chunk(
            mod._MAT_DIFFUSE, mod._w_chunk(mod._COLOR_F32,
                                           struct.pack("<3f", *rgb))))

    verts = mod._w_chunk(mod._VERTICES, struct.pack("<H", 9) + pos.tobytes())
    faces = mod._w_chunk(mod._FACES, struct.pack("<H", 3) + fr.tobytes()
                         + group("red", [0]) + group("blue", [1]))
    obj = mod._w_chunk(mod._OBJECT, b"tri\x00" + mod._w_chunk(
        mod._TRIMESH, verts + faces))
    editor = mod._w_chunk(mod._EDITOR, material("red", (1.0, 0.0, 0.0))
                          + material("blue", (0.0, 0.0, 1.0)) + obj)
    with open(path, "wb") as f:
        f.write(mod._w_chunk(mod._MAIN, editor))


def _polygon_fbx(mod, path):
    """A quad and a triangle with ByControlPoint normals (the JAX
    package's fan-triangulation test), written with `mod`'s node
    writer."""
    rng = np.random.default_rng(3)
    pos = rng.uniform(-1, 1, (8, 3))
    nrm = rng.normal(size=(8, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    pvi = np.asarray([0, 1, 2, ~3, 4, 5, ~6], np.int64)
    top = [
        ("Objects", (), (
            ("Geometry", (1, "Geometry::g", "Mesh"), (
                ("Vertices", (pos.reshape(-1).astype(np.float64),), ()),
                ("PolygonVertexIndex", (pvi,), ()),
                ("LayerElementNormal", (0,), (
                    ("MappingInformationType", ("ByControlPoint",), ()),
                    ("ReferenceInformationType", ("Direct",), ()),
                    ("Normals", (nrm.reshape(-1).astype(np.float64),), ()),
                )))),
            ("Model", (2, "Model::m", "Mesh"), ()))),
        ("Connections", (), (("C", ("OO", 1, 2), ()),
                             ("C", ("OO", 2, 0), ()))),
    ]
    out = mod._MAGIC + struct.pack("<I", 7400)
    for name, props, children in top:
        out += mod._w_node(name, props, children, base=len(out))
    with open(path, "wb") as f:
        f.write(out + b"\x00" * 13)


ZUP_DAE = """<?xml version="1.0"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
 <asset><up_axis>Z_UP</up_axis></asset>
 <library_geometries>
  <geometry id="g"><mesh>
   <source id="p">
    <float_array id="pa" count="9">1 0 0 0 1 0 0 0 1</float_array>
    <technique_common><accessor source="#pa" count="3" stride="3">
     <param name="X" type="float"/><param name="Y" type="float"/>
     <param name="Z" type="float"/></accessor></technique_common>
   </source>
   <vertices id="v"><input semantic="POSITION" source="#p"/></vertices>
   <triangles count="1">
    <input semantic="VERTEX" source="#v" offset="0"/>
    <p>0 1 2</p>
   </triangles>
  </mesh></geometry>
 </library_geometries>
 <library_visual_scenes><visual_scene id="s">
  <node id="n"><instance_geometry url="#g"/></node>
 </visual_scene></library_visual_scenes>
</COLLADA>
"""


def _zup_dae(path):
    """The Z_UP COLLADA document of tests/test_import_formats.py."""
    with open(path, "w") as f:
        f.write(ZUP_DAE)


DOCS = {"groups.3ds": lambda p: _face_groups_3ds(tds, p),
        "poly.fbx": lambda p: _polygon_fbx(fbx, p),
        "zup.dae": _zup_dae,
        "rig.dae": None}


@pytest.mark.parametrize("name", sorted(DOCS))
def test_loader_documents_equal_jax(name, tmp_path):
    """load_3ds, load_fbx and load_dae on the JAX tests' hand-built
    documents (face-material groups, a polygon fan with control-point
    normals, a Z-up scene, a rigged DAE) return the JAX loaders' documents
    value for value; so does the 3DS smooth-normal generator."""
    if DOCS[name] is None:
        path = _rigged_dae(tmp_path)
    else:
        path = str(tmp_path / name)
        DOCS[name](path)
    load = {".3ds": (tds.load_3ds, jax_tds.load_3ds),
            ".fbx": (fbx.load_fbx, jax_fbx.load_fbx),
            ".dae": (collada.load_dae, jax_collada.load_dae)}
    port_load, jax_load = load[os.path.splitext(name)[1]]
    for flip in (False, True):
        assert_same(port_load(path, flip_uv=flip),
                    jax_load(path, flip_uv=flip), f"{name} flip={flip}")
    pos, idx, _, _ = _mesh_args(5, 30)
    np.testing.assert_array_equal(tds.smooth_normals(pos, idx),
                                  jax_tds.smooth_normals(pos, idx))


def _garbage(tmp_path):
    """tests/test_import_formats.py::test_importers_reject_garbage's
    inputs, by loader."""
    def write(name, data):
        p = tmp_path / name
        (p.write_bytes if isinstance(data, bytes) else p.write_text)(data)
        return str(p)

    def head(name, n):
        with open(os.path.join(FIXDIR, name), "rb") as f:
            return f.read()[:n]

    return [
        ("3ds", write("x.3ds", b"nah, chunked this is not, 3ds neither")),
        ("3ds", write("trunc.3ds", head("cube.3ds", 64))),
        ("fbx", write("x.fbx", b"definitely not an fbx container")),
        ("fbx", write("trunc.fbx", head("cube.fbx", 90))),
        ("dae", write("empty.dae",
                      '<COLLADA xmlns="http://www.collada.org/2005/11/'
                      'COLLADASchema" version="1.4.1"></COLLADA>')),
        ("dae", write("bad.dae", "{json, not xml}")),
    ]


def test_importers_reject_garbage_as_jax(tmp_path):
    """Malformed inputs raise the JAX loaders' exception, of the same type
    with the same message, or load the same empty document."""
    loaders = {"3ds": (tds.load_3ds, jax_tds.load_3ds),
               "fbx": (fbx.load_fbx, jax_fbx.load_fbx),
               "dae": (collada.load_dae, jax_collada.load_dae)}
    raised = 0
    for kind, path in _garbage(tmp_path):
        port_load, jax_load = loaders[kind]
        try:
            want = jax_load(path)
        except Exception as e:           # noqa: BLE001 (JAX's own error)
            with pytest.raises(type(e)) as got:
                port_load(path)
            assert str(got.value) == str(e), path
            raised += 1
            continue
        assert_same(port_load(path), want, path)
    assert raised == 5
