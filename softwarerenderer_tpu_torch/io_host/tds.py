"""First-party Autodesk 3DS importer (+ a minimal writer).

The reference reaches .3ds through Assimp (ModelLoader.cs:
144-150); this module reads the classic chunked binary format directly:

  MAIN (0x4D4D)
    EDITOR (0x3D3D)
      MATERIAL (0xAFFF): name 0xA000, diffuse 0xA020 (color subchunks
        0x0010 f32 RGB / 0x0011 u8 RGB / 0x0012-0x0013 gamma variants),
        texture map 0xA200 → filename 0xA300
      OBJECT (0x4000, asciiz name)
        TRIMESH (0x4100): vertices 0x4110, faces 0x4120 (v0 v1 v2 flags
          u16s), face-material groups 0x4130 (faces split per material
          like Assimp), texture coords 0x4140
    KEYFRAMER (0xB000): skipped — 3DS stores vertices already placed in
      world space; pivot/animation data is out of this static subset.

Coordinates are Z-up and convert to the Y-up world exactly like the
COLLADA Z_UP path: (x, y, z) → (x, z, -y).  V coordinates flip (1 - v),
the Assimp FlipUVs post-process the reference requests
(ModelLoader.cs:147).  3DS carries NO normals: smooth area-weighted
vertex normals are generated — the analog of Assimp's GenerateNormals
flag (ModelLoader.cs:146); vertices duplicated per face (as exporters
emit for hard edges) therefore recover flat face normals.

Output matches io_host.gltf.load_gltf ({"meshes": [...], "lights": []}).
The writer (`write_3ds`) emits a minimal well-formed document (geometry
+ uvs + one material) for fixtures and interchange smoke tests.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from softwarerenderer_tpu_torch.models.scene import Material, bounding_sphere

F32 = np.float32

_MAIN = 0x4D4D
_EDITOR = 0x3D3D
_OBJECT = 0x4000
_TRIMESH = 0x4100
_VERTICES = 0x4110
_FACES = 0x4120
_FACE_MATS = 0x4130
_UVS = 0x4140
_MATERIAL = 0xAFFF
_MAT_NAME = 0xA000
_MAT_DIFFUSE = 0xA020
_MAT_TEXMAP = 0xA200
_MAT_TEXFILE = 0xA300
_COLOR_F32 = 0x0010
_COLOR_U8 = 0x0011
_COLOR_U8_G = 0x0012
_COLOR_F32_G = 0x0013


def _chunks(data: bytes, start: int, end: int):
    """Yield (chunk_id, body_start, body_end) for the chunks in
    data[start:end]; malformed lengths fail loudly."""
    pos = start
    while pos + 6 <= end:
        cid, length = struct.unpack_from("<HI", data, pos)
        if length < 6 or pos + length > end:
            raise ValueError(
                f"3DS chunk 0x{cid:04X} at {pos} has bad length {length}")
        yield cid, pos + 6, pos + length
        pos += length
    if pos != end:
        raise ValueError(f"trailing garbage in 3DS chunk list at {pos}")


def _asciiz(data: bytes, pos: int, end: int) -> Tuple[str, int]:
    z = data.index(b"\x00", pos, end)
    return data[pos:z].decode("latin-1"), z + 1


def _read_color(data: bytes, start: int, end: int) -> Tuple[float, ...]:
    for cid, b, e in _chunks(data, start, end):
        if cid in (_COLOR_U8, _COLOR_U8_G):
            r, g, bl = struct.unpack_from("<3B", data, b)
            return (r / 255.0, g / 255.0, bl / 255.0)
        if cid in (_COLOR_F32, _COLOR_F32_G):
            return struct.unpack_from("<3f", data, b)
    return (1.0, 1.0, 1.0)


def smooth_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals (Assimp GenerateNormals
    analog): accumulate each face's cross product onto its vertices."""
    pos = np.asarray(positions, np.float64).reshape(-1, 3)
    idx = np.asarray(indices, np.int64).reshape(-1, 3)
    fn = np.cross(pos[idx[:, 1]] - pos[idx[:, 0]],
                  pos[idx[:, 2]] - pos[idx[:, 0]])
    acc = np.zeros_like(pos)
    for k in range(3):
        np.add.at(acc, idx[:, k], fn)
    norm = np.linalg.norm(acc, axis=-1, keepdims=True)
    return (acc / np.where(norm < 1e-20, 1.0, norm)).astype(F32)


def _mesh_from_trimesh(name: str, pos: np.ndarray, uv: Optional[np.ndarray],
                       faces: np.ndarray, material: Material) -> Dict:
    if uv is None:
        uv = np.zeros((pos.shape[0], 2), F32)
    mesh = {
        "name": name,
        "position": pos.astype(F32),
        "uv": uv.astype(F32),
        "normal": smooth_normals(pos, faces),
        "color": np.ones((pos.shape[0], 4), F32),
        "indices": faces.astype(np.int32),
        "material": material,
    }
    c, r = bounding_sphere(mesh["position"])
    mesh["bounds_center"], mesh["bounds_radius"] = c, r
    return mesh


def load_3ds(path: str, flip_uv: bool = True) -> Dict:
    """Parse a .3ds file → {"meshes": [mesh dicts], "lights": []}."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 6 or struct.unpack_from("<H", data, 0)[0] != _MAIN:
        raise ValueError(f"not a 3DS file: {path}")
    main_len = struct.unpack_from("<I", data, 2)[0]
    if main_len > len(data) or main_len < 6:
        raise ValueError(f"3DS main chunk length {main_len} out of range")

    materials: Dict[str, Material] = {}
    meshes: List[Dict] = []
    base_dir = os.path.dirname(os.path.abspath(path))

    def parse_material(start: int, end: int) -> None:
        name = ""
        color = (1.0, 1.0, 1.0)
        tex: Optional[str] = None
        for cid, b, e in _chunks(data, start, end):
            if cid == _MAT_NAME:
                name, _ = _asciiz(data, b, e)
            elif cid == _MAT_DIFFUSE:
                color = _read_color(data, b, e)
            elif cid == _MAT_TEXMAP:
                for c2, b2, e2 in _chunks(data, b, e):
                    if c2 == _MAT_TEXFILE:
                        fname, _ = _asciiz(data, b2, e2)
                        tex = os.path.join(base_dir, fname)
        paths = (("diffuse", tex),) if tex else ()
        materials[name] = Material(
            base_color=(float(color[0]), float(color[1]),
                        float(color[2]), 1.0),
            texture_paths=paths)

    def parse_trimesh(name: str, start: int, end: int) -> None:
        pos = uv = None
        faces = np.zeros((0, 3), np.int32)
        groups: List[Tuple[str, np.ndarray]] = []
        for cid, b, e in _chunks(data, start, end):
            if cid == _VERTICES:
                (n,) = struct.unpack_from("<H", data, b)
                v = np.frombuffer(data, "<f4", n * 3, b + 2).reshape(-1, 3)
                # Z-up → Y-up, same as COLLADA Z_UP: (x, y, z) → (x, z, -y)
                pos = np.stack([v[:, 0], v[:, 2], -v[:, 1]], -1)
            elif cid == _FACES:
                (n,) = struct.unpack_from("<H", data, b)
                fr = np.frombuffer(data, "<u2", n * 4, b + 2).reshape(-1, 4)
                faces = fr[:, :3].astype(np.int32)
                # face-material groups nest AFTER the face records
                sub = b + 2 + n * 8
                if sub < e:
                    for c2, b2, e2 in _chunks(data, sub, e):
                        if c2 == _FACE_MATS:
                            mname, p2 = _asciiz(data, b2, e2)
                            (k,) = struct.unpack_from("<H", data, p2)
                            ids = np.frombuffer(data, "<u2", k, p2 + 2)
                            groups.append((mname, ids.astype(np.int64)))
            elif cid == _UVS:
                (n,) = struct.unpack_from("<H", data, b)
                t = np.frombuffer(data, "<f4", n * 2, b + 2).reshape(-1, 2)
                uv = np.stack(
                    [t[:, 0], 1.0 - t[:, 1] if flip_uv else t[:, 1]], -1)
        if pos is None or faces.size == 0:
            return
        if faces.max(initial=0) >= pos.shape[0]:
            raise ValueError(f"3DS object {name!r}: face index out of range")
        if groups:
            # Split per material group (Assimp emits one mesh per
            # material); ungrouped faces keep the default material.
            used = np.zeros(faces.shape[0], bool)
            for mname, ids in groups:
                ids = ids[ids < faces.shape[0]]
                if ids.size == 0:
                    continue
                used[ids] = True
                meshes.append(_mesh_from_trimesh(
                    name, pos, uv, faces[ids],
                    materials.get(mname, Material())))
            if not used.all():
                meshes.append(_mesh_from_trimesh(
                    name, pos, uv, faces[~used], Material()))
        else:
            meshes.append(_mesh_from_trimesh(name, pos, uv, faces,
                                             Material()))

    def parse_editor(start: int, end: int) -> None:
        for cid, b, e in _chunks(data, start, end):
            if cid == _MATERIAL:
                parse_material(b, e)
        for cid, b, e in _chunks(data, start, end):
            if cid == _OBJECT:
                name, p = _asciiz(data, b, e)
                for c2, b2, e2 in _chunks(data, p, e):
                    if c2 == _TRIMESH:
                        parse_trimesh(name, b2, e2)

    for cid, b, e in _chunks(data, 6, main_len):
        if cid == _EDITOR:
            parse_editor(b, e)
    return {"meshes": meshes, "lights": []}


# ---------------------------------------------------------------------------
# Minimal writer (fixtures / interchange smoke tests)
# ---------------------------------------------------------------------------

def _w_chunk(cid: int, body: bytes) -> bytes:
    return struct.pack("<HI", cid, 6 + len(body)) + body


def write_3ds(path: str, positions: np.ndarray, indices: np.ndarray,
              uvs: Optional[np.ndarray] = None,
              diffuse_color: Tuple[float, float, float] = (1.0, 1.0, 1.0),
              material_name: str = "mat0") -> None:
    """Write a single-object .3ds: Y-up inputs are stored Z-up (the
    inverse of the importer's axis conversion), V unflipped."""
    pos = np.asarray(positions, F32).reshape(-1, 3)
    idx = np.asarray(indices, np.int64).reshape(-1, 3)
    if pos.shape[0] > 0xFFFF or idx.shape[0] > 0xFFFF:
        raise ValueError("3DS uses u16 counts: mesh too large")
    # Y-up → Z-up storage: (x, y, z) → (x, -z, y)
    stored = np.stack([pos[:, 0], -pos[:, 2], pos[:, 1]], -1)

    body = struct.pack("<H", pos.shape[0]) \
        + stored.astype("<f4").tobytes()
    verts = _w_chunk(_VERTICES, body)

    fr = np.zeros((idx.shape[0], 4), "<u2")
    fr[:, :3] = idx
    fmats = _w_chunk(_FACE_MATS, material_name.encode() + b"\x00"
                     + struct.pack("<H", idx.shape[0])
                     + np.arange(idx.shape[0], dtype="<u2").tobytes())
    faces = _w_chunk(_FACES, struct.pack("<H", idx.shape[0])
                     + fr.tobytes() + fmats)
    tm = verts + faces
    if uvs is not None:
        t = np.asarray(uvs, F32).reshape(-1, 2)
        stored_uv = np.stack([t[:, 0], 1.0 - t[:, 1]], -1)  # author V-up
        tm += _w_chunk(_UVS, struct.pack("<H", t.shape[0])
                       + stored_uv.astype("<f4").tobytes())
    obj = _w_chunk(_OBJECT, b"obj0\x00" + _w_chunk(_TRIMESH, tm))

    r, g, b = (int(round(255 * c)) for c in diffuse_color)
    mat = _w_chunk(_MATERIAL,
                   _w_chunk(_MAT_NAME, material_name.encode() + b"\x00")
                   + _w_chunk(_MAT_DIFFUSE,
                              _w_chunk(_COLOR_U8, bytes((r, g, b)))))
    editor = _w_chunk(_EDITOR, mat + obj)
    with open(path, "wb") as f:
        f.write(_w_chunk(_MAIN, editor))
