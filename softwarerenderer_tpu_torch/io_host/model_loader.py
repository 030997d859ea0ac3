"""Model loading facade: caching, flip-book animation, OBJ, instances.

Mirrors the reference's Model.LoadModel behavior (ModelLoader.cs:69-135):
a path can be a single model file OR a directory whose model files (sorted
by name) become flip-book animation frames advanced at a fixed FPS
(ModelLoader.cs:331-348).  Models and decoded textures are cached by
normalized path (ModelLoader.cs:62-63, Renderer.cs:15).

Formats: glTF/GLB via the first-party importer (io_host.gltf), OBJ, STL,
PLY, COLLADA .dae (io_host.collada), binary FBX (io_host.fbx) and
Autodesk .3ds (io_host.tds) — the common subset of what the reference
reaches through Assimp (ModelLoader.cs:144-150).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional

import numpy as np

from softwarerenderer_tpu_torch.io_host import gltf as gltf_mod
from softwarerenderer_tpu_torch.models.scene import (
    Light,
    Material,
    MeshInstance,
    bounding_sphere,
)

F32 = np.float32

_MODEL_CACHE: Dict[str, "Model"] = {}
_TEXTURE_CACHE: Dict[str, Optional[np.ndarray]] = {}

SUPPORTED_EXTENSIONS = {".gltf", ".glb", ".obj", ".stl", ".ply",
                        ".dae", ".fbx", ".3ds"}


@dataclasses.dataclass
class Model:
    """Loaded model: world-baked meshes + lights + animation frames."""

    meshes: List[Dict] = dataclasses.field(default_factory=list)
    lights: List[Light] = dataclasses.field(default_factory=list)
    animation_frames: List["Model"] = dataclasses.field(default_factory=list)
    _frame_index: int = 0
    _time_accumulator: float = 0.0

    def play_animation(self, on_frame: Callable[["Model"], None],
                       delta_time: float, fps: int = 30) -> None:
        """Flip-book stepping exactly as ModelLoader.PlayAnimation
        (ModelLoader.cs:331-348)."""
        if not self.animation_frames:
            return
        frame_duration = 1.0 / fps
        self._time_accumulator += delta_time
        while self._time_accumulator >= frame_duration:
            self._time_accumulator -= frame_duration
            self._frame_index = (self._frame_index + 1) \
                % len(self.animation_frames)
        on_frame(self.animation_frames[self._frame_index])

    def advance_animation(self, delta_time: float, fps: int = 30) -> int:
        """PlayAnimation's fixed-FPS timing, returning the current frame
        index — feed it to the device as uniforms["anim_frame"] (the
        TPU-native path: frame stacks live on device, the index is a
        traced scalar, so stepping never re-uploads or recompiles)."""
        self.play_animation(lambda _m: None, delta_time, fps)
        return self._frame_index


def clear_caches() -> None:
    _MODEL_CACHE.clear()
    _TEXTURE_CACHE.clear()


def load_texture(path: str) -> Optional[np.ndarray]:
    """Cached image decode (Texture.LoadTexture + Renderer's
    ConcurrentDictionary cache, Texture.cs:70-94, Renderer.cs:821-828)."""
    key = os.path.abspath(path)
    if key not in _TEXTURE_CACHE:
        _TEXTURE_CACHE[key] = gltf_mod.load_image(key)
    return _TEXTURE_CACHE[key]


def write_obj(path: str, meshes: List[Dict],
              write_mtl: bool = True) -> None:
    """Export meshes as Wavefront OBJ (+ companion .mtl) — closing the
    exporter matrix for the one reader family (OBJ) that lacked a
    writer; the reference imports only (ModelLoader.cs:137-326).

    Geometry round-trips through `load_obj` exactly: positions/normals
    are printed with repr (shortest float32-exact decimal) and the UV V
    coordinate is stored as 1−v so the loader's FlipUVs undoes it (exact
    for v ≥ 0.5 by Sterbenz, 1 ulp below — the glTF writer's contract).
    Each mesh becomes an `o` block; materials map to .mtl entries
    (Kd = base_color rgb, d = alpha, Ke = emissive, map_Kd = the
    'diffuse' texture path when the material names one).
    """
    base = os.path.splitext(path)[0]
    mtl_name = os.path.basename(base) + ".mtl"
    lines = [f"# softwarerenderer_tpu export ({len(meshes)} meshes)"]
    if write_mtl:
        lines.append(f"mtllib {mtl_name}")
    mtl_lines = []
    v_off = 1
    for mi, mesh in enumerate(meshes):
        pos = np.asarray(mesh["position"], F32)
        uv = np.asarray(mesh["uv"], F32)
        nrm = np.asarray(mesh["normal"], F32)
        idx = np.asarray(mesh["indices"], np.int64).reshape(-1, 3)
        lines.append(f"o mesh{mi}")
        if write_mtl:
            lines.append(f"usemtl mat{mi}")
            mat = mesh.get("material") or Material()
            r, g, b, a = [float(x)
                          for x in (list(mat.base_color) + [1.0])[:4]]
            ke = [float(x) for x in mat.emissive]
            mtl_lines += [f"newmtl mat{mi}",
                          f"Kd {r!r} {g!r} {b!r}",
                          f"d {a!r}",
                          f"Ke {ke[0]!r} {ke[1]!r} {ke[2]!r}"]
            tp = mat.texture_path("diffuse")
            if tp:
                mtl_lines.append(f"map_Kd {tp}")
        # repr(float(x)) = shortest float64-exact decimal; the float32
        # value is preserved exactly through the f64 round trip.
        for p in pos:
            lines.append(f"v {float(p[0])!r} {float(p[1])!r} "
                         f"{float(p[2])!r}")
        for t in uv:
            lines.append(f"vt {float(t[0])!r} "
                         f"{float(np.float32(1.0) - t[1])!r}")
        for n in nrm:
            lines.append(f"vn {float(n[0])!r} {float(n[1])!r} "
                         f"{float(n[2])!r}")
        for tri in idx:
            c = [f"{int(k) + v_off}/{int(k) + v_off}/{int(k) + v_off}"
                 for k in tri]
            lines.append("f " + " ".join(c))
        v_off += pos.shape[0]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    if write_mtl:
        with open(os.path.join(os.path.dirname(path) or ".",
                               mtl_name), "w") as f:
            f.write("\n".join(mtl_lines) + "\n")


def load_obj(path: str) -> Dict:
    """Minimal OBJ: v/vt/vn + triangulated f (fan for polygons)."""
    positions, uvs, normals = [], [], []
    out_pos, out_uv, out_n = [], [], []
    indices = []
    vert_cache: Dict[str, int] = {}

    def corner(spec: str) -> int:
        if spec in vert_cache:
            return vert_cache[spec]
        parts = (spec.split("/") + ["", ""])[:3]
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ti = int(parts[1]) - 1 if parts[1] else None
        ni = int(parts[2]) - 1 if parts[2] else None
        out_pos.append(positions[vi])
        out_uv.append(uvs[ti] if ti is not None else (0.0, 0.0))
        out_n.append(normals[ni] if ni is not None else (0.0, 0.0, 0.0))
        idx = len(out_pos) - 1
        vert_cache[spec] = idx
        return idx

    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                positions.append(tuple(float(x) for x in t[1:4]))
            elif t[0] == "vt":
                uvs.append((float(t[1]), 1.0 - float(t[2])))  # FlipUVs
            elif t[0] == "vn":
                normals.append(tuple(float(x) for x in t[1:4]))
            elif t[0] == "f":
                corners = [corner(s) for s in t[1:]]
                for i in range(1, len(corners) - 1):
                    indices.append((corners[0], corners[i], corners[i + 1]))

    pos = np.asarray(out_pos, dtype=F32).reshape(-1, 3)
    center, radius = bounding_sphere(pos)
    mesh = {
        "position": pos,
        "uv": np.asarray(out_uv, dtype=F32).reshape(-1, 2),
        "normal": np.asarray(out_n, dtype=F32).reshape(-1, 3),
        "color": np.ones((pos.shape[0], 4), dtype=F32),
        "indices": np.asarray(indices, dtype=np.int32).reshape(-1, 3),
        "material": Material(),
        "bounds_center": center,
        "bounds_radius": radius,
    }
    return {"meshes": [mesh], "lights": []}


def _mesh_dict(pos, uv, normal, color, indices) -> Dict:
    """Common mesh-dict assembly for the simple single-mesh formats."""
    pos = np.asarray(pos, F32).reshape(-1, 3)
    center, radius = bounding_sphere(pos)
    return {
        "position": pos,
        "uv": np.asarray(uv, F32).reshape(-1, 2),
        "normal": np.asarray(normal, F32).reshape(-1, 3),
        "color": np.asarray(color, F32).reshape(-1, 4),
        "indices": np.asarray(indices, np.int32).reshape(-1, 3),
        "material": Material(),
        "bounds_center": center,
        "bounds_radius": radius,
    }


def load_stl(path: str) -> Dict:
    """STL, binary or ASCII — facet normals replicated per corner.

    (The reference imports STL through Assimp, ModelLoader.cs:144-150;
    this is the first-party equivalent.)  Vertices are NOT deduplicated:
    STL facets are independent, matching Assimp's default for STL."""
    with open(path, "rb") as f:
        head = f.read(5)
    if head == b"solid":
        # Probably ASCII — but binary files may also start with "solid";
        # fall back to binary when the ASCII parse finds no facets.
        tris = _parse_stl_ascii(path)
        if tris is None:
            tris = _parse_stl_binary(path)
    else:
        tris = _parse_stl_binary(path)
    normals, verts = tris
    n_tri = verts.shape[0]
    pos = verts.reshape(-1, 3)
    nrm = np.repeat(normals, 3, axis=0)
    # zero/garbage facet normals → recompute from winding
    bad = np.linalg.norm(nrm, axis=-1) < 1e-12
    if bad.any():
        e1 = verts[:, 1] - verts[:, 0]
        e2 = verts[:, 2] - verts[:, 0]
        face_n = np.cross(e1, e2)
        ln = np.linalg.norm(face_n, axis=-1, keepdims=True)
        face_n = np.divide(face_n, np.where(ln > 0, ln, 1.0))
        nrm[bad] = np.repeat(face_n, 3, axis=0)[bad]
    idx = np.arange(n_tri * 3, dtype=np.int32).reshape(-1, 3)
    mesh = _mesh_dict(pos, np.zeros((n_tri * 3, 2), F32), nrm,
                      np.ones((n_tri * 3, 4), F32), idx)
    return {"meshes": [mesh], "lights": []}


def _parse_stl_ascii(path: str):
    normals, verts, cur = [], [], []
    cur_n = (0.0, 0.0, 0.0)
    try:
        with open(path, "r", errors="strict") as f:
            for line in f:
                t = line.split()
                if not t:
                    continue
                if t[0] == "facet" and len(t) >= 5:
                    cur_n = (float(t[2]), float(t[3]), float(t[4]))
                elif t[0] == "vertex":
                    cur.append((float(t[1]), float(t[2]), float(t[3])))
                elif t[0] == "endfacet":
                    for i in range(1, len(cur) - 1):   # fan, like OBJ
                        normals.append(cur_n)
                        verts.append((cur[0], cur[i], cur[i + 1]))
                    cur = []
    except (UnicodeDecodeError, ValueError):
        return None
    if not verts:
        return None
    return np.asarray(normals, F32), np.asarray(verts, F32)


def _parse_stl_binary(path: str):
    with open(path, "rb") as f:
        f.seek(80)
        (n_tri,) = np.frombuffer(f.read(4), "<u4")
        rec = np.frombuffer(f.read(int(n_tri) * 50), dtype=np.uint8)
    rec = rec.reshape(n_tri, 50)
    floats = rec[:, :48].copy().view("<f4").reshape(n_tri, 12)
    return (floats[:, 0:3].astype(F32),
            floats[:, 3:12].reshape(n_tri, 3, 3).astype(F32))


def load_ply(path: str) -> Dict:
    """PLY, ascii / binary_little_endian — vertex position, optional
    normals, uv (s/t, u/v or texture_u/texture_v), and u8 or float
    colors; polygonal faces fan-triangulated."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elements = []          # (name, count, [(type, name) or list-spec])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("PLY header unterminated")
            t = line.decode("ascii", "replace").split()
            if not t or t[0] == "comment":
                continue
            if t[0] == "format":
                fmt = t[1]
            elif t[0] == "element":
                elements.append([t[1], int(t[2]), []])
            elif t[0] == "property":
                if t[1] == "list":
                    elements[-1][2].append(("list", t[2], t[3], t[4]))
                else:
                    elements[-1][2].append((t[1], t[2]))
            elif t[0] == "end_header":
                break
        body = f.read()

    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"unsupported PLY format: {fmt}")

    _PLY_NP = {"char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
               "short": "i2", "int16": "i2", "ushort": "u2",
               "uint16": "u2", "int": "i4", "int32": "i4", "uint": "u4",
               "uint32": "u4", "float": "f4", "float32": "f4",
               "double": "f8", "float64": "f8"}
    vdata: Dict[str, np.ndarray] = {}
    faces: List[tuple] = []

    if fmt == "ascii":
        rows = body.decode("ascii", "replace").split("\n")
        r = 0
        for name, count, props in elements:
            if name == "vertex":
                names = [p[1] for p in props]
                vals = np.asarray(
                    [rows[r + i].split() for i in range(count)], np.float64)
                for j, nm in enumerate(names):
                    vdata[nm] = vals[:, j]
                r += count
            elif name == "face":
                for i in range(count):
                    t = rows[r + i].split()
                    k = int(t[0])
                    faces.append(tuple(int(x) for x in t[1:1 + k]))
                r += count
            else:
                r += count
    else:
        def _skip_records(off, count, props):
            """Advance past `count` records of an element that may contain
            variable-length list properties (a fixed dtype cannot skip
            those — a wrong itemsize would corrupt the byte offsets of
            every element that follows)."""
            walk = [((np.dtype("<" + _PLY_NP[p[1]]),
                      np.dtype("<" + _PLY_NP[p[2]]))
                     if p[0] == "list"
                     else np.dtype("<" + _PLY_NP[p[0]]).itemsize)
                    for p in props]
            if all(isinstance(w, int) for w in walk):
                return off + sum(walk) * count
            for _ in range(count):
                for w in walk:             # properties in declared order
                    if isinstance(w, int):
                        off += w
                    else:
                        cnt_dt, item_dt = w
                        k = int(np.frombuffer(body, cnt_dt, 1, off)[0])
                        off += cnt_dt.itemsize + item_dt.itemsize * k
            return off

        off = 0
        for name, count, props in elements:
            if name == "vertex":
                if any(p[0] == "list" for p in props):
                    # Interleaved scalar/list vertex records can't map to
                    # one fixed dtype; no common exporter emits them.
                    raise ValueError(
                        "PLY: list properties on the vertex element are "
                        "not supported")
                dt = np.dtype([(p[1], "<" + _PLY_NP[p[0]]) for p in props])
                arr = np.frombuffer(body, dt, count, off)
                off += dt.itemsize * count
                for p in props:
                    vdata[p[1]] = arr[p[1]].astype(np.float64)
            elif name == "face":
                # list properties are per-row variable: walk records
                lp = props[0]
                cnt_dt = np.dtype("<" + _PLY_NP[lp[1]])
                idx_dt = np.dtype("<" + _PLY_NP[lp[2]])
                for _ in range(count):
                    k = int(np.frombuffer(body, cnt_dt, 1, off)[0])
                    off += cnt_dt.itemsize
                    ix = np.frombuffer(body, idx_dt, k, off)
                    off += idx_dt.itemsize * k
                    faces.append(tuple(int(x) for x in ix))
            else:
                # foreign elements: walk records (handles list properties)
                off = _skip_records(off, count, props)

    n_v = len(vdata.get("x", ()))
    pos = np.stack([vdata["x"], vdata["y"], vdata["z"]], -1)
    if {"nx", "ny", "nz"} <= vdata.keys():
        nrm = np.stack([vdata["nx"], vdata["ny"], vdata["nz"]], -1)
    else:
        nrm = np.zeros((n_v, 3))
    uv = np.zeros((n_v, 2))
    for ukey, vkey in (("s", "t"), ("u", "v"),
                       ("texture_u", "texture_v")):
        if {ukey, vkey} <= vdata.keys():
            uv = np.stack([vdata[ukey], 1.0 - vdata[vkey]], -1)  # FlipUVs
            break
    col = np.ones((n_v, 4))
    if {"red", "green", "blue"} <= vdata.keys():
        scale = 255.0 if vdata["red"].max(initial=0) > 1.0 else 1.0
        col[:, 0] = vdata["red"] / scale
        col[:, 1] = vdata["green"] / scale
        col[:, 2] = vdata["blue"] / scale
        if "alpha" in vdata:
            col[:, 3] = vdata["alpha"] / scale
    indices = []
    for face in faces:
        for i in range(1, len(face) - 1):
            indices.append((face[0], face[i], face[i + 1]))
    mesh = _mesh_dict(pos, uv, nrm, col,
                      np.asarray(indices, np.int32).reshape(-1, 3))
    return {"meshes": [mesh], "lights": []}


def _load_single(path: str, rigid_animation: bool = True) -> Model:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".gltf", ".glb"):
        doc = gltf_mod.load_gltf(path, rigid_animation=rigid_animation)
    elif ext == ".obj":
        doc = load_obj(path)
    elif ext == ".stl":
        doc = load_stl(path)
    elif ext == ".ply":
        doc = load_ply(path)
    elif ext == ".dae":
        from softwarerenderer_tpu_torch.io_host.collada import load_dae
        doc = load_dae(path)
    elif ext == ".fbx":
        from softwarerenderer_tpu_torch.io_host.fbx import load_fbx
        doc = load_fbx(path)
    elif ext == ".3ds":
        from softwarerenderer_tpu_torch.io_host.tds import load_3ds
        doc = load_3ds(path)
    else:
        raise ValueError(f"unsupported model format: {ext}")
    return Model(meshes=doc["meshes"], lights=doc["lights"])


def load_model(path: str, rigid_animation: bool = True) -> Model:
    """Cached load; a directory = flip-book animation (ModelLoader.cs:79-115).

    rigid_animation=False statically bakes node-TRS-animated glTF meshes
    at their rest pose instead of synthesizing device-evaluated 1-joint
    skins (gltf.load_gltf).  Use False for models whose PACKED positions
    feed host/world-space consumers — collision worlds, hitscan targets
    (sim/raycast reads packed vertices; an animated mesh would render
    transformed but collide untransformed)."""
    norm = os.path.abspath(path)
    key = (norm, bool(rigid_animation))
    if key in _MODEL_CACHE:
        return _MODEL_CACHE[key]
    if os.path.isdir(norm):
        files = sorted(
            f for f in os.listdir(norm)
            if os.path.splitext(f)[1].lower() in SUPPORTED_EXTENSIONS)
        frames = [_load_single(os.path.join(norm, f), rigid_animation)
                  for f in files]
        model = Model(animation_frames=frames)
        if frames:
            model.meshes = frames[0].meshes
            model.lights = frames[0].lights
    elif os.path.isfile(norm):
        model = _load_single(norm, rigid_animation)
    else:
        raise FileNotFoundError(f"Model path not found: {norm}")
    _MODEL_CACHE[key] = model
    return model


def save_model(path: str, model: Model,
               embed_textures: bool = False) -> None:
    """Export a loaded model — the asset round trip the reference lacks
    (Assimp is import-only in ModelLoader.cs:137-326).  glTF/GLB carries
    everything the loaders produce (world-baked meshes, vertex colors,
    materials, texture URIs, lights, skins) via io_host.gltf.write_gltf;
    embed_textures=True PNG-embeds every texture for a self-contained
    file.  For single-mesh FBX/3DS exports use write_fbx/write_3ds."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        write_obj(path, model.meshes)
        return
    if ext not in (".gltf", ".glb"):
        raise ValueError(f"save_model exports glTF/GLB/OBJ only (got "
                         f"'{ext}'); io_host.fbx.write_fbx / "
                         "io_host.tds.write_3ds handle single-mesh "
                         "fixture exports")
    gltf_mod.write_gltf(path, model.meshes, lights=model.lights,
                        embed_textures=embed_textures)


def model_instances(model: Model, model_matrix: Optional[np.ndarray] = None,
                    texture_override: Optional[np.ndarray] = None,
                    fallback_texture: Optional[np.ndarray] = None
                    ) -> List[MeshInstance]:
    """Turn a loaded model into packed-scene MeshInstances, resolving each
    mesh's diffuse texture through the cache (missing files → fallback)."""
    mm = (np.eye(4, dtype=F32) if model_matrix is None
          else np.asarray(model_matrix, dtype=F32))
    out = []
    for i, mesh in enumerate(model.meshes):
        material: Material = mesh.get("material", Material())
        tex = texture_override
        if tex is None:
            tex_path = material.texture_path("diffuse")
            if tex_path is not None:
                tex = load_texture(tex_path)
            if tex is None:
                tex = fallback_texture
        anim_pos = anim_nrm = None
        frames = model.animation_frames
        if len(frames) > 1 and all(
                i < len(f.meshes)
                and f.meshes[i]["position"].shape
                == mesh["position"].shape for f in frames):
            # Flip-book stacks (same topology per frame,
            # ModelLoader.cs:345-347) → device-side animation buffers.
            anim_pos = np.stack([np.asarray(f.meshes[i]["position"], F32)
                                 for f in frames])
            anim_nrm = np.stack([np.asarray(f.meshes[i]["normal"], F32)
                                 for f in frames])
        ntex = None
        npath = material.texture_path("normals")
        if npath is not None:
            ntex = load_texture(npath)   # reference loads, never samples
        out.append(MeshInstance(mesh=mesh, model_matrix=mm, texture=tex,
                                material=material,
                                normal_texture=ntex,
                                animation_positions=anim_pos,
                                animation_normals=anim_nrm,
                                skin=mesh.get("skin"),
                                morph=mesh.get("morph")))
    return out
