"""First-party glTF 2.0 (+ GLB) importer with the reference's semantics.

Replaces the reference's native Assimp import path (ModelLoader.cs:137-326,
consumed via AssimpNet P/Invoke — SURVEY.md §2).  Matches its behavior:

  * node hierarchy flattened with GLOBAL transforms baked into vertex
    positions; normals transformed by the rotation-only upper 3×3 (NOT the
    inverse-transpose — faithful to ModelLoader.cs:164-200) and normalized
  * triangles only (glTF primitive mode 4; other modes skipped, matching
    Assimp's Triangulate post-process + the IndexCount!=3 skip at :180)
  * UV V-flip (Assimp's FlipUVs flag, ModelLoader.cs:148)
  * missing normals → zero vector, missing UVs → (0,0), missing vertex
    colors → white (ModelLoader.cs:188-194)
  * per-mesh material: baseColor, metallic (default 0), roughness (default
    0.5), emissive, texture paths resolved against the model directory
    (ModelLoader.cs:221-281)
  * KHR_lights_punctual → Light records (ModelLoader.cs:305-322)
  * int32 indices (the reference's ushort/65k-vertex limit is lifted —
    SURVEY.md §7 step 2)

Pure Python + numpy; images decode through PIL with the reference's
≤2048px downscale (Texture.cs:70-84).
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from softwarerenderer_tpu_torch.models.scene import (
    Light,
    LightType,
    Material,
    bounding_sphere,
)

F32 = np.float32

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}
_LIGHT_TYPES = {"directional": LightType.DIRECTIONAL,
                "point": LightType.POINT, "spot": LightType.SPOT}

MAX_TEXTURE_SIZE = 2048  # Texture.cs:70


class GltfError(ValueError):
    pass


def _read_glb(data: bytes) -> Tuple[dict, Optional[bytes]]:
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise GltfError("not a GLB file")
    offset = 12
    gltf_json, bin_chunk = None, None
    while offset < len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        chunk = data[offset + 8: offset + 8 + chunk_len]
        if chunk_type == 0x4E4F534A:  # JSON
            gltf_json = json.loads(chunk)
        elif chunk_type == 0x004E4942:  # BIN
            bin_chunk = chunk
        offset += 8 + chunk_len
    if gltf_json is None:
        raise GltfError("GLB missing JSON chunk")
    return gltf_json, bin_chunk


def _load_buffers(doc: dict, base_dir: str,
                  glb_bin: Optional[bytes]) -> List[bytes]:
    out = []
    for i, buf in enumerate(doc.get("buffers", [])):
        uri = buf.get("uri")
        if uri is None:
            if glb_bin is None:
                raise GltfError(f"buffer {i} has no uri and no GLB chunk")
            out.append(glb_bin)
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                out.append(f.read())
    return out


def _read_sparse(doc: dict, buffers: List[bytes], acc: dict,
                 base: np.ndarray) -> np.ndarray:
    """Apply a sparse accessor's index/value overrides to `base` (the
    dense bufferView content, or zeros — the spec default).  Blender
    exports morph-target deltas this way by default."""
    sp = acc["sparse"]
    n = int(sp["count"])

    def seg(view_idx: int, extra_off: int, dtype, count: int):
        view = doc["bufferViews"][view_idx]
        data = buffers[view["buffer"]]
        off = view.get("byteOffset", 0) + extra_off
        return np.frombuffer(data, dtype=dtype, count=count, offset=off)

    si = sp["indices"]
    idx = seg(si["bufferView"], si.get("byteOffset", 0),
              _COMPONENT_DTYPES[si["componentType"]], n).astype(np.int64)
    sv = sp["values"]
    n_comp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    vals = seg(sv["bufferView"], sv.get("byteOffset", 0), dtype,
               n * n_comp).reshape(n, n_comp)
    out = np.array(base, copy=True)
    out[idx] = vals
    return out


def _read_accessor(doc: dict, buffers: List[bytes], idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    n_comp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    count = acc["count"]
    if "bufferView" not in acc:
        base = np.zeros((count, n_comp), dtype=dtype)
        if "sparse" in acc:
            base = _read_sparse(doc, buffers, acc, base)
            if acc.get("normalized") and np.issubdtype(dtype, np.integer):
                info = np.iinfo(dtype)
                return base.astype(F32) / F32(max(abs(info.min),
                                                  info.max))
        return base
    view = doc["bufferViews"][acc["bufferView"]]
    data = buffers[view["buffer"]]
    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    itemsize = np.dtype(dtype).itemsize
    elem_size = itemsize * n_comp
    stride = view.get("byteStride") or elem_size
    if stride == elem_size:
        arr = np.frombuffer(data, dtype=dtype, count=count * n_comp,
                            offset=start).reshape(count, n_comp)
    else:
        raw = np.frombuffer(data, dtype=np.uint8,
                            count=stride * (count - 1) + elem_size,
                            offset=start)
        strided = np.lib.stride_tricks.as_strided(
            raw, shape=(count, elem_size), strides=(stride, 1))
        arr = strided.reshape(-1).view(dtype).reshape(count, n_comp)
    if "sparse" in acc:
        arr = _read_sparse(doc, buffers, acc, arr)
    if acc.get("normalized") and np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        arr = arr.astype(F32) / F32(max(abs(info.min), info.max))
    return np.array(arr)  # copy out of the buffer


def _node_matrix_row(node: dict) -> np.ndarray:
    """Node transform as a ROW-vector matrix (glTF stores column-vector,
    column-major — the flat list transposes directly into our layout)."""
    if "matrix" in node:
        # column-major storage read row-by-row == transpose == row-vector form
        return np.asarray(node["matrix"], dtype=F32).reshape(4, 4)
    m = np.eye(4, dtype=F32)
    s = node.get("scale")
    r = node.get("rotation")
    t = node.get("translation")
    if s is not None:
        sm = np.diag(np.asarray(list(s) + [1.0], dtype=F32))
        m = m @ sm
    if r is not None:
        from softwarerenderer_tpu_torch.utils import hostmath as ml
        m = m @ ml.matrix_from_quaternion(np.asarray(r, dtype=F32))
    if t is not None:
        tm = np.eye(4, dtype=F32)
        tm[3, :3] = np.asarray(t, dtype=F32)
        m = m @ tm
    return m


EMBEDDED_SEP = "::image"   # pseudo-path marker: "<model file>::image<N>"


def _extract_material(doc: dict, base_dir: str, mi: Optional[int],
                      src_path: str = "") -> Material:
    if mi is None:
        return Material()
    mat = doc.get("materials", [])[mi]
    pbr = mat.get("pbrMetallicRoughness", {})
    base = tuple(pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0]))
    metallic = float(pbr.get("metallicFactor", 0.0))
    roughness = float(pbr.get("roughnessFactor", 0.5))
    emissive = tuple(mat.get("emissiveFactor", [0.0, 0.0, 0.0]))
    paths = []
    def tex_path(info, slot):
        if not info:
            return
        tex = doc["textures"][info["index"]]
        img_idx = tex.get("source")
        if img_idx is None:
            return
        img = doc["images"][img_idx]
        uri = img.get("uri")
        if uri and not uri.startswith("data:"):
            paths.append((slot, os.path.join(base_dir, uri)))
        elif uri or "bufferView" in img:
            # Embedded image (data: URI or GLB bufferView — what most
            # real-world .glb exports ship; Assimp decodes these too,
            # ModelLoader.cs:144-150).  A pseudo-path keeps Material
            # hashable and routes through the one texture cache;
            # load_image resolves it back to the bytes.
            paths.append((slot, f"{src_path}{EMBEDDED_SEP}{img_idx}"))
    tex_path(pbr.get("baseColorTexture"), "diffuse")
    tex_path(mat.get("normalTexture"), "normals")
    tex_path(mat.get("emissiveTexture"), "emissive")
    return Material(base_color=base, metallic=metallic, roughness=roughness,
                    emissive=emissive, texture_paths=tuple(paths))


def _quat_from_rot_rows(r: np.ndarray) -> np.ndarray:
    """xyzw quaternion from a row-vector 3×3 rotation (the layout of
    mathlib.matrix_from_quaternion: m01 − m10 = 4wz, etc.)."""
    t = r[0, 0] + r[1, 1] + r[2, 2]
    if t > 0:
        w = np.sqrt(1.0 + t) / 2.0
        x = (r[1, 2] - r[2, 1]) / (4 * w)
        y = (r[2, 0] - r[0, 2]) / (4 * w)
        z = (r[0, 1] - r[1, 0]) / (4 * w)
    elif r[0, 0] >= r[1, 1] and r[0, 0] >= r[2, 2]:
        x = np.sqrt(max(0.0, 1.0 + r[0, 0] - r[1, 1] - r[2, 2])) / 2.0
        w = (r[1, 2] - r[2, 1]) / (4 * x)
        y = (r[0, 1] + r[1, 0]) / (4 * x)
        z = (r[0, 2] + r[2, 0]) / (4 * x)
    elif r[1, 1] >= r[2, 2]:
        y = np.sqrt(max(0.0, 1.0 - r[0, 0] + r[1, 1] - r[2, 2])) / 2.0
        w = (r[2, 0] - r[0, 2]) / (4 * y)
        x = (r[0, 1] + r[1, 0]) / (4 * y)
        z = (r[1, 2] + r[2, 1]) / (4 * y)
    else:
        z = np.sqrt(max(0.0, 1.0 - r[0, 0] - r[1, 1] + r[2, 2])) / 2.0
        w = (r[0, 1] - r[1, 0]) / (4 * z)
        x = (r[0, 2] + r[2, 0]) / (4 * z)
        y = (r[1, 2] + r[2, 1]) / (4 * z)
    q = np.asarray([x, y, z, w], dtype=F32)
    return q / max(np.linalg.norm(q), 1e-30)


def _decompose_trs_row(m: np.ndarray):
    """Row-vector 4×4 → (translation, xyzw quat, scale).  Shear is lost
    (the standard approximation; glTF joint nodes are TRS by convention)."""
    t = m[3, :3].astype(F32)
    rows = m[:3, :3].astype(np.float64)
    s = np.linalg.norm(rows, axis=1)
    if np.linalg.det(rows) < 0:
        s[0] = -s[0]
    safe = np.where(s == 0, 1.0, s)
    q = _quat_from_rot_rows(rows / safe[:, None])
    return t, q, s.astype(F32)


def _node_trs(node: dict):
    """A node's rest-pose local TRS (decomposing `matrix` when present)."""
    if "matrix" in node:
        return _decompose_trs_row(_node_matrix_row(node))
    t = np.asarray(node.get("translation", [0, 0, 0]), F32)
    q = np.asarray(node.get("rotation", [0, 0, 0, 1]), F32)
    s = np.asarray(node.get("scale", [1, 1, 1]), F32)
    return t, q, s


def _resample_channel(times: np.ndarray, values: np.ndarray, grid: np.ndarray,
                      interpolation: str, is_quat: bool) -> np.ndarray:
    """Resample one sampler onto the uniform grid.  LINEAR → np.interp
    per component (quats sign-aligned first, renormalized after);
    STEP → previous key; CUBICSPLINE → its value-thirds, treated LINEAR
    (documented approximation)."""
    if interpolation == "CUBICSPLINE":
        values = values.reshape(times.shape[0], 3, -1)[:, 1, :]
    values = values.astype(np.float64)
    if is_quat:
        for k in range(1, values.shape[0]):
            if np.dot(values[k], values[k - 1]) < 0:
                values[k] = -values[k]
    if interpolation == "STEP":
        idx = np.clip(np.searchsorted(times, grid, side="right") - 1,
                      0, times.shape[0] - 1)
        out = values[idx]
    else:
        out = np.stack([np.interp(grid, times, values[:, c])
                        for c in range(values.shape[1])], axis=-1)
    if is_quat:
        out = out / np.maximum(
            np.linalg.norm(out, axis=-1, keepdims=True), 1e-30)
    return out.astype(F32)


def _parse_animation(doc: dict, buffers: List[bytes],
                     animation_index: int):
    """Channels of animation `animation_index`:
    (node → {path: (times, values, interpolation)}, clip duration)."""
    anims = doc.get("animations", [])
    channels = {}          # node → {path: (times, values, interpolation)}
    duration = 0.0
    if anims:
        anim = anims[min(animation_index, len(anims) - 1)]
        for ch in anim.get("channels", []):
            tgt = ch.get("target", {})
            node = tgt.get("node")
            path = tgt.get("path")
            if node is None or path not in ("translation", "rotation",
                                            "scale", "weights"):
                continue
            smp = anim["samplers"][ch["sampler"]]
            times = _read_accessor(doc, buffers, smp["input"]) \
                .reshape(-1).astype(np.float64)
            values = _read_accessor(doc, buffers, smp["output"])
            channels.setdefault(node, {})[path] = (
                times, values, smp.get("interpolation", "LINEAR"))
            if times.size:
                duration = max(duration, float(times[-1]))
    return channels, duration


def _chain_rate(channels: dict, duration: float, nodes) -> float:
    """Uniform resample rate for a set of nodes: densest sampler over the
    clip, floored at 30 fps, clamped to 120 (same rule for skins and
    rigid tracks so they share the anim_time clock)."""
    rate = 30.0
    for n in nodes:
        for times, _v, _i in channels.get(n, {}).values():
            if times.size > 1 and duration > 0:
                rate = max(rate, (times.size - 1) / duration)
    return float(np.clip(rate, 1.0, 120.0))


def _sampled_trs(doc: dict, channels: dict, node: int, grid: np.ndarray):
    """One node's (F, 3)/(F, 4)/(F, 3) TRS track on `grid` (static fields
    broadcast)."""
    F = grid.shape[0]
    t0, q0, s0 = _node_trs(doc["nodes"][node])
    ch = channels.get(node, {})
    t = (_resample_channel(*ch["translation"][:2], grid,
                           ch["translation"][2], False)
         if "translation" in ch else np.broadcast_to(t0, (F, 3)).copy())
    q = (_resample_channel(*ch["rotation"][:2], grid,
                           ch["rotation"][2], True)
         if "rotation" in ch else np.broadcast_to(q0, (F, 4)).copy())
    s = (_resample_channel(*ch["scale"][:2], grid,
                           ch["scale"][2], False)
         if "scale" in ch else np.broadcast_to(s0, (F, 3)).copy())
    return t.astype(F32), q.astype(F32), s.astype(F32)


def _rigid_track(doc: dict, channels: dict, duration: float, chain):
    """The 1-joint skeleton kwargs evaluating a mesh node's ANIMATED
    global transform on device (node-TRS animations on non-skinned
    meshes — rigid-body animation; Assimp exposes these as node anims,
    the reference ignores them).  `chain` = [node, parent, ..., root].

    The joint's track is the composed global TRS per uniform-clock frame
    (global = local_node @ local_parent @ ... in the row-vector
    convention), endpoint-dropped exactly like skin tracks; vertices
    stay authored-local and ride the existing skinning path.  Built
    ONCE per node (load_gltf caches it — a multi-primitive mesh shares
    the resample/decompose work and the track arrays)."""
    from softwarerenderer_tpu_torch.io_host.hostops import compose_trs

    rate = _chain_rate(channels, duration, chain)
    F = max(1, int(round(duration * rate)) + 1) if duration > 0 else 1
    grid = np.arange(F, dtype=np.float64) / rate
    tracks = [_sampled_trs(doc, channels, n, grid) for n in chain]
    trans = np.zeros((F, 1, 3), F32)
    rot = np.zeros((F, 1, 4), F32)
    scl = np.ones((F, 1, 3), F32)
    for f in range(F):
        m = np.eye(4, dtype=F32)
        for (t, q, s) in tracks:     # node-to-root: left-compose locals
            m = m @ compose_trs(t[f], q[f], s[f], xp=np)
        trans[f, 0], rot[f, 0], scl[f, 0] = _decompose_trs_row(m)
    if F > 1:                        # drop the duplicated loop endpoint
        trans, rot, scl = trans[:-1], rot[:-1], scl[:-1]
    return dict(parent=np.asarray([-1], np.int32),
                inverse_bind=np.eye(4, dtype=F32)[None],
                trans=trans, rot=rot, scale=scl, rate=rate)


def _build_skins(doc: dict, buffers: List[bytes], channels: dict,
                 duration: float,
                 node_parent: Dict[int, Optional[int]]):
    """Per glTF skin: topologically-ordered skeleton + uniform-clock TRS
    tracks, as models.scene.Skin kwargs (minus the per-vertex arrays).

    glTF semantics honored: joint world transform = the node's global
    transform; a root joint's non-joint ancestor chain is folded into its
    local track (matrix-composed per frame, then TRS-decomposed — exact
    for shear-free ancestors).  Returns (skins, joint_remaps) where
    joint_remaps[s] maps glTF joint slot → topo slot.
    """
    from softwarerenderer_tpu_torch.models.scene import Skin  # noqa: F401 (doc)

    out_skins, out_remaps = [], []
    for skin in doc.get("skins", []):
        joints = list(skin["joints"])
        jset = set(joints)

        def depth(n):
            d, p = 0, node_parent.get(n)
            while p is not None:
                d, p = d + 1, node_parent.get(p)
            return d

        order = sorted(range(len(joints)), key=lambda k: depth(joints[k]))
        remap = np.empty(len(joints), np.int32)
        for new, old in enumerate(order):
            remap[old] = new
        node_of = [joints[k] for k in order]
        slot_of_node = {n: i for i, n in enumerate(node_of)}

        parent = np.full(len(node_of), -1, np.int32)
        folded = []            # root joints with non-joint ancestors
        for i, n in enumerate(node_of):
            p = node_parent.get(n)
            while p is not None and p not in jset:
                p = node_parent.get(p)
            if p is not None:
                parent[i] = slot_of_node[p]
            else:
                a = node_parent.get(n)
                if a is not None:
                    folded.append(i)

        # Uniform clock: densest sampler (clamped) over the clip.
        rate = _chain_rate(channels, duration, node_of)
        F = max(1, int(round(duration * rate)) + 1) if duration > 0 else 1
        grid = np.arange(F, dtype=np.float64) / rate

        J = len(node_of)
        trans = np.zeros((F, J, 3), F32)
        rot = np.zeros((F, J, 4), F32)
        scl = np.ones((F, J, 3), F32)
        for i, n in enumerate(node_of):
            trans[:, i], rot[:, i], scl[:, i] = _sampled_trs(
                doc, channels, n, grid)

        # Fold static non-joint ancestor chains into root-joint tracks.
        from softwarerenderer_tpu_torch.io_host.hostops import compose_trs
        for i in folded:
            # A = L(nearest ancestor) @ ... @ L(root): global = local @
            # parent_global in the row-vector convention.
            a = node_parent.get(node_of[i])
            anc = np.eye(4, dtype=F32)
            while a is not None and a not in jset:
                anc = anc @ _node_matrix_row(doc["nodes"][a])
                a = node_parent.get(a)
            for f in range(F):
                m = compose_trs(trans[f, i], rot[f, i], scl[f, i],
                                xp=np) @ anc
                trans[f, i], rot[f, i], scl[f, i] = _decompose_trs_row(m)

        # The resample grid spans F = round(duration·rate)+1 rows and
        # includes BOTH t=0 and t=duration.  sample_tracks treats the row
        # count as the loop length (interval [F-1, F) wraps toward row 0),
        # so keeping the duplicated endpoint would stretch each loop one
        # frame interval past the authored duration and hold the end pose
        # for it.  Drop it: F-1 rows loop with exactly the authored
        # period, and the final interval crossfades last→first (identical
        # poses for loop-authored clips).
        if F > 1:
            trans, rot, scl = trans[:-1], rot[:-1], scl[:-1]

        if "inverseBindMatrices" in skin:
            ibm = _read_accessor(doc, buffers,
                                 skin["inverseBindMatrices"]) \
                .reshape(-1, 4, 4).astype(F32)
            # column-major 16-float storage read as (4,4) == transpose ==
            # our row-vector layout (same as _node_matrix_row)
            inv_bind = ibm[order]
        else:
            inv_bind = np.broadcast_to(np.eye(4, dtype=F32),
                                       (J, 4, 4)).copy()
        out_skins.append(dict(parent=parent, inverse_bind=inv_bind,
                              trans=trans, rot=rot, scale=scl, rate=rate))
        out_remaps.append(remap)
    return out_skins, out_remaps


def load_gltf(path: str, flip_uv: bool = True,
              animation_index: int = 0,
              rigid_animation: bool = True) -> Dict:
    """Parse a .gltf/.glb file into {"meshes": [...], "lights": [...]}.

    Each mesh dict: position/uv/normal/color (V, K) float32 arrays with the
    node's world transform baked in, indices (T, 3) int32, material
    (models.scene.Material), bounds_center (3,), bounds_radius float.

    Skinned primitives (a node with `skin` + JOINTS_0/WEIGHTS_0) keep
    their authored vertex positions (the node transform is ignored, per
    the glTF skinning spec) and additionally carry "skin": a
    models.scene.Skin with the topologically-ordered skeleton and the
    uniform-clock-resampled tracks of animation `animation_index`.

    With rigid_animation=True (default), a NON-skinned mesh whose node
    chain has TRS animation channels imports with a synthesized 1-joint
    "skin" evaluating the animated global transform on device (vertices
    stay authored-local) — rigid-body node animation, driven by the same
    traced uniforms["anim_time"] clock as real skins.  Set False to bake
    the rest pose statically (round-2 behavior).
    """
    src_path = os.path.abspath(path)
    base_dir = os.path.dirname(src_path)
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == b"glTF":
        doc, glb_bin = _read_glb(data)
    else:
        doc, glb_bin = json.loads(data), None
    buffers = _load_buffers(doc, base_dir, glb_bin)

    node_parent: Dict[int, Optional[int]] = {}
    for ni, nd in enumerate(doc.get("nodes", [])):
        for ch in nd.get("children", []):
            node_parent[ch] = ni
    channels, duration = _parse_animation(doc, buffers, animation_index)
    if doc.get("skins"):
        from softwarerenderer_tpu_torch.models.scene import Skin
        skin_protos, joint_remaps = _build_skins(
            doc, buffers, channels, duration, node_parent)
    else:
        skin_protos, joint_remaps = [], []

    meshes: List[Dict] = []
    rigid_tracks: Dict[int, Dict] = {}   # node → shared 1-joint track

    def process_node(node_idx: int, parent: np.ndarray, chain=()):
        chain = (node_idx,) + chain          # node → … → root
        node = doc["nodes"][node_idx]
        global_m = _node_matrix_row(node) @ parent
        rot_only = global_m.copy()
        rot_only[3, :] = [0, 0, 0, 1]
        rot_only[:, 3] = [0, 0, 0, 1]
        skin_idx = node.get("skin") if node.get("skin", None) is not None \
            and node.get("skin") < len(skin_protos) else None
        if "mesh" in node:
            gmesh = doc["meshes"][node["mesh"]]
            for prim in gmesh.get("primitives", []):
                if prim.get("mode", 4) != 4:
                    continue  # non-triangles skipped (ModelLoader.cs:180)
                attrs = prim["attributes"]
                pos = _read_accessor(doc, buffers, attrs["POSITION"]) \
                    .astype(F32)
                v = pos.shape[0]
                normal = (_read_accessor(doc, buffers, attrs["NORMAL"])
                          .astype(F32) if "NORMAL" in attrs
                          else np.zeros((v, 3), dtype=F32))
                uv = (_read_accessor(doc, buffers, attrs["TEXCOORD_0"])
                      .astype(F32)[:, :2] if "TEXCOORD_0" in attrs
                      else np.zeros((v, 2), dtype=F32))
                if "COLOR_0" in attrs:
                    col = _read_accessor(doc, buffers,
                                         attrs["COLOR_0"]).astype(F32)
                    if col.shape[1] == 3:
                        col = np.concatenate(
                            [col, np.ones((v, 1), dtype=F32)], axis=1)
                else:
                    col = np.ones((v, 4), dtype=F32)
                if flip_uv:
                    uv = uv.copy()
                    uv[:, 1] = F32(1.0) - uv[:, 1]
                if "indices" in prim:
                    idx = _read_accessor(
                        doc, buffers, prim["indices"]).reshape(-1)
                else:
                    idx = np.arange(v, dtype=np.uint32)
                idx = idx.astype(np.int32)
                if idx.shape[0] % 3:
                    idx = idx[: idx.shape[0] - idx.shape[0] % 3]

                skin_obj = None
                if skin_idx is not None and "JOINTS_0" in attrs \
                        and "WEIGHTS_0" in attrs:
                    # Skinned primitive: vertices stay in their authored
                    # space — the node transform is IGNORED per the glTF
                    # skinning spec; joints carry the full transforms.
                    proto = skin_protos[skin_idx]
                    remap = joint_remaps[skin_idx]
                    ji = _read_accessor(doc, buffers, attrs["JOINTS_0"]) \
                        .astype(np.int64)[:, :4]
                    wt = _read_accessor(doc, buffers,
                                        attrs["WEIGHTS_0"]).astype(F32)
                    wt = wt[:, :4]
                    wsum = wt.sum(axis=1, keepdims=True)
                    wt = np.where(wsum > 0, wt / np.maximum(wsum, 1e-8),
                                  np.asarray([1, 0, 0, 0], F32))
                    skin_obj = Skin(joints=remap[ji].astype(np.int32),
                                    weights=wt, **proto)
                    wpos, wn = pos, normal
                elif rigid_animation and any(
                        set(channels.get(n, ())) & {"translation",
                                                    "rotation", "scale"}
                        for n in chain):
                    # Animated node chain: evaluate the global transform
                    # on device through a synthesized 1-joint skin
                    # (vertices stay authored-local); the node's track is
                    # built once and shared across its primitives.
                    from softwarerenderer_tpu_torch.models.scene import (
                        Skin as _Skin,
                    )
                    if node_idx not in rigid_tracks:
                        rigid_tracks[node_idx] = _rigid_track(
                            doc, channels, duration, chain)
                    skin_obj = _Skin(
                        joints=np.zeros((v, 4), np.int32),
                        weights=np.tile(np.asarray([1, 0, 0, 0], F32),
                                        (v, 1)),
                        **rigid_tracks[node_idx])
                    wpos, wn = pos, normal
                else:
                    # Bake world transform (ModelLoader.cs:196-200) —
                    # native C++ kernels when built, NumPy otherwise.
                    from softwarerenderer_tpu_torch.native import (bake_normals,
                                                             bake_positions)
                    wpos = bake_positions(pos, global_m)
                    wn = bake_normals(normal, rot_only)

                # Morph targets (blend shapes): per-vertex deltas + the
                # mesh's (possibly animated) weights → ops/morph.py.
                morph_rec = None
                targets = prim.get("targets") or []
                if targets:
                    K = len(targets)
                    dps = np.zeros((K, v, 3), F32)
                    dns = np.zeros((K, v, 3), F32)
                    any_dn = False
                    for k, tg in enumerate(targets):
                        if "POSITION" in tg:
                            dps[k] = _read_accessor(
                                doc, buffers, tg["POSITION"]) \
                                .astype(F32)[:, :3]
                        if "NORMAL" in tg:
                            dns[k] = _read_accessor(
                                doc, buffers, tg["NORMAL"]) \
                                .astype(F32)[:, :3]
                            any_dn = True
                    if skin_obj is None:
                        # baked mesh: deltas rotate/scale with the node
                        # (no translation — they are directions)
                        dps = dps @ global_m[:3, :3]
                        if any_dn:
                            dns = dns @ rot_only[:3, :3]
                    w_dflt = np.asarray(
                        node.get("weights", gmesh.get("weights",
                                                      [0.0] * K)),
                        F32).reshape(-1)[:K]
                    w_dflt = np.pad(w_dflt, (0, K - w_dflt.shape[0]))
                    wch = channels.get(node_idx, {}).get("weights")
                    track, rate = None, 30.0
                    if wch is not None and duration > 0:
                        rate = _chain_rate(channels, duration, (node_idx,))
                        Fw = max(1, int(round(duration * rate)) + 1)
                        grid = np.arange(Fw, dtype=np.float64) / rate
                        times, values, interp = wch
                        per = values.reshape(-1).shape[0] // times.shape[0]
                        track = _resample_channel(
                            times, values.reshape(times.shape[0], per),
                            grid, interp, False)[:, :K]
                        if Fw > 1:     # endpoint-dropped, like TRS tracks
                            track = track[:-1]
                    morph_rec = {"pos": dps,
                                 "nrm": dns if any_dn else None,
                                 "weights": w_dflt,
                                 "weight_track": track, "rate": rate}

                center, radius = bounding_sphere(wpos)
                mesh_rec = {
                    "position": wpos,
                    "uv": uv.astype(F32),
                    "normal": wn,
                    "color": col,
                    "indices": idx.reshape(-1, 3),
                    "material": _extract_material(
                        doc, base_dir, prim.get("material"), src_path),
                    "bounds_center": center,
                    "bounds_radius": radius,
                }
                if skin_obj is not None:
                    mesh_rec["skin"] = skin_obj
                if morph_rec is not None:
                    mesh_rec["morph"] = morph_rec
                meshes.append(mesh_rec)
        for child in node.get("children", []):
            process_node(child, global_m, chain)

    scene_idx = doc.get("scene", 0)
    scenes = doc.get("scenes", [{"nodes": list(range(len(doc.get("nodes",
                                                                 []))))}])
    roots = scenes[scene_idx].get("nodes", [])
    for r in roots:
        process_node(r, np.eye(4, dtype=F32))

    lights: List[Light] = []
    ext = doc.get("extensions", {}).get("KHR_lights_punctual", {})
    for l in ext.get("lights", []):
        kw = dict(
            color=tuple(l.get("color", [1.0, 1.0, 1.0])),
            light_type=_LIGHT_TYPES.get(l.get("type"), LightType.POINT),
            spot_inner=float(l.get("spot", {}).get("innerConeAngle", 0.0)),
            spot_outer=float(l.get("spot", {}).get("outerConeAngle", 0.0)),
        )
        srt = l.get("extras", {}).get("softwarerenderer_tpu")
        if srt:
            # our writer's full-record block (write_gltf): restores the
            # fields KHR cannot carry (AMBIENT type, position/direction/
            # attenuation — Light.cs:19-32 imports them all)
            kw.update(
                position=tuple(srt.get("position", (0.0, 0.0, 0.0))),
                direction=tuple(srt.get("direction", (0.0, -1.0, 0.0))),
                light_type=int(srt.get("light_type", kw["light_type"])),
                attenuation_constant=float(srt.get("attenuation",
                                                   (1, 0, 0))[0]),
                attenuation_linear=float(srt.get("attenuation",
                                                 (1, 0, 0))[1]),
                attenuation_quadratic=float(srt.get("attenuation",
                                                    (1, 0, 0))[2]),
            )
        lights.append(Light(**kw))
    return {"meshes": meshes, "lights": lights}


_LIGHT_NAMES = {v: k for k, v in _LIGHT_TYPES.items()}


def write_gltf(path: str, meshes: List[Dict], lights: List[Light] = (),
               flip_uv: bool = True, embed_textures: bool = False) -> None:
    """Export mesh records (the `load_gltf` "meshes" schema) as .glb or
    .gltf — the framework's native-interchange round trip (the reference
    only ever READS models through Assimp, ModelLoader.cs:137-326; an
    exporter is a beyond-reference capability that completes the asset
    pipeline: load any supported format → bake → save as glTF).

    Each mesh dict needs position/(uv)/(normal)/(color)/indices and
    optionally material (models.scene.Material).  World transforms are
    assumed already baked (exactly what `load_gltf` returns), so every
    mesh becomes a root node with the identity transform and
    `load_gltf(written_path)` round-trips positions/uv/color/indices
    bit-exactly (normals are renormalized on load, so unit normals
    round-trip bit-exactly too).

    Skinned meshes (a "skin" key holding models.scene.Skin) export in
    full: JOINTS_0/WEIGHTS_0, a joint-node hierarchy, inverse bind
    matrices, and the uniform-clock TRS tracks as one shared LINEAR
    animation whose keyframes duplicate frame 0 at t = F/rate — exactly
    the wrapped endpoint `load_gltf`'s resampler drops again, so the
    reloaded Skin plays identically (the loader may permute joint slots
    by depth; compare poses, not arrays).  Caveats: all skins share one
    animation timeline (clips of different durations hold their last
    pose), and track rates below the loader's 30 fps floor are
    re-resampled on load.

    flip_uv=True stores V as 1−v so a loader with the default Assimp
    FlipUVs parity (load_gltf flip_uv=True) reads back the in-memory
    values.  Material texture paths are stored as URIs relative to the
    output file's directory — except embedded-source pseudo-paths
    ("<model>::image<N>", i.e. textures that came in embedded), which
    always re-embed, and everything when embed_textures=True: the decoded
    image is PNG-encoded into the buffer as a bufferView image, making
    the output fully self-contained.  `.glb` → binary container;
    anything else → JSON with an embedded base64 buffer (both load back
    through `load_gltf`).
    """
    out_dir = os.path.dirname(os.path.abspath(path))
    blob = bytearray()
    accessors, views = [], []
    doc_meshes, doc_nodes = [], []
    materials, mat_index = [], {}
    images, textures, img_index = [], [], {}

    def put_view(data: bytes, target: Optional[int] = None) -> int:
        while len(blob) % 4:
            blob.append(0)
        view = {"buffer": 0, "byteOffset": len(blob),
                "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        views.append(view)
        blob.extend(data)
        return len(views) - 1

    def put(arr: np.ndarray, target: Optional[int], acc_type: str,
            with_minmax: bool = False) -> int:
        put_view(np.ascontiguousarray(arr).tobytes(), target)
        comp = {np.dtype(np.float32): 5126,
                np.dtype(np.uint32): 5125,
                np.dtype(np.uint16): 5123}[arr.dtype]
        acc = {"bufferView": len(views) - 1, "componentType": comp,
               "count": int(arr.shape[0]), "type": acc_type}
        if with_minmax:  # required on POSITION by the glTF spec
            acc["min"] = [float(v) for v in arr.min(axis=0)]
            acc["max"] = [float(v) for v in arr.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    def _image_mime(data: bytes) -> Optional[str]:
        if data[:8] == b"\x89PNG\r\n\x1a\n":
            return "image/png"
        if data[:3] == b"\xff\xd8\xff":
            return "image/jpeg"
        return None                 # glTF allows only PNG/JPEG images

    def image_id(tex_path: str) -> int:
        if tex_path not in img_index:
            embed = embed_textures or EMBEDDED_SEP in tex_path
            raw = None
            if embed:
                # Pass the ORIGINAL encoded bytes through when they are
                # already PNG/JPEG — byte-identical, full resolution, no
                # decode (re-encoding via load_image would silently cap
                # at MAX_TEXTURE_SIZE).
                try:
                    if EMBEDDED_SEP in tex_path:
                        mp, i = tex_path.rsplit(EMBEDDED_SEP, 1)
                        raw = _embedded_image_bytes(mp, int(i))
                    else:
                        with open(tex_path, "rb") as f:
                            raw = f.read()
                except (OSError, ValueError, KeyError, GltfError):
                    raw = None
            mime = _image_mime(raw) if raw else None
            if embed and mime is not None:
                images.append({"bufferView": put_view(raw),
                               "mimeType": mime})
            elif embed and (img := load_image(tex_path)) is not None:
                # exotic source format: decode + PNG-encode (this path
                # applies load_image's MAX_TEXTURE_SIZE downscale)
                import io

                from PIL import Image
                buf = io.BytesIO()
                Image.fromarray(np.clip(np.round(img * 255.0), 0, 255)
                                .astype(np.uint8)).save(buf, format="PNG")
                images.append({"bufferView": put_view(buf.getvalue()),
                               "mimeType": "image/png"})
            elif EMBEDDED_SEP in tex_path:
                # embedded source that no longer decodes — no URI to fall
                # back to (the reference logs-and-continues on texture
                # failures, Texture.cs:89-93; an unloadable path would)
                raise GltfError("cannot decode embedded texture: "
                                f"{tex_path}")
            else:
                # missing/undecodable file: keep the URI reference (the
                # loader treats it as texture-load failure, same as now)
                uri = os.path.relpath(os.path.abspath(tex_path), out_dir)
                images.append({"uri": uri.replace(os.sep, "/")})
            textures.append({"source": len(images) - 1})
            img_index[tex_path] = len(textures) - 1
        return img_index[tex_path]

    def material_id(mat: Material) -> int:
        if mat not in mat_index:
            rec = {"pbrMetallicRoughness": {
                       "baseColorFactor": [float(c) for c in mat.base_color],
                       "metallicFactor": float(mat.metallic),
                       "roughnessFactor": float(mat.roughness)},
                   "emissiveFactor": [float(c) for c in mat.emissive[:3]]}
            for slot, key in (("diffuse", "baseColorTexture"),
                              ("emissive", "emissiveTexture")):
                p = mat.texture_path(slot)
                if p is not None:
                    tex = {"index": image_id(p)}
                    if slot == "diffuse":
                        rec["pbrMetallicRoughness"][key] = tex
                    else:
                        rec[key] = tex
            p = mat.texture_path("normals")
            if p is not None:
                rec["normalTexture"] = {"index": image_id(p)}
            materials.append(rec)
            mat_index[mat] = len(materials) - 1
        return mat_index[mat]

    doc_skins, joint_nodes = [], []
    anim_samplers, anim_channels = [], []
    skin_of = {}                       # id(Skin) -> skin index
    n_mesh_nodes = len(meshes)         # joint nodes follow the mesh nodes

    def add_skin(skin) -> int:
        J = int(skin.parent.shape[0])
        F = int(skin.trans.shape[0])
        base = n_mesh_nodes + len(joint_nodes)
        for j in range(J):             # rest pose = frame 0
            joint_nodes.append({
                "translation": [float(x) for x in skin.trans[0, j]],
                "rotation": [float(x) for x in skin.rot[0, j]],
                "scale": [float(x) for x in skin.scale[0, j]]})
        for j, p in enumerate(np.asarray(skin.parent, np.int64)):
            if p >= 0:
                joint_nodes[base - n_mesh_nodes + int(p)] \
                    .setdefault("children", []).append(base + j)
        ibm = put(np.asarray(skin.inverse_bind, F32).reshape(J, 16),
                  None, "MAT4")        # row-vector flat == loader's layout
        doc_skins.append({"joints": list(range(base, base + J)),
                          "inverseBindMatrices": ibm})
        if F > 1:
            # keyframes at k/rate for k = 0..F, the extra endpoint
            # wrapping to frame 0 (the loader drops it again)
            times = (np.arange(F + 1, dtype=np.float64)
                     / float(skin.rate)).astype(F32).reshape(-1, 1)
            t_acc = put(times, None, "SCALAR", with_minmax=True)
            for j in range(J):
                for name, track, acc_type in (
                        ("translation", skin.trans, "VEC3"),
                        ("rotation", skin.rot, "VEC4"),
                        ("scale", skin.scale, "VEC3")):
                    vals = np.concatenate(
                        [track[:, j], track[:1, j]], axis=0).astype(F32)
                    anim_samplers.append({
                        "input": t_acc, "output": put(vals, None, acc_type),
                        "interpolation": "LINEAR"})
                    anim_channels.append({
                        "sampler": len(anim_samplers) - 1,
                        "target": {"node": base + j, "path": name}})
        return len(doc_skins) - 1

    for mesh in meshes:
        pos = np.asarray(mesh["position"], F32).reshape(-1, 3)
        v = pos.shape[0]
        attrs = {"POSITION": put(pos, 34962, "VEC3", with_minmax=True)}
        nrm = np.asarray(mesh.get("normal",
                                  np.zeros((v, 3), F32)), F32)
        if np.any(nrm):
            attrs["NORMAL"] = put(nrm.reshape(-1, 3), 34962, "VEC3")
        uv = np.asarray(mesh.get("uv", np.zeros((v, 2), F32)), F32) \
            .reshape(-1, 2)
        if np.any(uv):
            if flip_uv:
                uv = np.stack([uv[:, 0], F32(1.0) - uv[:, 1]], axis=-1)
            attrs["TEXCOORD_0"] = put(uv, 34962, "VEC2")
        col = np.asarray(mesh.get("color", np.ones((v, 4), F32)), F32)
        if not np.all(col == 1.0):  # all-white is the loader's default
            attrs["COLOR_0"] = put(col.reshape(-1, 4), 34962, "VEC4")
        idx = np.asarray(mesh["indices"], np.uint32).reshape(-1)
        prim = {"attributes": attrs,
                "indices": put(idx, 34963, "SCALAR"), "mode": 4}
        mat = mesh.get("material")
        if mat is not None:
            prim["material"] = material_id(mat)
        mesh_entry = {"primitives": [prim]}
        node = {"mesh": len(doc_meshes)}
        morph = mesh.get("morph")
        if morph is not None:
            dps = np.asarray(morph["pos"], F32)
            K = dps.shape[0]
            dn = morph.get("nrm")
            tgs = []
            for k in range(K):
                tg = {"POSITION": put(dps[k].reshape(-1, 3), 34962,
                                      "VEC3", with_minmax=True)}
                if dn is not None:
                    tg["NORMAL"] = put(np.asarray(dn[k], F32)
                                       .reshape(-1, 3), 34962, "VEC3")
                tgs.append(tg)
            prim["targets"] = tgs
            mesh_entry["weights"] = [
                float(x) for x in np.asarray(
                    morph.get("weights", np.zeros(K)), F32)[:K]]
            wt = morph.get("weight_track")
            if wt is not None:
                wt = np.asarray(wt, F32)
                rate = float(morph.get("rate", 30.0))
                times = (np.arange(wt.shape[0] + 1, dtype=np.float64)
                         / rate).astype(F32).reshape(-1, 1)
                vals = np.concatenate([wt, wt[:1]], axis=0) \
                    .astype(F32).reshape(-1, 1)   # wrapped endpoint
                anim_samplers.append({
                    "input": put(times, None, "SCALAR", with_minmax=True),
                    "output": put(vals, None, "SCALAR"),
                    "interpolation": "LINEAR"})
                anim_channels.append({
                    "sampler": len(anim_samplers) - 1,
                    "target": {"node": len(doc_nodes),
                               "path": "weights"}})
        skin = mesh.get("skin")
        if skin is not None:
            if id(skin) not in skin_of:
                skin_of[id(skin)] = add_skin(skin)
            jts = np.asarray(skin.joints, np.int64).reshape(v, -1)[:, :4]
            if jts.max(initial=0) > np.iinfo(np.uint16).max:
                raise GltfError("joint ids exceed uint16 (glTF JOINTS_0)")
            attrs["JOINTS_0"] = put(jts.astype(np.uint16), 34962, "VEC4")
            attrs["WEIGHTS_0"] = put(
                np.asarray(skin.weights, F32).reshape(v, -1)[:, :4],
                34962, "VEC4")
            node["skin"] = skin_of[id(skin)]
        doc_meshes.append(mesh_entry)
        doc_nodes.append(node)

    all_nodes = doc_nodes + joint_nodes
    # scene roots: every mesh node + every root joint (children stay
    # reachable through their parents, as the glTF spec requires)
    child_ids = {c for n in all_nodes for c in n.get("children", ())}
    roots = [i for i in range(len(all_nodes)) if i not in child_ids]
    doc = {
        "asset": {"version": "2.0",
                  "generator": "softwarerenderer_tpu"},
        "scene": 0,
        "scenes": [{"nodes": roots}],
        "nodes": all_nodes,
        "meshes": doc_meshes,
        "bufferViews": views,
        "accessors": accessors,
    }
    if doc_skins:
        doc["skins"] = doc_skins
    if anim_channels:
        doc["animations"] = [{"channels": anim_channels,
                              "samplers": anim_samplers}]
    if materials:
        doc["materials"] = materials
    if images:
        doc["images"] = images
        doc["textures"] = textures
    if lights:
        doc["extensionsUsed"] = ["KHR_lights_punctual"]
        doc["extensions"] = {"KHR_lights_punctual": {"lights": [
            # KHR carries type/color/spot for foreign loaders (AMBIENT
            # has no KHR equivalent — written as "point"); the extras
            # block round-trips the FULL models.scene.Light record
            # (position/direction/attenuation/ambient) for ours.
            {"type": _LIGHT_NAMES.get(l.light_type, "point"),
             "color": [float(c) for c in l.color[:3]],
             **({"spot": {"innerConeAngle": float(l.spot_inner),
                          "outerConeAngle": float(l.spot_outer)}}
                if l.light_type == LightType.SPOT else {}),
             "extras": {"softwarerenderer_tpu": {
                 "position": [float(x) for x in l.position[:3]],
                 "direction": [float(x) for x in l.direction[:3]],
                 "light_type": int(l.light_type),
                 "attenuation": [float(l.attenuation_constant),
                                 float(l.attenuation_linear),
                                 float(l.attenuation_quadratic)]}}}
            for l in lights]}}

    payload = bytes(blob)
    if path.lower().endswith(".glb"):
        doc["buffers"] = [{"byteLength": len(payload)}]
        js = json.dumps(doc, separators=(",", ":")).encode()
        js += b" " * (-len(js) % 4)
        bn = payload + b"\x00" * (-len(payload) % 4)
        total = 12 + 8 + len(js) + 8 + len(bn)
        with open(path, "wb") as f:
            f.write(struct.pack("<III", 0x46546C67, 2, total))
            f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
            f.write(struct.pack("<II", len(bn), 0x004E4942) + bn)
    else:
        doc["buffers"] = [{
            "byteLength": len(payload),
            "uri": "data:application/octet-stream;base64,"
                   + base64.b64encode(payload).decode()}]
        with open(path, "w") as f:
            json.dump(doc, f, separators=(",", ":"))


def _embedded_image_bytes(model_path: str, img_idx: int) -> bytes:
    """The raw encoded bytes of image `img_idx` embedded in a .gltf/.glb
    (data: URI or bufferView into the binary buffer)."""
    with open(model_path, "rb") as f:
        data = f.read()
    if data[:4] == b"glTF":
        doc, glb_bin = _read_glb(data)
    else:
        doc, glb_bin = json.loads(data), None
    img = doc["images"][img_idx]
    uri = img.get("uri")
    if uri and uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    buffers = _load_buffers(doc, os.path.dirname(model_path), glb_bin)
    view = doc["bufferViews"][img["bufferView"]]
    off = view.get("byteOffset", 0)
    return buffers[view["buffer"]][off: off + view["byteLength"]]


def load_image(path: str) -> Optional[np.ndarray]:
    """Decode an image to (H, W, 4) float32 in [0,1], downscaled to fit
    MAX_TEXTURE_SIZE preserving aspect (Texture.cs:70-94).  Accepts plain
    image files and "<model>::image<N>" pseudo-paths for textures
    embedded in a glTF/GLB (_extract_material).  Returns None on failure
    (the reference logs and continues, Texture.cs:89-93)."""
    try:
        import io

        from PIL import Image
        if EMBEDDED_SEP in path:
            model_path, idx = path.rsplit(EMBEDDED_SEP, 1)
            src = io.BytesIO(_embedded_image_bytes(model_path, int(idx)))
        else:
            src = path
        with Image.open(src) as im:
            im = im.convert("RGBA")
            w, h = im.size
            if w > MAX_TEXTURE_SIZE or h > MAX_TEXTURE_SIZE:
                s = min(MAX_TEXTURE_SIZE / w, MAX_TEXTURE_SIZE / h)
                im = im.resize((max(1, int(w * s)), max(1, int(h * s))))
            return np.asarray(im, dtype=np.uint8).astype(F32) / F32(255.0)
    except Exception:
        return None
