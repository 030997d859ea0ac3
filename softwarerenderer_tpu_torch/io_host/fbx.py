"""First-party binary FBX importer (+ a minimal writer).

The reference reaches FBX through Assimp (ModelLoader.cs:
144-150); this module reads the common binary FBX 7.x subset directly:

  * the node-record container format (7.0-7.4 u32 offsets, ≥7.5 u64),
    typed properties incl. zlib-deflated arrays
  * Objects/Geometry: Vertices, PolygonVertexIndex (negative-terminated
    polygons), LayerElementNormal / LayerElementUV with
    ByPolygonVertex/ByControlPoint mapping and Direct/IndexToDirect
    reference modes
  * Objects/Model: Lcl Translation / Lcl Rotation (XYZ euler degrees) /
    Lcl Scaling from Properties70, composed through the Connections
    ("OO" child→parent) hierarchy
  * Objects/Material: DiffuseColor; texture chains
    (Texture --OP--> Material, Video/RelativeFilename)
  * GlobalSettings UnitScaleFactor (FBX native units are centimeters:
    positions scale by UnitScaleFactor/100 into meters, matching
    Assimp's FbxConverter)

Output matches io_host.gltf.load_gltf ({"meshes": [...], "lights": []});
transforms bake through the same native bake_positions / rotation-only
bake_normals pipeline, so an FBX asset and its glTF twin produce
identical scene buffers.  Corner attributes are expanded per polygon
vertex (no dedup — the same choice as the STL path).

The writer (`write_fbx`) emits a minimal well-formed binary FBX 7.4
document (geometry + transform + material color) — enough for fixtures
and interchange smoke tests with this importer and Assimp-based tools.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from softwarerenderer_tpu_torch.models.scene import Material, bounding_sphere

F32 = np.float32

_MAGIC = b"Kaydara FBX Binary  \x00\x1a\x00"

_ARRAY_TYPES = {
    b"f": ("<f4", 4), b"d": ("<f8", 8), b"l": ("<i8", 8),
    b"i": ("<i4", 4), b"b": ("<i1", 1),
}
_SCALAR_FMT = {b"Y": "<h", b"C": "<b", b"I": "<i", b"F": "<f",
               b"D": "<d", b"L": "<q"}


class FbxNode:
    __slots__ = ("name", "props", "children")

    def __init__(self, name: str, props, children):
        self.name = name
        self.props = props
        self.children = children

    def find(self, name: str) -> Optional["FbxNode"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def find_all(self, name: str) -> List["FbxNode"]:
        return [c for c in self.children if c.name == name]


def _read_props(data: bytes, off: int, count: int):
    props = []
    for _ in range(count):
        t = data[off:off + 1]
        off += 1
        if t in _SCALAR_FMT:
            fmt = _SCALAR_FMT[t]
            size = struct.calcsize(fmt)
            props.append(struct.unpack_from(fmt, data, off)[0])
            off += size
        elif t in _ARRAY_TYPES:
            dt, _ = _ARRAY_TYPES[t]
            n, enc, clen = struct.unpack_from("<III", data, off)
            off += 12
            if enc == 1:
                raw = zlib.decompress(data[off:off + clen])
                off += clen
            else:
                raw = data[off:off + clen]
                off += clen
            props.append(np.frombuffer(raw, dt, n))
        elif t == b"S" or t == b"R":
            n = struct.unpack_from("<I", data, off)[0]
            off += 4
            raw = data[off:off + n]
            off += n
            props.append(raw.decode("utf-8", "replace") if t == b"S"
                         else raw)
        else:
            raise ValueError(f"FBX: unknown property type {t!r}")
    return props, off


def parse_fbx(data: bytes) -> Tuple[FbxNode, int]:
    """Parse the binary container into a root FbxNode; returns
    (root, version)."""
    if not data.startswith(_MAGIC[:21]):
        raise ValueError("not a binary FBX file")
    version = struct.unpack_from("<I", data, 23)[0]
    long_offsets = version >= 7500
    off = 27
    roots = []

    def read2(off):
        if long_offsets:
            end, n_props, _plen = struct.unpack_from("<QQQ", data, off)
            hdr = 24
        else:
            end, n_props, _plen = struct.unpack_from("<III", data, off)
            hdr = 12
        p = off + hdr
        name_len = data[p]
        p += 1
        if end == 0 and n_props == 0 and name_len == 0:
            return None, p
        name = data[p:p + name_len].decode("utf-8", "replace")
        p += name_len
        props, p = _read_props(data, p, n_props)
        children = []
        while p < end:
            child, p = read2(p)
            if child is None:
                break
            children.append(child)
        return FbxNode(name, props, children), end

    while off < len(data):
        node, off = read2(off)
        if node is None:
            break
        roots.append(node)
    return FbxNode("", [], roots), version


def _props70(node: FbxNode) -> Dict[str, tuple]:
    out = {}
    p70 = node.find("Properties70")
    if p70 is None:
        return out
    for p in p70.find_all("P"):
        if p.props:
            out[p.props[0]] = tuple(p.props[4:])
    return out


# FBX time unit: 1 second = 46,186,158,000 "ktime" ticks.
FBX_TICKS_PER_SECOND = 46186158000.0


def _anim_channels(by_id: Dict[int, FbxNode],
                   op_links: Dict[int, List[tuple]]) -> Dict[int, Dict]:
    """Per-Model animation curves: model id → {"Lcl Translation" /
    "Lcl Rotation" / "Lcl Scaling": {axis 0-2: (times_s, values)}}.

    The FBX animation graph is AnimationCurve --OP("d|X")-->
    AnimationCurveNode --OP("Lcl …")--> Model (Assimp walks the same
    chains for the reference, ModelLoader.cs:144-150); times are ktime
    ticks (FBX_TICKS_PER_SECOND per second)."""
    out: Dict[int, Dict] = {}
    axis_of = {"d|X": 0, "d|Y": 1, "d|Z": 2}
    for mid, node in by_id.items():
        if node.name != "Model":
            continue
        for cnid, prop in op_links.get(mid, []):
            cn = by_id.get(cnid)
            if cn is None or cn.name != "AnimationCurveNode" \
                    or prop not in ("Lcl Translation", "Lcl Rotation",
                                    "Lcl Scaling"):
                continue
            axes = out.setdefault(mid, {}).setdefault(prop, {})
            for cid, axprop in op_links.get(cnid, []):
                c = by_id.get(cid)
                ax = axis_of.get(axprop)
                if c is None or c.name != "AnimationCurve" or ax is None:
                    continue
                kt = c.find("KeyTime")
                kv = c.find("KeyValueFloat")
                if kt is None or kv is None or not kt.props \
                        or not kv.props:
                    continue
                t = np.asarray(kt.props[0],
                               np.float64) / FBX_TICKS_PER_SECOND
                v = np.asarray(kv.props[0], np.float64)
                n = min(t.shape[0], v.shape[0])
                if n:
                    axes[ax] = (t[:n], v[:n])
    return out


def _sample_axes(axes: Dict[int, tuple], defaults,
                 grid: np.ndarray) -> np.ndarray:
    """(F, 3) per-axis linear resample on `grid` seconds; missing axes
    hold their Lcl default (FBX per-axis curves keyframe independently)."""
    out = np.tile(np.asarray(defaults, np.float64)[None], (grid.shape[0], 1))
    for ax, (t, v) in axes.items():
        if t.shape[0] == 1:
            out[:, ax] = v[0]
        else:
            out[:, ax] = np.interp(grid, t, v)
    return out


def _euler_xyz_row(rx, ry, rz) -> np.ndarray:
    """FBX Lcl Rotation (XYZ order, degrees) → row-vector rotation:
    v' = v @ Rx @ Ry @ Rz (X applied first)."""
    def rot(axis, deg):
        a = np.deg2rad(deg)
        c, s = np.cos(a), np.sin(a)
        m = np.eye(4)
        i, j = {"x": (1, 2), "y": (2, 0), "z": (0, 1)}[axis]
        # standard column-vector axis rotation (+θ right-handed),
        # transposed to row-vector form
        m[i, i] = c; m[j, j] = c
        m[i, j] = -s; m[j, i] = s
        return m.T
    return rot("x", rx) @ rot("y", ry) @ rot("z", rz)


def _model_local_row(model: FbxNode) -> np.ndarray:
    p = _props70(model)
    t = p.get("Lcl Translation", (0.0, 0.0, 0.0))[-3:]
    r = p.get("Lcl Rotation", (0.0, 0.0, 0.0))[-3:]
    s = p.get("Lcl Scaling", (1.0, 1.0, 1.0))[-3:]
    sm = np.diag([s[0], s[1], s[2], 1.0])
    rm = _euler_xyz_row(*r)
    pre = p.get("PreRotation")
    if pre:
        # column-vector chain T·Rpre·R·S → row-vector S·R·Rpre·T
        rm = rm @ _euler_xyz_row(*pre[-3:])
    tm = np.eye(4)
    tm[3, :3] = t
    return sm @ rm @ tm                        # row-vector S·R·T


def _model_track(model: FbxNode, channels: Dict, grid: np.ndarray):
    """One Model's uniform-clock local TRS track: trans (F, 3), quat
    (F, 4) xyzw, scale (F, 3) — animated axes resampled on `grid`,
    static axes from the Lcl properties, PreRotation composed like
    _model_local_row.  Quats come from the per-frame euler matrix via
    gltf's rotation decomposition, sign-aligned frame to frame so the
    on-device slerp-free lerp (ops/skinning.sample_tracks) never crosses
    the double-cover seam."""
    from softwarerenderer_tpu_torch.io_host.gltf import _quat_from_rot_rows

    p = _props70(model)
    t0 = p.get("Lcl Translation", (0.0, 0.0, 0.0))[-3:]
    r0 = p.get("Lcl Rotation", (0.0, 0.0, 0.0))[-3:]
    s0 = p.get("Lcl Scaling", (1.0, 1.0, 1.0))[-3:]
    pre = p.get("PreRotation")
    pre_rm = _euler_xyz_row(*pre[-3:]) if pre else None

    ch = channels or {}
    trans = _sample_axes(ch.get("Lcl Translation", {}), t0, grid)
    eul = _sample_axes(ch.get("Lcl Rotation", {}), r0, grid)
    scl = _sample_axes(ch.get("Lcl Scaling", {}), s0, grid)

    F = grid.shape[0]
    rot = np.zeros((F, 4), F32)
    for f in range(F):
        rm = _euler_xyz_row(*eul[f])
        if pre_rm is not None:
            rm = rm @ pre_rm
        q = _quat_from_rot_rows(rm[:3, :3])
        if f and np.dot(q, rot[f - 1]) < 0:
            q = -q
        rot[f] = q
    return trans.astype(F32), rot, scl.astype(F32)


def _collect_fbx_skins(by_id: Dict[int, FbxNode],
                       parents: Dict[int, List[int]],
                       children_map: Dict[int, List[int]],
                       channels_all: Dict[int, Dict],
                       scale: float):
    """Per-Geometry skinning data from Deformer Skin/Cluster chains.

    Returns geometry id → dict with per-CONTROL-POINT "joints" (P, 4) /
    "weights" (P, 4) and the models.scene.Skin skeleton kwargs.  FBX
    semantics (matching the FBX SDK's ComputeClusterDeformation, which
    Assimp reproduces for the reference): per cluster,
    TransformLink = the bone's global bind transform and Transform = the
    MESH's global bind transform, so in the row-vector convention
    inverse_bind_j = Transform @ TransformLink⁻¹ and
    skinned(v, t) = v_mesh_local @ inverse_bind_j @ bone_world(t).
    The skeleton = every cluster-linked bone Model plus its Model
    ancestors (topologically ordered; ancestors carry transforms only —
    no vertex weights point at them).  The document's unit scale folds
    into ROOT joint locals (uniform scale commutes with rotations), so
    skinned output lands in meters like the static bake."""
    out: Dict[int, Dict] = {}
    for gid, geom in by_id.items():
        if geom.name != "Geometry":
            continue
        skin_ids = [c for c in children_map.get(gid, [])
                    if by_id[c].name == "Deformer"
                    and len(by_id[c].props) >= 3
                    and "Skin" in str(by_id[c].props[2])]
        clusters = []
        for sid in skin_ids:
            for cid in children_map.get(sid, []):
                cn = by_id[cid]
                if cn.name == "Deformer" and len(cn.props) >= 3 \
                        and "Cluster" in str(cn.props[2]):
                    clusters.append(cid)
        if not clusters:
            continue

        # cluster → bone model + per-control-point weights + bind mats
        cl_data = []
        bone_set = []
        for cid in clusters:
            cn = by_id[cid]
            bones = [b for b in children_map.get(cid, [])
                     if by_id[b].name == "Model"]
            idx_n = cn.find("Indexes")
            wt_n = cn.find("Weights")
            tr_n = cn.find("Transform")
            tl_n = cn.find("TransformLink")
            if not bones or idx_n is None or wt_n is None \
                    or not idx_n.props or not wt_n.props \
                    or tl_n is None or not tl_n.props:
                continue
            bone = bones[0]
            tl = np.asarray(tl_n.props[0], np.float64).reshape(4, 4)
            tr = (np.asarray(tr_n.props[0], np.float64).reshape(4, 4)
                  if tr_n is not None and tr_n.props else np.eye(4))
            cl_data.append((bone,
                            np.asarray(idx_n.props[0], np.int64),
                            np.asarray(wt_n.props[0], np.float64),
                            tr, tl))
            if bone not in bone_set:
                bone_set.append(bone)
        if not cl_data:
            continue

        # Skeleton: bones + their Model ancestors, topo-ordered by depth.
        def model_parent(mid):
            for pid in parents.get(mid, []):
                pn = by_id.get(pid)
                if pn is not None and pn.name == "Model":
                    return pid
            return None

        joint_ids = list(bone_set)
        i = 0
        while i < len(joint_ids):
            p = model_parent(joint_ids[i])
            if p is not None and p not in joint_ids:
                joint_ids.append(p)
            i += 1

        def depth(mid):
            d, p = 0, model_parent(mid)
            while p is not None:
                d, p = d + 1, model_parent(p)
            return d

        joint_ids.sort(key=depth)
        slot = {mid: i for i, mid in enumerate(joint_ids)}
        J = len(joint_ids)
        parent_arr = np.full(J, -1, np.int32)
        for i, mid in enumerate(joint_ids):
            p = model_parent(mid)
            if p is not None:
                parent_arr[i] = slot[p]

        # Uniform clock over every joint's curves (gltf._chain_rate rule).
        duration = 0.0
        densest = 30.0
        for mid in joint_ids:
            for axes in channels_all.get(mid, {}).values():
                for t, _v in axes.values():
                    if t.size:
                        duration = max(duration, float(t[-1]))
        for mid in joint_ids:
            for axes in channels_all.get(mid, {}).values():
                for t, _v in axes.values():
                    if t.size > 1 and duration > 0:
                        densest = max(densest, (t.size - 1) / duration)
        rate = float(np.clip(densest, 1.0, 120.0))
        F = max(1, int(round(duration * rate)) + 1) if duration > 0 else 1
        grid = np.arange(F, dtype=np.float64) / rate

        trans = np.zeros((F, J, 3), F32)
        rot = np.zeros((F, J, 4), F32)
        scl = np.ones((F, J, 3), F32)
        for i, mid in enumerate(joint_ids):
            trans[:, i], rot[:, i], scl[:, i] = _model_track(
                by_id[mid], channels_all.get(mid), grid)
        # Fold the document unit scale into ROOT joint locals (uniform
        # scale commutes with the rotations above it in the chain).
        if scale != 1.0:
            for i in range(J):
                if parent_arr[i] == -1:
                    trans[:, i] *= scale
                    scl[:, i] *= scale
        if F > 1:    # drop the duplicated loop endpoint (gltf rule)
            trans, rot, scl = trans[:-1], rot[:-1], scl[:-1]

        inv_bind = np.broadcast_to(np.eye(4, dtype=F32), (J, 4, 4)).copy()
        n_pts = 0
        for bone, idxs, _w, _tr, _tl in cl_data:
            if idxs.size:
                n_pts = max(n_pts, int(idxs.max()) + 1)
        acc: List[List[tuple]] = [[] for _ in range(n_pts)]
        for bone, idxs, wts, tr, tl in cl_data:
            j = slot[bone]
            try:
                tl_inv = np.linalg.inv(tl)
            except np.linalg.LinAlgError:
                tl_inv = np.eye(4)
            inv_bind[j] = (tr @ tl_inv).astype(F32)
            for vi, w in zip(idxs, wts):
                if 0 <= vi < n_pts and w != 0.0:
                    acc[vi].append((float(w), j))
        joints_pp = np.zeros((n_pts, 4), np.int32)
        weights_pp = np.zeros((n_pts, 4), F32)
        for vi, lst in enumerate(acc):
            lst.sort(reverse=True)           # top-4 by weight
            total = sum(w for w, _ in lst[:4])
            for k, (w, j) in enumerate(lst[:4]):
                joints_pp[vi, k] = j
                weights_pp[vi, k] = w / total if total > 0 else 0.0
            if total <= 0:
                weights_pp[vi, 0] = 1.0
        out[gid] = dict(joints=joints_pp, weights=weights_pp,
                        parent=parent_arr, inverse_bind=inv_bind,
                        trans=trans, rot=rot, scale=scl, rate=rate)
    return out


def _layer_values(geom: FbxNode, layer_name: str, value_name: str,
                  index_name: str, pv_index: np.ndarray,
                  n_corners: int, width: int) -> Optional[np.ndarray]:
    """Per-corner attribute from a LayerElement (mapping + reference)."""
    layer = geom.find(layer_name)
    if layer is None:
        return None
    vals_node = layer.find(value_name)
    if vals_node is None or not vals_node.props:
        return None
    vals = np.asarray(vals_node.props[0], np.float64).reshape(-1, width)
    mapping = "ByPolygonVertex"
    ref = "Direct"
    m = layer.find("MappingInformationType")
    if m is not None and m.props:
        mapping = m.props[0]
    r = layer.find("ReferenceInformationType")
    if r is not None and r.props:
        ref = r.props[0]
    idx_node = layer.find(index_name)
    if ref == "IndexToDirect" and idx_node is not None and idx_node.props:
        idx = np.asarray(idx_node.props[0], np.int64)
        # -1 entries mean "no value" (e.g. unmapped polygon corners in a
        # partially UV-mapped mesh): zero them rather than aliasing
        # element 0
        vals = vals[np.clip(idx, 0, vals.shape[0] - 1)]
        vals = np.where((idx >= 0)[:, None], vals, 0.0)
    if mapping == "ByPolygonVertex":
        return vals[:n_corners]
    if mapping in ("ByVertex", "ByVertice", "ByControlPoint"):
        return vals[pv_index]
    if mapping == "AllSame":
        return np.broadcast_to(vals[:1], (n_corners, width))
    return None


def load_fbx(path: str, flip_uv: bool = False) -> Dict:
    """Parse a binary .fbx file into {"meshes": [...], "lights": []}.

    UV origin: FBX authors V bottom-left — already this repo's in-memory
    convention (see io_host.collada.load_dae) — so no flip by default."""
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "rb") as f:
        data = f.read()
    root, _version = parse_fbx(data)

    objects = root.find("Objects")
    conns = root.find("Connections")
    if objects is None:
        return {"meshes": [], "lights": []}

    # unit scale: FBX native cm → meters
    scale = 1.0
    gs = root.find("GlobalSettings")
    if gs is not None:
        usf = _props70(gs).get("UnitScaleFactor")
        if usf:
            scale = float(usf[-1]) / 100.0

    by_id: Dict[int, FbxNode] = {}
    for obj in objects.children:
        if obj.props and isinstance(obj.props[0], int):
            by_id[obj.props[0]] = obj

    parents: Dict[int, List[int]] = {}         # child id → parent ids
    op_links: Dict[int, List[tuple]] = {}      # (child, prop) OP links
    if conns is not None:
        for c in conns.find_all("C"):
            if len(c.props) >= 3 and c.props[0] == "OO":
                parents.setdefault(c.props[1], []).append(c.props[2])
            elif len(c.props) >= 4 and c.props[0] == "OP":
                op_links.setdefault(c.props[2], []).append(
                    (c.props[1], c.props[3]))
    children_map: Dict[int, List[int]] = {}    # parent id → child ids
    for _cid, _plist in parents.items():
        for _pid in _plist:
            children_map.setdefault(_pid, []).append(_cid)

    channels_all = _anim_channels(by_id, op_links)
    skins = _collect_fbx_skins(by_id, parents, children_map, channels_all,
                               scale)

    def model_world_row(mid: int, depth=0) -> np.ndarray:
        node = by_id.get(mid)
        if node is None or node.name != "Model" or depth > 64:
            return np.eye(4)
        local = _model_local_row(node)
        for pid in parents.get(mid, []):
            if pid == 0:
                return local
            p = by_id.get(pid)
            if p is not None and p.name == "Model":
                return local @ model_world_row(pid, depth + 1)
        return local

    # model id → Material, built ONCE (a per-geometry object scan would
    # make import O(#geometries × #objects))
    mat_of_model: Dict[int, Material] = {}
    for cid, node in by_id.items():
        if node.name != "Material":
            continue
        p = _props70(node)
        dc = p.get("DiffuseColor", (1.0, 1.0, 1.0))[-3:]
        tex_path = None
        for tid, _prop in op_links.get(cid, []):
            tnode = by_id.get(tid)
            if tnode is not None and tnode.name == "Texture":
                fn = tnode.find("RelativeFilename") \
                    or tnode.find("FileName")
                if fn is not None and fn.props:
                    tex_path = os.path.normpath(os.path.join(
                        base_dir, str(fn.props[0]).replace("\\", "/")))
        mat = Material(
            base_color=(float(dc[0]), float(dc[1]), float(dc[2]), 1.0),
            texture_paths=(("diffuse", tex_path),) if tex_path else ())
        for mid in parents.get(cid, []):
            mat_of_model.setdefault(mid, mat)

    from softwarerenderer_tpu_torch.native import bake_normals, bake_positions

    meshes: List[Dict] = []
    for gid, geom in by_id.items():
        if geom.name != "Geometry":
            continue
        v_node = geom.find("Vertices")
        i_node = geom.find("PolygonVertexIndex")
        if v_node is None or i_node is None or not v_node.props:
            continue
        verts = np.asarray(v_node.props[0], np.float64).reshape(-1, 3)
        pvi = np.asarray(i_node.props[0], np.int64)

        # negative-terminated polygons → fan triangulation over CORNER
        # positions (preserving per-corner layer order)
        corner_vert = np.where(pvi < 0, ~pvi, pvi)
        poly_ends = np.nonzero(pvi < 0)[0]
        tri_corners = []
        start = 0
        for e in poly_ends:
            for i in range(start + 1, e):
                tri_corners.extend((start, i, i + 1))
            start = e + 1
        tri_corners = np.asarray(tri_corners, np.int64)
        n_corners = corner_vert.shape[0]

        nrm = _layer_values(geom, "LayerElementNormal", "Normals",
                            "NormalsIndex", corner_vert, n_corners, 3)
        uv = _layer_values(geom, "LayerElementUV", "UV", "UVIndex",
                           corner_vert, n_corners, 2)
        if nrm is None:
            nrm = np.zeros((n_corners, 3))
        if uv is None:
            uv = np.zeros((n_corners, 2))

        # world transform from the owning Model (first OO parent chain)
        world = np.eye(4)
        mat = Material()
        owner_mid = None
        for pid in parents.get(gid, []):
            p = by_id.get(pid)
            if p is not None and p.name == "Model":
                owner_mid = pid
                world = model_world_row(pid)
                mat = mat_of_model.get(pid, Material())
                break
        world = world @ np.diag([scale, scale, scale, 1.0])
        rot_only = world.copy()
        rot_only[3, :] = [0, 0, 0, 1]
        rot_only[:, 3] = [0, 0, 0, 1]

        cpos = verts[corner_vert][tri_corners]
        cnrm = np.asarray(nrm, np.float64)[tri_corners]
        cuv = np.asarray(uv, np.float64)[tri_corners][:, :2]
        if flip_uv:
            cuv = cuv.copy()
            cuv[:, 1] = 1.0 - cuv[:, 1]

        skin_data = skins.get(gid)
        rigid = None
        if skin_data is None and owner_mid is not None:
            rigid = _fbx_rigid_track(owner_mid, by_id, parents,
                                     channels_all, scale)
        if skin_data is not None or rigid is not None:
            # Skinned / rigid-animated geometry: vertices stay MESH-LOCAL
            # (the joint transforms carry placement; the document unit
            # scale is folded into root joint locals) — the same
            # convention as the glTF loader's skinning path, so an FBX
            # rig and its glTF twin produce identical packed scenes.
            wpos = cpos.astype(F32)
            nlen = np.linalg.norm(cnrm, axis=-1, keepdims=True)
            wn = (cnrm / np.where(nlen == 0, 1.0, nlen)).astype(F32)
        else:
            wpos = bake_positions(cpos.astype(F32), world.astype(F32))
            wn = bake_normals(cnrm.astype(F32), rot_only.astype(F32))
        idx = np.arange(tri_corners.shape[0],
                        dtype=np.int32).reshape(-1, 3)
        center, radius = bounding_sphere(wpos)
        mesh_dict = {
            "position": wpos,
            "uv": cuv.astype(F32),
            "normal": wn,
            "color": np.ones((wpos.shape[0], 4), F32),
            "indices": idx,
            "material": mat,
            "bounds_center": center,
            "bounds_radius": radius,
        }
        if skin_data is not None:
            from softwarerenderer_tpu_torch.models.scene import Skin
            jp = skin_data["joints"]
            wp = skin_data["weights"]
            if jp.shape[0] < verts.shape[0]:
                pad = verts.shape[0] - jp.shape[0]
                jp = np.pad(jp, ((0, pad), (0, 0)))
                wp = np.pad(wp, ((0, pad), (0, 0)))
                wp[-pad:, 0] = 1.0        # unweighted → joint 0 (glTF rule)
            mesh_dict["skin"] = Skin(
                joints=jp[corner_vert][tri_corners].astype(np.int32),
                weights=wp[corner_vert][tri_corners].astype(F32),
                parent=skin_data["parent"],
                inverse_bind=skin_data["inverse_bind"],
                trans=skin_data["trans"], rot=skin_data["rot"],
                scale=skin_data["scale"], rate=skin_data["rate"])
        elif rigid is not None:
            from softwarerenderer_tpu_torch.models.scene import Skin
            n_corner = wpos.shape[0]
            mesh_dict["skin"] = Skin(
                joints=np.zeros((n_corner, 4), np.int32),
                weights=np.tile(np.asarray([1, 0, 0, 0], F32),
                                (n_corner, 1)),
                **rigid)
        meshes.append(mesh_dict)
    return {"meshes": meshes, "lights": []}


def _fbx_rigid_track(owner_mid: int, by_id: Dict[int, FbxNode],
                     parents: Dict[int, List[int]],
                     channels_all: Dict[int, Dict], scale: float):
    """1-joint Skin kwargs evaluating a NON-skinned mesh's ANIMATED
    global transform on device (the FBX analog of gltf._rigid_track —
    rigid-body node animation; Assimp exposes the same curves).  Returns
    None when nothing on the owner's Model chain is animated."""
    chain = []
    mid = owner_mid
    while mid is not None and by_id.get(mid) is not None \
            and by_id[mid].name == "Model" and len(chain) < 64:
        chain.append(mid)
        nxt = None
        for pid in parents.get(mid, []):
            p = by_id.get(pid)
            if p is not None and p.name == "Model":
                nxt = pid
                break
        mid = nxt
    if not any(channels_all.get(m) for m in chain):
        return None
    from softwarerenderer_tpu_torch.io_host.gltf import _decompose_trs_row
    from softwarerenderer_tpu_torch.io_host.hostops import compose_trs

    duration = 0.0
    densest = 30.0
    for m in chain:
        for axes in channels_all.get(m, {}).values():
            for t, _v in axes.values():
                if t.size:
                    duration = max(duration, float(t[-1]))
    for m in chain:
        for axes in channels_all.get(m, {}).values():
            for t, _v in axes.values():
                if t.size > 1 and duration > 0:
                    densest = max(densest, (t.size - 1) / duration)
    rate = float(np.clip(densest, 1.0, 120.0))
    F = max(1, int(round(duration * rate)) + 1) if duration > 0 else 1
    grid = np.arange(F, dtype=np.float64) / rate

    tracks = [_model_track(by_id[m], channels_all.get(m), grid)
              for m in chain]
    trans = np.zeros((F, 1, 3), F32)
    rot = np.zeros((F, 1, 4), F32)
    scl = np.ones((F, 1, 3), F32)
    unit = np.diag([scale, scale, scale, 1.0]).astype(F32)
    for f in range(F):
        m = np.eye(4, dtype=F32)
        for (t, q, s) in tracks:     # node-to-root: left-compose locals
            m = m @ compose_trs(t[f], q[f], s[f], xp=np)
        m = m @ unit
        trans[f, 0], rot[f, 0], scl[f, 0] = _decompose_trs_row(m)
    if F > 1:                        # drop the duplicated loop endpoint
        trans, rot, scl = trans[:-1], rot[:-1], scl[:-1]
    return dict(parent=np.asarray([-1], np.int32),
                inverse_bind=np.eye(4, dtype=F32)[None],
                trans=trans, rot=rot, scale=scl, rate=rate)


# ---------------------------------------------------------------------------
# Minimal binary FBX writer (fixtures + interchange smoke tests)
# ---------------------------------------------------------------------------

def _w_props(props) -> bytes:
    out = b""
    for p in props:
        if isinstance(p, bool):
            out += b"C" + struct.pack("<b", 1 if p else 0)
        elif isinstance(p, int):
            out += b"L" + struct.pack("<q", p)
        elif isinstance(p, float):
            out += b"D" + struct.pack("<d", p)
        elif isinstance(p, str):
            raw = p.encode()
            out += b"S" + struct.pack("<I", len(raw)) + raw
        elif isinstance(p, np.ndarray):
            if p.dtype == np.float64:
                t, dt = b"d", "<f8"
            elif p.dtype == np.float32:
                t, dt = b"f", "<f4"
            elif p.dtype == np.int32:
                t, dt = b"i", "<i4"
            elif p.dtype == np.int64:
                t, dt = b"l", "<i8"
            else:
                raise ValueError(f"unsupported array dtype {p.dtype}")
            raw = np.ascontiguousarray(p.reshape(-1), dt).tobytes()
            out += t + struct.pack("<III", p.size, 0, len(raw)) + raw
        else:
            raise ValueError(f"unsupported property {type(p)}")
    return out


def _w_node(name: str, props=(), children=(), base=0) -> bytes:
    pbytes = _w_props(props)
    body = name.encode()
    inner = b""
    cursor = base + 13 + len(body) + len(pbytes)
    for c in children:
        cb = _w_node(*c, base=cursor)
        inner += cb
        cursor += len(cb)
    if children:
        inner += b"\x00" * 13                  # null terminator record
        cursor += 13
    end = cursor
    return (struct.pack("<III", end, len(props), len(pbytes))
            + bytes([len(body)]) + body + pbytes + inner)


def _euler_xyz_deg_row(m: np.ndarray) -> np.ndarray:
    """(rx, ry, rz) degrees such that _euler_xyz_row(rx, ry, rz) equals
    the given row-vector rotation (3×3 or 4×4); ±90° pitch falls back to
    the standard rz=0 branch."""
    import math
    sy = -float(m[0, 2])
    if abs(sy) < 0.999999:
        ry = math.asin(sy)
        rx = math.atan2(float(m[1, 2]), float(m[2, 2]))
        rz = math.atan2(float(m[0, 1]), float(m[0, 0]))
    else:
        ry = math.copysign(math.pi / 2, sy)
        rx = math.atan2(-float(m[2, 1]), float(m[1, 1]))
        rz = 0.0
    return np.degrees(np.asarray([rx, ry, rz], np.float64))


def _skin_objects(skin, mesh_world: np.ndarray, geo_id: int):
    """FBX object + connection tuples for a models.scene.Skin whose
    joints/weights index the writer's CONTROL POINTS: LimbNode bone
    Models (bind pose = frame-0 locals), a Skin Deformer with per-joint
    Clusters (Transform = mesh bind world, TransformLink =
    inverse_bind⁻¹ @ mesh world — inverting this module's loader rule,
    so the pair round-trips), and — when the tracks animate — an
    AnimationStack/Layer with per-joint T/R/S CurveNodes whose per-axis
    curves carry the uniform clock with the loop CLOSED (key F = key 0:
    the loader's endpoint-drop then reconstructs exactly F frames)."""
    from softwarerenderer_tpu_torch.io_host.hostops import compose_trs
    from softwarerenderer_tpu_torch.utils import hostmath as ml

    J = skin.parent.shape[0]
    F = skin.trans.shape[0]
    rate = float(skin.rate)
    BONE0, CL0, SKIN_ID = 5000001, 5100001, 5200001
    STACK, LAYER, CN0, CV0 = 5300001, 5300002, 5400001, 5500001

    objs: List[tuple] = []
    conns: List[tuple] = []

    # Bind-pose bone worlds (row-vector; topo order ⇒ parents first).
    local0 = [compose_trs(skin.trans[0, j], skin.rot[0, j],
                          skin.scale[0, j], xp=np) for j in range(J)]
    world = [None] * J
    for j in range(J):
        p = int(skin.parent[j])
        world[j] = local0[j] if p < 0 else local0[j] @ world[p]

    for j in range(J):
        rm = ml.matrix_from_quaternion(np.asarray(skin.rot[0, j]), xp=np)
        eul = _euler_xyz_deg_row(rm)
        t = np.asarray(skin.trans[0, j], np.float64)
        s = np.asarray(skin.scale[0, j], np.float64)
        objs.append(("Model", (BONE0 + j, f"Model::bone{j}", "LimbNode"), (
            ("Version", (232,), ()),
            ("Properties70", (), (
                ("P", ("Lcl Translation", "Lcl Translation", "", "A",
                       float(t[0]), float(t[1]), float(t[2])), ()),
                ("P", ("Lcl Rotation", "Lcl Rotation", "", "A",
                       float(eul[0]), float(eul[1]), float(eul[2])), ()),
                ("P", ("Lcl Scaling", "Lcl Scaling", "", "A",
                       float(s[0]), float(s[1]), float(s[2])), ()),
            )),
        )))
        p = int(skin.parent[j])
        conns.append(("C", ("OO", BONE0 + j,
                            0 if p < 0 else BONE0 + p), ()))

    objs.append(("Deformer", (SKIN_ID, "Deformer::skin", "Skin"),
                 (("Version", (101,), ()),)))
    conns.append(("C", ("OO", SKIN_ID, geo_id), ()))

    joints = np.asarray(skin.joints, np.int64)
    weights = np.asarray(skin.weights, np.float64)
    for j in range(J):
        sel = np.nonzero((joints == j) & (weights > 0))
        idxs = sel[0].astype(np.int32)
        wts = weights[sel]
        tl = np.linalg.inv(
            np.asarray(skin.inverse_bind[j], np.float64)) @ mesh_world
        objs.append(("Deformer",
                     (CL0 + j, f"SubDeformer::cl{j}", "Cluster"), (
                         ("Version", (100,), ()),
                         ("Indexes", (idxs,), ()),
                         ("Weights", (wts.astype(np.float64),), ()),
                         ("Transform",
                          (np.asarray(mesh_world,
                                      np.float64).reshape(-1),), ()),
                         ("TransformLink",
                          (tl.reshape(-1),), ()),
                     )))
        conns.append(("C", ("OO", CL0 + j, SKIN_ID), ()))
        conns.append(("C", ("OO", BONE0 + j, CL0 + j), ()))

    if F > 1:
        objs.append(("AnimationStack", (STACK, "AnimStack::take", ""), ()))
        objs.append(("AnimationLayer", (LAYER, "AnimLayer::base", ""), ()))
        conns.append(("C", ("OO", LAYER, STACK), ()))
        # Closed-loop key grid: F+1 keys, the last repeating key 0.
        ticks = np.round(np.arange(F + 1, dtype=np.float64) / rate
                         * FBX_TICKS_PER_SECOND).astype(np.int64)
        cn = CN0
        cv = CV0
        for j in range(J):
            eul = np.empty((F, 3), np.float64)
            for f in range(F):
                eul[f] = _euler_xyz_deg_row(ml.matrix_from_quaternion(
                    np.asarray(skin.rot[f, j]), xp=np))
            for prop, vals in (("Lcl Translation",
                                np.asarray(skin.trans[:, j], np.float64)),
                               ("Lcl Rotation", eul),
                               ("Lcl Scaling",
                                np.asarray(skin.scale[:, j], np.float64))):
                objs.append(("AnimationCurveNode",
                             (cn, "AnimCurveNode::", ""), ()))
                conns.append(("C", ("OP", cn, BONE0 + j, prop), ()))
                conns.append(("C", ("OO", cn, LAYER), ()))
                for ax, axname in enumerate(("d|X", "d|Y", "d|Z")):
                    closed = np.concatenate([vals[:, ax],
                                             vals[:1, ax]])
                    objs.append(("AnimationCurve", (cv, "AnimCurve::", ""),
                                 (("KeyTime", (ticks,), ()),
                                  ("KeyValueFloat",
                                   (closed.astype(np.float32),), ()))))
                    conns.append(("C", ("OP", cv, cn, axname), ()))
                    cv += 1
                cn += 1
    return objs, conns


def write_fbx(path: str, positions: np.ndarray, indices: np.ndarray,
              normals: Optional[np.ndarray] = None,
              uvs: Optional[np.ndarray] = None,
              translation=(0.0, 0.0, 0.0),
              rotation_deg=(0.0, 0.0, 0.0),
              scaling=(1.0, 1.0, 1.0),
              diffuse_color=(1.0, 1.0, 1.0),
              skin=None) -> None:
    """Write a single-mesh binary FBX 7.4 file.

    positions (V, 3); indices (T, 3) int; normals/uvs per VERTEX
    (ByControlPoint mapping) — enough for this importer, Assimp and
    Blender to read the geometry back.

    skin: optional models.scene.Skin whose joints/weights index the
    POSITIONS rows — emits the bone hierarchy, Skin/Cluster deformers
    and animation curves (see _skin_objects) so a rigged model
    round-trips through load_fbx with the same skeleton, weights, bind
    matrices and uniform-clock tracks as a glTF twin.
    """
    positions = np.asarray(positions, np.float64).reshape(-1, 3)
    indices = np.asarray(indices, np.int64).reshape(-1, 3)
    pvi = indices.copy()
    pvi[:, 2] = ~pvi[:, 2]                     # negative-terminate tris

    geo_children = [
        ("Vertices", (positions.reshape(-1),), ()),
        ("PolygonVertexIndex", (pvi.reshape(-1),), ()),
        ("GeometryVersion", (124,), ()),
    ]
    if normals is not None:
        normals = np.asarray(normals, np.float64).reshape(-1, 3)
        geo_children.append(("LayerElementNormal", (0,), (
            ("Version", (101,), ()),
            ("Name", ("",), ()),
            ("MappingInformationType", ("ByControlPoint",), ()),
            ("ReferenceInformationType", ("Direct",), ()),
            ("Normals", (normals.reshape(-1),), ()),
        )))
    if uvs is not None:
        uvs = np.asarray(uvs, np.float64).reshape(-1, 2)
        geo_children.append(("LayerElementUV", (0,), (
            ("Version", (101,), ()),
            ("Name", ("",), ()),
            ("MappingInformationType", ("ByControlPoint",), ()),
            ("ReferenceInformationType", ("Direct",), ()),
            ("UV", (uvs.reshape(-1),), ()),
        )))

    GEO_ID, MODEL_ID, MAT_ID = 1000001, 2000001, 3000001
    p70_model = ("Properties70", (), (
        ("P", ("Lcl Translation", "Lcl Translation", "", "A",
               float(translation[0]), float(translation[1]),
               float(translation[2])), ()),
        ("P", ("Lcl Rotation", "Lcl Rotation", "", "A",
               float(rotation_deg[0]), float(rotation_deg[1]),
               float(rotation_deg[2])), ()),
        ("P", ("Lcl Scaling", "Lcl Scaling", "", "A",
               float(scaling[0]), float(scaling[1]),
               float(scaling[2])), ()),
    ))
    p70_mat = ("Properties70", (), (
        ("P", ("DiffuseColor", "Color", "", "A",
               float(diffuse_color[0]), float(diffuse_color[1]),
               float(diffuse_color[2])), ()),
    ))
    p70_gs = ("Properties70", (), (
        ("P", ("UnitScaleFactor", "double", "Number", "", 100.0), ()),
        ("P", ("UpAxis", "int", "Integer", "", 1), ()),
    ))

    obj_children = [
        ("Geometry", (GEO_ID, "Geometry::mesh", "Mesh"),
         tuple(geo_children)),
        ("Model", (MODEL_ID, "Model::mesh", "Mesh"), (
            ("Version", (232,), ()), p70_model)),
        ("Material", (MAT_ID, "Material::mat", ""), (
            ("Version", (102,), ()),
            ("ShadingModel", ("lambert",), ()), p70_mat)),
    ]
    conn_children = [
        ("C", ("OO", GEO_ID, MODEL_ID), ()),
        ("C", ("OO", MODEL_ID, 0), ()),
        ("C", ("OO", MAT_ID, MODEL_ID), ()),
    ]
    if skin is not None:
        sm = np.diag([float(scaling[0]), float(scaling[1]),
                      float(scaling[2]), 1.0])
        rm = _euler_xyz_row(*[float(r) for r in rotation_deg])
        tm = np.eye(4)
        tm[3, :3] = [float(t) for t in translation]
        mesh_world = sm @ rm @ tm
        sobjs, sconns = _skin_objects(skin, mesh_world, GEO_ID)
        obj_children += sobjs
        conn_children += sconns

    top = [
        ("FBXHeaderExtension", (), (
            ("FBXHeaderVersion", (1003,), ()),
            ("FBXVersion", (7400,), ()),
        )),
        ("GlobalSettings", (), (("Version", (1000,), ()), p70_gs)),
        ("Objects", (), tuple(obj_children)),
        ("Connections", (), tuple(conn_children)),
    ]

    out = _MAGIC + struct.pack("<I", 7400)
    cursor = len(out)
    for name, props, children in top:
        nb = _w_node(name, props, children, base=cursor)
        out += nb
        cursor += len(nb)
    out += b"\x00" * 13                        # top-level terminator
    # standard-ish footer padding (readers don't require the magic tail)
    out += b"\x00" * 120
    with open(path, "wb") as f:
        f.write(out)
