"""First-party COLLADA (.dae) importer.

The reference loads DAE through Assimp (ModelLoader.cs:
144-150 — any Assimp format); this is the native equivalent for the most
common interchange subset: `library_geometries` triangles/polylist
primitives with POSITION/NORMAL/TEXCOORD inputs, the `library_visual_
scenes` node hierarchy (matrix / translate / rotate / scale elements in
document order), instance_geometry + bind_material, lambert/phong/blinn
diffuse (color or texture through the sampler→surface→image chain),
`up_axis` conversion and the `unit` meter scale.

Output matches io_host.gltf.load_gltf: {"meshes": [...], "lights": []}
with node transforms BAKED into vertices through the same native
bake_positions / rotation-only bake_normals pipeline, so a DAE asset and
its glTF twin produce identical scene buffers.

Conventions: COLLADA matrices are written row-major for column vectors
(v' = M·v); this repo uses the .NET row-vector convention (v' = v·M,
utils/mathlib.py), so every matrix is transposed on read and composition
follows the glTF importer's `global = local @ parent` pattern.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from softwarerenderer_tpu_torch.models.scene import Light, LightType, Material, \
    bounding_sphere

F32 = np.float32


def _local(tag: str) -> str:
    return tag.split("}")[-1]


def _children(el, name):
    return [c for c in el if _local(c.tag) == name]


def _find(el, *path):
    cur = [el]
    for name in path:
        nxt = []
        for e in cur:
            nxt.extend(_children(e, name))
        cur = nxt
    return cur


def _floats(text: Optional[str]) -> np.ndarray:
    return np.asarray([float(x) for x in (text or "").split()], np.float64)


def _ints(text: Optional[str]) -> np.ndarray:
    return np.asarray([int(x) for x in (text or "").split()], np.int64)


def _node_matrix_row(node) -> np.ndarray:
    """Compose the node's transform elements (document order) into one
    row-vector matrix."""
    m = np.eye(4, dtype=np.float64)           # column-vector accumulator
    for el in node:
        t = _local(el.tag)
        if t == "matrix":
            v = _floats(el.text)
            if v.size == 16:
                m = m @ v.reshape(4, 4)       # row-major text = col-vec M
        elif t == "translate":
            v = _floats(el.text)
            tm = np.eye(4)
            tm[:3, 3] = v[:3]
            m = m @ tm
        elif t == "rotate":
            v = _floats(el.text)
            if v.size == 4:
                axis = v[:3]
                ln = np.linalg.norm(axis)
                if ln > 0:
                    axis = axis / ln
                    a = np.deg2rad(v[3])
                    x, y, z = axis
                    c, s = np.cos(a), np.sin(a)
                    C = 1 - c
                    rm = np.eye(4)
                    rm[:3, :3] = [
                        [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
                        [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
                        [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
                    ]
                    m = m @ rm
        elif t == "scale":
            v = _floats(el.text)
            sm = np.diag([v[0], v[1], v[2], 1.0])
            m = m @ sm
    return m.T.astype(F32)                    # col-vec → row-vec


def _build_sources(mesh_el) -> Dict[str, np.ndarray]:
    """source id → (N, stride) float array."""
    out = {}
    for src in _children(mesh_el, "source"):
        sid = src.get("id")
        arrs = _children(src, "float_array")
        if not arrs:
            continue
        data = _floats(arrs[0].text)
        stride = 3
        for acc in _find(src, "technique_common", "accessor"):
            stride = int(acc.get("stride", 3))
        out[sid] = data.reshape(-1, stride)
    return out


def _resolve_vertices(mesh_el, sources) -> Dict[str, str]:
    """vertices id → {semantic: source id} (the POSITION indirection)."""
    out = {}
    for v in _children(mesh_el, "vertices"):
        sem = {}
        for inp in _children(v, "input"):
            sem[inp.get("semantic")] = inp.get("source", "").lstrip("#")
        out[v.get("id")] = sem
    return out


def _material_index(root, base_dir: str) -> Dict[str, Material]:
    """material id → Material (diffuse color / texture path)."""
    images = {}
    for img in _find(root, "library_images", "image"):
        for init in _children(img, "init_from"):
            # 1.4: text; 1.5: nested <ref>
            refs = _children(init, "ref")
            path = (refs[0].text if refs else init.text) or ""
            images[img.get("id")] = path.strip()
    effects = {}
    for eff in _find(root, "library_effects", "effect"):
        diffuse_color = (1.0, 1.0, 1.0, 1.0)
        tex_path = None
        # sampler → surface → image indirection inside profile_COMMON
        newparams = {}
        for np_el in _find(eff, "profile_COMMON", "newparam"):
            sid = np_el.get("sid")
            for srf in _children(np_el, "surface"):
                for init in _children(srf, "init_from"):
                    newparams[sid] = ("surface", (init.text or "").strip())
            for smp in _children(np_el, "sampler2D"):
                for src in _children(smp, "source"):
                    newparams[sid] = ("sampler", (src.text or "").strip())
        for shader in ("lambert", "phong", "blinn", "constant"):
            for sh in _find(eff, "profile_COMMON", "technique", shader):
                for dif in _children(sh, "diffuse"):
                    for col in _children(dif, "color"):
                        v = _floats(col.text)
                        if v.size >= 3:
                            diffuse_color = (float(v[0]), float(v[1]),
                                             float(v[2]),
                                             float(v[3]) if v.size > 3
                                             else 1.0)
                    for tex in _children(dif, "texture"):
                        ref = tex.get("texture", "")
                        # walk sampler → surface → image (or direct image)
                        seen = set()
                        while ref in newparams and ref not in seen:
                            seen.add(ref)
                            ref = newparams[ref][1]
                        path = images.get(ref, ref)
                        if path:
                            tex_path = os.path.normpath(
                                os.path.join(base_dir, path))
        effects[eff.get("id")] = (diffuse_color, tex_path)
    mats = {}
    for mat in _find(root, "library_materials", "material"):
        for inst in _children(mat, "instance_effect"):
            eid = inst.get("url", "").lstrip("#")
            color, tex = effects.get(eid, ((1, 1, 1, 1), None))
            mats[mat.get("id")] = Material(
                base_color=tuple(color),
                texture_paths=(("diffuse", tex),) if tex else ())
    return mats


def _triangulate_prim(prim, sources, vertices_map):
    """One <triangles>/<polylist> → corner-expanded (pos, uv, nrm, idx)."""
    inputs = []                    # (offset, semantic, set, source_id)
    max_off = 0
    for inp in _children(prim, "input"):
        off = int(inp.get("offset", 0))
        max_off = max(max_off, off)
        inputs.append((off, inp.get("semantic"), int(inp.get("set", 0)),
                       inp.get("source", "").lstrip("#")))
    stride = max_off + 1
    p_els = _children(prim, "p")
    if not p_els:
        return None
    p = np.concatenate([_ints(el.text) for el in p_els])
    if p.size % stride:
        p = p[: p.size - p.size % stride]
    p = p.reshape(-1, stride)      # (corners, stride)

    kind = _local(prim.tag)
    if kind == "polylist":
        vcounts = _ints(_children(prim, "vcount")[0].text)
    elif kind == "triangles":
        vcounts = np.full(p.shape[0] // 3, 3, np.int64)
    else:
        return None

    # Fan-triangulate: corner rows per polygon → triangle corner rows.
    tri_rows = []
    c = 0
    for vc in vcounts:
        for i in range(1, vc - 1):
            tri_rows.extend((c, c + i, c + i + 1))
        c += vc
    rows = p[np.asarray(tri_rows, np.int64)]   # (3T, stride)

    n = rows.shape[0]
    pos = np.zeros((n, 3), np.float64)
    nrm = np.zeros((n, 3), np.float64)
    uv = np.zeros((n, 2), np.float64)
    vert_rows = np.zeros((n,), np.int64)     # per-corner VERTEX index
    # Take the LOWEST-numbered TEXCOORD set present — some exporters
    # (3ds Max, certain Maya configs) emit set="1" as the only UV
    # channel, and requiring exactly set 0 would silently zero all UVs.
    uv_sets = sorted(set_i for _, sem, set_i, src in inputs
                     if sem == "TEXCOORD" and src in sources)
    uv_set = uv_sets[0] if uv_sets else 0
    for off, sem, set_i, src in inputs:
        idx = rows[:, off]
        if sem == "VERTEX":
            vert_rows = idx
            sem_map = vertices_map.get(src, {})
            for vsem, vsrc in sem_map.items():
                arr = sources.get(vsrc)
                if arr is None:
                    continue
                if vsem == "POSITION":
                    pos = arr[idx, :3]
                elif vsem == "NORMAL":
                    nrm = arr[idx, :3]
                elif vsem == "TEXCOORD":
                    uv = arr[idx, :2]
        elif sem == "NORMAL" and src in sources:
            nrm = sources[src][idx, :3]
        elif sem == "TEXCOORD" and set_i == uv_set and src in sources:
            uv = sources[src][idx, :2]
    indices = np.arange(n, dtype=np.int32).reshape(-1, 3)
    return pos, uv, nrm, indices, prim.get("material"), vert_rows


def _name_list(src_el) -> List[str]:
    for arr in _children(src_el, "Name_array"):
        return (arr.text or "").split()
    return []


def _parse_controllers(root) -> Dict[str, Dict]:
    """controller id → skin data: geometry id, bind_shape (row-vector),
    joint sids, inverse binds (J, 4, 4 row-vector), per-vertex top-4
    (joints, weights).  COLLADA matrices are column-vector row-major
    text → transposed on read (module docstring)."""
    out: Dict[str, Dict] = {}
    for ctrl in _find(root, "library_controllers", "controller"):
        for sk in _children(ctrl, "skin"):
            geom_id = sk.get("source", "").lstrip("#")
            bind_shape = np.eye(4, dtype=np.float64)
            for bs in _children(sk, "bind_shape_matrix"):
                v = _floats(bs.text)
                if v.size == 16:
                    bind_shape = v.reshape(4, 4).T       # col→row vector
            sources: Dict[str, object] = {}
            for src in _children(sk, "source"):
                sid = src.get("id")
                names = _name_list(src)
                if names:
                    sources[sid] = names
                else:
                    arrs = _children(src, "float_array")
                    if arrs:
                        sources[sid] = _floats(arrs[0].text)
            joint_names: List[str] = []
            inv_bind = None
            for jo in _children(sk, "joints"):
                for inp in _children(jo, "input"):
                    src = sources.get(inp.get("source", "").lstrip("#"))
                    if inp.get("semantic") == "JOINT" \
                            and isinstance(src, list):
                        joint_names = src
                    elif inp.get("semantic") == "INV_BIND_MATRIX" \
                            and src is not None:
                        m = np.asarray(src, np.float64).reshape(-1, 4, 4)
                        inv_bind = np.swapaxes(m, -1, -2)  # col→row
            vw = _children(sk, "vertex_weights")
            if not vw or not joint_names:
                continue
            vw = vw[0]
            weight_vals = None
            joff = woff = 0
            stride = 1
            for inp in _children(vw, "input"):
                off = int(inp.get("offset", 0))
                stride = max(stride, off + 1)
                if inp.get("semantic") == "JOINT":
                    joff = off
                elif inp.get("semantic") == "WEIGHT":
                    woff = off
                    weight_vals = sources.get(
                        inp.get("source", "").lstrip("#"))
            vcount = _ints(_children(vw, "vcount")[0].text)
            v = _ints(_children(vw, "v")[0].text)
            if weight_vals is None:
                continue
            V = vcount.shape[0]
            joints_pp = np.zeros((V, 4), np.int32)
            weights_pp = np.zeros((V, 4), F32)
            c = 0
            for vi, n in enumerate(vcount):
                pairs = []
                for k in range(n):
                    ji = int(v[(c + k) * stride + joff])
                    wi = int(v[(c + k) * stride + woff])
                    w = float(weight_vals[wi]) if 0 <= wi < len(
                        weight_vals) else 0.0
                    if ji >= 0 and w != 0.0:
                        pairs.append((w, ji))
                c += n
                pairs.sort(reverse=True)
                total = sum(w for w, _ in pairs[:4])
                for k, (w, ji) in enumerate(pairs[:4]):
                    joints_pp[vi, k] = ji
                    weights_pp[vi, k] = w / total if total > 0 else 0.0
                if total <= 0:
                    weights_pp[vi, 0] = 1.0
            if inv_bind is None:
                inv_bind = np.broadcast_to(
                    np.eye(4), (len(joint_names), 4, 4)).copy()
            out[ctrl.get("id")] = dict(
                geom=geom_id, bind_shape=bind_shape,
                joint_names=joint_names,
                inv_bind=np.asarray(inv_bind, F32),
                joints=joints_pp, weights=weights_pp)
    return out


def _parse_animations(root) -> Dict[str, tuple]:
    """Matrix-channel animations: target node id → (times (K,),
    matrices (K, 4, 4) row-vector).  Covers the common exporter shape
    (Blender & friends: one `<matrix sid="transform">` channel per
    animated node); nested <animation> elements are walked
    recursively."""
    out: Dict[str, tuple] = {}

    def walk(anim):
        sources = {}
        for src in _children(anim, "source"):
            arrs = _children(src, "float_array")
            if arrs:
                sources[src.get("id")] = _floats(arrs[0].text)
        samplers = {}
        for smp in _children(anim, "sampler"):
            io = {}
            for inp in _children(smp, "input"):
                io[inp.get("semantic")] = inp.get("source", "").lstrip("#")
            samplers[smp.get("id")] = io
        for ch in _children(anim, "channel"):
            target = ch.get("target", "")
            node_id = target.split("/")[0]
            io = samplers.get(ch.get("source", "").lstrip("#"), {})
            times = sources.get(io.get("INPUT"))
            vals = sources.get(io.get("OUTPUT"))
            if times is None or vals is None or times.size == 0:
                continue
            if vals.size == times.size * 16:
                m = vals.reshape(-1, 4, 4)
                out[node_id] = (times, np.swapaxes(m, -1, -2))  # col→row
        for sub in _children(anim, "animation"):
            walk(sub)

    for anim in _find(root, "library_animations", "animation"):
        walk(anim)
    return out


def _dae_skin_for_instance(ctrl: Dict, anims: Dict, node_index: Dict,
                           root_row: np.ndarray):
    """models.scene.Skin kwargs (minus per-vertex arrays) for one
    instance_controller: joints resolved by sid over the visual scene,
    topo-ordered, with matrix-channel tracks resampled on the gltf
    uniform clock (densest sampler, floor 30 fps, endpoint dropped) and
    static non-joint ancestor chains (incl. the up-axis/unit root) folded
    into root joint locals — the same conventions as the glTF and FBX
    importers, so a DAE rig and its twins evaluate identically."""
    from softwarerenderer_tpu_torch.io_host.gltf import _decompose_trs_row

    names = ctrl["joint_names"]
    elems, parent_el = node_index
    order = sorted(range(len(names)),
                   key=lambda k: _node_depth(elems.get(names[k]),
                                             parent_el))
    remap = np.empty(len(names), np.int32)
    for new, old in enumerate(order):
        remap[old] = new
    node_of = [elems.get(names[k]) for k in order]
    el_slot = {id(el): i for i, el in enumerate(node_of) if el is not None}

    J = len(node_of)
    parent = np.full(J, -1, np.int32)
    for i, el in enumerate(node_of):
        if el is None:
            continue
        p = parent_el.get(id(el))
        while p is not None and id(p) not in el_slot:
            p = parent_el.get(id(p))
        if p is not None:
            parent[i] = el_slot[id(p)]

    # Uniform clock over the instance's animated joints.
    duration = 0.0
    densest = 30.0
    for el in node_of:
        if el is None:
            continue
        ch = anims.get(el.get("id"))
        if ch is not None and ch[0].size:
            duration = max(duration, float(ch[0][-1]))
    for el in node_of:
        if el is None:
            continue
        ch = anims.get(el.get("id"))
        if ch is not None and ch[0].size > 1 and duration > 0:
            densest = max(densest, (ch[0].size - 1) / duration)
    rate = float(np.clip(densest, 1.0, 120.0))
    F = max(1, int(round(duration * rate)) + 1) if duration > 0 else 1
    grid = np.arange(F, dtype=np.float64) / rate

    trans = np.zeros((F, J, 3), F32)
    rot = np.zeros((F, J, 4), F32)
    rot[..., 3] = 1.0
    scl = np.ones((F, J, 3), F32)
    for i, el in enumerate(node_of):
        if el is None:
            continue
        ch = anims.get(el.get("id"))
        if ch is None:
            mats = np.broadcast_to(
                _node_matrix_row(el).astype(np.float64), (F, 4, 4))
        else:
            times, kmats = ch
            mats = np.empty((F, 4, 4), np.float64)
            for r in range(4):
                for c in range(4):
                    mats[:, r, c] = np.interp(grid, times, kmats[:, r, c])
        if parent[i] == -1:
            # Fold the static ancestor chain (non-joint nodes up to the
            # scene root) + the up-axis/unit root transform.
            anc = np.eye(4, dtype=np.float64)
            p = parent_el.get(id(el))
            while p is not None:
                anc = anc @ _node_matrix_row(p).astype(np.float64)
                p = parent_el.get(id(p))
            anc = anc @ root_row.astype(np.float64)
            mats = mats @ anc[None]
        for f in range(F):
            t, q, s = _decompose_trs_row(mats[f].astype(F32))
            if f and np.dot(q, rot[f - 1, i]) < 0:
                q = -q
            trans[f, i], rot[f, i], scl[f, i] = t, q, s
    if F > 1:
        trans, rot, scl = trans[:-1], rot[:-1], scl[:-1]
    return dict(parent=parent, inverse_bind=ctrl["inv_bind"][order],
                trans=trans, rot=rot, scale=scl, rate=rate), remap


def _node_depth(el, parent_el) -> int:
    d = 0
    p = parent_el.get(id(el)) if el is not None else None
    while p is not None:
        d, p = d + 1, parent_el.get(id(p))
    return d


def load_dae(path: str, flip_uv: bool = False) -> Dict:
    """Parse a .dae file into {"meshes": [...], "lights": [...]} (same
    contract as gltf.load_gltf: transforms baked, rotation-only normal
    baking).

    UV origin: COLLADA authors V with a bottom-left origin — which IS
    this repo's in-memory convention (the glTF importer's flip converts
    glTF's top-left origin to it) — so no flip happens by default; a DAE
    asset and its glTF twin land on identical UVs."""
    base_dir = os.path.dirname(os.path.abspath(path))
    root = ET.parse(path).getroot()

    # up-axis + unit conversion as a root transform (column-vector), like
    # Assimp's MakeLeftHanded-free default import.
    unit = 1.0
    up = "Y_UP"
    for asset in _children(root, "asset"):
        for u in _children(asset, "unit"):
            unit = float(u.get("meter", 1.0))
        for ua in _children(asset, "up_axis"):
            up = (ua.text or "Y_UP").strip()
    root_m = np.eye(4, dtype=np.float64)
    if up == "Z_UP":
        # (x, y, z)_zup → (x, z, -y)_yup
        root_m[:3, :3] = [[1, 0, 0], [0, 0, 1], [0, -1, 0]]
    elif up == "X_UP":
        root_m[:3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    root_m[:3, :3] *= unit
    root_row = root_m.T.astype(F32)

    # geometry id → list of primitive tuples
    geoms: Dict[str, List] = {}
    for geo in _find(root, "library_geometries", "geometry"):
        prims = []
        for mesh_el in _children(geo, "mesh"):
            sources = _build_sources(mesh_el)
            vmap = _resolve_vertices(mesh_el, sources)
            for prim in mesh_el:
                if _local(prim.tag) in ("triangles", "polylist"):
                    tri = _triangulate_prim(prim, sources, vmap)
                    if tri is not None:
                        prims.append(tri)
        geoms[geo.get("id")] = prims

    materials = _material_index(root, base_dir)
    controllers = _parse_controllers(root)
    anims = _parse_animations(root) if controllers else {}
    from softwarerenderer_tpu_torch.native import bake_normals, bake_positions

    # sid/id → node element + element-identity parent map (joint
    # resolution for instance_controller skeletons).
    elems: Dict[str, object] = {}
    parent_el: Dict[int, object] = {}

    def index_nodes(node, parent):
        if parent is not None:
            parent_el[id(node)] = parent
        for key in (node.get("sid"), node.get("id")):
            if key and key not in elems:
                elems[key] = node
        for ch in _children(node, "node"):
            index_nodes(ch, node)

    for vs in _find(root, "library_visual_scenes", "visual_scene"):
        for node in _children(vs, "node"):
            index_nodes(node, None)

    skin_cache: Dict[str, tuple] = {}
    meshes: List[Dict] = []

    def bind_sym_map(inst):
        sym_map = {}
        for im in _find(inst, "bind_material", "technique_common",
                        "instance_material"):
            sym_map[im.get("symbol")] = im.get("target", "").lstrip("#")
        return sym_map

    def emit_mesh(pos, uv, nrm, idx, mat, skin_obj=None):
        uv2 = uv.astype(F32)
        if flip_uv:
            uv2 = uv2.copy()
            uv2[:, 1] = F32(1.0) - uv2[:, 1]
        center, radius = bounding_sphere(pos)
        mesh = {
            "position": pos,
            "uv": uv2,
            "normal": nrm,
            "color": np.ones((pos.shape[0], 4), F32),
            "indices": idx,
            "material": mat,
            "bounds_center": center,
            "bounds_radius": radius,
        }
        if skin_obj is not None:
            mesh["skin"] = skin_obj
        meshes.append(mesh)

    def process_node(node, parent_row):
        global_m = _node_matrix_row(node) @ parent_row
        rot_only = global_m.copy()
        rot_only[3, :] = [0, 0, 0, 1]
        rot_only[:, 3] = [0, 0, 0, 1]
        for inst in _children(node, "instance_geometry"):
            gid = inst.get("url", "").lstrip("#")
            sym_map = bind_sym_map(inst)
            for pos, uv, nrm, idx, mat_sym, _vr in geoms.get(gid, []):
                wpos = bake_positions(pos.astype(F32), global_m)
                wn = bake_normals(nrm.astype(F32), rot_only)
                emit_mesh(wpos, uv, wn, idx,
                          materials.get(sym_map.get(mat_sym, mat_sym),
                                        Material()))
        for inst in _children(node, "instance_controller"):
            # Skinned instance: vertices bake through the controller's
            # bind_shape_matrix only (joint transforms carry world
            # placement, incl. the up-axis/unit root folded into root
            # joint locals — the glTF skinning convention, so a DAE rig
            # and its twins produce identical packed scenes).
            cid = inst.get("url", "").lstrip("#")
            ctrl = controllers.get(cid)
            if ctrl is None:
                continue
            from softwarerenderer_tpu_torch.models.scene import Skin
            if cid not in skin_cache:
                skin_cache[cid] = _dae_skin_for_instance(
                    ctrl, anims, (elems, parent_el), root_row)
            skin_kwargs, remap = skin_cache[cid]
            bs = ctrl["bind_shape"].astype(F32)
            bs_rot = bs.copy()
            bs_rot[3, :] = [0, 0, 0, 1]
            bs_rot[:, 3] = [0, 0, 0, 1]
            sym_map = bind_sym_map(inst)
            for pos, uv, nrm, idx, mat_sym, vrows in geoms.get(
                    ctrl["geom"], []):
                lpos = bake_positions(pos.astype(F32), bs)
                lnrm = bake_normals(nrm.astype(F32), bs_rot)
                vr = np.clip(vrows, 0, ctrl["joints"].shape[0] - 1)
                skin_obj = Skin(
                    joints=remap[ctrl["joints"][vr]].astype(np.int32),
                    weights=ctrl["weights"][vr].astype(F32),
                    **skin_kwargs)
                emit_mesh(lpos, uv, lnrm, idx,
                          materials.get(sym_map.get(mat_sym, mat_sym),
                                        Material()), skin_obj)
        for child in _children(node, "node"):
            process_node(child, global_m)

    for vs in _find(root, "library_visual_scenes", "visual_scene"):
        for node in _children(vs, "node"):
            process_node(node, root_row)

    lights: List[Light] = []
    for lt in _find(root, "library_lights", "light"):
        for tc in _children(lt, "technique_common"):
            for kind in tc:
                k = _local(kind.tag)
                color = (1.0, 1.0, 1.0)
                for col in _children(kind, "color"):
                    v = _floats(col.text)
                    if v.size >= 3:
                        color = (float(v[0]), float(v[1]), float(v[2]))
                type_map = {"directional": LightType.DIRECTIONAL,
                            "point": LightType.POINT,
                            "spot": LightType.SPOT,
                            "ambient": LightType.AMBIENT}
                if k in type_map:
                    lights.append(Light(color=color,
                                        light_type=type_map[k]))
    return {"meshes": meshes, "lights": lights}
