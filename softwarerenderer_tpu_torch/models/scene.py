"""Scene data model: cameras, materials, lights, meshes, packed scene buffers.

Mirrors the reference's scene types (ModelLoader.cs:42-67 Mesh/Model,
Material.cs, Light.cs, Camera.cs) as host-side dataclasses plus a TPU-first
packing step: instead of per-mesh draw calls under Parallel.ForEach
(Renderer.cs:444-465), all meshes are concatenated into one device-resident
triangle soup with per-vertex mesh ids, per-mesh transforms and a packed
texture atlas, so a frame is ONE fused program over static-shape arrays.

Copied from softwarerenderer_tpu/models/scene.py (numpy only) so that the
port imports nothing of the JAX package; tests/test_torch_package.py holds
build_scene_buffers equal to the source key for key and dtype for dtype.
Left out: the Camera class (the port's engine takes camera uniforms) and
the pack-time helpers of features the port does not render yet (particle
slots, normal-map tangents, skinned bounds), which raise
NotImplementedError here as the engine does for their scene keys.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


F32 = np.float32


# ---------------------------------------------------------------------------
# Material / Light (Material.cs, Light.cs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Material:
    """PBR-ish material record (Material.cs:6-22)."""

    base_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    metallic: float = 0.0
    roughness: float = 0.5
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    texture_paths: Tuple[Tuple[str, str], ...] = ()  # (slot, path) pairs

    def texture_path(self, slot: str = "diffuse") -> Optional[str]:
        for s, p in self.texture_paths:
            if s == slot:
                return p
        return None


class LightType:
    DIRECTIONAL = 0
    POINT = 1
    SPOT = 2
    AMBIENT = 3


@dataclasses.dataclass(frozen=True)
class Light:
    """Imported light record (Light.cs:7-33)."""

    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    direction: Tuple[float, float, float] = (0.0, -1.0, 0.0)
    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    light_type: int = LightType.DIRECTIONAL
    attenuation_constant: float = 1.0
    attenuation_linear: float = 0.0
    attenuation_quadratic: float = 0.0
    spot_inner: float = 0.0
    spot_outer: float = 0.0


# ---------------------------------------------------------------------------
# Bounding spheres (FrustumCuller.CalculateBoundingSphere, :59-151)
# ---------------------------------------------------------------------------

def bounding_sphere(positions: np.ndarray) -> Tuple[np.ndarray, float]:
    """Ritter-style 3-pass bounding sphere, vectorized.

    Pass 1: farthest point p1 from vertex 0; pass 2: farthest p2 from p1;
    pass 3: grow the (p1,p2) sphere to cover stragglers.
    """
    positions = np.asarray(positions, dtype=F32)
    if positions.size == 0:
        return np.zeros(3, dtype=F32), 0.0
    if positions.shape[0] == 1:
        return positions[0].copy(), 0.0
    p0 = positions[0]
    d0 = np.sum((positions - p0) ** 2, axis=-1)
    p1 = positions[np.argmax(d0)]
    d1 = np.sum((positions - p1) ** 2, axis=-1)
    i2 = np.argmax(d1)
    p2 = positions[i2]
    center = (p1 + p2) * F32(0.5)
    radius = F32(np.sqrt(d1[i2]) * 0.5)
    # growth pass (sequential in the reference; order-dependent growth is
    # conservative either way — we apply it deterministically in index order
    # over only the out-of-sphere points)
    for p in positions:
        dist = float(np.linalg.norm(p - center))
        if dist > radius:
            new_radius = (radius + dist) * 0.5
            center = center + (p - center) * ((new_radius - radius) / dist)
            radius = F32(new_radius)
    return center.astype(F32), float(radius)


# ---------------------------------------------------------------------------
# Texture atlas
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TextureAtlas:
    """All scene textures shelf-packed into one (H, W, 4) array.

    Per-texture metadata (offset + size) lets the device shader do the
    reference's repeat-wrap nearest sampling inside its sub-rectangle.
    Texture id 0 is always a 1x1 white texel (the "no texture" fallback,
    Renderer.cs:852 `texture?.Sample(...) ?? Vector4.One`).
    """

    data: np.ndarray            # (H, W, 4) uint8 RGBA (texture.pack_rgba8)
    offsets: np.ndarray         # (N, 2) int32 (y, x) — mip 0
    sizes: np.ndarray           # (N, 2) int32 (h, w) — mip 0
    mip_offsets: Optional[np.ndarray] = None  # (N, M, 2) int32
    mip_sizes: Optional[np.ndarray] = None    # (N, M, 2) int32
    n_mips: Optional[np.ndarray] = None       # (N,) int32 chain lengths
    # Per-texture minimum sampled alpha (f32 in [0,1], from the packed u8
    # base image — mips are box averages, so base min == 1 ⇒ every mip and
    # bilinear blend is exactly 1 too).  Lets the K-buffer peel prove
    # triangles opaque at pack time (engine.renderer.opaque_tri_flags).
    min_alpha: Optional[np.ndarray] = None    # (N,) float32

    @property
    def n_textures(self) -> int:
        return self.offsets.shape[0]


MAX_MIP_LEVELS = 8


def _box_downsample(im: np.ndarray) -> np.ndarray:
    """2×2 box filter (odd trailing row/col duplicated) for mip building."""
    h, w = im.shape[:2]
    if h % 2:
        im = np.concatenate([im, im[-1:]], axis=0)
        h += 1
    if w % 2:
        im = np.concatenate([im, im[:, -1:]], axis=1)
        w += 1
    return im.reshape(h // 2, 2, w // 2, 2, -1).mean(axis=(1, 3))


def pack_atlas(textures: List[np.ndarray], pad_to_multiple: int = 128
               ) -> TextureAtlas:
    """Shelf-pack (H,W,4) float32 images; index 0 = implicit white texel.

    Every texture also contributes its box-filtered mip chain (down to 1 px
    or MAX_MIP_LEVELS) — a quality/perf mode beyond the reference
    (ROADMAP #4): distant triangles sample coarser mips, killing both
    aliasing and far-texture gather scatter.  Mip tables ride alongside
    the mip-0 tables so non-mip paths keep their exact parity semantics.
    """
    images = [np.ones((1, 1, 4), dtype=F32)]
    mip_of = [[0]]                       # image index per (texture, level)
    for t in textures:
        t = np.asarray(t, dtype=F32)
        if t.ndim == 2:
            t = t[..., None]
        if t.shape[-1] == 3:
            t = np.concatenate([t, np.ones(t.shape[:2] + (1,), dtype=F32)], -1)
        chain = [len(images)]
        images.append(t)
        m = t
        while len(chain) < MAX_MIP_LEVELS and min(m.shape[:2]) > 1:
            m = _box_downsample(m).astype(F32)
            chain.append(len(images))
            images.append(m)
        mip_of.append(chain)

    max_w = max(im.shape[1] for im in images)
    atlas_w = -(-max(max_w, 1) // pad_to_multiple) * pad_to_multiple
    # shelf packing in given order
    offsets, sizes = [], []
    shelf_y = 0
    shelf_h = 0
    cur_x = 0
    for im in images:
        h, w = im.shape[0], im.shape[1]
        if cur_x + w > atlas_w:
            shelf_y += shelf_h
            cur_x = 0
            shelf_h = 0
        offsets.append((shelf_y, cur_x))
        sizes.append((h, w))
        cur_x += w
        shelf_h = max(shelf_h, h)
    atlas_h = -(-(shelf_y + shelf_h) // pad_to_multiple) * pad_to_multiple
    data = np.zeros((atlas_h, atlas_w, 4), dtype=F32)
    for im, (oy, ox), (h, w) in zip(images, offsets, sizes):
        data[oy:oy + h, ox:ox + w] = im
    # Mip tables: per (texture, level) region, levels past a texture's
    # chain clamped to its last (coarsest) mip.
    n_tex = len(mip_of)
    offs = np.asarray(offsets, np.int32)
    szs = np.asarray(sizes, np.int32)
    mip_offsets = np.zeros((n_tex, MAX_MIP_LEVELS, 2), np.int32)
    mip_sizes = np.zeros((n_tex, MAX_MIP_LEVELS, 2), np.int32)
    n_mips = np.zeros(n_tex, np.int32)
    for ti, chain in enumerate(mip_of):
        n_mips[ti] = len(chain)
        for lv in range(MAX_MIP_LEVELS):
            src = chain[min(lv, len(chain) - 1)]
            mip_offsets[ti, lv] = offs[src]
            mip_sizes[ti, lv] = szs[src]

    # Pack as RGBA u8 rows: the reference's byte-image value space
    # (Texture.cs) and 4× narrower gather rows (texture.pack_rgba8).
    from softwarerenderer_tpu_torch.ops.texture import pack_rgba8
    base = np.asarray([chain[0] for chain in mip_of], np.int32)
    data_u8 = pack_rgba8(data)
    # Minimum sampled alpha per texture, measured on the quantized bytes
    # the shader actually fetches (base image; mips are box averages of
    # it, so an all-255 base keeps alpha exactly 1 at every level).
    min_alpha = np.empty(n_tex, np.float32)
    for ti in range(n_tex):
        (oy, ox), (h, w) = offs[base[ti]], szs[base[ti]]
        min_alpha[ti] = data_u8[oy:oy + h, ox:ox + w, 3].min() / 255.0
    return TextureAtlas(
        data=data_u8,
        offsets=offs[base],
        sizes=szs[base],
        mip_offsets=mip_offsets,
        mip_sizes=mip_sizes,
        n_mips=n_mips,
        min_alpha=min_alpha,
    )


# ---------------------------------------------------------------------------
# Packed scene buffers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Skin:
    """Skeleton + per-vertex skinning data for one MeshInstance (beyond
    the reference, whose only animation is the flip-book swap —
    ModelLoader.cs:331-348).  Joints must be topologically ordered
    (parent[j] < j, roots = -1); tracks are uniform-clock TRS keyframes
    at `rate` frames/second (a single-frame track = static pose).  See
    ops/skinning.py for the evaluation semantics."""

    joints: np.ndarray          # (V, 4) int32 — joint ids per vertex
    weights: np.ndarray         # (V, 4) float32 — blend weights (sum 1)
    parent: np.ndarray          # (J,) int32 — topo order, -1 = root
    inverse_bind: np.ndarray    # (J, 4, 4) float32 (row-vector layout)
    trans: np.ndarray           # (F, J, 3) float32
    rot: np.ndarray             # (F, J, 4) float32 xyzw quats
    scale: np.ndarray           # (F, J, 3) float32
    rate: float = 30.0          # keyframes per second


@dataclasses.dataclass
class MeshInstance:
    """One draw: a mesh dict (primitives.py layout) + transform + texture.

    Flip-book animation (ModelLoader.cs:331-348 PlayAnimation): supply
    `animation_positions` (F, V, 3) — and optionally `animation_normals`
    (F, V, 3) — stacked per-frame vertex data with the SAME topology as
    `mesh`.  The packed scene then carries the stack on device and the
    jitted frame selects each mesh's frame from the traced
    uniforms["anim_frame"] vector — no re-upload, no recompile per frame.
    """

    mesh: Dict[str, np.ndarray]
    model_matrix: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=F32))
    texture: Optional[np.ndarray] = None   # (H, W, 4) float32, or None
    # Tangent-space normal map (ops/normalmap.py; the reference loads
    # these paths but never samples them — ModelLoader.cs:221-281).
    # Packs into the same atlas; per-vertex tangents are computed at
    # pack time.
    normal_texture: Optional[np.ndarray] = None
    material: Material = Material()
    animation_positions: Optional[np.ndarray] = None   # (F, V, 3)
    animation_normals: Optional[np.ndarray] = None     # (F, V, 3)
    skin: Optional[Skin] = None                        # skeletal animation
    # Morph targets (ops/morph.py): {"pos": (K, V, 3) deltas,
    # "nrm": (K, V, 3) deltas or None, "weights": (K,) defaults,
    # "weight_track": (F, K) uniform-clock keys or None, "rate": fps}.
    # Applied before skinning, weighted from traced uniforms/anim_time.
    morph: Optional[Dict] = None
    # Particle slot capacity (sim/particles.py): the mesh must be
    # particles_mesh(capacity) — 4·N reserved billboard vertices whose
    # world-space corners the jitted frame writes from the traced
    # particle uniforms.  Model matrix must stay identity.
    particles: Optional[int] = None


def assign_texture_ids(instances: List[MeshInstance],
                       neutral_nm: Optional[np.ndarray] = None):
    """Atlas texture-id assignment — the single source of truth shared by
    `build_scene_buffers` (which packs in this order) and
    `engine.rtt.atlas_id_of` (which asks where a texture landed).

    Walks instances in order, visiting the diffuse texture then (only when
    the scene uses normal mapping at all) the normal texture, first-seen
    identity-keyed; id 0 is the implicit white texel.  Instances without a
    normal map share `neutral_nm` (a 1x1 +z texel, created here if the
    caller doesn't supply one).

    Returns (textures, id_of, neutral_nm): the pack-order texture list
    (atlas id = index + 1), a mapping id(array) -> atlas id, and the
    neutral texel actually used (None when the scene has no normal maps).
    """
    any_nm = any(inst.normal_texture is not None for inst in instances)
    if any_nm and neutral_nm is None:
        neutral_nm = np.asarray([[[0.5, 0.5, 1.0, 1.0]]], F32)
    textures: List[np.ndarray] = []
    id_of: Dict[int, int] = {}

    def visit(arr):
        key = id(arr)
        if key not in id_of:
            textures.append(arr)
            id_of[key] = len(textures)  # atlas id (0 is white)

    for inst in instances:
        if inst.texture is not None:
            visit(inst.texture)
        if any_nm:
            visit(inst.normal_texture if inst.normal_texture is not None
                  else neutral_nm)
    return textures, id_of, (neutral_nm if any_nm else None)


def build_scene_buffers(instances: List[MeshInstance]) -> Dict[str, np.ndarray]:
    """Concatenate mesh instances into one static-shape triangle soup.

    Returns a dict of arrays (a pytree ready for device upload):
      position/uv/normal/color : (V, ...) packed vertex attributes
      indices                  : (T, 3) int32 into the packed vertex arrays
      tri_mesh_id              : (T,)  mesh-instance id per triangle
      vert_mesh_id             : (V,)  mesh-instance id per vertex
      mesh_matrices            : (M, 4, 4) model matrices
      tri_texture_id           : (T,) atlas texture ids (0 = white)
      bounds_center/bounds_radius : per-mesh local-space bounding spheres
      atlas_data/atlas_offsets/atlas_sizes : packed texture atlas
      base_color               : (M, 4) material base colors
    """
    positions, uvs, normals, colors, all_indices = [], [], [], [], []
    tri_mesh_id, vert_mesh_id, tri_tex_id = [], [], []
    matrices, centers, radii, base_colors = [], [], [], []
    metallics, roughnesses, emissives = [], [], []
    tangents, tri_nm_id = [], []
    tri_lod, mesh_lod_px = [], []
    any_normal_map = any(inst.normal_texture is not None
                         for inst in instances)
    # Atlas ids come from the shared assignment walk — engine.rtt.atlas_id_of
    # calls the same function, so the two can never desync.  neutral_nm is
    # the 1×1 +z texel shared by normal-map-less instances in a
    # normal-mapped scene (atlas layout unchanged otherwise).
    textures, tex_id_of, neutral_nm = assign_texture_ids(instances)
    anim = {"pos": [], "nrm": [], "vidx": [], "slot": [], "nf": []}
    mo = {"vidx": [], "slot": [], "dpos": [], "dnrm": [], "dw": [],
          "track": [], "rate": []}

    v_off = 0
    for mi, inst in enumerate(instances):
        if inst.particles or inst.skin is not None \
                or inst.normal_texture is not None:
            raise NotImplementedError(
                "particles, skins and normal maps are not implemented in "
                "softwarerenderer_tpu_torch yet")
        mesh = inst.mesh
        pos = np.asarray(mesh["position"], dtype=F32)
        v = pos.shape[0]
        if inst.animation_positions is not None:
            ap = np.asarray(inst.animation_positions, dtype=F32)
            if ap.shape[1:] != (v, 3):
                raise ValueError(
                    f"animation_positions {ap.shape} does not match mesh "
                    f"vertex count {v} (flip-book frames must share "
                    f"topology, ModelLoader.cs:345-347)")
            an = inst.animation_normals
            an = (np.asarray(an, dtype=F32) if an is not None
                  else np.broadcast_to(
                      np.asarray(mesh["normal"], F32)[None], ap.shape))
            anim["pos"].append(ap)
            anim["nrm"].append(np.asarray(an, F32))
            anim["vidx"].append(v_off + np.arange(v, dtype=np.int32))
            anim["slot"].append(np.full(v, len(anim["nf"]), np.int32))
            anim["nf"].append(ap.shape[0])
        if inst.morph is not None:
            m = inst.morph
            dp = np.asarray(m["pos"], F32)
            if dp.ndim != 3 or dp.shape[1] != v:
                raise ValueError(
                    f"morph deltas {dp.shape} do not match mesh vertex "
                    f"count {v} (expected (K, {v}, 3))")
            mo["vidx"].append(v_off + np.arange(v, dtype=np.int32))
            mo["slot"].append(np.full(v, len(mo["rate"]), np.int32))
            mo["dpos"].append(dp.transpose(1, 0, 2))       # (V, K, 3)
            dn = m.get("nrm")
            mo["dnrm"].append(np.asarray(dn, F32).transpose(1, 0, 2)
                              if dn is not None else None)
            mo["dw"].append(np.asarray(
                m.get("weights", np.zeros(dp.shape[0])), F32)
                .reshape(-1)[: dp.shape[0]])
            mo["track"].append(None if m.get("weight_track") is None
                               else np.asarray(m["weight_track"], F32))
            mo["rate"].append(float(m.get("rate", 30.0)))
        positions.append(pos)
        uvs.append(np.asarray(mesh["uv"], dtype=F32))
        normals.append(np.asarray(mesh["normal"], dtype=F32))
        colors.append(np.asarray(mesh["color"], dtype=F32))
        idx = np.asarray(mesh["indices"], dtype=np.int32).reshape(-1, 3)
        if mesh.get("lod_indices"):
            # Mesh LOD (ops/lod.py): every level's triangles pack into
            # the soup; the jitted frame masks to the active level.
            levels = [idx] + [np.asarray(s, np.int32).reshape(-1, 3)
                              for s in mesh["lod_indices"]]
            tri_lod.append(np.concatenate(
                [np.full(lv.shape[0], li, np.int32)
                 for li, lv in enumerate(levels)]))
            idx = np.concatenate(levels)
            mesh_lod_px.append([float(p) for p in mesh["lod_px"]])
        else:
            tri_lod.append(np.zeros(idx.shape[0], np.int32))
            mesh_lod_px.append([])
        all_indices.append(idx + v_off)
        t = idx.shape[0]
        tri_mesh_id.append(np.full(t, mi, dtype=np.int32))
        vert_mesh_id.append(np.full(v, mi, dtype=np.int32))
        tex = tex_id_of[id(inst.texture)] if inst.texture is not None else 0
        tri_tex_id.append(np.full(t, tex, dtype=np.int32))
        if any_normal_map:
            nm_tex = inst.normal_texture if inst.normal_texture is not None \
                else neutral_nm
            tangents.append(np.tile(np.asarray([[1, 0, 0, 1]], F32),
                                    (v, 1)))
            tri_nm_id.append(np.full(t, tex_id_of[id(nm_tex)],
                                     dtype=np.int32))
        matrices.append(np.asarray(inst.model_matrix, dtype=F32))
        # Animated meshes: bound every frame so culling stays conservative.
        c, r = bounding_sphere(
            pos if inst.animation_positions is None
            else np.asarray(inst.animation_positions, F32).reshape(-1, 3))
        if inst.morph is not None:
            # Conservative morph slack: each target moves a vertex at most
            # max|delta|, scaled by the largest weight magnitude on file
            # (glTF weights are usually in [0,1] but may exceed it).
            dp = np.asarray(inst.morph["pos"], F32)
            wmax = max(1.0, float(np.abs(mo["dw"][-1]).max(initial=0.0)))
            if mo["track"][-1] is not None:
                wmax = max(wmax,
                           float(np.abs(mo["track"][-1]).max(initial=0.0)))
            r = float(r) + wmax * float(
                np.linalg.norm(dp, axis=-1).max(axis=1).sum())
        centers.append(c)
        radii.append(r)
        base_colors.append(np.asarray(inst.material.base_color, dtype=F32))
        metallics.append(float(inst.material.metallic))
        roughnesses.append(float(inst.material.roughness))
        emissives.append(np.asarray(inst.material.emissive[:3], F32))
        v_off += v

    atlas = pack_atlas(textures)
    out = {
        "position": np.concatenate(positions, axis=0),
        "uv": np.concatenate(uvs, axis=0),
        "normal": np.concatenate(normals, axis=0),
        "color": np.concatenate(colors, axis=0),
        "indices": np.concatenate(all_indices, axis=0),
        "tri_mesh_id": np.concatenate(tri_mesh_id, axis=0),
        "vert_mesh_id": np.concatenate(vert_mesh_id, axis=0),
        "tri_texture_id": np.concatenate(tri_tex_id, axis=0),
        "mesh_matrices": np.stack(matrices, axis=0),
        "bounds_center": np.stack(centers, axis=0),
        "bounds_radius": np.asarray(radii, dtype=F32),
        "base_color": np.stack(base_colors, axis=0),
        # PBR-ish material properties the reference imports but never
        # shades with (Material.cs, ModelLoader.cs:221-281) — consumed by
        # ops/lighting.pbr_scene_fragment_shader.
        "mesh_metallic": np.asarray(metallics, F32),
        "mesh_roughness": np.asarray(roughnesses, F32),
        "mesh_emissive": np.stack(emissives, axis=0),
        "atlas_data": atlas.data,
        "atlas_offsets": atlas.offsets,
        "atlas_sizes": atlas.sizes,
        "atlas_mip_offsets": atlas.mip_offsets,
        "atlas_mip_sizes": atlas.mip_sizes,
        "atlas_n_mips": atlas.n_mips,
        "tex_min_alpha": atlas.min_alpha,
    }
    if any_normal_map:
        out["tangent"] = np.concatenate(tangents, axis=0)
        out["tri_normal_tex_id"] = np.concatenate(tri_nm_id, axis=0)
    tmi = out["tri_mesh_id"]
    if tmi.size == 0 or (np.diff(tmi) >= 0).all():
        # First triangle slot of each mesh's contiguous segment — lets
        # per-mesh bool/int values broadcast to tri granularity by
        # delta-scatter + cumsum instead of a per-element gather
        # (culling.segment_broadcast: jnp.take over 584k ids measured
        # ~5 ms on v5e, the cumsum form ~2 ms).  Guarded on sortedness;
        # consumers treat absence as "use take".  NOTE: valid only at
        # full triangle-array size — parallel/sharding.py pops it for
        # tri-sharded slices.
        out["tri_seg_starts"] = np.searchsorted(
            tmi, np.arange(len(matrices))).astype(np.int32)
    vmi = out["vert_mesh_id"]
    if vmi.size == 0 or (np.diff(vmi) >= 0).all():
        # Same contiguity fact at VERTEX granularity: lets the per-vertex
        # model-matrix fan-out run as the exact bitcast delta-cumsum
        # (culling.segment_broadcast_bits) instead of a (V, 4, 4) take —
        # the dominant vertex-stage cost at crowd scale (~5 ms for 181k
        # vertices on v5e, BENCHMARKS.md).
        out["vert_seg_starts"] = np.searchsorted(
            vmi, np.arange(len(matrices))).astype(np.int32)
    if any(mesh_lod_px):
        # LOD level per triangle + per-mesh pixel thresholds ((M, Lmax),
        # -inf padding never activates — ops/lod.lod_tri_mask).
        l_max = max(len(p) for p in mesh_lod_px)
        out["tri_lod_level"] = np.concatenate(tri_lod)
        out["mesh_lod_px"] = np.asarray(
            [p + [-np.inf] * (l_max - len(p)) for p in mesh_lod_px], F32)
    if anim["nf"]:
        # Frame stacks concatenated on the vertex axis, frame axis padded to
        # the longest animation (selection is per-mesh modulo n_frames, so
        # the padding rows are never read).
        f_max = max(anim["nf"])
        out["anim_positions"] = np.concatenate(
            [np.pad(a, ((0, f_max - a.shape[0]), (0, 0), (0, 0)))
             for a in anim["pos"]], axis=1)
        out["anim_normals"] = np.concatenate(
            [np.pad(a, ((0, f_max - a.shape[0]), (0, 0), (0, 0)))
             for a in anim["nrm"]], axis=1)
        out["anim_vert_index"] = np.concatenate(anim["vidx"])
        out["anim_slot"] = np.concatenate(anim["slot"])
        out["anim_n_frames"] = np.asarray(anim["nf"], np.int32)
    if mo["rate"]:
        # Morph-target buffers (ops/morph.py): deltas vertex-major with
        # the target axis padded to the widest mesh (padded targets carry
        # zero deltas and zero weights, so they never displace anything);
        # weight tracks padded on the frame axis (playback is modulo
        # n_frames per slot — slots without a track store 0 frames and
        # keep their default weights).
        k_max = max(d.shape[1] for d in mo["dpos"])

        def padk(arrs):
            return np.concatenate(
                [np.pad(a, ((0, 0), (0, k_max - a.shape[1]), (0, 0)))
                 for a in arrs], axis=0)

        out["morph_vert_index"] = np.concatenate(mo["vidx"])
        out["morph_slot"] = np.concatenate(mo["slot"])
        out["morph_deltas_pos"] = padk(mo["dpos"])
        if any(d is not None for d in mo["dnrm"]):
            out["morph_deltas_nrm"] = padk(
                [d if d is not None else np.zeros_like(p)
                 for d, p in zip(mo["dnrm"], mo["dpos"])])
        out["morph_default_weights"] = np.stack(
            [np.pad(w, (0, k_max - w.shape[0])) for w in mo["dw"]])
        if any(t is not None for t in mo["track"]):
            f_max = max(t.shape[0] for t in mo["track"] if t is not None)
            tracks = np.zeros((len(mo["track"]), f_max, k_max), F32)
            nf = np.zeros(len(mo["track"]), np.int32)
            for i, t in enumerate(mo["track"]):
                if t is not None:
                    tracks[i, : t.shape[0], : t.shape[1]] = t
                    nf[i] = t.shape[0]
            out["morph_weight_tracks"] = tracks
            out["morph_track_frames"] = nf
            out["morph_rate"] = np.asarray(mo["rate"], F32)
    return out
