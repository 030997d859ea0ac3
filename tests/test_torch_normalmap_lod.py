"""The port's normal mapping (ops.normalmap) and mesh LOD (ops.lod)
against the JAX package's, on the same numpy inputs (fixed seeds): the
pack-time helpers exactly, the shaders run eagerly at rtol 1e-6 / atol
1e-6 (measured differences in each test), the LOD mask exactly on meshes
kept away from their thresholds.  Frames with both are held against JAX's
in tests/test_torch_package.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softwarerenderer_tpu.ops import lod as jlod
from softwarerenderer_tpu.ops import normalmap as jnm
from softwarerenderer_tpu_torch import RenderParams, scenes
from softwarerenderer_tpu_torch.engine import renderer
from softwarerenderer_tpu_torch.models import primitives
from softwarerenderer_tpu_torch.models import scene as scene_mod
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.ops import lod, normalmap
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = np.float32


def _close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


MESHES = {"quad": lambda: primitives.plane(2.0),
          "sphere": lambda: primitives.uv_sphere(0.7, rings=9, sectors=13),
          "soup": lambda: primitives.random_triangle_soup(60, seed=4)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_compute_tangents_matches_jax(mesh):
    m = MESHES[mesh]()
    args = (m["position"], m["uv"], m["normal"], m["indices"])
    got = normalmap.compute_tangents(*args)
    assert got.shape == (m["position"].shape[0], 4) and got.dtype == F32
    np.testing.assert_array_equal(got, jnm.compute_tangents(*args))
    assert set(np.unique(got[:, 3])) <= {-1.0, 1.0}


def test_normal_mapped_vertex_shader_matches_jax():
    """Seeded vertices under per-vertex model matrices (measured: within
    2.4e-7)."""
    rng = np.random.default_rng(1)
    n = 200
    vin = {"position": rng.normal(size=(n, 3)).astype(F32),
           "uv": rng.uniform(0, 1, (n, 2)).astype(F32),
           "normal": rng.normal(size=(n, 3)).astype(F32),
           "color": rng.uniform(0, 1, (n, 4)).astype(F32),
           "tangent": np.concatenate([rng.normal(size=(n, 3)),
                                      rng.choice([-1.0, 1.0], (n, 1))],
                                     -1).astype(F32)}
    model = (rng.normal(size=(n, 4, 4)) * 0.5).astype(F32)
    model[:, :, 3] = [0, 0, 0, 1]
    u = {"model": model, "view": rng.normal(size=(4, 4)).astype(F32),
         "projection": rng.normal(size=(4, 4)).astype(F32)}
    got = normalmap.normal_mapped_vertex_shader(
        {k: torch.from_numpy(v) for k, v in vin.items()},
        {k: torch.from_numpy(v) for k, v in u.items()})
    want = jnm.normal_mapped_vertex_shader(
        {k: jnp.asarray(v) for k, v in vin.items()},
        {k: jnp.asarray(v) for k, v in u.items()}, xp=jnp)
    for k in ("clip_position", "color", "uv", "normal"):
        _close(got[k], want[k])
    for k in ("world_normal", "world_tangent"):
        _close(got["data"][k], want["data"][k])


def test_normal_mapped_fragment_shader_matches_jax():
    """Seeded fragments over a packed atlas with a diffuse texture and a
    normal map, through each triangle's tex_* and nm_* regions (measured:
    within 1.2e-7); the registries are JAX's."""
    rng = np.random.default_rng(2)
    nm = scenes.bumps_normal_map(16, 4)
    tex = rng.uniform(0, 1, (8, 8, 4)).astype(F32)
    sc = scene_mod.build_scene_buffers([scene_mod.MeshInstance(
        primitives.plane(1.0), texture=tex, normal_texture=nm)])
    n = 500
    tri = {}
    for prefix, tid in (("tex", sc["tri_texture_id"][0]),
                        ("nm", sc["tri_normal_tex_id"][0])):
        oy, ox = sc["atlas_offsets"][tid]
        h, w = sc["atlas_sizes"][tid]
        for k, v in (("oy", oy), ("ox", ox), ("h", h), ("w", w)):
            tri[f"{prefix}_{k}"] = np.full(n, v, np.int32)
    frag = {"color": rng.uniform(0, 1, (n, 4)).astype(F32),
            "uv": rng.uniform(-2, 2, (n, 2)).astype(F32),
            "clip_position": rng.uniform(0, 120, (n, 4)).astype(F32),
            "data": {"world_normal": rng.normal(size=(n, 3)).astype(F32),
                     "world_tangent": np.concatenate(
                         [rng.normal(size=(n, 3)),
                          rng.choice([-1.0, 1.0], (n, 1))], -1)
                     .astype(F32)}}
    u = renderer.default_frame_uniforms(64, 48)
    u = {k: np.asarray(u[k], F32) for k in ("light_direction", "light_color",
                                            "fog_color", "fog_start",
                                            "fog_end")}
    u["atlas_data"] = sc["atlas_data"]

    def conv(x, f):
        return {k: conv(v, f) if isinstance(v, dict) else f(v)
                for k, v in x.items()}

    got = normalmap.normal_mapped_fragment_shader(
        dict(conv(frag, torch.from_numpy), tri=conv(tri, torch.from_numpy)),
        conv(u, lambda v: torch.from_numpy(np.asarray(v))))
    want = jnm.normal_mapped_fragment_shader(
        dict(conv(frag, jnp.asarray), tri=conv(tri, jnp.asarray)),
        conv(u, jnp.asarray), xp=jnp)
    _close(got, want)
    flat = normalmap.normal_mapped_fragment_shader(
        dict(conv(frag, torch.from_numpy),
             tri=conv(dict(tri, nm_h=tri["tex_h"] * 0), torch.from_numpy)),
        conv(u, lambda v: torch.from_numpy(np.asarray(v))))
    assert (got - flat).abs().max() > 0.05       # the map moves the light
    for attr in ("varyings", "tri_extras", "alpha_sources"):
        assert getattr(normalmap.normal_mapped_fragment_shader, attr) == \
            getattr(jnm.normal_mapped_fragment_shader, attr)


def lod_scene():
    """Eight spheres of two levels (12 px) and two of three (60, 20 px)
    at distances 2-80 from the origin camera, and a mesh without LOD.  At
    72, 240 and 1080 rows every projected radius lies outside 0.83-1.2
    times each threshold."""
    sphere = primitives.uv_sphere(1.0, rings=12, sectors=16)
    two = lod.add_lods(sphere, cells=(4,), px=(12.0,))
    three = lod.add_lods(sphere, cells=(6, 3), px=(60.0, 20.0))
    insts = [scene_mod.MeshInstance(primitives.cube(1.0),
                                    ml.translation([0, 0, -5]))]
    for d in (2.0, 4.5, 6.0, 13.0, 18.0, 26.0, 60.0, 80.0):
        insts.append(scene_mod.MeshInstance(
            two, ml.translation([0.4 * d, 0.0, -d])))
    for d in (5.0, 20.0):
        insts.append(scene_mod.MeshInstance(
            three, np.diag(F32([1.5, 1.5, 1.5, 1]))
            @ ml.translation([-0.3 * d, 0.0, -d])))
    return scene_mod.build_scene_buffers(insts)


@pytest.mark.parametrize("height", [72, 240, 1080])
def test_lod_tri_mask_matches_jax(height):
    """Every mesh's level equals JAX's at three frame heights, and the
    heights choose the levels expected of lod_scene's radii."""
    sc = lod_scene()
    u = renderer.default_frame_uniforms(96, height)
    got = lod.lod_tri_mask(scene_to_torch(sc, "cpu"),
                           renderer.device_uniforms(u, 96, height, "cpu"),
                           height)
    want = np.asarray(jlod.lod_tri_mask(
        {k: jnp.asarray(v) for k, v in sc.items()}, u, height, xp=jnp))
    np.testing.assert_array_equal(got.numpy(), want)
    mesh_level = np.zeros(sc["mesh_lod_px"].shape[0], np.int32)
    mesh_level[sc["tri_mesh_id"][want]] = sc["tri_lod_level"][want]
    assert mesh_level.tolist() == {
        72: [0, 0, 1, 1, 1, 1, 1, 1, 1, 2, 2],
        240: [0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2],
        1080: [0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 1]}[height]


@pytest.mark.parametrize("ssaa", [1, 2])
def test_posed_geometry_keeps_each_pass_levels(ssaa):
    """engine.posed_geometry at the main frame's height, handed to
    render_frame as the shadowed frames hand it, gives render_frame's own
    frame.  With ssaa the frame keeps the levels of its supersampled
    height (JAX's): here they differ from the shared mask's, and drawing
    the shared mask at that height changes the frame."""
    st = scene_to_torch(lod_scene(), "cpu")
    u = renderer.default_frame_uniforms(96, 72)
    params = RenderParams(96, 72, ssaa=ssaa)
    posed = renderer.posed_geometry(
        st, renderer.device_uniforms(u, 96, 72, "cpu"), 72)
    hi = params.replace(width=96 * ssaa, height=72 * ssaa, ssaa=1)
    own = lod.lod_tri_mask(
        st, renderer.device_uniforms(u, hi.width, hi.height, "cpu"),
        hi.height)
    assert torch.equal(posed["tri_mask"], own) == (ssaa == 1)
    want = renderer.render_frame(st, u, params)
    got = renderer.render_frame(st, u, params, posed=posed)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if ssaa > 1:
        shared = renderer.render_frame(st, u, hi, posed=posed)[0]
        assert not torch.equal(shared, renderer.render_frame(st, u, hi)[0])


def test_lod_host_helpers_match_jax():
    """decimate_indices, add_lods and the suggested caps equal JAX's."""
    m = primitives.uv_sphere(1.0, rings=12, sectors=16)
    for cells in (2, 4, 8):
        np.testing.assert_array_equal(
            lod.decimate_indices(m["position"], m["indices"], cells),
            jlod.decimate_indices(m["position"], m["indices"], cells))
    got, want = lod.add_lods(m), jlod.add_lods(m)
    assert got["lod_px"] == want["lod_px"]
    for g, w in zip(got["lod_indices"], want["lod_indices"]):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="descending"):
        lod.add_lods(m, px=(10.0, 20.0))
    sc = lod_scene()
    assert lod.suggested_active_cap(sc) == jlod.suggested_active_cap(sc)
    assert lod.suggested_geom_cap(sc) == jlod.suggested_geom_cap(sc)
    bare = scene_mod.build_scene_buffers([scene_mod.MeshInstance(m)])
    assert lod.suggested_active_cap(bare) == jlod.suggested_active_cap(bare)


def test_normal_mapped_frame_setup():
    """frame_setup packs the normal map's nm_* region for each clip-fan
    slot (the neutral texel for meshes without a map), and the tile
    route's plan interpolates the 3-wide world normal with the vec3
    renormalisation (pw3) and the 4-wide tangent without it (pw)."""
    from softwarerenderer_tpu_torch import RenderParams
    from softwarerenderer_tpu_torch.engine import frame_setup
    from softwarerenderer_tpu_torch.ops import tile_raster
    nm = scenes.bumps_normal_map(8, 2)
    sc = scene_mod.build_scene_buffers([
        scene_mod.MeshInstance(primitives.plane(4.0),
                               ml.translation([0, -1, -3]),
                               normal_texture=nm),
        scene_mod.MeshInstance(primitives.cube(1.0),
                               ml.translation([0, 0, -4]))])
    params = RenderParams(64, 48)
    fs = normalmap.normal_mapped_fragment_shader
    f = frame_setup(scene_to_torch(sc, "cpu"),
                    renderer.default_frame_uniforms(64, 48), params,
                    normalmap.normal_mapped_vertex_shader, fs)
    nid = np.repeat(sc["tri_normal_tex_id"], 2)
    for k, (table, col) in {"nm_oy": ("atlas_offsets", 0),
                            "nm_ox": ("atlas_offsets", 1),
                            "nm_h": ("atlas_sizes", 0),
                            "nm_w": ("atlas_sizes", 1)}.items():
        np.testing.assert_array_equal(f["per_tri"][k].numpy(),
                                      sc[table][nid, col])
    assert sorted(f["per_tri"]) == sorted(fs.tri_extras)
    assert len(set(sc["tri_normal_tex_id"].tolist())) == 2
    ctx = tile_raster.prepare(f["tris"], params, f["fb_depth"],
                              f["per_tri"], gb_keep=fs.varyings)
    kinds = {k: kind for (kind, lo, hi), k in zip(
        ctx["plan"], sorted(f["tris"]["attrs"]))}
    assert kinds["data.world_normal"] == "pw3"
    assert kinds["data.world_tangent"] == "pw"
