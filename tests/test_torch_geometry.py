"""Port geometry stage (softwarerenderer_tpu_torch.ops.geometry) against the
JAX build_triangles on the same packed scene and the same uniforms."""

import jax
import numpy as np
import pytest
import torch

from softwarerenderer_tpu import CullMode
from softwarerenderer_tpu.engine import renderer as jr
from softwarerenderer_tpu.models import primitives
from softwarerenderer_tpu.models import scene as scene_mod
from softwarerenderer_tpu.ops import geometry as jgeom
from softwarerenderer_tpu.ops import texture as tex_np
from softwarerenderer_tpu.utils import mathlib as ml
from softwarerenderer_tpu_torch.engine import renderer as tr
from softwarerenderer_tpu_torch.ops import geometry as tgeom

W, H = 136, 92


def cubes_scene():
    """The plane and 11 cubes of tests/test_pallas_raster.py."""
    checker = np.asarray(tex_np.checkerboard(16, 4)["data"])
    insts = [scene_mod.MeshInstance(primitives.plane(20.0),
                                    ml.translation([0, -1, 0]),
                                    texture=checker),
             scene_mod.MeshInstance(primitives.cube(0.8),
                                    ml.translation([0, 0, -3]),
                                    texture=checker)]
    rng = np.random.default_rng(0)
    for _ in range(10):
        pos = rng.uniform(-4, 4, 3).astype(np.float32)
        pos[1] = rng.uniform(-0.5, 1.5)
        insts.append(scene_mod.MeshInstance(primitives.cube(0.5),
                                            ml.translation(pos),
                                            texture=checker))
    return scene_mod.build_scene_buffers(insts)


def nearclip_scene():
    """Triangles straddling the camera plane, so the near clip fires."""
    soup = primitives.random_triangle_soup(120, seed=5, extent=0.5,
                                           z_range=(-2.0, 0.5))
    return scene_mod.build_scene_buffers([scene_mod.MeshInstance(soup)])


SCENES = {"cubes": (cubes_scene, np.float32([0, 0.5, 3.0])),
          "nearclip": (nearclip_scene, np.float32([0, 0, 0]))}


def frame_uniforms(scene, cam):
    u = jr.default_frame_uniforms(W, H)
    u["camera_position"] = cam
    view, proj = jr.camera_matrices(u, W, H, xp=np)
    u.update(model=scene["mesh_matrices"][scene["vert_mesh_id"]],
             view=np.asarray(view), projection=np.asarray(proj))
    return u


def both_builds(name, keep, cull):
    make, cam = SCENES[name]
    scene = make()
    u = frame_uniforms(scene, cam)
    vin = {k: scene[k] for k in ("position", "uv", "normal", "color")}
    rng = np.random.default_rng(1)
    mask = rng.uniform(size=scene["indices"].shape[0]) < 0.9

    def jax_build(vin, idx, u, mask):
        return jgeom.build_triangles(
            jr.scene_vertex_shader, vin, idx, u, width=W, height=H,
            cull_mode=cull, near_clip=u["near_clip"], tri_mask=mask,
            keep_varyings=keep)

    # Op by op, not under jit: XLA then rounds every operation once, as
    # torch does, instead of contracting multiply-adds into FMAs.
    ref = jax.tree_util.tree_map(np.asarray, jax_build(
        vin, scene["indices"], u, mask))
    tu = {k: torch.from_numpy(np.asarray(v, np.float32))
          for k, v in u.items() if k in ("model", "view", "projection",
                                         "near_clip")}
    got = tgeom.build_triangles(
        tr.scene_vertex_shader,
        {k: torch.from_numpy(v) for k, v in vin.items()},
        torch.from_numpy(scene["indices"]), tu, width=W, height=H,
        cull_mode=cull, tri_mask=torch.from_numpy(mask), keep_varyings=keep)
    return ref, {k: (v.numpy() if torch.is_tensor(v)
                     else {a: b.numpy() for a, b in v.items()})
                 for k, v in got.items()}


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("keep,cull", [
    (jr.scene_fragment_shader.varyings, CullMode.BACK),
    (None, CullMode.NONE)])
def test_build_triangles_matches_jax(name, keep, cull):
    ref, got = both_builds(name, keep, cull)
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    v = ref["valid"]
    assert v.sum() > 10
    # bbox is read only for valid triangles (binning masks the rest), and
    # an invalid triangle's float->int cast differs between backends.
    np.testing.assert_array_equal(got["bbox"][v], ref["bbox"][v])
    tol = dict(rtol=1e-6, atol=1e-5)
    for k in ("screen", "depth", "inv_area", "area"):
        np.testing.assert_allclose(got[k][v], ref[k][v], **tol, err_msg=k)
    assert sorted(got["attrs"]) == sorted(ref["attrs"])
    for k in ref["attrs"]:
        np.testing.assert_allclose(got["attrs"][k][v], ref["attrs"][k][v],
                                   **tol, err_msg=k)


def test_nearclip_scene_clips():
    """The near-plane scene really exercises the clipper: some input
    triangles emit a valid second fan slot."""
    ref, got = both_builds("nearclip", None, CullMode.NONE)
    assert got["valid"][1::2].any()
    np.testing.assert_array_equal(got["valid"], ref["valid"])
