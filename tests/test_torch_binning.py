"""Port tile binning (softwarerenderer_tpu_torch.ops.binning) against the
JAX bin_triangles, fed the same triangles: every output exactly equal."""

import jax
import numpy as np
import pytest
import torch

from softwarerenderer_tpu import CullMode, RenderParams
from softwarerenderer_tpu.engine import renderer as jr
from softwarerenderer_tpu.models import primitives
from softwarerenderer_tpu.models import scene as scene_mod
from softwarerenderer_tpu.ops import binning as jbin
from softwarerenderer_tpu.ops import geometry as jgeom
from softwarerenderer_tpu_torch.ops import binning as tbin


def soup_tris(w, h, n, seed):
    """Set-up triangles of a random soup, built by the JAX geometry stage."""
    soup = primitives.random_triangle_soup(n, seed=seed)
    scene = scene_mod.build_scene_buffers([scene_mod.MeshInstance(soup)])
    u = jr.default_frame_uniforms(w, h)
    view, proj = jr.camera_matrices(u, w, h, xp=np)
    u.update(model=scene["mesh_matrices"][scene["vert_mesh_id"]],
             view=np.asarray(view), projection=np.asarray(proj))
    vin = {k: scene[k] for k in ("position", "uv", "normal", "color")}
    tris = jax.jit(lambda vin, idx, u: jgeom.build_triangles(
        jr.scene_vertex_shader, vin, idx, u, width=w, height=h,
        cull_mode=CullMode.NONE, near_clip=u["near_clip"]))(
            vin, scene["indices"], u)
    return {k: np.asarray(tris[k]) for k in ("bbox", "valid")}


@pytest.mark.parametrize("w,h,n,tile_h,tile_w,span_cap", [
    (136, 92, 300, 16, 128, 6),
    (320, 240, 500, 32, 128, 8),
    (320, 240, 500, 32, 128, 1),      # most triangles go global
    (200, 150, 200, 16, 64, 4),
])
def test_bin_triangles_matches_jax(w, h, n, tile_h, tile_w, span_cap):
    tris = soup_tris(w, h, n, seed=n + span_cap)
    params = RenderParams(width=w, height=h)
    ref = jbin.bin_triangles(tris, params, tile_h, tile_w, span_cap)
    got = tbin.bin_triangles({k: torch.tensor(v) for k, v in tris.items()},
                             params, tile_h, tile_w, span_cap)
    assert int(ref["n_global"]) == int(got["n_global"][0])
    for k in ("order", "sorted_tri", "starts", "counts"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert (got["ntx"], got["nty"]) == (ref["ntx"], ref["nty"])
    assert int(got["counts"].sum()) > 0
