"""The JAX package's counterparts of tests/torch_parallel_ranks.py's cases.

Not a test module: tests/test_torch_parallel*.py render these in the test
process, on the virtual CPU mesh that tests/conftest.py sets up, while
their gloo ranks render the port's frames, and hold the two against each
other (jax_frame, close).  The ranks never import this module.
"""

from __future__ import annotations

import functools

import numpy as np

import torch_parallel_ranks as ranks

# The rasterised frames against JAX's jitted ones: PERF.md section 2's
# raster limit for scenes that are not simple (D5), at most 0.5 % of pixels
# off by > 1e-5.  On the small scene the port's single-device frame equals
# the JAX package's run op by op on every pixel and misses its jitted frame
# on 0.37 % (texel flips on the checkered floor: XLA contracts the uv
# interpolation into FMAs), and each package's sharded frame equals its
# single-device frame, so the sharded frames differ by that same share.
RASTER_OFF_MAX = 5e-3
# Cases whose share exceeds it, each bound about twice its measured share
# (PERF.md section 2's rule for frames against JAX's jitted ones; CPU
# test, PR 16): the port's single-device frame equals the JAX package's
# run op by op on every pixel at each of these, and the sharded frames
# equal the single-device ones, so the share is XLA's contraction alone.
# The 128x100 frame's flips 0.70 %; ssaa's 0.53 % after the box filter;
# FXAA spreads each flip to its neighbours, 1.48 %.
OFF_MAX = {"mesh_4x1_ragged": 1.5e-2, "ssaa": 1.1e-2, "post_fx": 3e-2}
# The ray-traced frames: tests/test_torch_raytrace.py's limits, coverage
# flipped on under 0.2 % of pixels, depth within 1e-5 where both cover,
# colour within 1e-3 on over 99 % of pixels.  The brute route's soft
# shadows and reflections on the small scene miss that colour bound on
# 1.11 % of pixels (0.83 % against JAX run op by op; 0.47 % between JAX's
# own op-by-op and jitted frames), so their bound is twice that share.
RT_FLIP_MAX, RT_DEPTH_ATOL, RT_COLOR_SHARE = 2e-3, 1e-5, 0.99
RT_COLOR_SHARE_OF = {"raytraced_2": 0.978, "raytraced_4": 0.978}


def _params(w, h, **kw):
    from softwarerenderer_tpu import RenderParams
    return RenderParams(width=w, height=h, **kw)


def _run(mesh, fn, *args):
    import jax
    with mesh:
        return tuple(np.asarray(x) for x in jax.jit(fn)(*args))


def _sharded(shape, scene, u, params, balanced=False, shaders=None):
    from softwarerenderer_tpu.parallel import (make_mesh,
                                               render_frame_sharded,
                                               shard_scene_triangles)
    mesh = make_mesh(*shape)
    return _run(mesh, functools.partial(
        render_frame_sharded, params=params, mesh=mesh, balanced=balanced,
        **(shaders or {})), shard_scene_triangles(scene, shape[1]), u)


def _dim(color, depth, uniforms):
    """torch_parallel_ranks._fxaa_then_dim in JAX: halves the red
    channel."""
    import jax.numpy as jnp
    return color * jnp.asarray([0.5, 1.0, 1.0, 1.0], jnp.float32)


def _animated_shaders():
    from softwarerenderer_tpu.ops import normalmap
    return dict(vertex_shader=normalmap.normal_mapped_vertex_shader,
                fragment_shader=normalmap.normal_mapped_fragment_shader)


def _ring(n, scene, u, params):
    from softwarerenderer_tpu.parallel import shard_scene_triangles
    from softwarerenderer_tpu.parallel.ring import (make_ring_mesh,
                                                    render_frame_ring)
    mesh = make_ring_mesh(n)
    return _run(mesh, functools.partial(render_frame_ring, params=params,
                                        mesh=mesh),
                shard_scene_triangles(scene, n), u)


def _views(v, scene, u, params):
    from softwarerenderer_tpu.parallel import (make_view_mesh,
                                               render_frame_views,
                                               stack_views)
    mesh = make_view_mesh(v)
    return _run(mesh, lambda s, uu, vs: render_frame_views(
        s, uu, params, vs, mesh), scene, u,
        stack_views(ranks._view_overrides(v)))


def _raytraced(n_fb, cap, scene, u):
    from jax.sharding import Mesh
    from softwarerenderer_tpu.parallel import (make_mesh,
                                               render_frame_raytraced_sharded)
    opts = dict(cluster_cap=cap) if cap else dict(shadow_samples=2,
                                                  reflections=True)
    params = _params(ranks.W, ranks.H, pallas_interpret=bool(cap))
    mesh = Mesh(np.asarray(make_mesh(n_fb, 1).devices).reshape(-1), ("fb",))
    return _run(mesh, functools.partial(
        render_frame_raytraced_sharded, params=params, mesh=mesh, **opts),
        scene, u)


def jax_frame(name: str):
    """The JAX package's frame of case `name` of torch_parallel_ranks.cases
    (the same packed scene, uniforms and params, on a mesh of the same
    shape), or None for a case that renders no frame."""
    W, H, P = ranks.W, ranks.H, ranks.PARAMS
    small, u = ranks.small_scene(), ranks.small_uniforms()
    p = _params(W, H, **P)
    if name.startswith("mesh_"):
        a, b = (int(x) for x in name.split("_")[1].split("x"))
        if name.endswith("ragged"):
            return _sharded((a, b), small, ranks.small_uniforms(W, 100),
                            _params(W, 100, **P))
        return _sharded((a, b), small, u, p)
    if name == "deferred_2x2":
        return _sharded((2, 2), small, u, _params(W, H, use_pallas=False,
                                                  **P))
    if name.startswith("balanced_"):
        bw, bh = ranks.BALANCED_SIZE
        shape = (2, 2) if name.endswith("2x2") else (4, 1)
        return _sharded(shape, ranks.bottom_heavy_scene(),
                        ranks.downward_uniforms(bw, bh),
                        _params(bw, bh, **P),
                        balanced="tiles" if "tiles" in name else True)
    if name == "ssaa":
        return _sharded((2, 2), small, u, _params(W, H, ssaa=2, **P))
    if name == "post_fx":
        return _sharded((2, 2), small, u, _params(
            W, H, fxaa=True, post_fx=("fxaa", _dim), **P))
    if name == "animated":
        # JAX's sharded frame cannot take the normal-mapped shader: its
        # fused resolve packs no per-triangle extras (KeyError "nm_oy"), so
        # this case is held against JAX's single-device frame.
        import jax
        from softwarerenderer_tpu.engine.renderer import render_frame
        return tuple(np.asarray(x) for x in jax.jit(functools.partial(
            render_frame, params=_params(*ranks.ANIMATED_SIZE),
            **_animated_shaders()))(ranks._animated(),
                                    ranks._animated_uniforms()))
    if name.startswith("kbuffer_") and name != "kbuffer_tri_refused":
        # JAX peels balanced rows only through its tile kernel (interpreted
        # off the TPU), as the port peels through K1 and K2.
        rows = name.endswith("rows")
        kp = _params(*ranks.KBUFFER_SIZE, kbuffer=4, cull_mode=0, tile_h=8,
                     tile_w=32, pallas_interpret=rows)
        return _sharded((4, 1), ranks._translucent(),
                        ranks._kbuffer_uniforms(), kp, balanced=rows)
    if name.startswith("ring_"):
        return _ring(int(name[5:]), small, u, _params(W, H))
    if name.startswith("views_"):
        return _views(int(name[6:]), small, u, p)
    if name.startswith("raytraced_"):
        n_fb = int(name.split("_")[1])
        ru = dict(u, rt_light_radius=np.float32(0.3))
        return _raytraced(n_fb, ranks.RT_CAP if name.endswith("cap") else 0,
                          small, ru)
    return None


def close(name: str, got, want) -> dict:
    """The port's frame `got` against JAX's `want` under the case's limits
    (ray-traced or raster); raises AssertionError past them and returns
    the measured shares."""
    (c, d), (jc, jd) = got, want
    assert c.shape == jc.shape and d.shape == jd.shape, name
    if name.startswith("raytraced_"):
        from softwarerenderer_tpu.ops.raster import DEPTH_CLEAR
        flip = (d == DEPTH_CLEAR) != (jd == DEPTH_CLEAR)
        cov = (jd != DEPTH_CLEAR) & ~flip
        color_ok = (np.abs(c - jc).max(-1) < 1e-3).mean()
        assert flip.mean() < RT_FLIP_MAX, (name, flip.mean())
        assert cov.mean() > 0.3, name
        np.testing.assert_allclose(d[cov], jd[cov], rtol=0,
                                   atol=RT_DEPTH_ATOL, err_msg=name)
        assert color_ok > RT_COLOR_SHARE_OF.get(name, RT_COLOR_SHARE), \
            (name, color_ok)
        return {"flip": float(flip.mean()), "color_ok": float(color_ok)}
    color_off = (np.abs(c - jc).max(-1) > 1e-5).mean()
    depth_off = (np.abs(d - jd) > 1e-5).mean()
    bound = OFF_MAX.get(name, RASTER_OFF_MAX)
    assert color_off <= bound, (name, color_off)
    assert depth_off <= bound, (name, depth_off)
    return {"color_off": float(color_off), "depth_off": float(depth_off)}
