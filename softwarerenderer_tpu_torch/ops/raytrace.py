"""Ray-traced frame: primary visibility, hard or soft shadows and one
mirror bounce, over the collision world.

Counterpart of ``softwarerenderer_tpu/ops/raytrace.py``.  Every pixel casts
a primary ray through the raster's camera model
(``sky.pixel_ray_directions``); hits shade through the same fragment-shader
ABI as the raster path (uv, color and world normal interpolated at the
hit's barycentrics, the triangle's atlas region); secondary rays toward
the light give exact shadows.  Outputs follow the raster conventions:
depth = -(ndcZ + 1) / 2 at the hit, DEPTH_CLEAR and the clear color on a
miss.

Two routes, as in JAX:

  * ``cluster_cap=0``, the brute route: every ray against every triangle
    through ``sim.raycast.raycast_batch``;
  * ``cluster_cap > 0``, the bundle route: 32x32-pixel ray bundles, culled
    against Morton clusters and swept by K4 (``ops/rt_sweep``,
    ``csrc/rt_sweep.cu``) with ``capb=None``, which can never overflow.
    As on JAX's Pallas route, ``cluster_cap``'s value and ``cluster_group``
    then change nothing.  Shadow rays use the any-hit sweep, soft-shadow
    samples stacked into the ray axis of one cast; reflections are a second
    nearest cast.

Both routes shade at the cast's own Möller–Trumbore barycentrics, so the
two give the same image (JAX's brute route re-derives them from the hit
point, which differs from them by ulps).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from softwarerenderer_tpu_torch.config import RenderParams
from softwarerenderer_tpu_torch.ops import rt_sweep, sky
from softwarerenderer_tpu_torch.ops.binning import cdiv
from softwarerenderer_tpu_torch.ops.raster import DEPTH_CLEAR
from softwarerenderer_tpu_torch.sim import raycast as rc
from softwarerenderer_tpu_torch.utils import mathlib as ml

F32 = torch.float32
I64 = torch.int64
HIT_KEYS = ("hit", "distance", "point", "normal", "tri", "u", "v")
# (rows, columns) of pixels in one ray bundle of the bundle route: K4 sweeps
# each bundle's 1,024 rays in one block (csrc/rt_sweep.cu).
BUNDLE = (32, 32)


def build_rt_world(scene: Dict[str, torch.Tensor], uniforms: Dict) -> Dict:
    """Collision world plus what shading reads per triangle: the (T, 22)
    ``shade_table`` (uv corners | atlas region | color corners) and the
    (T, 18) ``geom_table`` (v0 | e1 | e2 | n0 | n1 | n2), each one row
    gather per ray.  uniforms["mesh_visible"] (host bools per mesh) folds
    into ``tri_mask``."""
    world = rc.build_collision_world(scene)
    dev = world["v0"].device
    idx = scene["indices"].long()
    uv = scene["uv"].to(F32)[idx]                                # (T, 3, 2)
    col = scene["color"].to(F32)[idx]                            # (T, 3, 4)
    tid = scene["tri_texture_id"].long()
    aoff, asiz = scene["atlas_offsets"], scene["atlas_sizes"]
    mask = None
    if "mesh_visible" in uniforms:
        vis = torch.from_numpy(np.asarray(uniforms["mesh_visible"], bool))
        mask = vis.to(dev)[world["tri_mesh_id"].long()]
    region = torch.stack([aoff[:, 0][tid], aoff[:, 1][tid], asiz[:, 0][tid],
                          asiz[:, 1][tid]], 1)
    world.update(tri_mask=mask)
    world["shade_table"] = torch.cat([uv.reshape(-1, 6), region.to(F32),
                                      col.reshape(-1, 12)], 1)
    world["geom_table"] = torch.cat([
        world["v0"], world["v1"] - world["v0"], world["v2"] - world["v0"],
        world["n0"], world["n1"], world["n2"]], 1)
    return world


def _shade_hits(hits: Dict, world: Dict, uniforms: Dict,
                fragment_shader: Callable, white_colors: bool = False):
    """Build the raster-ABI frag dict at each hit (flat (N,) leaves with
    the winner's barycentrics "u"/"v") and run the fragment shader;
    returns (rgba (N, 4), depth (N,)).  white_colors skips the vertex-color
    interpolation for scenes whose colors are all white."""
    u, v = hits["u"], hits["v"]
    w = 1.0 - u - v
    bary = torch.stack([w, u, v], -1)[..., None]                 # (N, 3, 1)
    tbl = world["shade_table"][hits["tri"].long()]               # (N, 22)
    uv = (tbl[:, 0:6].reshape(-1, 3, 2) * bary).sum(1)
    region = {k: tbl[:, 6 + i].to(torch.int32)
              for i, k in enumerate(("tex_oy", "tex_ox", "tex_h", "tex_w"))}
    if white_colors:
        col = torch.ones(uv.shape[:-1] + (4,), dtype=F32, device=uv.device)
    else:
        col = (tbl[:, 10:22].reshape(-1, 3, 4) * bary).sum(1)
    clip = ml.transform(ml.transform(ml.homogenize(hits["point"]),
                                     uniforms["view"]),
                        uniforms["projection"])                   # (N, 4)
    wc = clip[..., 3]
    ndc_z = clip[..., 2] / torch.where(wc == 0, 1.0, wc)
    # The raster stores the negated (ndcZ + 1) / 2 so its (depth, index)
    # max-fold picks the nearest fragment; ray-traced depth matches it.
    depth = -((ndc_z + 1.0) * 0.5)
    frag = {"uv": uv, "color": col, "clip_position": clip,
            "normal": hits["normal"],
            "data": {"world_normal": hits["normal"]}, "tri": region}
    return fragment_shader(frag, uniforms), depth


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to the int32 they wrap to, still int64."""
    return ((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def shadow_hash(ray_id: torch.Tensor, s: int) -> torch.Tensor:
    """JAX's _shadow_dir integer mix of flat ray ids at sample s, int32
    arithmetic with wraparound and arithmetic shifts, computed in int64 so
    that every wrap is explicit."""
    hh = _wrap_i32(ray_id.to(I64) * -1640531535 + 40503 * (s + 1))
    hh = hh ^ (hh >> 13)
    hh = _wrap_i32(hh * -1028477387)                  # 0xc2b2ae35 as i32
    return (hh ^ (hh >> 16)).to(torch.int32)


def _shadow_dir(ray_id, s, light, lt1, lt2, sradius):
    """Deterministic disc-light jitter direction for flat (N,) ray ids at
    sample s (JAX's _shadow_dir): shared by both routes, so both cast the
    same shadow rays."""
    hh = shadow_hash(ray_id, s)
    a = (hh & 0x7FFFFF).to(F32) * float(np.float32(2 * np.pi / 0x800000))
    r = torch.sqrt(((hh >> 8) & 0xFFFF).to(F32)
                   / torch.full((), 0xFFFF, dtype=F32, device=hh.device))
    jx = torch.cos(a) * r
    jy = torch.sin(a) * r
    return ml.safe_normalize(
        -light[None] + (jx[:, None] * lt1[None] + jy[:, None] * lt2[None])
        * sradius)


def render_frame_raytraced(scene: Dict[str, torch.Tensor], uniforms: Dict,
                           params: RenderParams,
                           vertex_shader: Optional[Callable] = None,
                           fragment_shader: Optional[Callable] = None,
                           shadows: bool = True, shadow_samples: int = 1,
                           reflections: bool = False, cluster_cap: int = 0,
                           cluster_group: int = 64,
                           rt_white_colors: bool = False,
                           sweep: Optional[Callable] = None):
    """Engine-compatible frame function (``Engine(scene, params,
    frame_fn=render_frame_raytraced)``): returns (color (H, W, 4), depth
    (H, W)) on the scene's device.

    vertex_shader is accepted for the signature and ignored: primary rays
    are the camera transform.  shadows: rays from just off each hit toward
    -light_direction; occluded hits fall toward uniforms["rt_shadow_floor"]
    (default 0.35) of their color.  shadow_samples with
    uniforms["rt_light_radius"] > 0 jitters them over a disc light (soft
    shadows) by an integer hash of the pixel.  reflections: one mirror
    bounce at the smooth normal, mixed by uniforms["rt_reflectivity"]
    (default 0.25).  cluster_cap > 0 takes the bundle route (module
    docstring), whose casts go through `sweep`: rt_sweep.rt_sweep (K4) by
    default, rt_sweep.rt_sweep_plain for the same frame through the plain
    twin.  cluster_group is accepted for JAX's callers and changes
    nothing."""
    H, W = params.height, params.width
    dev = scene["position"].device
    dirs = sky.pixel_ray_directions(uniforms, W, H, device=dev)
    ray_ids = torch.arange(H * W, dtype=torch.int32,
                           device=dev).reshape(H, W)
    return trace_pixel_rows(scene, uniforms, params, dirs, ray_ids,
                            fragment_shader=fragment_shader, shadows=shadows,
                            shadow_samples=shadow_samples,
                            reflections=reflections, cluster_cap=cluster_cap,
                            rt_white_colors=rt_white_colors, sweep=sweep)


def trace_pixel_rows(scene: Dict[str, torch.Tensor], uniforms: Dict,
                     params: RenderParams, dirs: torch.Tensor,
                     ray_ids: torch.Tensor, *,
                     fragment_shader: Optional[Callable] = None,
                     shadows: bool = True, shadow_samples: int = 1,
                     reflections: bool = False, cluster_cap: int = 0,
                     rt_white_colors: bool = False,
                     sweep: Optional[Callable] = None):
    """Trace an (h, W) block of pixel rays: `dirs` (h, W, 3) world ray
    directions, `ray_ids` (h, W) int32 global ray indices (they seed the
    soft-shadow jitter).  The camera comes from `uniforms` and params (the
    full frame's).  Returns (color (h, W, 4), depth (h, W)) with the
    background composited; options as render_frame_raytraced's."""
    from softwarerenderer_tpu_torch.engine.renderer import (
        device_uniforms, scene_fragment_shader)

    if "sky_panorama" in uniforms:
        raise NotImplementedError("not implemented in "
                                  "softwarerenderer_tpu_torch yet: "
                                  "['sky_panorama']")
    fragment_shader = fragment_shader or scene_fragment_shader
    h, W = dirs.shape[0], dirs.shape[1]
    dev = dirs.device

    with record_function("rt.world"):
        u = device_uniforms(uniforms, params.width, params.height, dev)
        u["atlas_data"] = scene["atlas_data"]
        world = build_rt_world(scene, uniforms)
        tri_mask = world["tri_mask"]
        eye = u["camera_position"]
        light = ml.safe_normalize(u["light_direction"])

        def scalar(key, default):
            return u[key] if key in u else torch.full((), default, dtype=F32,
                                                      device=dev)
        floor = scalar("rt_shadow_floor", 0.35)
        sradius = scalar("rt_light_radius", 0.0)
        refl_amt = scalar("rt_reflectivity", 0.25)
        # Orthonormal basis around the light direction for the disc jitter.
        axes = torch.eye(3, dtype=F32, device=dev)
        helper = torch.where(light[0].abs() < 0.9, axes[0], axes[1])
        lt1 = ml.safe_normalize(ml.cross(light, helper))
        lt2 = ml.cross(light, lt1)
        S = max(1, shadow_samples)
        n_samples = torch.full((), S, dtype=F32, device=dev)

    def background(n):
        return u["clear_color"].expand(n, 4)

    def mix_reflection(rgba, rh):
        rrgba, _ = _shade_hits(rh, world, u, fragment_shader,
                               rt_white_colors)
        refl = torch.where(rh["hit"][:, None], rrgba,
                           background(rrgba.shape[0]))
        return torch.cat([rgba[..., :3] + (refl[..., :3] - rgba[..., :3])
                          * refl_amt, rgba[..., 3:]], -1)

    def shade_lit(rgba, occl):
        vis = 1.0 - occl / n_samples
        lit = (floor + (1.0 - floor) * vis)[:, None]
        return torch.cat([rgba[..., :3] * lit, rgba[..., 3:]], -1)

    if cluster_cap:
        color, depth = _bundle_route(
            world, u, dirs, ray_ids, eye, tri_mask, fragment_shader,
            rt_white_colors, shadows, S, reflections, sweep,
            (light, lt1, lt2, sradius), mix_reflection, shade_lit)
    else:
        color, depth = _brute_route(
            world, u, dirs, ray_ids, eye, tri_mask, fragment_shader,
            rt_white_colors, shadows, S, reflections,
            (light, lt1, lt2, sradius), mix_reflection, shade_lit)

    with record_function("rt.composite"):
        covered = depth != DEPTH_CLEAR
        color = torch.where(covered[..., None], color,
                            u["clear_color"].expand(h, W, 4))
    return color, depth


def _brute_route(world, u, dirs, ray_ids, eye, tri_mask, fragment_shader,
                 white, shadows, S, reflections, light_basis,
                 mix_reflection, shade_lit):
    h, W = dirs.shape[0], dirs.shape[1]
    d = dirs.reshape(-1, 3)
    ids = ray_ids.reshape(-1)

    def cast(o, dd):
        with record_function("rt.brute_cast"):
            return rc.raycast_batch_bary(o, dd, world, rc.FACE_MASK_NONE,
                                         tri_mask)
    hits = cast(eye.expand_as(d), d)
    with record_function("rt.shade"):
        rgba, depth = _shade_hits(hits, world, u, fragment_shader, white)
        off = hits["point"] + hits["normal"] * 1e-3
    if reflections:
        with record_function("rt.shade"):
            n = hits["normal"]
            rdir = d - 2.0 * ml.dot(d, n)[:, None] * n
        rh = cast(off, rdir)
        with record_function("rt.shade"):
            rgba = mix_reflection(rgba, rh)
    if shadows:
        occl = torch.zeros(d.shape[0], dtype=F32, device=d.device)
        for s in range(S):
            with record_function("rt.shade"):
                sdir = _shadow_dir(ids, s, *light_basis)
            occl = occl + cast(off, sdir)["hit"].to(F32)
        with record_function("rt.shade"):
            rgba = shade_lit(rgba, occl)
    ok = hits["hit"]
    color = torch.where(ok[:, None], rgba, 0.0).reshape(h, W, 4)
    return color, torch.where(ok, depth, DEPTH_CLEAR).reshape(h, W)


def _bundle_route(world, u, dirs, ray_ids, eye, tri_mask, fragment_shader,
                  white, shadows, S, reflections, sweep,
                  light_basis, mix_reflection, shade_lit):
    h, W = dirs.shape[0], dirs.shape[1]
    dev = dirs.device
    th, tw = min(BUNDLE[0], h), min(BUNDLE[1], W)
    hp, Wp = cdiv(h, th) * th, cdiv(W, tw) * tw
    nth, ntw = hp // th, Wp // tw
    B, R = nth * ntw, th * tw

    with record_function("rt.accel"):
        accel = rt_sweep.build_rt_accel_pl(world)
        # Edge padding (JAX's jnp.pad mode="edge"): the pad rays replicate
        # the last row and column and take part in the bundle bounds.
        rows = torch.arange(hp, device=dev).clamp(max=h - 1)
        cols = torch.arange(Wp, device=dev).clamp(max=W - 1)
        d_t = dirs[rows][:, cols].reshape(nth, th, ntw, tw, 3) \
            .permute(0, 2, 1, 3, 4).reshape(B, R, 3)
        i_t = ray_ids[rows][:, cols].reshape(nth, th, ntw, tw) \
            .permute(0, 2, 1, 3).reshape(B * R)

    def cast_nearest(o_b, d_b):
        res = rt_sweep.raycast_bundles_nearest(
            o_b, d_b, world, accel, face_mask=rc.FACE_MASK_NONE,
            tri_mask=tri_mask, sweep=sweep)
        return res, {k: res[k].reshape((B * R,) + res[k].shape[2:])
                     for k in HIT_KEYS}

    prim, hits = cast_nearest(eye.expand(B, R, 3), d_t)
    with record_function("rt.shade"):
        rgba, depth = _shade_hits(hits, world, u, fragment_shader, white)
        hit_b = prim["hit"]
        off = prim["point"] + prim["normal"] * 1e-3                # (B, R, 3)
        # Miss rays start their secondary rays from the bundle's mean hit
        # point, so its bounds stay tight; an all-miss bundle gets NaN
        # origins, which keep no cluster alive (its results are discarded).
        nhit = hit_b.to(F32).sum(1)
        ctr = torch.where(hit_b[..., None], off, 0.0).sum(1) \
            / torch.clamp(nhit, min=1.0)[:, None]
        ctr = torch.where((nhit > 0)[:, None], ctr, math.nan)
        off = torch.where(hit_b[..., None], off, ctr[:, None, :])
    if reflections:
        with record_function("rt.shade"):
            n = prim["normal"]
            rdir = d_t - 2.0 * ml.dot(d_t, n)[..., None] * n
        _, rh = cast_nearest(off, rdir)
        with record_function("rt.shade"):
            rgba = mix_reflection(rgba, rh)
    if shadows:
        with record_function("rt.shade"):
            sdirs = torch.stack([_shadow_dir(i_t, s, *light_basis)
                                 .reshape(B, R, 3) for s in range(S)], 1)
        sh = rt_sweep.raycast_bundles_any(
            off[:, None].expand(B, S, R, 3).reshape(B, S * R, 3),
            sdirs.reshape(B, S * R, 3), world, accel,
            face_mask=rc.FACE_MASK_NONE, tri_mask=tri_mask, sweep=sweep)
        with record_function("rt.shade"):
            occl = sh["hit"].reshape(B, S, R).to(F32).sum(1).reshape(-1)
            rgba = shade_lit(rgba, occl)
    with record_function("rt.composite"):
        ok = hits["hit"]
        color = torch.where(ok[:, None], rgba, 0.0)
        depth = torch.where(ok, depth, DEPTH_CLEAR)
        color = color.reshape(nth, ntw, th, tw, 4).permute(0, 2, 1, 3, 4) \
            .reshape(hp, Wp, 4)[:h, :W]
        depth = depth.reshape(nth, ntw, th, tw).permute(0, 2, 1, 3) \
            .reshape(hp, Wp)[:h, :W]
    return color, depth
