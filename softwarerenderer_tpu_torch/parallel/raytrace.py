"""Multi-device ray tracing: the ray-traced frame's pixel rows sharded over
a mesh's "fb" axis.

Counterpart of ``softwarerenderer_tpu/parallel/raytrace.py``.  Ray tracing
is parallel over pixels: every rank holds the scene, traces its band of
rows through ``ops.raytrace.trace_pixel_rows`` (K4 once a band and cast)
and the bands are gathered; no other collective.  Rays carry their global
ids, which seed the soft-shadow jitter, so the sharded frame equals the
single-device frame bit for bit, with or without the bundle route's
clusters (each band culls against its own bundles).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from softwarerenderer_tpu_torch.config import RenderParams
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.parallel import collectives
from softwarerenderer_tpu_torch.parallel.sharding import mesh_device


def render_frame_raytraced_sharded(scene: Dict, uniforms: Dict,
                                   params: RenderParams, mesh: DeviceMesh,
                                   fragment_shader: Optional[Callable] = None,
                                   chunk: int = 512, shadows: bool = True,
                                   shadow_samples: int = 1,
                                   reflections: bool = False,
                                   cluster_cap: int = 0,
                                   cluster_group: int = 64,
                                   sweep: Optional[Callable] = None):
    """The ray-traced frame with pixel rows sharded over mesh axis "fb"
    (any other axis replicates), called by every rank with the same
    arguments.  Returns the whole (color (H, W, 4), depth (H, W)) on every
    rank; H must divide by the "fb" size.  Options as
    ops.raytrace.render_frame_raytraced's; chunk and cluster_group are
    JAX's and change nothing here."""
    from softwarerenderer_tpu_torch.ops import raytrace, sky
    D = mesh.size(mesh.mesh_dim_names.index("fb"))
    H, W = params.height, params.width
    if H % D:
        raise ValueError(f"height {H} not divisible by fb axis size {D}")
    dev = mesh_device(mesh)
    h = H // D
    r0 = mesh.get_local_rank("fb") * h
    dirs = sky.pixel_ray_directions(uniforms, W, H, device=dev)
    ray_ids = torch.arange(r0 * W, (r0 + h) * W, dtype=torch.int32,
                           device=dev).reshape(h, W)
    c, d = raytrace.trace_pixel_rows(
        scene_to_torch(scene, dev), uniforms, params,
        dirs[r0:r0 + h].contiguous(), ray_ids,
        fragment_shader=fragment_shader, shadows=shadows,
        shadow_samples=shadow_samples, reflections=reflections,
        cluster_cap=cluster_cap, sweep=sweep)
    bands = collectives.all_gather(torch.cat([c, d[..., None]], -1),
                                   mesh.get_group("fb"))
    frame = bands.reshape(H, W, 5)
    return frame[..., :4], frame[..., 4]
