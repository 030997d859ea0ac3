"""View-parallel rendering: one rank a camera.

Counterpart of ``softwarerenderer_tpu/parallel/multiview.py``.  Split
screens, CCTV walls and stereo pairs share the scene and differ only in
the camera, so each rank of a ("view",) mesh renders the complete
single-device frame (``engine.render_frame``, K1 on the tile route) on
its own view, and the views are gathered: no other collective.  The
scale-out form of ``engine.render_frame_multiview``, which tiles the views
into one frame on one device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from softwarerenderer_tpu_torch.config import RenderParams
from softwarerenderer_tpu_torch.models.convert import scene_to_torch
from softwarerenderer_tpu_torch.parallel import collectives
from softwarerenderer_tpu_torch.parallel.sharding import (make_mesh,
                                                          mesh_device)

AXIS = "view"


def make_view_mesh(n_views: int, device=None) -> DeviceMesh:
    """A ("view",) DeviceMesh over ranks 0 .. n_views - 1 (every rank calls
    it; devices as sharding.make_mesh)."""
    mesh = make_mesh(n_views, 1, device=device)
    return DeviceMesh(mesh.device_type, torch.arange(n_views),
                      mesh_dim_names=(AXIS,))


def stack_views(views) -> Dict:
    """Per-view uniform overrides stacked along a leading view axis (the
    views_stacked input of render_frame_views): numpy arrays, or tensors
    where every view gives a tensor.  Every view must override the same
    keys."""
    if not views:
        raise ValueError("views must be non-empty")
    keys = set(views[0])
    for ov in views[1:]:
        if set(ov) != keys:
            raise ValueError("every view must override the same keys "
                             f"(got {sorted(keys)} vs {sorted(set(ov))})")
    out = {}
    for k in sorted(keys):
        vals = [ov[k] for ov in views]
        out[k] = torch.stack(vals) if all(
            isinstance(v, torch.Tensor) for v in vals) \
            else np.stack([np.asarray(v) for v in vals])
    return out


def render_frame_views(scene: Dict, uniforms: Dict, params: RenderParams,
                       views_stacked: Dict, mesh: DeviceMesh,
                       vertex_shader: Optional[Callable] = None,
                       fragment_shader: Optional[Callable] = None,
                       chunk: int = 128):
    """One whole frame a rank of the mesh's "view" axis, called by every
    rank with the same arguments: `uniforms` overridden by the rank's
    slice of views_stacked (leading axis V, the mesh's size; stack_views),
    rendered by render_frame, so equal to that view rendered alone.
    Returns (color (V, H, W, 4), depth (V, H, W)) on every rank.  chunk
    is JAX's working-set size and changes nothing here."""
    from softwarerenderer_tpu_torch.engine import renderer
    V = mesh.size()
    for k, a in views_stacked.items():
        if a.shape[0] != V:
            raise ValueError(f"views_stacked[{k!r}] leading axis "
                             f"{a.shape[0]} != mesh view size {V}")
    i = mesh.get_local_rank(AXIS)
    u = dict(uniforms)
    u.update({k: a[i] for k, a in views_stacked.items()})
    c, d = renderer.render_frame(
        scene_to_torch(scene, mesh_device(mesh)), u, params,
        vertex_shader or renderer.scene_vertex_shader,
        fragment_shader or renderer.scene_fragment_shader)[:2]
    out = collectives.all_gather(torch.cat([c, d[..., None]], -1),
                                 mesh.get_group(AXIS))
    return out[..., :4], out[..., 4]
