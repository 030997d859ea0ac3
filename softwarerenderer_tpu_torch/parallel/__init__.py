"""The multi-device layer on torch.distributed, one process a rank.

Counterpart of ``softwarerenderer_tpu/parallel``: framebuffer and triangle
sharding (``sharding``), the ring pass (``ring``), view-parallel frames
(``multiview``), ray-traced bands (``raytrace``) and the multi-process
bootstrap (``multihost``).  Every rank calls the same function (SPMD);
NCCL carries the collectives between cards, gloo on the CPU
(``collectives``).  JAX's ``_compat.py``, which locates ``shard_map``
across JAX versions, has no counterpart: nothing here is a single
controller over many devices.
"""

from softwarerenderer_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    render_frame_sharded,
    shard_scene_triangles,
)
from softwarerenderer_tpu_torch.parallel.ring import (  # noqa: F401
    make_ring_mesh,
    render_frame_ring,
)
from softwarerenderer_tpu_torch.parallel.multiview import (  # noqa: F401
    make_view_mesh,
    render_frame_views,
    stack_views,
)
from softwarerenderer_tpu_torch.parallel.raytrace import (  # noqa: F401
    render_frame_raytraced_sharded,
)
from softwarerenderer_tpu_torch.parallel import multihost  # noqa: F401
