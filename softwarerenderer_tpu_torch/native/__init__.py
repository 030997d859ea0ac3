"""Native (C++) asset-pipeline kernels with ctypes bindings.

Build: `python -m softwarerenderer_tpu_torch.native.build` (or it happens
automatically on first import when g++ is available).  Every entry point
has a NumPy fallback, so the framework works without the library.
"""

from softwarerenderer_tpu_torch.native.binding import (  # noqa: F401
    accessor_to_f32,
    bake_normals,
    bake_positions,
    bounding_sphere_native,
    is_available,
    scale_pcm16,
)
