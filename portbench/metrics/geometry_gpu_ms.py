"""geometry_gpu_ms: kernel ms a frame inside frame.camera_cull and
frame.geometry (ops/geometry.py, ops/lod.py); nothing when those spans
held no kernel."""

NAME, UNIT, MOVES = "geometry_gpu_ms", "ms", "frame_ms"
LAYER = "Camera, cull, LOD, geometry"
SPANS = ("frame.camera_cull", "frame.geometry")


def read(summary, cell):
    v = sum(summary["span_kernel_ms"].get(s, 0.0) for s in SPANS)
    return v or None
