"""geometry_host_ms: host self ms a frame of frame.camera_cull and
frame.geometry, the spans whose kernels geometry_gpu_ms reads
(portbench.spans); nothing where the program keeps no span totals."""

from portbench import spans

NAME, UNIT, MOVES = "geometry_host_ms", "ms", "frame_ms"
LAYER = "Camera, cull, LOD, geometry"


def read(summary, cell):
    return spans.geometry_host_ms(spans.totals())
