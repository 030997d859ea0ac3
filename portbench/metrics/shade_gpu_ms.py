"""shade_gpu_ms: kernel ms a frame inside tile.shade (the configuration's
fragment shader); nothing when the span held no kernel."""

NAME, UNIT, MOVES = "shade_gpu_ms", "ms", "frame_ms"
LAYER = "Shading"
SPANS = ("tile.shade",)


def read(summary, cell):
    v = sum(summary["span_kernel_ms"].get(s, 0.0) for s in SPANS)
    return v or None
