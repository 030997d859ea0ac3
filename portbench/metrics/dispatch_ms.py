"""dispatch_ms: host ms a frame inside the harness's own span around its
calls into the program (Engine.render, to_rgb8, the copy, the event)."""

NAME, UNIT, LAYER, MOVES = "dispatch_ms", "ms", "Frame loop", "frame_ms"


def read(summary, cell):
    return summary["dispatch_ms"] or None
