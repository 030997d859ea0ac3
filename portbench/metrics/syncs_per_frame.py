"""syncs_per_frame: CUDA runtime *Synchronize calls a frame made inside
the harness's dispatch span (the client's own present wait lies outside
it, and so do the profiler's)."""

NAME, UNIT, LAYER, MOVES = "syncs_per_frame", "1/frame", "Engine", "frame_ms"


def read(summary, cell):
    return summary["syncs"]
