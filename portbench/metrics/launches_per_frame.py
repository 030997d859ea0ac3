"""launches_per_frame: kernel-launch runtime calls a frame inside the
harness's dispatch span."""

NAME, UNIT, LAYER, MOVES = ("launches_per_frame", "1/frame", "Engine",
                            "frame_ms")


def read(summary, cell):
    return summary["launches"] or None
