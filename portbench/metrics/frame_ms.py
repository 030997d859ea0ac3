"""frame_ms: the window's length over the frames whose completion event
fell inside it (the frame rate a player or an Engine user sees)."""

NAME, UNIT, SOURCE = "frame_ms", "ms", "host_clock"


def read_window(stats, cell):
    return stats["window_ms"] / stats["frames"] if stats["frames"] else None
