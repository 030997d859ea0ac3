"""frame_ms_p95: the 95th percentile of the intervals between consecutive
frames' completions, over every frame of the window (stutter: one stall
moves it, where a median would not)."""

import numpy as np

NAME, UNIT, SOURCE = "frame_ms_p95", "ms", "host_clock"


def read_window(stats, cell):
    x = stats["intervals_ms"]
    return float(np.percentile(x, 95)) if len(x) else None
