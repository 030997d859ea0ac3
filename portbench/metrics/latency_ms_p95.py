"""latency_ms_p95: the 95th percentile, over every frame of the window,
of the time from the host's entry into the frame's render call to the
frame's completion on the card (input lag; it rises when a change keeps
more frames in flight)."""

import numpy as np

NAME, UNIT, SOURCE = "latency_ms_p95", "ms", "host_clock"


def read_window(stats, cell):
    x = stats["latency_ms"]
    return float(np.percentile(x, 95)) if len(x) else None
