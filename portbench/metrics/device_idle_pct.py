"""device_idle_pct: 100 x (1 - the union of the card's kernel, copy and
fill intervals / the traced window), the window from the first frame's
dispatch to the last device activity."""

NAME, UNIT, LAYER, MOVES = "device_idle_pct", "%", "Device", "frame_ms"


def read(summary, cell):
    if not summary["window_s"]:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
