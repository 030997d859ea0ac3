"""post_host_ms: host ms a frame inside the program's frame.post span, the
whole post chain with its uniforms' upload and waits (portbench.spans);
nothing where the program keeps no span totals or ran no post chain."""

from portbench import spans

NAME, UNIT, MOVES = "post_host_ms", "ms", "frame_ms"
LAYER = "Post chain"
SPAN = "frame.post"


def read(summary, cell):
    t = spans.totals()
    n = spans.frames(t)
    if not n or SPAN not in t:
        return None
    return t[SPAN]["host_ms"] / n
