"""host_issue_ms: host ms a frame inside the program's engine.render span
less its sync.* time, the time the host takes to queue a frame's work
(portbench.spans); nothing where the program keeps no span totals."""

from portbench import spans

NAME, UNIT, LAYER, MOVES = "host_issue_ms", "ms", "Engine", "frame_ms"


def read(summary, cell):
    return spans.host_issue_ms(spans.totals())
