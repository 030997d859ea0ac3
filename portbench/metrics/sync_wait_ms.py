"""sync_wait_ms: host ms a frame inside the program's sync.* spans, the
places where Engine.render waits for the card (portbench.spans); 0.0
where the frames waited nowhere, nothing where the program keeps no span
totals."""

from portbench import spans

NAME, UNIT, LAYER, MOVES = "sync_wait_ms", "ms", "Engine", "frame_ms"


def read(summary, cell):
    return spans.sync_wait_ms(spans.totals())
