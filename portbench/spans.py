"""The program's own host spans after a traced window, a frame.

The program keeps each span's calls, host time and self time (host time
less that of the spans opened inside it) while the torch profiler runs:
``softwarerenderer_tpu_torch.utils.profiling.span_totals()``, {name:
{"calls", "host_ms", "self_ms"}}.  The harness runs the profiler over the
traced frames alone, so the totals cover exactly those frames.  A frame
is one call of ``engine.render`` (``Engine.render``); ``sync.<what>``
spans hold each place where the host waits for the card.  A program
without span_totals gives no totals, and every number here is then
None.
"""

from __future__ import annotations

from typing import Dict, Optional

RENDER = "engine.render"
SYNC = "sync."
# The layer's spans, as geometry_gpu_ms reads their kernels.
GEOMETRY = ("frame.camera_cull", "frame.geometry")


def totals() -> Optional[Dict]:
    """The program's span_totals(), or None where it keeps none."""
    from softwarerenderer_tpu_torch.utils import profiling
    read = getattr(profiling, "span_totals", None)
    return None if read is None else read()


def frames(t: Optional[Dict]) -> int:
    """Calls of engine.render in the totals."""
    return int(t.get(RENDER, {}).get("calls", 0)) if t else 0


def sync_wait_ms(t: Optional[Dict]) -> Optional[float]:
    """Host ms a frame inside sync.* spans: 0.0 where no span waited."""
    n = frames(t)
    if not n:
        return None
    return sum(v["host_ms"] for k, v in t.items()
               if k.startswith(SYNC)) / n


def host_issue_ms(t: Optional[Dict]) -> Optional[float]:
    """Host ms a frame inside engine.render less the sync.* time (the
    harness's path opens sync.* spans only inside engine.render)."""
    n = frames(t)
    if not n:
        return None
    return t[RENDER]["host_ms"] / n - sync_wait_ms(t)


def geometry_host_ms(t: Optional[Dict]) -> Optional[float]:
    """Self ms a frame of the camera, cull, LOD and geometry spans."""
    n = frames(t)
    if not n:
        return None
    return sum(t[k]["self_ms"] for k in GEOMETRY if k in t) / n
