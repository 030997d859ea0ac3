"""On the card: every host wait inside a frame has a name.

    python -m pytest tests/test_torch_sync_spans.py -q -s

For each Engine route at a small size (the opaque bench frame, a small LOD
crowd, the deferred frame, the K-buffer at K = 4, the ray-traced frame at
cluster_cap 24, the image-quality frame with ssaa 2, the post chain and
the sky, the point-shadowed frame and the model viewer's frame), two
frames after warm-up are traced with torch.profiler, and every CUDA
runtime or driver call that blocks the host (a ``*Synchronize``, or a
``Memcpy`` that is not ``Async``) inside an ``engine.render`` span must
lie inside a ``sync.*`` span (``utils/profiling.span``).  With ``-s`` each
route prints its ``sync.*`` spans' calls a frame.  Skips without a CUDA
card (the check is made in the fixture)."""

import functools
import json
import os

import pytest
import torch

from softwarerenderer_tpu_torch import scenes
from softwarerenderer_tpu_torch.config import RenderParams
from softwarerenderer_tpu_torch.engine import Engine
from softwarerenderer_tpu_torch.utils import profiling

W, H = 320, 180
FRAMES = 2
WARMUP = 2
ROUTES = ("opaque", "crowd", "deferred", "kbuffer4", "raytraced",
          "image_quality", "point_shadows", "viewer")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.cuda.get_device_name(0)


def route_step(name: str, device="cuda"):
    """step(i): frame i of the route on `device`, through Engine.render
    (the viewer: through Viewer.step, whose Engine.present reads the
    frame back)."""
    if name == "viewer":
        from softwarerenderer_tpu_torch.apps import viewer
        v = viewer.Viewer(os.path.join(REPO, "tests", "fixtures",
                                       "cube.dae"), width=W, height=H,
                          render_scale=1.0, headless=True, device=device)
        idle = {"keys": set(), "mouse_delta": (0.0, 0.0)}
        return lambda i: v.step(1.0 / 60.0, idle)
    if name == "point_shadows":
        scene, params, u, fn, shaders = scenes.shadow_golden_frame(
            "point_shadows")
        eng = Engine(scene, params, device=device, frame_fn=fn.func,
                     **shaders)
        return lambda i: eng.render(u)
    if name == "crowd":
        from softwarerenderer_tpu_torch.models.scene import (
            build_scene_buffers)
        eng = Engine(build_scene_buffers(scenes.lod_crowd_instances()[:64]),
                     RenderParams(W, H), device=device)
        return lambda i: eng.render(scenes.lod_crowd_uniforms(
            eng.uniforms, i))
    kw, scene = {}, scenes.bench_scene()
    params = RenderParams(W, H)
    extra = {}
    if name == "deferred":
        params = RenderParams(W, H, use_pallas=False)
    elif name == "kbuffer4":
        scene = scenes.translucent_scene()
        params = RenderParams(W, H, kbuffer=4, cull_mode=0)
    elif name == "raytraced":
        from softwarerenderer_tpu_torch.ops.raytrace import (
            render_frame_raytraced)
        kw["frame_fn"] = functools.partial(render_frame_raytraced,
                                           cluster_cap=24)
    elif name == "image_quality":
        from softwarerenderer_tpu_torch.engine import (
            scene_fragment_shader_trilinear)
        params = RenderParams(W, H, ssaa=2, use_mipmaps="trilinear",
                              ssao=True, bloom=True, tonemap="aces",
                              fxaa=True)
        kw["fragment_shader"] = scene_fragment_shader_trilinear
        extra["sky_panorama"] = scenes.sky_panorama()
    eng = Engine(scene, params, device=device, **kw)
    return lambda i: eng.render(dict(scenes.camera_uniforms(eng.uniforms, i),
                                     **extra))


def blocking(name: str) -> bool:
    """A runtime or driver call that returns only when the card is done."""
    return "Synchronize" in name or ("Memcpy" in name
                                     and "Async" not in name)


def unnamed_waits(trace: dict) -> dict:
    """The blocking calls inside an engine.render span and outside every
    sync.* span of the same thread: {"waits": all blocking calls inside
    engine.render, "unnamed": [(call, innermost span) ...]}."""
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    spans = [(e["tid"], e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
             if e.get("cat") == "user_annotation"]
    calls = [e for e in ev if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and blocking(e["name"])]

    def holding(e, pred):
        return [(hi - lo, n) for tid, lo, hi, n in spans
                if tid == e["tid"] and lo <= e["ts"] <= hi and pred(n)]
    waits = [e for e in calls if holding(e, lambda n: n == "engine.render")]
    unnamed = [(e["name"], min(holding(e, lambda n: True))[1]) for e in waits
               if not holding(e, lambda n: n.startswith("sync."))]
    return {"waits": len(waits), "unnamed": unnamed}


@pytest.mark.card
@pytest.mark.parametrize("route", ROUTES)
def test_every_wait_in_a_frame_is_named(card, route, tmp_path):
    step = route_step(route)
    for i in range(WARMUP):
        step(i)
    torch.cuda.synchronize()
    profiling.reset_span_totals()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(FRAMES):
            step(WARMUP + i)
        torch.cuda.synchronize()
    totals = profiling.span_totals()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        found = unnamed_waits(json.load(f))
    syncs = {k: v["calls"] / FRAMES for k, v in sorted(totals.items())
             if k.startswith("sync.")}
    print(f"\n{route} [{card}]: {found['waits'] / FRAMES} waits a frame "
          f"inside engine.render; sync.* calls a frame {syncs}; "
          f"engine.render {totals['engine.render']['host_ms'] / FRAMES:.3f}"
          f" ms a frame")
    assert totals["engine.render"]["calls"] == FRAMES
    assert found["unnamed"] == [], found["unnamed"]
