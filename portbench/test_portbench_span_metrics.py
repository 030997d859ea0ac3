"""The program-span metrics' arithmetic on synthetic span totals, and on a
program that keeps none."""

import pytest

from portbench import harness, spans

METRICS = ("sync_wait_ms", "host_issue_ms", "geometry_host_ms")


def _t(**named):
    return {k.replace("__", "."): {"calls": c, "host_ms": h, "self_ms": s}
            for k, (c, h, s) in named.items()}


# Two frames: engine.render 50 ms in all, one 12 ms sync.uniforms a frame
# inside frame.camera_cull (3 ms of its own a frame), frame.geometry 2 ms
# of its own a frame.
TWO_FRAMES = _t(engine__render=(2, 50.0, 1.0),
                sync__uniforms=(2, 24.0, 24.0),
                frame__camera_cull=(2, 30.0, 6.0),
                frame__geometry=(2, 4.0, 4.0),
                tile__fold=(2, 10.0, 10.0))


def test_split_of_a_frame():
    assert spans.frames(TWO_FRAMES) == 2
    assert spans.sync_wait_ms(TWO_FRAMES) == pytest.approx(12.0)
    assert spans.host_issue_ms(TWO_FRAMES) == pytest.approx(13.0)
    assert spans.geometry_host_ms(TWO_FRAMES) == pytest.approx(5.0)
    # issue and wait add up to the frame's host time
    assert spans.sync_wait_ms(TWO_FRAMES) + spans.host_issue_ms(
        TWO_FRAMES) == pytest.approx(TWO_FRAMES["engine.render"]["host_ms"]
                                     / 2)


def test_every_sync_span_counts_as_waiting():
    t = dict(TWO_FRAMES, **_t(sync__fb=(1, 2.0, 2.0),
                              sync__peel_live=(6, 4.0, 4.0)))
    assert spans.sync_wait_ms(t) == pytest.approx(15.0)
    assert spans.host_issue_ms(t) == pytest.approx(10.0)


def test_no_wait_reads_zero_not_none():
    t = {k: v for k, v in TWO_FRAMES.items() if k != "sync.uniforms"}
    assert spans.sync_wait_ms(t) == 0.0
    assert spans.host_issue_ms(t) == pytest.approx(25.0)


def test_without_geometry_spans_reads_zero():
    t = _t(engine__render=(4, 8.0, 8.0))
    assert spans.geometry_host_ms(t) == 0.0


@pytest.mark.parametrize("t", [None, {}, _t(tile__fold=(3, 1.0, 1.0)),
                               _t(engine__render=(0, 0.0, 0.0))])
def test_none_only_without_a_frame(t):
    assert spans.frames(t) == 0
    for name in METRICS:
        assert getattr(spans, name)(t) is None


@pytest.mark.parametrize("name", METRICS)
def test_metric_files_read_the_program(name, monkeypatch):
    monkeypatch.setattr(spans, "totals", lambda: TWO_FRAMES)
    want = {"sync_wait_ms": 12.0, "host_issue_ms": 13.0,
            "geometry_host_ms": 5.0}[name]
    assert harness.metric(name).read({}, {}) == pytest.approx(want)


@pytest.mark.parametrize("name", METRICS)
def test_a_program_without_span_totals_reads_nothing(name, monkeypatch):
    from softwarerenderer_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "span_totals")
    assert spans.totals() is None
    assert harness.metric(name).read({}, {}) is None


def test_traced_cpu_run_reports_the_split():
    """A traced run on the CPU at a tiny size: the program's frames lie
    inside the harness's dispatch span, so issue and wait add up to less
    than it."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        r, _ = harness.run("lodcrowd-4k.sweep", 2 ** 33 + 3, 0.0, True,
                           device="cpu",
                           over={"grid": 4, "width": 192, "height": 108})
    finally:
        torch.set_num_threads(n)
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert r["correct"] is True
    assert set(METRICS) <= set(m)
    assert m["sync_wait_ms"] >= 0.0 and m["geometry_host_ms"] > 0.0
    assert 0.0 < m["sync_wait_ms"] + m["host_issue_ms"] <= m["dispatch_ms"]
