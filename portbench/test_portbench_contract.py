"""BENCHMARK.json against the benchmark's contract, and every name in it
against the file the harness finds it by."""

import ast
import json
import os
import re

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
ALL_METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert all(TEXT.match(w) for w in BENCH["command"])
    assert len(BENCH["command"]) <= 32


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + ALL_METRICS, ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for k in ("config", "traffic"):
        if k in entry:
            assert NAME.match(entry[k])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for k in ("why", "layer", "source"):
        if k in entry:
            assert TEXT.match(entry[k])
    for k in entry.get("reduced", []):
        assert NAME.match(k)


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], ALL_METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_rules():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_rules():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
    for c in cells:
        assert harness.metrics_of(BENCH, c, "per_layer")


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda e: e["name"])
def test_configs_resolve(cfg):
    path = os.path.join(ROOT, cfg["file"])
    assert cfg["file"].startswith("portbench/") and os.path.exists(path)
    assert json.load(open(path))["name"] == cfg["name"]
    assert os.path.exists(path[:-len(".json")] + ".py")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda e: e["name"])
def test_cells_resolve(cell):
    c = harness.cell_of(cell["name"])
    assert c["config"] == cell["config"]
    assert cell["chips"] in (1, 4)
    for k in ("make_inputs", "Program", "Reference"):
        assert hasattr(c["module"], k)
    assert set(c["limits"]) == set(harness.CHECKS)


@pytest.mark.parametrize("m", ALL_METRICS, ids=lambda e: e["name"])
def test_metrics_resolve(m):
    mod = harness.metric(m["name"])
    assert mod.NAME == m["name"] and mod.UNIT == m["unit"]
    if m in BENCH["per_layer"]:
        assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
        assert callable(mod.read)
    else:
        assert callable(mod.read_window)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    base = os.path.join(ROOT, "portbench", sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax(path):
    """Nothing of the benchmark imports JAX or the JAX package, by whole
    top-level name (the port's name starts with the JAX package's)."""
    assert not set(_imports(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_reference_is_independent(path):
    assert "softwarerenderer_tpu_torch" not in set(_imports(path))
