"""BENCHMARK.json and the files it names: found by name, and shaped as
the port expects (CPU only)."""
from __future__ import annotations

import json
import re

import pytest

from portbench import harness as H
from portbench import testing

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = H.benchmark()
ALL = testing.bench()          # with the waiting cells
CELLS = [w["name"] for w in ALL["workloads"]]


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in ALL[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in ALL["end_to_end"] + ALL["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in ALL["configs"] + ALL["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_bounds_and_metric_sources():
    for m in ALL["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in ALL["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    e2e = {m["name"] for m in ALL["end_to_end"]}
    for m in ALL["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in H.e2e_metrics(ALL, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = H.layer_metrics(ALL, cell)
    assert layer
    for m in layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_lookup_by_name(cell):
    c = H.Cell(ALL, cell, 1, 1.0, True, "cpu")
    assert c.conf["name"] == c.entry["config"]
    assert c.kind in ("score", "train") and hasattr(c.driver, "Work")
    assert c.limits and all(v > 0 for v in c.limits.values())
    for name, reader in c.readers.items():
        assert callable(reader.read), name
        for module, attr, _ in getattr(reader, "ENTRIES", ()):
            mod = __import__(module, fromlist=[attr])
            assert callable(getattr(mod, attr)), (name, module, attr)


def test_a_metric_is_reported_where_it_lists_or_everywhere():
    listed = {"name": "x", "workloads": ["a.b"]}
    assert H.applies(listed, "a.b") and not H.applies(listed, "c.d")
    assert H.applies({"name": "setup_s"}, "c.d")
    assert [m["name"] for m in H.layer_metrics(BENCH, "rwkv6-3b.score")] \
        == ["mfu.score", "wkv6_roofline", "device_idle.score"]


def test_unknown_names_are_refused():
    with pytest.raises(H.BenchError):
        H.find_cell(BENCH, "no-such-cell")
    with pytest.raises(H.BenchError):
        H.load_module(H.HERE / "metrics" / "no_such_metric.py")
