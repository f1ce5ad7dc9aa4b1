"""The span readers on a tiny traced run (CPU): each reports in the cells
it lists, and a program without spans gives no reading."""
from __future__ import annotations

import pytest

from portbench import harness as H
from portbench import testing

SPAN_METRICS = [m for m in H.benchmark()["per_layer"]
                if m["source"] in ("program_span", "program_counter")]


@pytest.fixture(scope="module")
def traced():
    cells = sorted({c for m in SPAN_METRICS for c in m["workloads"]})
    return {c: testing.run_tiny(c, trace=True) for c in cells}


@pytest.mark.parametrize("metric", SPAN_METRICS, ids=lambda m: m["name"])
def test_a_span_metric_is_read_in_its_cells(traced, metric):
    for cell in metric["workloads"]:
        got = traced[cell]["metrics"][metric["name"]]
        assert got["unit"] == metric["unit"]
        assert got["value"] > 0
        if metric["unit"] == "%":
            assert got["value"] <= 100


@pytest.mark.parametrize("metric", SPAN_METRICS, ids=lambda m: m["name"])
def test_without_the_programs_tracing_a_reader_reads_nothing(monkeypatch,
                                                             metric):
    reader = H.load_module(H.HERE / "metrics" / f"{metric['name']}.py")
    from portbench.metrics import _spans
    monkeypatch.setattr(_spans, "tracing", None)
    assert reader.read({"traced_units": 2}) is None
