"""The jamba2-mini cell's own pieces on tiny runs (CPU): its two readers,
which read the Mamba scan's calls and the ``mamba`` spans there and
nothing in the cells without Mamba layers, and its router setting, which
the reference holds the program to."""
from __future__ import annotations

import dataclasses
import math
import time

import pytest

from portbench import harness as H
from portbench import testing

CELL = "jamba2-mini.score"
OTHERS = ("qwen3-moe-30b-a3b.score", "rwkv6-3b.score")
READERS = ("mamba_roofline", "mamba_ms.score")


def _cell(name: str, trace: bool, **kw) -> H.Cell:
    return H.Cell(testing.tiny_bench(), name, 20260, 0.2, trace, "cpu",
                  overrides=testing.tiny_overrides(name, **kw))


@pytest.fixture(scope="module")
def readings():
    """Each new reader's number on a tiny traced run of each cell, read
    right after it (the program's spans keep only the last units)."""
    readers = {n: H.load_module(H.HERE / "metrics" / f"{n}.py")
               for n in READERS}
    out = {}
    for name in (CELL,) + OTHERS:
        cell = _cell(name, trace=True)
        with testing.few_threads():
            t = H.run_cell(cell, time.perf_counter())["trace"]
        out[name] = {n: r.read(t) for n, r in readers.items()}
    return out


# mamba_ms.score is a program_span metric listed in BENCHMARK.json, so
# test_portbench_spans.py already reads it on this cell
@pytest.mark.parametrize("metric", ("mamba_roofline",))
def test_a_reader_reads_the_hybrid_cell(readings, metric):
    got = readings[CELL][metric]
    assert got is not None and math.isfinite(got) and 0 < got <= 100


@pytest.mark.parametrize("metric", READERS)
@pytest.mark.parametrize("cell", OTHERS)
def test_a_reader_reads_nothing_without_mamba_layers(readings, cell, metric):
    assert readings[cell][metric] is None


def test_a_router_that_renormalises_is_not_correct():
    """The program in f32 with its router renormalising the top-2 weights,
    as every router did before ``norm_topk_prob``, against the reference's
    Jamba router, which keeps them: the check refuses it."""
    cell = _cell(CELL, trace=False, f32=True)
    kind = H.load_module(H.HERE / "kinds" / f"{cell.kind}.py")
    made = kind.program_config

    def renormalising(conf, kind):
        cfg = made(conf, kind)
        assert cfg.moe.norm_topk_prob is False
        return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                   norm_topk_prob=True))

    kind.program_config = renormalising
    try:
        with testing.few_threads():
            out = H.result_line(cell, H.run_cell(cell, time.perf_counter()))
    finally:
        kind.program_config = made
    assert not out["correct"], out["checks"]
