"""Each fault a cell can have, planted under the timed path, turns
``correct`` false; the same tiny run without it is correct.  The
program runs in f32 on the CPU, where it agrees with the reference to
rounding, against the cells' own limits."""
from __future__ import annotations

import pytest

from portbench import harness as H
from portbench import testing


def _cases():
    for w in testing.bench()["workloads"]:
        conf = H.load_json(H.HERE / "configs" / f"{w['config']}.json")
        kind = H.load_json(H.HERE / "traffic" / f"{w['traffic']}.json")[
            "kind"]
        for fault in testing.faults(kind, conf["model"]["family"]):
            yield w["name"], fault


@pytest.mark.parametrize("cell,fault", list(_cases()))
def test_a_planted_fault_is_not_correct(cell, fault):
    assert testing.run_tiny(cell, f32=True, batch=4)["correct"]
    with testing.planted(fault):
        out = testing.run_tiny(cell, f32=True, batch=4)
    assert not out["correct"], out["checks"]
