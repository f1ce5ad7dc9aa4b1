"""Each fault a cell can have, planted under the timed path, turns
``correct`` false; the same tiny run without it is correct.  The
program runs in f32 on the CPU, where it agrees with the reference to
rounding, against the cells' own limits."""
from __future__ import annotations

import pytest

from portbench import testing


def _cases():
    for name in testing.tiny_cells():
        over = testing.tiny_overrides(name)
        family = over["conf"]["model"]["family"]
        for fault in testing.faults(over["traffic"]["kind"], family):
            yield name, fault


@pytest.mark.parametrize("cell,fault", list(_cases()))
def test_a_planted_fault_is_not_correct(cell, fault):
    assert testing.run_tiny(cell, f32=True, batch=4)["correct"]
    with testing.planted(fault):
        out = testing.run_tiny(cell, f32=True, batch=4)
    assert not out["correct"], out["checks"]
