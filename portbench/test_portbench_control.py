"""The control, the reference computed with fp8 products in the
program's place, is not correct by the cells' limits (a tiny size on
the CPU; ``control.py`` reads it on the card at the cells' sizes)."""
from __future__ import annotations

import pytest

from portbench import control
from portbench import harness as H
from portbench import testing


@pytest.mark.parametrize("cell", testing.tiny_cells())
def test_the_control_fails_a_limit(cell):
    c = H.Cell(testing.tiny_bench(), cell, 31, 0, False, "cpu",
               overrides=testing.tiny_overrides(cell, batch=4))
    with testing.few_threads():
        if c.kind == "score":
            got = control.score_readings(c, control=True)["control"]
        else:
            got = control.train_readings(c, "control")
    assert not control.judged(c, got), got
