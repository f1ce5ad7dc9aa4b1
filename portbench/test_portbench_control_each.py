"""``control_each.py`` on the tiny jamba2-mini cell (CPU, the program in
f32, the cell's own batch of 2 and limits): the program's reading is
correct, and each planted fault, read against a reference of its own,
is not."""
from __future__ import annotations

import pytest

from portbench import control, control_each
from portbench import harness as H
from portbench import testing

CELL = "jamba2-mini.score"


def _cell() -> H.Cell:
    return H.Cell(testing.tiny_bench(), CELL, 41, 0, False, "cpu",
                  overrides=testing.tiny_overrides(CELL, f32=True))


@pytest.mark.parametrize("fault", testing.faults("score", "hybrid"))
def test_each_fault_fails_a_limit_beside_a_correct_program(fault):
    c = _cell()
    with testing.few_threads():
        got = dict(control_each.readings(c, [fault]))
    assert list(got) == ["program", fault]
    assert control.judged(c, got["program"]), got["program"]
    assert not control.judged(c, got[fault]), got[fault]


def test_the_program_is_read_once_a_seed():
    c = _cell()
    faults = testing.faults("score", "hybrid")[:2]
    with testing.few_threads():
        whats = [w for w, _ in control_each.readings(c, faults)]
    assert whats == ["program"] + list(faults)
