"""The token stream, the check's sample and gaps, and the trace
arithmetic, against hand counts (CPU only)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import tokens, trace


def test_token_stream_is_a_seeded_zipf():
    a = tokens.packed_rows(2 ** 31 + 11, 8, 64, 1000)
    b = tokens.packed_rows(2 ** 31 + 11, 8, 64, 1000)
    c = tokens.packed_rows(2 ** 31 + 12, 8, 64, 1000)
    assert a.shape == (8, 65) and a.dtype == np.int32
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < 1000
    counts = np.bincount(a.ravel(), minlength=1000)
    assert counts[0] == counts.max()
    from portbench.kinds.score import Pool
    pool = Pool(2 ** 31 + 11, 2, 4, 64, 1000, "cpu")
    b1 = pool.get(1)
    assert b1["tokens"].tolist() == a[4:8, :-1].tolist()
    assert b1["targets"].tolist() == a[4:8, 1:].tolist()
    assert pool.get(3)["tokens"].tolist() == b1["tokens"].tolist()
    assert tokens.stream_seed(-1) == 2 ** 64 - 1


def test_sample_is_drawn_from_the_seed():
    from portbench.kinds import score
    assert score.sample(7, 50, 4) == score.sample(7, 50, 4)
    assert len(set(score.sample(7, 50, 4))) == 4
    assert score.sample(7, 3, 4) == [0, 1, 2]


def test_hidden_gap_is_the_worst_row_relative_to_the_reference():
    from portbench.kinds import score
    want = torch.ones(3, 4, 2)
    got = want.clone()
    assert score.hidden_gap(got, want) == 0.0
    got[1, 0] = 2.0                      # row 1: 2 of its 8 numbers off by 1
    assert score.hidden_gap(got, want) == pytest.approx((2 / 8) ** 0.5)
    assert score.hidden_gap(got[:2], want) == float("inf")
    assert score.hidden_gap(None, want) == float("inf")


def test_step_gaps_hold_each_layer_to_the_reference_on_its_own_input():
    from portbench.kinds import score
    embed = torch.ones(2, 3, 4)
    states = [torch.ones(1, 3, 4), torch.full((1, 3, 4), 3.0),
              torch.full((1, 3, 4), 4.0)]
    forced = [torch.full((1, 3, 4), 3.0), torch.full((1, 3, 4), 5.0)]
    # layer 0 as the reference; layer 1 gave 4 where it gives 5 on 3,
    # off by all of its update (5 - 3 = 2) but half of it
    assert score.step_gaps(embed, states, embed, forced) == \
        pytest.approx([0.0, 0.0, 0.5])
    assert score.step_gaps(embed[:1], states, embed, forced)[0] == \
        float("inf")                                   # rows left out
    assert score.step_gaps(embed, states[:2], embed, forced) == \
        [float("inf")] * 3                             # a layer not run


def test_union_and_gaps_of_device_intervals():
    iv = [(0, 10), (5, 20), (30, 40), (41, 45), (100, 101)]
    assert trace.union_s(iv) == pytest.approx((20 + 10 + 4 + 1) / 1e9)
    assert trace.gaps(iv) == [(45, 100), (20, 30), (40, 41)]
    assert trace.union_s([]) == 0.0
