"""Token traffic from the seed: a Zipf stream cut into packed rows.

``synth_tokens`` is a frozen copy of the port's ``data/pipeline.py``
generator (numpy's draws, so one seed gives the same stream on any
machine).  A run's batches are consecutive rows of one stream: row j is
tokens [j (S+1), (j+1)(S+1)), its inputs the first S and its targets
the last S, positions 0..S-1.  Every seed gives the same sizes; only the
tokens differ.  ``Pool`` holds a run's batches on the device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def synth_tokens(seed: int, shard: int, n: int, vocab: int) -> np.ndarray:
    """Deterministic Zipf-distributed token stream (unigram p ~ 1/rank)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, shard]))
    probs = 1.0 / np.arange(1, vocab + 1, dtype=np.float64)
    probs /= probs.sum()
    return rng.choice(vocab, size=n, p=probs).astype(np.int32)


def stream_seed(seed: int) -> int:
    """A non-negative seed for numpy, from any whole number."""
    return int(seed) % (1 << 64)


def packed_rows(seed: int, rows: int, seq: int, vocab: int) -> np.ndarray:
    """[rows, seq + 1] int32: the stream of ``seed`` cut into rows."""
    flat = synth_tokens(stream_seed(seed), 0, rows * (seq + 1), vocab)
    return flat.reshape(rows, seq + 1)


class Pool:
    """The run's batches: rows of the seed's stream, on the device."""

    def __init__(self, seed: int, n: int, batch: int, seq: int, vocab: int,
                 device):
        rows = torch.from_numpy(packed_rows(seed, n * batch, seq,
                                                   vocab))
        self.n, self.batch = n, batch
        self.tokens = rows[:, :-1].contiguous().to(device)
        self.targets = rows[:, 1:].contiguous().to(device)
        self.positions = torch.arange(seq, dtype=torch.int32, device=device
                                      ).expand(batch, seq).contiguous()

    def get(self, i: int) -> Dict[str, torch.Tensor]:
        j = (i % self.n) * self.batch
        return {"tokens": self.tokens[j:j + self.batch],
                "targets": self.targets[j:j + self.batch],
                "positions": self.positions}
