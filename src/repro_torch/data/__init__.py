"""Batches for the port's training and eval steps (``repro/data``); the
sharded pipeline over the fabric waits for ROADMAP port slices (a) and
(b2)."""
from repro_torch.data.batches import (  # noqa: F401
    batch_shapes, make_batch,
)
