"""Error-feedback int8 gradient compression (``repro/optim/compress.py``).

Each gradient leaf plus its carried error is coded blockwise in int8 and
decoded; what the code lost is carried into the next step instead of
dropped (the EF-SGD lineage).  On one device the codec is applied to the
whole gradient before the optimizer, as the reference does under ``jit``.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.optim.adamw import q8_decode, q8_encode, tree_leaves, tree_map

Params = Any
BLOCK = 256


def init_error(params: Params) -> Params:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


@torch.no_grad()
def compress_decompress(grads: Params, error: Params,
                        ) -> Tuple[Params, Params]:
    """Replaces ``grads`` by their decoded int8 codes and ``error`` by what
    the codes lost, in place; returns (grads, error), the same objects."""
    for g, e in zip(tree_leaves(grads), tree_leaves(error)):
        g32 = g.float() + e
        flat = g32.reshape(1, -1) if g32.dim() == 0 else g32
        deq = q8_decode(*q8_encode(flat, BLOCK), BLOCK).reshape(g32.shape)
        e.copy_(g32 - deq)
        g.copy_(deq)
    return grads, error
