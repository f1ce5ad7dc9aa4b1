"""Batch shapes and synthetic batches (``repro/data/batches.py``) for the
ported families (dense, MoE, RWKV6, hybrid): ``tokens``, ``targets`` and
``positions``, each [B, S].

Random tokens come from a ``torch.Generator`` on the batch's device, so
their bits differ from ``jax.random``'s; a parity test feeds the same
numpy batch to both packages instead.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config.base import ENCDEC, VLM, ModelConfig
from repro_torch.device import DeviceLike, resolve_device

Batch = Dict[str, torch.Tensor]


def batch_shapes(cfg: ModelConfig, batch: int, seq: int,
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} for a training/prefill batch."""
    if cfg.family in (ENCDEC, VLM):
        raise NotImplementedError(
            f"family {cfg.family!r} batches wait for ROADMAP port slice (f), "
            "enc-dec / VLM")
    return {name: ((batch, seq), torch.int32)
            for name in ("tokens", "targets", "positions")}


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               generator: Optional[torch.Generator] = None,
               device: DeviceLike = "cuda") -> Batch:
    """Uniform random tokens and targets in [0, vocab), positions 0..S-1."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    out: Batch = {}
    for name, (shape, dtype) in batch_shapes(cfg, batch, seq).items():
        if name == "positions":
            out[name] = torch.arange(seq, dtype=dtype, device=dev
                                     ).expand(shape).contiguous()
        else:
            out[name] = torch.randint(0, cfg.vocab_size, shape,
                                      generator=generator, dtype=dtype,
                                      device=dev)
    return out
