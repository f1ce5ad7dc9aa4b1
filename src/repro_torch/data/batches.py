"""Batch shapes and synthetic batches (``repro/data/batches.py``):
``tokens``, ``targets`` and ``positions``, each [B, S]; an enc-dec batch
adds the encoder's ``frontend`` [B, S, E]; a VLM batch splits its S
positions into ``vlm_patch_count(S)`` frontend patches and the text
tokens after them, with M-RoPE positions [3, B, S].

Random tokens and frontends come from a ``torch.Generator`` on the
batch's device, so their bits differ from ``jax.random``'s; a parity test
feeds the same numpy batch to both packages instead.  ``make_specs`` gives
the same entries as tensors on the ``meta`` device (shapes and dtypes, no
storage), the counterpart of the reference's ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config.base import ENCDEC, VLM, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import torch_dtype

Batch = Dict[str, torch.Tensor]


def vlm_patch_count(seq_len: int) -> int:
    return min(1024, max(seq_len // 4, 4))


def batch_shapes(cfg: ModelConfig, batch: int, seq: int,
                 ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} for a training/prefill batch."""
    i32, dt = torch.int32, torch_dtype(cfg.dtype)
    if cfg.family == ENCDEC:
        return {
            "frontend": ((batch, seq, cfg.frontend_embed_dim), dt),
            "tokens": ((batch, seq), i32),
            "targets": ((batch, seq), i32),
            "positions": ((batch, seq), i32),
        }
    if cfg.family == VLM:
        npat = vlm_patch_count(seq)
        ntext = seq - npat
        return {
            "frontend": ((batch, npat, cfg.frontend_embed_dim), dt),
            "tokens": ((batch, ntext), i32),
            "targets": ((batch, ntext), i32),
            "positions": ((3, batch, seq), i32),
        }
    return {name: ((batch, seq), i32)
            for name in ("tokens", "targets", "positions")}


def make_batch(cfg: ModelConfig, batch: int, seq: int,
               generator: Optional[torch.Generator] = None,
               device: DeviceLike = "cuda") -> Batch:
    """Uniform random tokens and targets in [0, vocab), positions 0..S-1
    (each of t, h, w for a VLM), standard normal frontend embeddings."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    out: Batch = {}
    for name, (shape, dtype) in batch_shapes(cfg, batch, seq).items():
        if name == "positions":
            out[name] = torch.arange(seq, dtype=dtype, device=dev
                                     ).expand(shape).contiguous()
        elif name == "frontend":
            out[name] = torch.randn(shape, generator=generator,
                                    dtype=torch.float32, device=dev).to(dtype)
        else:
            out[name] = torch.randint(0, cfg.vocab_size, shape,
                                      generator=generator, dtype=dtype,
                                      device=dev)
    return out


def make_specs(cfg: ModelConfig, batch: int, seq: int) -> Batch:
    """``meta`` tensors with ``batch_shapes``' shapes and dtypes."""
    return {name: torch.empty(shape, dtype=dtype, device="meta")
            for name, (shape, dtype) in batch_shapes(cfg, batch, seq).items()}


def decode_token_shapes(cfg: ModelConfig, batch: int,
                        ) -> Tuple[Tuple[int, ...], torch.dtype]:
    return (batch, 1), torch.int32


def make_decode_tokens(cfg: ModelConfig, batch: int,
                       generator: Optional[torch.Generator] = None,
                       device: DeviceLike = "cuda") -> torch.Tensor:
    """One uniform random token in [0, vocab) a sequence, [batch, 1]."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(1)
    shape, dtype = decode_token_shapes(cfg, batch)
    return torch.randint(0, cfg.vocab_size, shape, generator=generator,
                         dtype=dtype, device=dev)
