"""Decoder transformer block with a dense SwiGLU MLP.

Counterpart of ``repro/models/blocks.py``, dense path.  The MoE block
waits for its own slice of the port.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models.attention import (
    attention_apply, attention_decode, attention_init, attention_prefill,
)
from repro_torch.models.layers import (
    Params, mlp_apply, mlp_init, rmsnorm, rmsnorm_init, torch_dtype,
)

_MOE_TODO = "MoE blocks wait for ROADMAP port slice (c), gmm with MoE"


def block_init(cfg: ModelConfig, gen: torch.Generator,
               device: torch.device) -> Params:
    if cfg.is_moe:
        raise NotImplementedError(_MOE_TODO)
    dt = torch_dtype(cfg.param_dtype)
    return {
        "ln1": rmsnorm_init(cfg.d_model, dt, device),
        "attn": attention_init(cfg, gen, device),
        "ln2": rmsnorm_init(cfg.d_model, dt, device),
        "mlp": mlp_init(cfg, gen, device),
    }


def _ffn(cfg: ModelConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    if cfg.is_moe:
        raise NotImplementedError(_MOE_TODO)
    return h + mlp_apply(cfg, p["mlp"], rmsnorm(h, p["ln2"], cfg.rms_eps))


def block_apply(cfg: ModelConfig, p: Params, h: torch.Tensor,
                positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  h: [B,S,d] -> (h, aux_loss)."""
    a = attention_apply(cfg, p["attn"], rmsnorm(h, p["ln1"], cfg.rms_eps),
                        positions, causal=True)
    return _ffn(cfg, p, h + a), torch.zeros((), device=h.device)


def block_prefill(cfg: ModelConfig, p: Params, h: torch.Tensor,
                  positions: torch.Tensor,
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                             torch.Tensor]:
    a, cache = attention_prefill(cfg, p["attn"],
                                 rmsnorm(h, p["ln1"], cfg.rms_eps), positions)
    return _ffn(cfg, p, h + a), cache, torch.zeros((), device=h.device)


def block_decode(cfg: ModelConfig, p: Params, h: torch.Tensor,
                 positions: torch.Tensor, cache_k: torch.Tensor,
                 cache_v: torch.Tensor, index: torch.Tensor,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    a, ck, cv = attention_decode(cfg, p["attn"],
                                 rmsnorm(h, p["ln1"], cfg.rms_eps),
                                 positions, cache_k, cache_v, index)
    return _ffn(cfg, p, h + a), ck, cv
