"""Decoder transformer block (dense MLP or MoE) shared by the dense and
MoE families.

Counterpart of ``repro/models/blocks.py``.
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
from repro_torch.models.moe import moe_apply, moe_init


def block_init(cfg: ModelConfig, gen: torch.Generator,
               device: torch.device) -> Params:
    dt = torch_dtype(cfg.param_dtype)
    p = {
        "ln1": rmsnorm_init(cfg.d_model, dt, device),
        "attn": attention_init(cfg, gen, device),
        "ln2": rmsnorm_init(cfg.d_model, dt, device),
    }
    if cfg.is_moe:
        p["moe"] = moe_init(cfg, gen, device)
    else:
        p["mlp"] = mlp_init(cfg, gen, device)
    return p


def _ffn(cfg: ModelConfig, p: Params, h: torch.Tensor,
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = rmsnorm(h, p["ln2"], cfg.rms_eps)
    if cfg.is_moe:
        y, aux = moe_apply(cfg, p["moe"], x)
    else:
        y = mlp_apply(cfg, p["mlp"], x)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + y, aux


def block_apply(cfg: ModelConfig, p: Params, h: torch.Tensor,
                positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  h: [B,S,d] -> (h, aux_loss)."""
    a = attention_apply(cfg, p["attn"], rmsnorm(h, p["ln1"], cfg.rms_eps),
                        positions, causal=True)
    return _ffn(cfg, p, h + a)


def block_prefill(cfg: ModelConfig, p: Params, h: torch.Tensor,
                  positions: torch.Tensor,
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                             torch.Tensor]:
    a, cache = attention_prefill(cfg, p["attn"],
                                 rmsnorm(h, p["ln1"], cfg.rms_eps), positions)
    h, aux = _ffn(cfg, p, h + a)
    return h, cache, aux


def block_decode(cfg: ModelConfig, p: Params, h: torch.Tensor,
                 positions: torch.Tensor, cache_k: torch.Tensor,
                 cache_v: torch.Tensor, index: torch.Tensor,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    a, ck, cv = attention_decode(cfg, p["attn"],
                                 rmsnorm(h, p["ln1"], cfg.rms_eps),
                                 positions, cache_k, cache_v, index)
    h, _ = _ffn(cfg, p, h + a)
    return h, ck, cv
