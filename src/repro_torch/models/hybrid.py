"""Jamba-style hybrid superblock: period-P interleave of Mamba and attention.

Counterpart of ``repro/models/hybrid.py``.  With period 8 and attn_pos 4
the superblock is

    pos 0-3: mamba + MLP      pos 4: attention + MLP      pos 5-7: mamba + MLP

The reference puts MoE on odd positions when the config has experts;
MoE waits for its own slice of the port, so such a config raises.  The
reference stacks each superblock's Mamba and MLP layers on a leading
axis; here ``p["mamba"]`` and ``p["mlp"]`` are lists of per-layer dicts,
and ``ln_mix``/``ln_ffn`` stay [period, d] tensors.  The decode cache
keeps the reference's layout: ``k``/``v`` [nb, B, max_len, kv_dim],
``conv`` [nb, n_mamba, B, K-1, di] and ``ssm`` [nb, n_mamba, B, di, N]
(f32), so batch is axis 2 of the Mamba entries.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models.attention import (
    attention_apply, attention_decode, attention_init, attention_prefill,
)
from repro_torch.models.layers import (
    Params, mlp_apply, mlp_init, rmsnorm, torch_dtype,
)
from repro_torch.models.mamba import (
    mamba_apply, mamba_cache_init, mamba_decode, mamba_init,
)

_MOE_TODO = "MoE blocks wait for ROADMAP port slice (c), gmm with MoE"


def _positions(cfg: ModelConfig) -> List[str]:
    """The mixer ("attn" or "mamba") of each position in one superblock;
    every position's FFN is the dense MLP."""
    if cfg.is_moe:
        raise NotImplementedError(_MOE_TODO)
    return ["attn" if i == cfg.hybrid_attn_pos else "mamba"
            for i in range(cfg.hybrid_period)]


def n_mamba(cfg: ModelConfig) -> int:
    return _positions(cfg).count("mamba")


def superblock_init(cfg: ModelConfig, gen: torch.Generator,
                    device: torch.device) -> Params:
    dt = torch_dtype(cfg.param_dtype)
    pos = _positions(cfg)
    return {
        "attn": attention_init(cfg, gen, device),
        "mamba": [mamba_init(cfg, gen, device) for _ in range(n_mamba(cfg))],
        "mlp": [mlp_init(cfg, gen, device) for _ in pos],
        "ln_mix": torch.ones((len(pos), cfg.d_model), dtype=dt, device=device),
        "ln_ffn": torch.ones((len(pos), cfg.d_model), dtype=dt, device=device),
    }


def _ffn(cfg: ModelConfig, p: Params, h: torch.Tensor, i: int) -> torch.Tensor:
    x = rmsnorm(h, p["ln_ffn"][i], cfg.rms_eps)
    return h + mlp_apply(cfg, p["mlp"][i], x)


def superblock_apply(cfg: ModelConfig, p: Params, h: torch.Tensor,
                     positions: torch.Tensor,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward through one superblock -> (h, aux_loss)."""
    im = 0
    for i, mixer in enumerate(_positions(cfg)):
        x = rmsnorm(h, p["ln_mix"][i], cfg.rms_eps)
        if mixer == "attn":
            h = h + attention_apply(cfg, p["attn"], x, positions, causal=True)
        else:
            h = h + mamba_apply(cfg, p["mamba"][im], x)
            im += 1
        h = _ffn(cfg, p, h, i)
    return h, torch.zeros((), device=h.device)


def superblock_prefill(cfg: ModelConfig, p: Params, h: torch.Tensor,
                       positions: torch.Tensor,
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: also returns this superblock's decode state, the attention
    K/V [B,S,kv_dim] and the Mamba ``conv``/``ssm`` [n_mamba, B, ...].
    The Mamba layers take the state-returning scan, never the kernel."""
    cache: Dict[str, torch.Tensor] = {}
    states = []
    im = 0
    for i, mixer in enumerate(_positions(cfg)):
        x = rmsnorm(h, p["ln_mix"][i], cfg.rms_eps)
        if mixer == "attn":
            a, kv = attention_prefill(cfg, p["attn"], x, positions)
            h = h + a
            cache.update(kv)
        else:
            y, st = mamba_apply(cfg, p["mamba"][im], x, return_state=True)
            h = h + y
            states.append(st)
            im += 1
        h = _ffn(cfg, p, h, i)
    for name in ("conv", "ssm"):
        cache[name] = torch.stack([st[name] for st in states])
    return h, cache


def superblock_decode(cfg: ModelConfig, p: Params, h: torch.Tensor,
                      positions: torch.Tensor, cache: Dict[str, torch.Tensor],
                      index: torch.Tensor) -> torch.Tensor:
    """One-token step.  ``cache`` holds this superblock's ``k``/``v``
    [B, max_len, kv_dim], ``conv`` [n_mamba, B, K-1, di] and ``ssm``
    [n_mamba, B, di, N]; all four are updated in place."""
    im = 0
    for i, mixer in enumerate(_positions(cfg)):
        x = rmsnorm(h, p["ln_mix"][i], cfg.rms_eps)
        if mixer == "attn":
            a, _, _ = attention_decode(cfg, p["attn"], x, positions,
                                       cache["k"], cache["v"], index)
            h = h + a
        else:
            st = {"conv": cache["conv"][im], "ssm": cache["ssm"][im]}
            y, new = mamba_decode(cfg, p["mamba"][im], x, st)
            h = h + y
            for name, t in new.items():
                st[name].copy_(t)
            im += 1
        h = _ffn(cfg, p, h, i)
    return h


def hybrid_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    nb = cfg.num_layers // cfg.hybrid_period
    one = mamba_cache_init(cfg, batch, device)
    dt = torch_dtype(cfg.dtype)
    kv = (nb, batch, max_len, cfg.kv_dim)
    return {
        "k": torch.zeros(kv, dtype=dt, device=device),
        "v": torch.zeros(kv, dtype=dt, device=device),
        **{name: torch.zeros((nb, n_mamba(cfg)) + tuple(t.shape),
                             dtype=t.dtype, device=device)
           for name, t in one.items()},
    }
