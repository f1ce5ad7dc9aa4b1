"""Jamba-style hybrid superblock: period-P interleave of Mamba and attention.

Counterpart of ``repro/models/hybrid.py``.  With period 8, attn_pos 4 and
MoE on odd positions the superblock is

    pos 0: mamba + MLP        pos 4: attention + MLP
    pos 1: mamba + MoE        pos 5: mamba + MoE
    pos 2: mamba + MLP        pos 6: mamba + MLP
    pos 3: mamba + MoE        pos 7: mamba + MoE

and without experts every position's FFN is the MLP.  The reference
stacks each superblock's Mamba, MLP and MoE layers on a leading axis;
here ``p["mamba"]``, ``p["mlp"]`` and ``p["moe"]`` are lists of per-layer
dicts, and ``ln_mix``/``ln_ffn`` stay [period, d] tensors.  The decode
cache keeps the reference's layout: ``k``/``v`` [nb, B, max_len, kv_dim],
``conv`` [nb, n_mamba, B, K-1, di] and ``ssm`` [nb, n_mamba, B, di, N]
(f32), so batch is axis 2 of the Mamba entries.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models.attention import (
    attention_apply, attention_axes, attention_decode, attention_init,
    attention_prefill,
)
from repro_torch.models.layers import (
    Axes, Params, mlp_apply, mlp_axes, mlp_init, rmsnorm, torch_dtype,
)
from repro_torch.models.mamba import (
    mamba_apply, mamba_axes, mamba_cache_init, mamba_decode, mamba_init,
)
from repro_torch.models.moe import moe_apply, moe_axes, moe_init


def _positions(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """[(mixer, ffn)] for each position in one superblock: the mixer is
    "attn" or "mamba", the FFN "moe" where ``i % moe_every == moe_offset``
    (with experts) and "mlp" elsewhere."""
    m = cfg.moe
    out = []
    for i in range(cfg.hybrid_period):
        mixer = "attn" if i == cfg.hybrid_attn_pos else "mamba"
        is_moe = cfg.is_moe and i % m.moe_every == m.moe_offset
        out.append((mixer, "moe" if is_moe else "mlp"))
    return out


def n_mamba(cfg: ModelConfig) -> int:
    return sum(1 for mixer, _ in _positions(cfg) if mixer == "mamba")


def n_moe(cfg: ModelConfig) -> int:
    return sum(1 for _, ffn in _positions(cfg) if ffn == "moe")


def superblock_init(cfg: ModelConfig, gen: torch.Generator,
                    device: torch.device) -> Params:
    dt = torch_dtype(cfg.param_dtype)
    pos = _positions(cfg)
    p = {
        "attn": attention_init(cfg, gen, device),
        "mamba": [mamba_init(cfg, gen, device) for _ in range(n_mamba(cfg))],
        "mlp": [mlp_init(cfg, gen, device)
                for _ in range(len(pos) - n_moe(cfg))],
        "ln_mix": torch.ones((len(pos), cfg.d_model), dtype=dt, device=device),
        "ln_ffn": torch.ones((len(pos), cfg.d_model), dtype=dt, device=device),
    }
    if n_moe(cfg):
        p["moe"] = [moe_init(cfg, gen, device) for _ in range(n_moe(cfg))]
    return p


def superblock_axes(cfg: ModelConfig) -> Axes:
    """The reference's superblock axes without its ``"sublayer"`` axis:
    the port keeps those layers as lists, one axes dict each."""
    a: Axes = {
        "attn": attention_axes(cfg),
        "mamba": [mamba_axes(cfg) for _ in range(n_mamba(cfg))],
        "mlp": [mlp_axes(cfg) for _ in range(cfg.hybrid_period - n_moe(cfg))],
        "ln_mix": (None, "embed"),
        "ln_ffn": (None, "embed"),
    }
    if n_moe(cfg):
        a["moe"] = [moe_axes(cfg) for _ in range(n_moe(cfg))]
    return a


def _layers(cfg: ModelConfig, p: Params):
    """Per position: (position, mixer, ffn kind, that FFN's parameters)."""
    io = il = 0
    for i, (mixer, ffn) in enumerate(_positions(cfg)):
        if ffn == "moe":
            yield i, mixer, ffn, p["moe"][io]
            io += 1
        else:
            yield i, mixer, ffn, p["mlp"][il]
            il += 1


def _ffn(cfg: ModelConfig, p: Params, h: torch.Tensor, i: int,
         ffn: str, fp: Params) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """h + FFN(norm(h)) at position i -> (h, aux loss or None for an MLP)."""
    x = rmsnorm(h, p["ln_ffn"][i], cfg.rms_eps)
    if ffn == "moe":
        y, aux = moe_apply(cfg, fp, x)
        return h + y, aux
    return h + mlp_apply(cfg, fp, x), None


def superblock_apply(cfg: ModelConfig, p: Params, h: torch.Tensor,
                     positions: torch.Tensor,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward through one superblock -> (h, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    im = 0
    for i, mixer, ffn, fp in _layers(cfg, p):
        x = rmsnorm(h, p["ln_mix"][i], cfg.rms_eps)
        if mixer == "attn":
            h = h + attention_apply(cfg, p["attn"], x, positions, causal=True)
        else:
            h = h + mamba_apply(cfg, p["mamba"][im], x)
            im += 1
        h, a = _ffn(cfg, p, h, i, ffn, fp)
        if a is not None:
            aux = aux + a
    return h, aux


def superblock_prefill(cfg: ModelConfig, p: Params, h: torch.Tensor,
                       positions: torch.Tensor,
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                  torch.Tensor]:
    """Prefill: also returns this superblock's decode state, the attention
    K/V [B,S,kv_dim] and the Mamba ``conv``/``ssm`` [n_mamba, B, ...], and
    its aux loss.  The Mamba layers take the state-returning scan (the
    kernel under ``scan_impl="pallas"``)."""
    cache: Dict[str, torch.Tensor] = {}
    states = []
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    im = 0
    for i, mixer, ffn, fp in _layers(cfg, p):
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
        h, a = _ffn(cfg, p, h, i, ffn, fp)
        if a is not None:
            aux = aux + a
    for name in ("conv", "ssm"):
        cache[name] = torch.stack([st[name] for st in states])
    return h, cache, aux


def superblock_decode(cfg: ModelConfig, p: Params, h: torch.Tensor,
                      positions: torch.Tensor, cache: Dict[str, torch.Tensor],
                      index: torch.Tensor) -> torch.Tensor:
    """One-token step.  ``cache`` holds this superblock's ``k``/``v``
    [B, max_len, kv_dim], ``conv`` [n_mamba, B, K-1, di] and ``ssm``
    [n_mamba, B, di, N]; all four are updated in place."""
    im = 0
    for i, mixer, ffn, fp in _layers(cfg, p):
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
        h, _ = _ffn(cfg, p, h, i, ffn, fp)
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
