"""Shared building blocks: norms, RoPE, SwiGLU, embeddings.

Counterpart of ``repro/models/layers.py``.  Parameters are plain nested
dicts of tensors with the reference's names and layouts (weights stored
[in, out], so a projection is ``x @ w``).  Inits take an explicit
``torch.Generator`` and device; they match the reference in distribution
only (``jax.random`` bits cannot be reproduced), which is why the tests
bring the reference's own parameters over with ``repro_torch.bridge``.
M-RoPE waits for the VLM slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (config dtypes are strings)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               device: torch.device, in_axis: int = 0) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init (MaxText-style), f32 then cast."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * (1.0 / math.sqrt(shape[in_axis]))).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    t.normal_(0.0, 1.0, generator=gen)
    return (t * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2] (float32)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate ``x`` [..., S, H, D] by per-token ``positions`` [..., S]."""
    if theta <= 0.0:  # NoPE
        return x
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # [half]
    angles = positions[..., None].float() * freqs                # [..., S, half]
    cos = torch.cos(angles)[..., None, :]                        # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_init(cfg: ModelConfig, gen: torch.Generator, device: torch.device,
             d_ff: Optional[int] = None) -> Params:
    d_ff = d_ff or cfg.d_ff
    dt = torch_dtype(cfg.param_dtype)
    return {
        "wi_gate": dense_init(gen, (cfg.d_model, d_ff), dt, device),
        "wi_up": dense_init(gen, (cfg.d_model, d_ff), dt, device),
        "wo": dense_init(gen, (d_ff, cfg.d_model), dt, device),
    }


def mlp_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    dt = torch_dtype(cfg.dtype)
    gate = x @ p["wi_gate"].to(dt)
    up = x @ p["wi_up"].to(dt)
    return (F.silu(gate) * up) @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embedding_init(cfg: ModelConfig, gen: torch.Generator,
                   device: torch.device) -> Params:
    if cfg.frontend_embed_dim:
        raise NotImplementedError(
            "modality frontends wait for ROADMAP port slice (f), enc-dec / VLM")
    dt = torch_dtype(cfg.param_dtype)
    p = {"embedding": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                                 device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt,
                                  device)
    return p


def embed_tokens(cfg: ModelConfig, p: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens].to(torch_dtype(cfg.dtype))


def unembed(cfg: ModelConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    w = p["embedding"].T if cfg.tie_embeddings else p["unembed"]
    return h @ w.to(torch_dtype(cfg.dtype))
