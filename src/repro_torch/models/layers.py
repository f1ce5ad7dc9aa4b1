"""Shared building blocks: norms, RoPE/M-RoPE, SwiGLU, embeddings.

Counterpart of ``repro/models/layers.py``.  Parameters are plain nested
dicts of tensors with the reference's names and layouts (weights stored
[in, out], so a projection is ``x @ w``).  Inits take an explicit
``torch.Generator`` and device; they match the reference in distribution
only (``jax.random`` bits cannot be reproduced), which is why the tests
bring the reference's own parameters over with ``repro_torch.bridge``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig

Params = Dict[str, Any]
# logical axis names of each parameter dim (``parallel/sharding.py``)
Axes = Dict[str, Any]


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
# RoPE / M-RoPE
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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): rotate ``x`` [..., S, H, D] by
    ``positions`` [3, ..., S] (t, h, w).

    Frequency index i in [0, D/2) takes its position id from the section
    it falls into: sections = (n_t, n_h, n_w), sum = D/2.  Positions
    without the leading (t, h, w) axis raise; the reference's gather
    fills the missing sections with NaN there.
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim / 2 = {half}")
    if positions.dim() != x.dim() - 1 or positions.shape[0] != len(sections):
        raise ValueError(f"M-RoPE wants positions [{len(sections)}, ..., S] "
                         f"for x {tuple(x.shape)}; got "
                         f"{tuple(positions.shape)}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # [half]
    # section j's frequencies take position ids positions[j]: the
    # reference's per-frequency gather, by slices (no host round trip)
    bounds = [0]
    for n in sections:
        bounds.append(bounds[-1] + n)
    angles = torch.cat([positions[j].float()[..., None] * freqs[a:b]
                        for j, (a, b) in enumerate(zip(bounds, bounds[1:]))],
                       dim=-1)                                   # [..., S, half]
    cos = torch.cos(angles)[..., None, :]
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


def mlp_axes(cfg: ModelConfig) -> Axes:
    return {
        "wi_gate": ("embed", "mlp"),
        "wi_up": ("embed", "mlp"),
        "wo": ("mlp", "embed"),
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
    dt = torch_dtype(cfg.param_dtype)
    p = {"embedding": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                                 device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt,
                                  device)
    if cfg.frontend_embed_dim:
        # modality frontend stub projection (identity-shaped if dims equal)
        p["frontend_proj"] = dense_init(
            gen, (cfg.frontend_embed_dim, cfg.d_model), dt, device)
    return p


def embedding_axes(cfg: ModelConfig) -> Axes:
    a: Axes = {"embedding": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        a["unembed"] = ("embed", "vocab")
    if cfg.frontend_embed_dim:
        a["frontend_proj"] = (None, "embed")
    return a


def embed_tokens(cfg: ModelConfig, p: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens].to(torch_dtype(cfg.dtype))


def unembed(cfg: ModelConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    w = p["embedding"].T if cfg.tie_embeddings else p["unembed"]
    return h @ w.to(torch_dtype(cfg.dtype))
