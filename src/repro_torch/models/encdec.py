"""Encoder-decoder backbone (SeamlessM4T-medium shape).

Counterpart of ``repro/models/encdec.py``.  Encoder: bidirectional
self-attention blocks over stub frame embeddings.  Decoder: causal
self-attention + cross-attention to the encoder states.  Under
``attention_impl="pallas"`` every attention that the reference sends to
``_attend`` takes the flash kernel: the encoder's (non-causal), the
decoder's self-attention (causal) and cross-attention (non-causal,
Sq != Skv; one query row a decode step).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models.attention import (
    _attend, _project_q, _project_qkv, attention_apply, attention_axes,
    attention_decode, attention_init, attention_prefill,
)
from repro_torch.models.layers import (
    Axes, Params, mlp_apply, mlp_axes, mlp_init, rmsnorm, rmsnorm_init,
    torch_dtype,
)


# ---------------------------------------------------------------------------
# encoder block (bidirectional)
# ---------------------------------------------------------------------------

def enc_block_init(cfg: ModelConfig, gen: torch.Generator,
                   device: torch.device) -> Params:
    dt = torch_dtype(cfg.param_dtype)
    return {
        "ln1": rmsnorm_init(cfg.d_model, dt, device),
        "attn": attention_init(cfg, gen, device),
        "ln2": rmsnorm_init(cfg.d_model, dt, device),
        "mlp": mlp_init(cfg, gen, device),
    }


def enc_block_axes(cfg: ModelConfig) -> Axes:
    return {"ln1": ("embed",), "attn": attention_axes(cfg),
            "ln2": ("embed",), "mlp": mlp_axes(cfg)}


def enc_block_apply(cfg: ModelConfig, p: Params, h: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    a = attention_apply(cfg, p["attn"], rmsnorm(h, p["ln1"], cfg.rms_eps),
                        positions, causal=False)
    h = h + a
    return h + mlp_apply(cfg, p["mlp"], rmsnorm(h, p["ln2"], cfg.rms_eps))


# ---------------------------------------------------------------------------
# decoder block (causal self-attn + cross-attn)
# ---------------------------------------------------------------------------

def dec_block_init(cfg: ModelConfig, gen: torch.Generator,
                   device: torch.device) -> Params:
    dt = torch_dtype(cfg.param_dtype)
    return {
        "ln1": rmsnorm_init(cfg.d_model, dt, device),
        "self_attn": attention_init(cfg, gen, device),
        "ln_x": rmsnorm_init(cfg.d_model, dt, device),
        "cross_attn": attention_init(cfg, gen, device, cross=True),
        "ln2": rmsnorm_init(cfg.d_model, dt, device),
        "mlp": mlp_init(cfg, gen, device),
    }


def dec_block_axes(cfg: ModelConfig) -> Axes:
    return {
        "ln1": ("embed",), "self_attn": attention_axes(cfg),
        "ln_x": ("embed",), "cross_attn": attention_axes(cfg),
        "ln2": ("embed",), "mlp": mlp_axes(cfg),
    }


def dec_block_apply(cfg: ModelConfig, p: Params, h: torch.Tensor,
                    positions: torch.Tensor, enc_h: torch.Tensor,
                    enc_positions: torch.Tensor) -> torch.Tensor:
    a = attention_apply(cfg, p["self_attn"],
                        rmsnorm(h, p["ln1"], cfg.rms_eps),
                        positions, causal=True)
    h = h + a
    x = attention_apply(cfg, p["cross_attn"],
                        rmsnorm(h, p["ln_x"], cfg.rms_eps),
                        positions, causal=False, kv_x=enc_h,
                        kv_positions=enc_positions)
    h = h + x
    return h + mlp_apply(cfg, p["mlp"], rmsnorm(h, p["ln2"], cfg.rms_eps))


def dec_block_prefill(cfg: ModelConfig, p: Params, h: torch.Tensor,
                      positions: torch.Tensor, enc_h: torch.Tensor,
                      enc_positions: torch.Tensor,
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (h, the layer's cache entries): self-attention ``k``/``v``
    [B,S,kv_dim] and the encoder-side ``xk``/``xv`` [B,Senc,kv_dim],
    projected once here so decode never projects them again."""
    a, self_kv = attention_prefill(cfg, p["self_attn"],
                                   rmsnorm(h, p["ln1"], cfg.rms_eps),
                                   positions)
    h = h + a
    xn = rmsnorm(h, p["ln_x"], cfg.rms_eps)
    q, ck, cv = _project_qkv(cfg, p["cross_attn"], xn, positions,
                             kv_x=enc_h, kv_positions=enc_positions)
    o = _attend(cfg, q, ck, cv, causal=False)
    B, S = h.shape[:2]
    dt = torch_dtype(cfg.dtype)
    h = h + o.reshape(B, S, cfg.q_dim) @ p["cross_attn"]["wo"].to(dt)
    h = h + mlp_apply(cfg, p["mlp"], rmsnorm(h, p["ln2"], cfg.rms_eps))
    Senc = enc_h.shape[1]
    cache = {
        "k": self_kv["k"], "v": self_kv["v"],
        "xk": ck.reshape(B, Senc, cfg.kv_dim),
        "xv": cv.reshape(B, Senc, cfg.kv_dim),
    }
    return h, cache


def dec_block_decode(cfg: ModelConfig, p: Params, h: torch.Tensor,
                     positions: torch.Tensor, cache: Dict[str, torch.Tensor],
                     index: torch.Tensor) -> torch.Tensor:
    """One-token decode.  ``cache`` holds the layer's ``k``/``v``
    [B,Smax,kv_dim], written in place at ``index``, and ``xk``/``xv``
    [B,Senc,kv_dim], attended in full (no mask, as in the reference)."""
    a, _, _ = attention_decode(cfg, p["self_attn"],
                               rmsnorm(h, p["ln1"], cfg.rms_eps),
                               positions, cache["k"], cache["v"], index)
    h = h + a
    xn = rmsnorm(h, p["ln_x"], cfg.rms_eps)
    B = h.shape[0]
    Senc = cache["xk"].shape[1]
    q = _project_q(cfg, p["cross_attn"], xn, positions)
    kk = cache["xk"].reshape(B, Senc, cfg.num_kv_heads, cfg.head_dim)
    vv = cache["xv"].reshape(B, Senc, cfg.num_kv_heads, cfg.head_dim)
    o = _attend(cfg, q, kk, vv, causal=False)
    dt = torch_dtype(cfg.dtype)
    h = h + o.reshape(B, 1, cfg.q_dim) @ p["cross_attn"]["wo"].to(dt)
    return h + mlp_apply(cfg, p["mlp"], rmsnorm(h, p["ln2"], cfg.rms_eps))
