"""GQA attention, dense path: init, full/prefill forward, decode.

Counterpart of ``repro/models/attention.py``.  Two implementations of the
full-sequence attention share one module, selected by
``cfg.attention_impl``:
  * ``xla``    - plain PyTorch, q-block-chunked softmax(QK^T)V;
  * ``pallas`` - the hand-written CUDA flash-attention kernel through
                 ``kernels/ops.py`` (its plain version on a CPU tensor).
Decode attention is plain PyTorch, as in the reference.  Cross-attention
(the enc-dec decoder's) takes its keys and values from ``kv_x`` at
``kv_positions``; VLM configs rotate with M-RoPE, positions [3, B, S].

Weights are stored with flattened head dims ([d_model, H*Dh]).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (
    Params, apply_mrope, apply_rope, dense_init, rmsnorm, rmsnorm_init,
    torch_dtype,
)

ATTN_CHUNK = 2048  # q-block size for the chunked plain path
NEG_INF = -1e30


def attention_init(cfg: ModelConfig, gen: torch.Generator,
                   device: torch.device, *, cross: bool = False) -> Params:
    """Self- or (``cross``) cross-attention weights: the same leaves."""
    del cross
    dt = torch_dtype(cfg.param_dtype)
    p: Params = {
        "wq": dense_init(gen, (cfg.d_model, cfg.q_dim), dt, device),
        "wk": dense_init(gen, (cfg.d_model, cfg.kv_dim), dt, device),
        "wv": dense_init(gen, (cfg.d_model, cfg.kv_dim), dt, device),
        "wo": dense_init(gen, (cfg.q_dim, cfg.d_model), dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.q_dim,), dtype=dt, device=device)
        p["bk"] = torch.zeros((cfg.kv_dim,), dtype=dt, device=device)
        p["bv"] = torch.zeros((cfg.kv_dim,), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(cfg.head_dim, dt, device)
        p["k_norm"] = rmsnorm_init(cfg.head_dim, dt, device)
    return p


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def _rotate(cfg: ModelConfig, t: torch.Tensor,
            positions: torch.Tensor) -> torch.Tensor:
    """RoPE (M-RoPE where ``cfg.mrope_sections``) of [B,S,H,Dh] heads."""
    if cfg.rope_theta <= 0.0:
        return t
    if cfg.mrope_sections:
        return apply_mrope(t, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(t, positions, cfg.rope_theta)


def _project_q(cfg: ModelConfig, p: Params, x: torch.Tensor,
               positions: Optional[torch.Tensor]) -> torch.Tensor:
    """q [B,S,Hq,Dh] with qk-norm + RoPE applied."""
    dt = torch_dtype(cfg.dtype)
    q = x @ p["wq"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
    B, S = x.shape[:2]
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.rms_eps)
    return q if positions is None else _rotate(cfg, q, positions)


def _project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 positions: Optional[torch.Tensor],
                 kv_x: Optional[torch.Tensor] = None,
                 kv_positions: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns q [B,S,Hq,Dh], k/v [B,Skv,Hkv,Dh] with qk-norm + RoPE applied.

    k and v come from ``kv_x`` (default ``x``), rotated by
    ``kv_positions`` (default ``positions``)."""
    dt = torch_dtype(cfg.dtype)
    kv_x = x if kv_x is None else kv_x
    q = _project_q(cfg, p, x, positions)
    k = kv_x @ p["wk"].to(dt)
    v = kv_x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    B, Skv = kv_x.shape[:2]
    k = k.reshape(B, Skv, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, Skv, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.rms_eps)
    if positions is not None:
        k = _rotate(cfg, k, positions if kv_positions is None
                    else kv_positions)
    return q, k, v


# ---------------------------------------------------------------------------
# chunked softmax attention (plain path)
# ---------------------------------------------------------------------------

def repeat_kv(cfg: ModelConfig, t: torch.Tensor) -> torch.Tensor:
    """[B,S,Hkv,Dh] -> [B,S,Hq,Dh]."""
    G = cfg.num_heads // cfg.num_kv_heads
    if G == 1:
        return t
    return torch.repeat_interleave(t, G, dim=2)


def _attend_chunked(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, *, causal: bool,
                    q_offset: int = 0) -> torch.Tensor:
    """softmax(QK^T)V with the q axis processed in ATTN_CHUNK blocks.

    Bounds the materialized score tensor to [B,H,chunk,Skv].
    q: [B,Sq,Hq,Dh]  k,v: [B,Skv,Hkv,Dh]  ->  [B,Sq,Hq,Dh]
    """
    B, Sq, Hq, Dh = q.shape
    Skv = k.shape[1]
    scale = Dh ** -0.5
    kf = repeat_kv(cfg, k).float()
    vf = repeat_kv(cfg, v).float()
    kpos = torch.arange(Skv, device=q.device)
    if Sq > ATTN_CHUNK and Sq % ATTN_CHUNK:
        raise ValueError(f"Sq={Sq} must be <= or a multiple of {ATTN_CHUNK}")
    out = []
    for c0 in range(0, Sq, ATTN_CHUNK):
        qb = q[:, c0:c0 + ATTN_CHUNK]
        s = torch.einsum("bchd,bshd->bchs", qb.float() * scale, kf)
        if causal:
            qpos = q_offset + c0 + torch.arange(qb.shape[1], device=q.device)
            mask = qpos[:, None] >= kpos[None, :]                 # [C, Skv]
            s = torch.where(mask[None, :, None, :], s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        out.append(torch.einsum("bchs,bshd->bchd", w, vf).to(q.dtype))
    return torch.cat(out, dim=1)


def _attend(cfg: ModelConfig, q, k, v, *, causal, q_offset: int = 0):
    if cfg.attention_impl == "pallas":
        return kops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    return _attend_chunked(cfg, q, k, v, causal=causal, q_offset=q_offset)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def attention_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    kv_x: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    ) -> torch.Tensor:
    """Full (train/prefill) attention.  x: [B,S,d] -> [B,S,d]; with
    ``kv_x`` [B,Skv,d], cross-attention to it."""
    dt = torch_dtype(cfg.dtype)
    q, k, v = _project_qkv(cfg, p, x, positions, kv_x, kv_positions)
    o = _attend(cfg, q, k, v, causal=causal)
    B, S = x.shape[:2]
    return o.reshape(B, S, cfg.q_dim) @ p["wo"].to(dt)


def attention_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      positions: torch.Tensor,
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: returns output AND the (flattened-kv) cache entries."""
    dt = torch_dtype(cfg.dtype)
    q, k, v = _project_qkv(cfg, p, x, positions)
    o = _attend(cfg, q, k, v, causal=True)
    B, S = x.shape[:2]
    out = o.reshape(B, S, cfg.q_dim) @ p["wo"].to(dt)
    cache = {"k": k.reshape(B, S, cfg.kv_dim), "v": v.reshape(B, S, cfg.kv_dim)}
    return out, cache


def attention_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     positions: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_index: torch.Tensor,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode step against a [B, Smax, kv_dim] cache.

    x: [B,1,d]; ``cache_index`` is a per-slot [B] vector.  The new k/v are
    written into ``cache_k``/``cache_v`` IN PLACE (the reference returns
    new arrays; here that would copy the whole cache per layer and step)
    and the same tensors are returned.  A slot whose index is >= Smax is
    not written, as the reference's ``mode="drop"`` scatter drops it.
    Returns (out [B,1,d], cache_k, cache_v).
    """
    dt = torch_dtype(cfg.dtype)
    B = x.shape[0]
    Smax = cache_k.shape[1]
    q, k, v = _project_qkv(cfg, p, x, positions)
    k = k.reshape(B, cfg.kv_dim).to(cache_k.dtype)
    v = v.reshape(B, cfg.kv_dim).to(cache_v.dtype)
    bidx = torch.arange(B, device=x.device)
    keep = (cache_index < Smax)[:, None]
    pos = cache_index.clamp(max=Smax - 1)
    # out-of-range slots rewrite their last row with its own value: no sync
    cache_k[bidx, pos] = torch.where(keep, k, cache_k[bidx, pos])
    cache_v[bidx, pos] = torch.where(keep, v, cache_v[bidx, pos])
    G = cfg.num_heads // cfg.num_kv_heads
    kk = cache_k.reshape(B, Smax, cfg.num_kv_heads, cfg.head_dim)
    vv = cache_v.reshape(B, Smax, cfg.num_kv_heads, cfg.head_dim)
    # grouped einsum instead of the reference's repeat_kv: same sums, no
    # [B,Smax,Hq,Dh] copy of the cache
    qg = q.reshape(B, cfg.num_kv_heads, G, cfg.head_dim)
    scale = cfg.head_dim ** -0.5
    s = torch.einsum("bhgd,bshd->bhgs", qg.float() * scale, kk.float())
    # mask positions beyond each slot's index (index = this token's slot)
    valid = (torch.arange(Smax, device=x.device)[None, :]
             <= cache_index[:, None])[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", w, vv.float())
    o = o.to(dt).reshape(B, 1, cfg.q_dim)
    return o @ p["wo"].to(dt), cache_k, cache_v
