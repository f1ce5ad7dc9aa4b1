"""Top-level model API: init / forward / prefill / decode, ``DENSE`` family.

Counterpart of ``repro/models/model.py``.  The reference stacks layer
parameters and runs ``jax.lax.scan`` over them; here ``p["blocks"]`` is a
list of per-layer dicts and depth is a Python loop.  The KV cache keeps
the reference's layout: ``k``/``v`` [L, B, max_len, kv_dim] and a per-slot
``index`` [B] (int32).  ``loss_fn`` and remat wait for the training slice;
the other families for their own slices (ROADMAP).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.config.base import DENSE, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != DENSE:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; ROADMAP.md lists the "
            "slice that ports it")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Params:
    """Random parameters drawn from ``generator`` (on ``device``'s type)."""
    _require_dense(cfg)
    dev = resolve_device(device)
    dt = L.torch_dtype(cfg.param_dtype)
    return {
        "embed": L.embedding_init(cfg, generator, dev),
        "final_norm": L.rmsnorm_init(cfg.d_model, dt, dev),
        "blocks": [B.block_init(cfg, generator, dev)
                   for _ in range(cfg.num_layers)],
    }


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------

def _logits(cfg: ModelConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(h, p["final_norm"], cfg.rms_eps)
    return L.unembed(cfg, p["embed"], h)


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, p: Params, batch: Batch,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B,S,V], aux_loss)."""
    _require_dense(cfg)
    positions = batch["positions"]
    h = L.embed_tokens(cfg, p["embed"], batch["tokens"])
    aux = torch.zeros((), device=h.device)
    for lp in p["blocks"]:
        h, a = B.block_apply(cfg, lp, h, positions)
        aux = aux + a
    return _logits(cfg, p, h), aux


# ---------------------------------------------------------------------------
# KV-cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = "cuda") -> Params:
    _require_dense(cfg)
    dev = resolve_device(device)
    dt = L.torch_dtype(cfg.dtype)
    shape = (cfg.num_layers, batch, max_len, cfg.kv_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "index": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill(cfg: ModelConfig, p: Params, batch: Batch, max_len: int,
            ) -> Tuple[torch.Tensor, Params]:
    """Run the full prompt; returns (last-position logits, filled cache)."""
    _require_dense(cfg)
    positions = batch["positions"]
    h = L.embed_tokens(cfg, p["embed"], batch["tokens"])
    kvs = []
    for lp in p["blocks"]:
        h, kv, _ = B.block_prefill(cfg, lp, h, positions)
        kvs.append(kv)
    cache = _embed_cache(cfg, kvs, h.shape[0], max_len)
    Bsz, S = batch["tokens"].shape
    cache["index"] = torch.full((Bsz,), S, dtype=torch.int32, device=h.device)
    return _logits(cfg, p, h[:, -1:, :]), cache


def _embed_cache(cfg: ModelConfig, kvs: List[Dict[str, torch.Tensor]],
                 batch: int, max_len: int) -> Params:
    """Pad per-layer prefill K/V [B,S,kv] into a [L,B,max_len,kv] cache."""
    S = kvs[0]["k"].shape[1]
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len={max_len}")
    dt = L.torch_dtype(cfg.dtype)
    out = {}
    for name in ("k", "v"):
        t = torch.zeros((len(kvs), batch, max_len, cfg.kv_dim), dtype=dt,
                        device=kvs[0][name].device)
        for i, kv in enumerate(kvs):
            t[i, :, :S] = kv[name]
        out[name] = t
    return out


def decode_step(cfg: ModelConfig, p: Params, tokens: torch.Tensor,
                cache: Params) -> Tuple[torch.Tensor, Params]:
    """One-token decode.  tokens: [B,1] -> (logits [B,1,V], new cache).

    The k/v tensors of ``cache`` are updated in place and shared by the
    returned cache; its ``index`` is a new tensor, one higher for every
    slot, active or not, as in the reference.
    """
    _require_dense(cfg)
    index = cache["index"]
    h = L.embed_tokens(cfg, p["embed"], tokens)
    pos = index[:, None]
    for i, lp in enumerate(p["blocks"]):
        h, _, _ = B.block_decode(cfg, lp, h, pos, cache["k"][i],
                                 cache["v"][i], index)
    new_cache = dict(cache)
    new_cache["index"] = index + 1
    return _logits(cfg, p, h), new_cache
