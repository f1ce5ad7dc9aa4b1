"""Top-level model API: init / forward / loss / prefill / decode, per
family.

Counterpart of ``repro/models/model.py``.  The reference stacks layer
parameters and runs ``jax.lax.scan`` over them; here ``p["blocks"]`` is a
list of per-layer (hybrid: per-superblock) dicts and depth is a Python
loop; the enc-dec family has two such lists, ``enc_blocks`` and
``dec_blocks``.  The caches keep the reference's layouts: dense and VLM
``k``/``v`` [L, B, max_len, kv_dim]; RWKV6 ``tshift``/``cshift`` [L, B, d]
and ``wkv`` [L, B, H, D, D] (f32); hybrid ``k``/``v`` [nb, B, max_len,
kv_dim], ``conv`` [nb, n_mamba, B, K-1, di] and ``ssm`` [nb, n_mamba, B,
di, N] (f32); enc-dec ``k``/``v`` [Ld, B, max_len, kv_dim] and the
encoder-side ``xk``/``xv`` [Ld, B, Senc, kv_dim] (``init_cache`` gives
them ``max_len`` rows, as the reference's does); all with a per-slot
``index`` [B] (int32).  ``cache_batch_axes`` says which axis of each
entry is the batch.  ``MOE`` and ``VLM`` run the ``DENSE`` branches
(MoE blocks hold ``moe`` in place of ``mlp``, and their aux losses reach
``loss_fn``; VLM prepends its frontend embeddings and rotates with
M-RoPE, positions [3, B, S]).

Under grad mode ``forward`` and ``loss_fn`` differentiate through autograd
on the plain paths (``attention_impl``/``scan_impl`` ``"xla"``; a CUDA
kernel refuses grad, ``kernels/_grad.py``).  ``cfg.remat`` is the
reference's ``_maybe_remat``: each group of ``cfg.layers_per_step`` blocks
(of either enc-dec stack) runs inside ``torch.utils.checkpoint``, saving
nothing inside the group (``"full"``) or the matmul outputs (``"dots"``,
the reference's ``checkpoint_dots``).  Without grad mode the groups run as
they are.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.config.base import ENCDEC, HYBRID, SSM, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as RW

Params = Dict[str, Any]
Batch = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Params:
    """Random parameters drawn from ``generator`` (on ``device``'s type)."""
    dev = resolve_device(device)
    dt = L.torch_dtype(cfg.param_dtype)
    p: Params = {
        "embed": L.embedding_init(cfg, generator, dev),
        "final_norm": L.rmsnorm_init(cfg.d_model, dt, dev),
    }
    if cfg.family == ENCDEC:
        p["enc_blocks"] = [ED.enc_block_init(cfg, generator, dev)
                           for _ in range(cfg.encoder_layers)]
        p["dec_blocks"] = [ED.dec_block_init(cfg, generator, dev)
                           for _ in range(cfg.decoder_layers)]
        p["enc_norm"] = L.rmsnorm_init(cfg.d_model, dt, dev)
        return p
    n = cfg.num_layers
    if cfg.family == HYBRID:
        block_init, n = HY.superblock_init, n // cfg.hybrid_period
    elif cfg.family == SSM:
        block_init = RW.rwkv_init
    else:
        block_init = B.block_init
    p["blocks"] = [block_init(cfg, generator, dev) for _ in range(n)]
    return p


def param_axes(cfg: ModelConfig) -> Any:
    """Logical axes of every parameter, in the tree of ``init_params``:
    the reference's ``param_axes`` without the stacked ``"layers"`` axis
    (and, in a hybrid superblock, ``"sublayer"``), since the port keeps
    those layers as lists."""
    a: Dict[str, Any] = {
        "embed": L.embedding_axes(cfg),
        "final_norm": ("embed",),
    }
    if cfg.family == ENCDEC:
        a["enc_blocks"] = [ED.enc_block_axes(cfg)
                           for _ in range(cfg.encoder_layers)]
        a["dec_blocks"] = [ED.dec_block_axes(cfg)
                           for _ in range(cfg.decoder_layers)]
        a["enc_norm"] = ("embed",)
        return a
    n = cfg.num_layers
    if cfg.family == HYBRID:
        block_axes, n = HY.superblock_axes, n // cfg.hybrid_period
    elif cfg.family == SSM:
        block_axes = RW.rwkv_axes
    else:
        block_axes = B.block_axes
    a["blocks"] = [block_axes(cfg) for _ in range(n)]
    return a


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------

def _frontend(cfg: ModelConfig, p: Params, batch: Batch) -> torch.Tensor:
    """The frontend embeddings [B,Sf,E] projected to [B,Sf,d]."""
    dt = L.torch_dtype(cfg.dtype)
    return batch["frontend"].to(dt) @ p["embed"]["frontend_proj"].to(dt)


def _prepends_frontend(cfg: ModelConfig, batch: Batch) -> bool:
    """Whether the batch's frontend embeddings go before its tokens (VLM);
    the enc-dec frontend feeds the encoder instead."""
    return bool(cfg.frontend_embed_dim) and "frontend" in batch \
        and cfg.family != ENCDEC


def _embed_inputs(cfg: ModelConfig, p: Params, batch: Batch) -> torch.Tensor:
    """Token embeddings, with modality-frontend embeddings prepended."""
    h = L.embed_tokens(cfg, p["embed"], batch["tokens"])
    if _prepends_frontend(cfg, batch):
        h = torch.cat([_frontend(cfg, p, batch), h], dim=1)
    return h


def _logits(cfg: ModelConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    h = L.rmsnorm(h, p["final_norm"], cfg.rms_eps)
    return L.unembed(cfg, p["embed"], h)


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------

def _shift(x: torch.Tensor) -> torch.Tensor:
    """x [B,S,d] shifted right by one token (zeros first)."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _rwkv_block(cfg: ModelConfig, lp: Params, h: torch.Tensor,
                return_state: bool = False):
    """One RWKV6 layer over the full sequence; with ``return_state`` also
    the layer's decode cache entry (tshift, cshift, wkv)."""
    xn = L.rmsnorm(h, lp["ln1"], cfg.rms_eps)
    tm = RW.rwkv_time_mix(cfg, lp, xn, _shift(xn), return_state=return_state)
    if return_state:
        tm, st = tm
    h = h + tm
    xn2 = L.rmsnorm(h, lp["ln2"], cfg.rms_eps)
    h = h + RW.rwkv_channel_mix(cfg, lp, xn2, _shift(xn2))
    if not return_state:
        return h
    return h, {"tshift": xn[:, -1, :], "cshift": xn2[:, -1, :], "wkv": st}


# matmul reaches dispatch as one of these; "dots" saves their outputs
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_kwargs(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.remat == "full":
        return {}
    if cfg.remat == "dots":
        return {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_dots)}
    raise ValueError(f"unknown remat {cfg.remat!r}")


BlockFn = Callable[[Params, torch.Tensor],
                   Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _apply_group(apply_fn: BlockFn, group: List[Params], h: torch.Tensor,
                 aux: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    for lp in group:
        h, a = apply_fn(lp, h)
        if a is not None:
            aux = aux + a
    return h, aux


def _scan_blocks(cfg: ModelConfig, blocks: List[Params], h: torch.Tensor,
                 apply_fn: BlockFn) -> Tuple[torch.Tensor, torch.Tensor]:
    """``apply_fn(block, h) -> (h, aux or None)`` over ``blocks`` in groups
    of ``cfg.layers_per_step``, each group one remat region under grad
    mode (the reference's ``_scan_blocks``): the stash between groups
    shrinks by the group size, the recompute grows by it."""
    g = max(cfg.layers_per_step, 1)
    if len(blocks) % g:
        raise ValueError(f"layers_per_step={g} does not divide the "
                         f"{len(blocks)} blocks")
    aux = torch.zeros((), device=h.device)
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    kw = _remat_kwargs(cfg) if remat else {}
    for i in range(0, len(blocks), g):
        run = functools.partial(_apply_group, apply_fn, blocks[i:i + g])
        if remat:
            h, aux = checkpoint(run, h, aux, use_reentrant=False, **kw)
        else:
            h, aux = run(h, aux)
    return h, aux


def forward(cfg: ModelConfig, p: Params, batch: Batch,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B,S,V], aux_loss)."""
    positions = batch["positions"]
    h = _embed_inputs(cfg, p, batch)
    blocks = p["dec_blocks"] if cfg.family == ENCDEC else p["blocks"]
    if cfg.family == ENCDEC:
        enc_h, enc_positions = _encode(cfg, p, batch)

        def apply_fn(lp, hh):
            return ED.dec_block_apply(cfg, lp, hh, positions, enc_h,
                                      enc_positions), None
    elif cfg.family == SSM:
        def apply_fn(lp, hh):
            return _rwkv_block(cfg, lp, hh), None
    elif cfg.family == HYBRID:
        def apply_fn(lp, hh):
            return HY.superblock_apply(cfg, lp, hh, positions)
    else:
        def apply_fn(lp, hh):
            return B.block_apply(cfg, lp, hh, positions)
    h, aux = _scan_blocks(cfg, blocks, h, apply_fn)
    return _logits(cfg, p, h), aux


def _encode(cfg: ModelConfig, p: Params, batch: Batch,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder over the projected frontend: (enc_h [B,Senc,d] after
    ``enc_norm``, enc_positions [B,Senc])."""
    enc_h = _frontend(cfg, p, batch)
    Bsz, Senc = enc_h.shape[:2]
    enc_positions = torch.arange(Senc, device=enc_h.device).expand(Bsz, Senc)

    def enc_apply(lp, hh):
        return ED.enc_block_apply(cfg, lp, hh, enc_positions), None

    enc_h, _ = _scan_blocks(cfg, p["enc_blocks"], enc_h, enc_apply)
    return L.rmsnorm(enc_h, p["enc_norm"], cfg.rms_eps), enc_positions


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

Z_LOSS_COEF = 1e-4


def loss_fn(cfg: ModelConfig, p: Params, batch: Batch,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy + z-loss + aux; targets < 0 are masked."""
    logits, aux = forward(cfg, p, batch)
    targets = batch["targets"]
    if _prepends_frontend(cfg, batch):
        # frontend positions carry no next-token target; score text tail only
        logits = logits[:, -targets.shape[1]:, :]
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    mask = (targets >= 0).float()
    tgt = torch.where(targets >= 0, targets, 0).long()
    ll = torch.gather(lf, -1, tgt[..., None])[..., 0]
    nll = (lse - ll) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = nll.sum() / denom
    z = Z_LOSS_COEF * (lse.square() * mask).sum() / denom
    total = ce + z + aux
    return total, {"loss": total, "ce": ce, "aux": aux, "z": z,
                   "tokens": mask.sum()}


# ---------------------------------------------------------------------------
# KV-cache init / prefill / decode
# ---------------------------------------------------------------------------

def cache_logical_axes(cfg: ModelConfig, *, shard_seq: bool = False) -> Any:
    """Logical axes of the cache entries (the reference's layouts, so the
    reference's axes); ``shard_seq`` makes the sequence axis shardable."""
    seq = "kv_seq" if shard_seq else None
    kv = (None, "batch", seq, "kv_act")
    if cfg.family == HYBRID:
        a = {"k": kv, "v": kv,
             "conv": (None, None, "batch", None, "inner_act"),
             "ssm": (None, None, "batch", "inner_act", None)}
    elif cfg.family == SSM:
        a = {"tshift": (None, "batch", "embed_act"),
             "cshift": (None, "batch", "embed_act"),
             "wkv": (None, "batch", "heads_act", None, None)}
    elif cfg.family == ENCDEC:
        a = {"k": kv, "v": kv, "xk": kv, "xv": kv}
    else:
        a = {"k": kv, "v": kv}
    a["index"] = ("batch",)
    return a


def cache_batch_axes(cfg: ModelConfig) -> Dict[str, int]:
    """The batch (slot) axis of each cache entry: where
    ``cache_logical_axes`` places ``"batch"``."""
    return {k: ax.index("batch") for k, ax in cache_logical_axes(cfg).items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = "cuda") -> Params:
    dev = resolve_device(device)
    index = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if cfg.family == HYBRID:
        return dict(HY.hybrid_cache_init(cfg, batch, max_len, dev),
                    index=index)
    if cfg.family == SSM:
        one = RW.rwkv_cache_init(cfg, batch, dev)
        c = {k: torch.zeros((cfg.num_layers,) + tuple(v.shape), dtype=v.dtype,
                            device=dev) for k, v in one.items()}
        c["index"] = index
        return c
    dt = L.torch_dtype(cfg.dtype)
    names = ("k", "v")
    n = cfg.num_layers
    if cfg.family == ENCDEC:
        names, n = ("k", "v", "xk", "xv"), cfg.decoder_layers
    shape = (n, batch, max_len, cfg.kv_dim)
    c = {name: torch.zeros(shape, dtype=dt, device=dev) for name in names}
    c["index"] = index
    return c


def prefill(cfg: ModelConfig, p: Params, batch: Batch, max_len: int,
            ) -> Tuple[torch.Tensor, Params]:
    """Run the full prompt; returns (last-position logits, filled cache).

    RWKV6 prefill and the hybrid's Mamba layers ask for the final state
    (``return_state``).  RWKV6 takes its state-returning plain path, as in
    the reference, never the WKV6 kernel; the Mamba layers take the
    selective-scan kernel under ``scan_impl="pallas"`` (it returns the
    state too), where the reference takes its token loop.  Those states
    have no sequence axis, so ``max_len`` bounds only the attention K/V.
    The enc-dec cache holds the encoder-side ``xk``/``xv`` at the
    encoder's length; a VLM's index counts its frontend positions.
    """
    positions = batch["positions"]
    h = _embed_inputs(cfg, p, batch)
    if cfg.family == ENCDEC:
        enc_h, enc_positions = _encode(cfg, p, batch)
        ents = []
        for lp in p["dec_blocks"]:
            h, ent = ED.dec_block_prefill(cfg, lp, h, positions, enc_h,
                                          enc_positions)
            ents.append(ent)
        cache = _embed_cache(cfg, ents, h.shape[0], max_len)
        for name in ("xk", "xv"):
            cache[name] = torch.stack([e[name] for e in ents])
    elif cfg.family == SSM:
        ents = []
        for lp in p["blocks"]:
            h, ent = _rwkv_block(cfg, lp, h, return_state=True)
            ents.append(ent)
        cache = {k: torch.stack([e[k] for e in ents]) for k in ents[0]}
    elif cfg.family == HYBRID:
        ents = []
        for lp in p["blocks"]:
            h, ent, _ = HY.superblock_prefill(cfg, lp, h, positions)
            ents.append(ent)
        cache = _embed_cache(cfg, ents, h.shape[0], max_len)
        cache["conv"] = torch.stack([e["conv"] for e in ents]).to(
            L.torch_dtype(cfg.dtype))
        cache["ssm"] = torch.stack([e["ssm"] for e in ents])
    else:
        kvs = []
        for lp in p["blocks"]:
            h, kv, _ = B.block_prefill(cfg, lp, h, positions)
            kvs.append(kv)
        cache = _embed_cache(cfg, kvs, h.shape[0], max_len)
    Bsz, prefilled = batch["tokens"].shape
    if _prepends_frontend(cfg, batch):
        prefilled += batch["frontend"].shape[1]
    cache["index"] = torch.full((Bsz,), prefilled, dtype=torch.int32,
                                device=h.device)
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

    The state tensors of ``cache`` (k/v, tshift/cshift/wkv, conv/ssm) are
    updated in place (the enc-dec ``xk``/``xv`` are only read) and shared by the returned cache; its ``index`` is a
    new tensor, one higher for every slot, active or not, as in the
    reference.
    """
    index = cache["index"]
    h = L.embed_tokens(cfg, p["embed"], tokens)
    pos = index[:, None]
    if cfg.mrope_sections:
        pos = index[None, :, None].expand(3, tokens.shape[0], 1)
    blocks = p["dec_blocks"] if cfg.family == ENCDEC else p["blocks"]
    for i, lp in enumerate(blocks):
        if cfg.family == ENCDEC:
            ce = {k: cache[k][i] for k in ("k", "v", "xk", "xv")}
            h = ED.dec_block_decode(cfg, lp, h, pos, ce, index)
            continue
        if cfg.family == HYBRID:
            ce = {k: cache[k][i] for k in ("k", "v", "conv", "ssm")}
            h = HY.superblock_decode(cfg, lp, h, pos, ce, index)
            continue
        if cfg.family != SSM:
            h, _, _ = B.block_decode(cfg, lp, h, pos, cache["k"][i],
                                     cache["v"][i], index)
            continue
        ce = {k: cache[k][i] for k in ("tshift", "cshift", "wkv")}
        xn = L.rmsnorm(h, lp["ln1"], cfg.rms_eps)
        tm, st = RW.rwkv_decode_time(cfg, lp, xn, ce)
        h = h + tm
        xn2 = L.rmsnorm(h, lp["ln2"], cfg.rms_eps)
        cm, st["cshift"] = RW.rwkv_decode_channel(cfg, lp, xn2, ce["cshift"])
        h = h + cm
        for k, v in st.items():
            ce[k].copy_(v)
    new_cache = dict(cache)
    new_cache["index"] = index + 1
    return _logits(cfg, p, h), new_cache
