"""Mixture-of-Experts layer: top-k router + capacity-bounded scatter dispatch.

Counterpart of ``repro/models/moe.py``, step for step and dtype for dtype:
the router runs in f32; each token's k assignments get a position in
their expert by a token-major running count; assignments past the
capacity C are parked in slot C of the [E, C+1, d] dispatch buffer (in
``cfg.dtype``) and weighted by 0 when gathered back; the k expert outputs
are summed in ``cfg.dtype``.  ``cfg.scan_impl`` picks how the three
per-expert products over the buffer run:
  * ``pallas`` - the hand-written CUDA grouped-matmul kernel
                 (``kernels/csrc/gmm.cu``), E groups of C+1 rows, through
                 ``kernels/ops.py`` ``gmm_equal`` (its plain version on a
                 CPU tensor);
  * otherwise  - ``torch.einsum``, as the reference computes them.
Both compute the reference's function: bf16 products summed in f32 and
rounded once.  The routing, capacity and dropping are the same on both.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import Axes, Params, dense_init, torch_dtype

AUX_LOSS_COEF = 0.01


def moe_init(cfg: ModelConfig, gen: torch.Generator,
             device: torch.device) -> Params:
    """One layer's parameters; the router stays f32 whatever
    ``param_dtype`` is, as in the reference."""
    m = cfg.moe
    assert m is not None
    dt = torch_dtype(cfg.param_dtype)
    E, d, f = m.num_experts, cfg.d_model, m.d_ff_expert
    return {
        "router": dense_init(gen, (d, E), torch.float32, device),
        "wi_gate": dense_init(gen, (E, d, f), dt, device, in_axis=1),
        "wi_up": dense_init(gen, (E, d, f), dt, device, in_axis=1),
        "wo": dense_init(gen, (E, f, d), dt, device, in_axis=1),
    }


def moe_axes(cfg: ModelConfig) -> Axes:
    return {
        "router": ("embed", None),
        "wi_gate": ("experts", "embed", "expert_mlp"),
        "wi_up": ("experts", "embed", "expert_mlp"),
        "wo": ("experts", "expert_mlp", "embed"),
    }


def _capacity(m, num_tokens: int) -> int:
    c = int(m.capacity_factor * num_tokens * m.experts_per_token
            / m.num_experts)
    return max(c, m.experts_per_token)


def moe_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,d] -> (out [B,S,d], aux_loss scalar).

    Batches of more than ``moe.chunk_tokens`` tokens (when it divides
    them) are routed chunk by chunk, each chunk with its own capacity, and
    the aux loss is the mean over chunks, as the reference's scan.
    """
    m = cfg.moe
    assert m is not None
    B, S, d = x.shape
    T = B * S
    Tc = m.chunk_tokens
    xf = x.reshape(T, d)
    if Tc and T > Tc and T % Tc == 0:
        nc = T // Tc
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        ys = []
        for xc in xf.split(Tc):
            yc, a = _moe_tokens(cfg, p, xc)
            ys.append(yc)
            aux = aux + a
        return torch.cat(ys).reshape(B, S, d), aux / nc
    out, aux = _moe_tokens(cfg, p, xf)
    return out.reshape(B, S, d), aux


def _expert_products(cfg: ModelConfig, p: Params, xe: torch.Tensor,
                     ) -> torch.Tensor:
    """The per-expert SwiGLU over the dispatch buffer xe [E, C+1, d]."""
    dt = xe.dtype
    wg, wu, wo = (p[k].to(dt) for k in ("wi_gate", "wi_up", "wo"))
    if cfg.scan_impl == "pallas":
        gate = kops.gmm_equal(xe, wg)
        up = kops.gmm_equal(xe, wu)
        return kops.gmm_equal(F.silu(gate) * up, wo)
    gate = torch.einsum("ecd,edf->ecf", xe, wg)
    up = torch.einsum("ecd,edf->ecf", xe, wu)
    return torch.einsum("ecf,efd->ecd", F.silu(gate) * up, wo)


def _moe_tokens(cfg: ModelConfig, p: Params, xf: torch.Tensor,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route + dispatch + expert FFN + combine for a flat [T, d] slab."""
    m = cfg.moe
    dt = torch_dtype(cfg.dtype)
    T, d = xf.shape
    E, k = m.num_experts, m.experts_per_token
    C = _capacity(m, T)
    logits = xf.float() @ p["router"].float()                 # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_w, ids = torch.topk(probs, k, dim=-1)                # [T, k]
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)        # renormalize

    # ---- load-balancing auxiliary loss (Switch-style) ------------------
    me = probs.mean(dim=0)                                    # [E]
    ce = F.one_hot(ids, E).float().sum(dim=1).mean(dim=0)     # frac routed
    aux = AUX_LOSS_COEF * E * (me * ce).sum() / k

    # ---- position-in-expert: running count over the token-major order --
    # (the reference's cumsum of a [T*k, E] one-hot; here the rank of each
    # assignment among its expert's in a stable sort, the same integers)
    ids_flat = ids.reshape(T * k)
    order = torch.argsort(ids_flat, stable=True)
    counts = torch.bincount(ids_flat, minlength=E)
    starts = torch.cumsum(counts, dim=0) - counts              # [E]
    rank = torch.arange(T * k, device=xf.device) - starts[ids_flat[order]]
    pos_flat = torch.empty_like(rank).scatter_(0, order, rank)
    keep = pos_flat < C                                       # drop overflow
    pos_flat = torch.where(keep, pos_flat, C)                 # park drops

    # ---- dispatch: scatter tokens into [E, C+1, d] (slot C = dropped) --
    upd = xf.to(dt).repeat_interleave(k, dim=0)               # [T*k, d]
    xe = torch.zeros((E * (C + 1), d), dtype=dt, device=xf.device)
    xe.index_add_(0, ids_flat * (C + 1) + pos_flat, upd)
    xe = xe.view(E, C + 1, d)

    ye = _expert_products(cfg, p, xe)                         # [E, C+1, d]

    # ---- combine: gather back + weighted sum over k ---------------------
    back = ye[ids_flat, pos_flat]                             # [T*k, d]
    back = back * (keep[:, None] * gate_w.reshape(T * k)[:, None]).to(dt)
    out = back.reshape(T, k, d).sum(dim=1)
    return out, aux


def moe_flops(cfg: ModelConfig, num_tokens: int) -> int:
    """Forward matmul FLOPs of one MoE layer (for roofline accounting)."""
    m = cfg.moe
    assert m is not None
    per_tok = 2 * 3 * cfg.d_model * m.d_ff_expert * m.experts_per_token
    return num_tokens * (per_tok + 2 * cfg.d_model * m.num_experts)
