"""Mixture-of-Experts layer: top-k router + capacity-bounded scatter dispatch.

Counterpart of ``repro/models/moe.py``, step for step and dtype for dtype:
the router runs in f32 (its top-k weights renormalised unless
``moe.norm_topk_prob`` is false, a switch the reference lacks, which
Jamba's router needs); each token's k assignments get a position in
their expert by a token-major running count; assignments past the
capacity C are parked in slot C of the [E, C+1, d] dispatch buffer (in
``cfg.dtype``) and weighted by 0 when gathered back; the k expert outputs
are summed in ``cfg.dtype``.  ``cfg.scan_impl`` picks how the dispatch,
the three per-expert products over the buffer and the combine run:
  * ``pallas`` - hand-written CUDA kernels through ``kernels/ops.py``
                 (their plain versions on a CPU tensor): ``moe_dispatch``
                 (``kernels/csrc/moe_permute.cu``) writes each buffer row
                 once, a kept row or zeros, the parking slot zeros;
                 ``gmm_equal`` (``kernels/csrc/gmm.cu``) the products, E
                 groups of C+1 rows; ``moe_combine`` (``moe_permute.cu``)
                 reads back each token's kept rows and sums them;
  * otherwise  - the reference's ops: ``index_add_dispatch`` (the tokens
                 repeated k times and ``index_add_``-ed into a zeroed
                 buffer, the dropped rows summed in the parking slot),
                 ``torch.einsum``, and ``gather_combine`` (a gather,
                 weight and sum).
Both compute the reference's function: bf16 products summed in f32 and
rounded once; the parking slot's rows differ, and are weighted by 0.  The
routing, capacity and dropping are the same on both.

On a mesh (DTensor tokens under ``parallel/context.py``) the layer keeps
the reference's global function: one capacity and one running count
over all the tokens of a chunk.  So the router, the top-k, the slot
count, the dispatch and the combine run on the tokens gathered from the
data axes, alike on every rank; the dispatch buffer is then cut to
``Shard(0)`` on ``model`` (``"experts_act"``), so the three products run
on each rank's own E/tp experts (``gmm`` under ``pallas``), and the
outputs are gathered back over ``model`` for the combine, whose result
is batch-sharded again by the caller's ``shard``.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch import tracing
from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (
    Axes, Params, dense_init, torch_dtype, use,
)
from repro_torch.parallel.context import shard

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
    sharded = isinstance(x, DTensor)
    if sharded:   # every rank routes all the tokens
        x = x.redistribute(x.device_mesh, (Replicate(),) * x.device_mesh.ndim)
    xf = x.reshape(T, d)
    if Tc and T > Tc and T % Tc == 0:
        nc = T // Tc
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        ys = []
        for xc in xf.split(Tc):
            yc, a = _moe_tokens(cfg, p, xc)
            ys.append(yc)
            aux = aux + a
        out, aux = torch.cat(ys), aux / nc
    else:
        out, aux = _moe_tokens(cfg, p, xf)
    out = out.reshape(B, S, d)
    return (shard(out, "batch", None, "embed_act") if sharded else out), aux


def _expert_products(cfg: ModelConfig, wg: torch.Tensor, wu: torch.Tensor,
                     wo: torch.Tensor, xe: torch.Tensor) -> torch.Tensor:
    """The per-expert SwiGLU over the dispatch buffer xe [E, C+1, d], by
    the experts these tensors hold (a rank's own on a mesh)."""
    if cfg.scan_impl == "pallas":
        gate = kops.gmm_equal(xe, wg)
        up = kops.gmm_equal(xe, wu)
        return kops.gmm_equal(F.silu(gate) * up, wo)
    gate = torch.einsum("ecd,edf->ecf", xe, wg)
    up = torch.einsum("ecd,edf->ecf", xe, wu)
    return torch.einsum("ecf,efd->ecd", F.silu(gate) * up, wo)


def _experts(cfg: ModelConfig, p: Params, xe: torch.Tensor) -> torch.Tensor:
    """``_expert_products`` with the weights in ``xe``'s dtype; on a mesh,
    on each rank's experts (``"experts"`` on ``model``; an ``fsdp``
    weight's ``"embed"`` gathered first), the buffer cut to match and the
    outputs gathered back."""
    with tracing.span("moe.experts"):
        dt = xe.dtype
        w = [use(p["wi_gate"], dt, "experts", None, None),
             use(p["wi_up"], dt, "experts", None, None),
             use(p["wo"], dt, "experts", None, None)]
        if not isinstance(xe, DTensor):
            return _expert_products(cfg, *w, xe)
        full = xe.placements
        xe = shard(xe, "experts_act", None, None)
        pl = xe.placements
        ye = local_map(functools.partial(_expert_products, cfg),
                       out_placements=list(pl),
                       in_placements=tuple(t.placements for t in w) + (pl,),
                       device_mesh=xe.device_mesh)(*w, xe)
        return ye.redistribute(ye.device_mesh, full)


def _on_tokens(fn, n_out: int, *args):
    """``fn`` (``n_out`` outputs) on the local tensors of replicated
    DTensors (every rank holds all the tokens), its outputs replicated
    again; plain tensors go straight through."""
    first = args[0]
    if not isinstance(first, DTensor):
        return fn(*args)
    rep = [Replicate()] * first.device_mesh.ndim
    return local_map(fn, out_placements=rep if n_out == 1 else (rep,) * n_out,
                     in_placements=tuple(rep for _ in args),
                     device_mesh=first.device_mesh,
                     redistribute_inputs=True)(*args)


def _route(cfg: ModelConfig, router: torch.Tensor, xf: torch.Tensor, C: int):
    """Router, top-k, slots and dispatch of a flat [T, d] slab: (xe
    [E, C+1, d], the assignments' experts and slots [T*k], whether each
    was kept, their gate weights [T, k], the aux loss)."""
    m = cfg.moe
    T = xf.shape[0]
    E, k = m.num_experts, m.experts_per_token
    with tracing.span("moe.route"):
        ids_flat, pos_flat, keep, gate_w, aux = _slots(m, router, xf, C)
        tracing.count("moe.kept", keep)
        tracing.count("moe.slots", E * (C + 1))

    # ---- dispatch: scatter tokens into [E, C+1, d] (slot C = dropped) --
    with tracing.span("moe.dispatch"):
        dt = torch_dtype(cfg.dtype)
        if cfg.scan_impl == "pallas":
            xe = kops.moe_dispatch(xf.to(dt), ids_flat.view(T, k),
                                   pos_flat.view(T, k), E, C)
        else:
            xe = index_add_dispatch(xf.to(dt), ids_flat, pos_flat, E, C)
    return xe, ids_flat, pos_flat, keep, gate_w, aux


def index_add_dispatch(x: torch.Tensor, ids_flat: torch.Tensor,
                       pos_flat: torch.Tensor, num_experts: int,
                       capacity: int) -> torch.Tensor:
    """The ``"xla"`` dispatch of x [T, d] by its assignments' experts and
    slots [T*k]: the rows repeated k times and ``index_add_``-ed into a
    zeroed [E, C+1, d] buffer (the dropped ones summed in slot C)."""
    T, d = x.shape
    upd = x.repeat_interleave(ids_flat.numel() // T, dim=0)   # [T*k, d]
    xe = torch.zeros((num_experts * (capacity + 1), d), dtype=x.dtype,
                     device=x.device)
    xe.index_add_(0, ids_flat * (capacity + 1) + pos_flat, upd)
    return xe.view(num_experts, capacity + 1, d)


def _slots(m, router: torch.Tensor, xf: torch.Tensor, C: int):
    """Router, top-k, aux loss and each assignment's slot in its expert:
    (experts and slots [T*k], kept [T*k], gate weights [T, k], aux).  The
    gate weights are the softmax's top k, renormalised to sum 1 where
    ``m.norm_topk_prob`` (the reference's router) and as they are
    otherwise."""
    T = xf.shape[0]
    E, k = m.num_experts, m.experts_per_token
    logits = xf.float() @ router                              # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_w, ids = torch.topk(probs, k, dim=-1)                # [T, k]
    if m.norm_topk_prob:
        gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)    # renormalize

    # ---- load-balancing auxiliary loss (Switch-style) ------------------
    me = probs.mean(dim=0)                                    # [E]
    ce = F.one_hot(ids, E).float().sum(dim=1).mean(dim=0)     # frac routed
    aux = AUX_LOSS_COEF * E * (me * ce).sum() / k

    # ---- position-in-expert: running count over the token-major order --
    # (the reference's cumsum of a [T*k, E] one-hot; here the rank of each
    # assignment among its expert's in a stable sort, the same integers)
    ids_flat = ids.reshape(T * k)
    order = torch.argsort(ids_flat, stable=True)
    counts = torch.zeros(E, dtype=ids_flat.dtype, device=xf.device
                         ).scatter_add_(0, ids_flat, torch.ones_like(ids_flat))
    starts = torch.cumsum(counts, dim=0) - counts              # [E]
    rank = torch.arange(T * k, device=xf.device) - starts[ids_flat[order]]
    pos_flat = torch.empty_like(rank).scatter_(0, order, rank)
    keep = pos_flat < C                                       # drop overflow
    pos_flat = torch.where(keep, pos_flat, C)                 # park drops
    return ids_flat, pos_flat, keep, gate_w, aux


def _combine(cfg: ModelConfig, ye: torch.Tensor, ids_flat, pos_flat, keep,
             gate_w):
    """Gather each assignment's output back and sum a token's k of them,
    weighted (a dropped one by 0)."""
    T, k = gate_w.shape
    with tracing.span("moe.combine"):
        if cfg.scan_impl == "pallas":
            return kops.moe_combine(ye, ids_flat.view(T, k),
                                    pos_flat.view(T, k), gate_w)
        return gather_combine(ye, ids_flat, pos_flat, keep, gate_w)


def gather_combine(ye: torch.Tensor, ids_flat: torch.Tensor,
                   pos_flat: torch.Tensor, keep: torch.Tensor,
                   gate_w: torch.Tensor) -> torch.Tensor:
    """The ``"xla"`` combine: each assignment's row of ye [E, C+1, d]
    gathered, weighted by ``keep * gate_w`` in ye's dtype and a token's k
    of them summed -> [T, d]."""
    T, k = gate_w.shape
    back = ye[ids_flat, pos_flat]                             # [T*k, d]
    back = back * (keep[:, None] * gate_w.reshape(T * k)[:, None]).to(
        ye.dtype)
    return back.reshape(T, k, -1).sum(dim=1)


def _moe_tokens(cfg: ModelConfig, p: Params, xf: torch.Tensor,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route + dispatch + expert FFN + combine for a flat [T, d] slab."""
    C = _capacity(cfg.moe, xf.shape[0])
    router = use(p["router"], torch.float32, None, None)
    xe, ids_flat, pos_flat, keep, gate_w, aux = _on_tokens(
        functools.partial(_route, cfg, C=C), 6, router, xf)
    ye = _experts(cfg, p, xe)                                 # [E, C+1, d]
    out = _on_tokens(functools.partial(_combine, cfg), 1, ye, ids_flat,
                     pos_flat, keep, gate_w)
    return out, aux


def moe_flops(cfg: ModelConfig, num_tokens: int) -> int:
    """Forward matmul FLOPs of one MoE layer (for roofline accounting)."""
    m = cfg.moe
    assert m is not None
    per_tok = 2 * 3 * cfg.d_model * m.d_ff_expert * m.experts_per_token
    return num_tokens * (per_tok + 2 * cfg.d_model * m.num_experts)
