"""Expert-parallel MoE with explicit all-to-all dispatch, one rank's part.

Counterpart of ``repro/parallel/ep_moe.py``.  The reference wraps a
per-device function in ``shard_map``; here every rank of a
``torch.distributed`` job calls ``ep_moe_apply`` on its own shard.  Ranks
along the ``model`` axis own ``E / n_tp`` experts each and hold the same
tokens (the reference shards the batch over the batch axes only); every
rank routes its tokens, packs a fixed-capacity per-destination buffer,
one ``all_to_all_single`` ships the tokens to their expert owners (a
second one their [expert, source row] metadata), the local experts run,
and a third ships the results back: cap rows of d to each peer and
back, plus the metadata, and no reduction.

The slot rule is the reference's: a running count per destination over
the assignments in token-major, then k, order; an assignment past the
capacity ``cap = max(int(cf * T_loc * k / n_tp), k)`` is dropped.  The
local experts do not gather a [d, f] weight a received row, as the
reference's ``_expert_ffn`` does (at dbrx-132b's width that gather would
be ~5 TB): the rows are sorted by local expert, the empty slots last, and
run as grouped products, through the ``gmm`` kernel under
``scan_impl="pallas"`` (``kernels/ops.py`` ``gmm_sorted``) or its plain
version (one product a group) otherwise; rows that hold no token give
zeros.  The same function.

The all-to-alls are ``torch.distributed.nn.functional.all_to_all_single``,
so the plain path differentiates through them, as the reference's does
(a CUDA kernel refuses grad: ``kernels/_grad.py``).  ``ep_moe_plain`` is
the same function in one process, each all-to-all a transpose of the
simulated ranks' buffers: the tests' and the card's yardstick, on no
rank's path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.distributed.nn.functional import all_to_all_single
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.gmm import gmm_plain
from repro_torch.models.layers import Params, torch_dtype
from repro_torch.parallel.sharding import axis_size

EXPERT_LEAVES = ("wi_gate", "wi_up", "wo")


class Pack(NamedTuple):
    """One rank's routing of its T tokens to n_tp destinations."""
    send: torch.Tensor     # [n_tp * cap, d] the rows to ship, empty slots 0
    meta: torch.Tensor     # [n_tp * cap, 2] int32 (local expert, src row), -1
    gate_w: torch.Tensor   # [T, k] f32 combine weights
    dst: torch.Tensor      # [T * k] destination of each assignment
    slot: torch.Tensor     # [T * k] its slot there, ``cap`` where dropped
    keep: torch.Tensor     # [T * k] whether it fit


def capacity(cfg: ModelConfig, tokens: int, n_tp: int,
             capacity_factor: Optional[float] = None) -> int:
    """Slots a rank sends each destination for ``tokens`` local tokens."""
    m = cfg.moe
    cf = capacity_factor or m.capacity_factor
    return max(int(cf * tokens * m.experts_per_token / n_tp),
               m.experts_per_token)


def _local_pack(cfg: ModelConfig, router_logits: torch.Tensor,
                xf: torch.Tensor, n_shards: int, cap: int) -> Pack:
    """Route local tokens xf [T, d] and pack the per-destination buffers."""
    m = cfg.moe
    E, k = m.num_experts, m.experts_per_token
    e_loc = E // n_shards
    T, d = xf.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_w, ids = torch.topk(probs, k, dim=-1)                # [T, k]
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)

    flat_ids = ids.reshape(T * k)
    dst = flat_ids // e_loc                                   # owner shard
    # slot within the destination buffer: running count per dst
    oh = F.one_hot(dst, n_shards)                             # [T*k, S]
    slot = (oh.cumsum(dim=0) - 1).gather(1, dst[:, None])[:, 0]
    keep = slot < cap
    slot = torch.where(keep, slot, cap)                       # park drops
    # a kept assignment's row in the flat send buffer; drops go to one
    # extra row past its end, which is never shipped
    row = torch.where(keep, dst * cap + slot, n_shards * cap)
    srcs = torch.arange(T, device=xf.device).repeat_interleave(k)
    # each slot's source token, T (a zero row appended to xf) where empty
    src_of = torch.full((n_shards * cap + 1,), T, dtype=torch.long,
                        device=xf.device).index_copy_(0, row, srcs)
    send = torch.cat([xf, xf.new_zeros(1, d)])[src_of[:-1]]
    meta = torch.full((n_shards * cap + 1, 2), -1, dtype=torch.int32,
                      device=xf.device)
    meta.index_copy_(0, row, torch.stack([flat_ids % e_loc, srcs],
                                         dim=1).to(torch.int32))
    return Pack(send, meta[:-1], gate_w, dst, slot, keep)


def _expert_ffn(cfg: ModelConfig, p_loc: Params, xe: torch.Tensor,
                eid: torch.Tensor) -> torch.Tensor:
    """Apply each received row's expert.  xe: [R, d]; eid: [R] local expert
    ids, -1 for a slot that holds no token (its output is 0)."""
    dt = torch_dtype(cfg.dtype)
    e_loc = p_loc["wi_gate"].shape[0]
    key = torch.where(eid >= 0, eid.long(), e_loc)            # empties last
    order = torch.argsort(key, stable=True)
    sizes = torch.bincount(key, minlength=e_loc + 1)[:e_loc].to(torch.int32)
    xs = xe[order].to(dt)
    wg, wu, wo = (p_loc[n].to(dt) for n in EXPERT_LEAVES)
    grouped = kops.gmm_sorted if cfg.scan_impl == "pallas" else gmm_plain
    gate = grouped(xs, wg, sizes)
    up = grouped(xs, wu, sizes)
    ys = grouped(F.silu(gate) * up, wo, sizes)
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=order.device)
    return ys[inverse]                                        # un-sort


def _combine(cfg: ModelConfig, back: torch.Tensor, pack: Pack,
             x_dtype: torch.dtype) -> torch.Tensor:
    """back [n_tp, cap, d]: the results of this rank's slots -> [T, d]."""
    k = cfg.moe.experts_per_token
    dt = torch_dtype(cfg.dtype)
    cap = back.shape[1]
    # assignment j of token t sits at (dst[tk], slot[tk])
    contrib = back[pack.dst, pack.slot.clamp(max=cap - 1)]   # [T*k, d]
    contrib = contrib * pack.keep[:, None].to(contrib.dtype)
    w_flat = pack.gate_w.reshape(-1, 1).to(dt)
    out = (contrib.to(dt) * w_flat).reshape(-1, k, back.shape[2]).sum(dim=1)
    return out.to(x_dtype)


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Equal splits of t's rows to and from every rank of ``group``."""
    return all_to_all_single(torch.empty_like(t), t, group=group)


def _router_logits(xf: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    return xf.float() @ router.float()


def local_params(params: Params, mesh: DeviceMesh,
                 tp_axis: str = "model") -> Params:
    """This rank's part of whole MoE params: the router as it is, the
    experts of its coordinate along ``tp_axis``."""
    return expert_slice(params, mesh.get_local_rank(tp_axis),
                        axis_size(mesh, tp_axis))


def expert_slice(params: Params, j: int, n_tp: int) -> Params:
    """Router and experts [j * E/n_tp, (j+1) * E/n_tp) of whole params."""
    E = params["wi_gate"].shape[0]
    e_loc = E // n_tp
    out = {n: params[n][j * e_loc:(j + 1) * e_loc] for n in EXPERT_LEAVES}
    out["router"] = params["router"]
    return out


def ep_moe_apply(cfg: ModelConfig, params: Params, x: torch.Tensor,
                 mesh: DeviceMesh, *, tp_axis: str = "model",
                 capacity_factor: Optional[float] = None) -> torch.Tensor:
    """One rank's EP forward of its activation shard x [B_loc, S, d].

    params: {"router" [d, E] whole; "wi_gate"/"wi_up" [E/n_tp, d, f] and
    "wo" [E/n_tp, f, d], the experts of this rank's coordinate along
    ``tp_axis``} (``local_params``).  x is this rank's shard of the batch
    over the other axes, the same on every rank along ``tp_axis``.
    Returns [B_loc, S, d].
    """
    m = cfg.moe
    n_tp = axis_size(mesh, tp_axis)
    if params["wi_gate"].shape[0] * n_tp != m.num_experts:
        raise ValueError(f"{params['wi_gate'].shape[0]} local experts on "
                         f"{n_tp} ranks of {tp_axis!r}; the config has "
                         f"{m.num_experts}")
    group = mesh.get_group(tp_axis)
    B, S, d = x.shape
    cap = capacity(cfg, B * S, n_tp, capacity_factor)
    xf = x.reshape(B * S, d)
    pack = _local_pack(cfg, _router_logits(xf, params["router"]), xf, n_tp,
                       cap)
    # ship tokens to expert owners (and metadata alongside)
    recv = _all_to_all(pack.send, group)
    recv_meta = _all_to_all(pack.meta, group)
    ye = _expert_ffn(cfg, params, recv, recv_meta[:, 0])
    # ship results back
    back = _all_to_all(ye, group)
    return _combine(cfg, back.view(n_tp, cap, d), pack, x.dtype
                    ).reshape(B, S, d)


def ep_moe_plain(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
                 n_tp: int, n_batch: int = 1,
                 capacity_factor: Optional[float] = None) -> torch.Tensor:
    """``ep_moe_apply`` of every rank of an (n_batch, n_tp) mesh, in one
    process: x [B, S, d] whole, params whole ([E, ...] experts).  Returns
    [n_batch, n_tp, B / n_batch, S, d]: what rank j along the tp axis of
    batch shard b returns."""
    B, S, d = x.shape
    b_loc = B // n_batch
    cap = capacity(cfg, b_loc * S, n_tp, capacity_factor)
    outs = []
    for xb in x.split(b_loc):
        xf = xb.reshape(b_loc * S, d)
        packs = [_local_pack(cfg, _router_logits(xf, params["router"]), xf,
                             n_tp, cap) for _ in range(n_tp)]
        # all-to-all: [src, dst, cap, ...] -> [dst, src, cap, ...]
        recv = torch.stack([p.send.view(n_tp, cap, d) for p in packs]
                           ).transpose(0, 1)
        meta = torch.stack([p.meta.view(n_tp, cap, 2) for p in packs]
                           ).transpose(0, 1)
        ye = torch.stack([
            _expert_ffn(cfg, expert_slice(params, j, n_tp),
                        recv[j].reshape(n_tp * cap, d),
                        meta[j].reshape(n_tp * cap, 2)[:, 0]
                        ).view(n_tp, cap, d)
            for j in range(n_tp)])
        back = ye.transpose(0, 1)                             # [src, dst, ...]
        outs.append(torch.stack([_combine(cfg, back[i], packs[i], x.dtype)
                                 .reshape(b_loc, S, d)
                                 for i in range(n_tp)]))
    return torch.stack(outs)
