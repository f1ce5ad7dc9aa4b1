"""train_step / eval_step builders (``repro/train/step.py``).

``make_train_step(run)`` returns ``step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the gradient of ``loss_fn`` by autograd,
summed over ``run.microbatches`` microbatches and divided by their number,
clipped to ``run.optim.grad_clip``, optionally int8-compressed with error
feedback, then one AdamW step.  The parameters and the optimizer state are
updated in place and returned.  ``metrics`` holds 0-dim tensors: ``loss``
(the microbatches' mean), ``grad_norm`` (before clipping), ``lr``, and
the last microbatch's ``ce``/``aux``/``z``, as the reference takes them.

The step turns ``requires_grad`` on for the parameter leaves while it
runs and restores their flags after, and leaves no ``.grad`` behind:
``init_params`` and ``params_from_numpy`` make leaves without grad, which
serving and the kernels' grad guard rely on.  Train on
``attention_impl``/``scan_impl`` ``"xla"``: a CUDA kernel refuses grad
(``kernels/_grad.py``), as the reference's Pallas calls do.

Under a mesh context (``parallel/context.py`` ``sharding_ctx``) the step
is the counterpart of ``jit(step, in_shardings, out_shardings)``: every
leaf of the params, the optimizer state and the batch must be a DTensor
laid out by its sharding (``parallel/sharding.py`` ``distribute_tree``;
a plain leaf raises), the params and state are updated in place in that
layout, and microbatch i is the global rows [i·B/n, (i+1)·B/n) of the
batch, as the reference splits it, laid out on the batch's own placements
(``_split_global``: one all-to-all a batch leaf among the ranks that share
a model coordinate, ``parallel/collectives.py`` ``all_to_all_rows``).
The metrics come back as plain tensors.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import tracing
from repro_torch.config.base import RunConfig
from repro_torch.models import loss_fn
from repro_torch.optim import (
    adamw_update, clip_by_global_norm, compress_decompress, init_error,
    init_state, lr_at,
)
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.parallel.collectives import all_to_all_rows
from repro_torch.parallel.context import current_ctx
from repro_torch.parallel.sharding import check_distributed

Params = Any
Batch = Dict[str, torch.Tensor]


def make_opt_state(run: RunConfig, params: Params) -> Dict[str, Any]:
    state = init_state(params, run.optim)
    if run.optim.grad_compress == "int8":
        state["ef_error"] = init_error(params)
    return state


def _batch_dim(name: str, x: torch.Tensor) -> int:
    """The batch dim of a batch leaf: 1 for VLM positions [3, B, S]
    (``parallel/sharding.py`` ``batch_shardings``), 0 for the rest."""
    return 1 if name == "positions" and x.ndim == 3 and x.shape[0] == 3 \
        else 0


def _split_microbatches(batch: Batch, n: int) -> Batch:
    """[B, ...] -> [n, B/n, ...] (positions for VLM split on dim 1)."""
    def split(name, x):
        if _batch_dim(name, x) == 1:
            return x.reshape(3, n, x.shape[1] // n,
                             *x.shape[2:]).movedim(1, 0)
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])

    return {k: split(k, v) for k, v in batch.items()}


def _split_global(batch: Batch, n: int) -> list:
    """n microbatches of DTensors: microbatch i holds the global rows
    [i·B/n, (i+1)·B/n) of every leaf on its batch dim, as
    ``_split_microbatches`` splits one device's batch, laid out on the
    leaf's own placements, so each rank holds its block of it."""
    out = [dict() for _ in range(n)]
    for name, x in batch.items():
        dim = _batch_dim(name, x)
        shape = list(x.shape)
        if shape[dim] % n:
            raise ValueError(f"batch {name!r} of {shape[dim]} rows does not "
                             f"split into {n} microbatches")
        shape[dim] //= n
        local = x.to_local()
        mesh_dims = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
        if mesh_dims:
            local = _to_microbatch_order(local.movedim(dim, 0), x.device_mesh,
                                         mesh_dims, n).movedim(0, dim)
        for i, part in enumerate(local.chunk(n, dim=dim)):
            out[i][name] = DTensor.from_local(
                part.contiguous(), x.device_mesh, x.placements,
                run_check=False, shape=torch.Size(shape),
                stride=torch.empty(shape, device="meta").stride())
    return out


def _to_microbatch_order(local: torch.Tensor, mesh, mesh_dims: list,
                         n: int) -> torch.Tensor:
    """This rank's rows of every microbatch, microbatch after microbatch,
    from its block of a batch sharded on dim 0 over ``mesh_dims`` (D
    blocks, the major mesh dim first, as DTensor splits a dim).

    In units of m = B / (n·D) rows, block d holds the global units
    [d·n, (d+1)·n), and microbatch i's block r is unit i·D + r: each rank
    sends its n units to the ranks that hold them in their microbatches
    and receives its own from the blocks that hold them, in one
    all-to-all among the ranks that share this rank's coordinates on the
    other mesh dims (issued on the default group, which the mesh must
    span, with no rows for the others)."""
    if mesh.size() != dist.get_world_size():
        raise ValueError("the mesh must span the default process group")
    sizes = [mesh.size(i) for i in mesh_dims]
    coord = mesh.get_coordinate()
    D, d = 1, 0
    for i, size in zip(mesh_dims, sizes):
        D, d = D * size, d * size + coord[i]
    rows = local.shape[0]
    if rows % n:
        raise ValueError(f"{rows} batch rows a rank do not split into {n} "
                         "microbatches")
    m = rows // n

    def rank_of(block: int) -> int:
        c = list(coord)
        for i, size in zip(reversed(mesh_dims), reversed(sizes)):
            block, c[i] = divmod(block, size)
        return int(mesh.mesh[tuple(c)])

    dest = [rank_of((d * n + u) % D) for u in range(n)]
    src = [rank_of((i * D + d) // n) for i in range(n)]
    # each buffer runs rank by rank, a sender's units in their order
    send_order = sorted(range(n), key=dest.__getitem__)
    recv_order = sorted(range(n), key=src.__getitem__)
    units = local.reshape(n, m, *local.shape[1:])
    send = units[send_order].reshape(local.shape)
    recv = all_to_all_rows(send, [(dest[u], m) for u in send_order],
                           [(src[i], m) for i in recv_order])
    recv = recv.reshape(n, m, *local.shape[1:])
    return recv[[recv_order.index(i) for i in range(n)]].reshape(local.shape)


def _plain(x: torch.Tensor) -> torch.Tensor:
    return x.full_tensor() if isinstance(x, DTensor) else x


def make_train_step(run: RunConfig) -> Callable:
    cfg = run.model
    n_micro = run.microbatches

    def train_step(params: Params, opt_state: Dict[str, Any], batch: Batch,
                   ) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
        sharded = current_ctx() is not None
        if sharded:
            for tree, what in ((params, "params"), (opt_state, "opt_state"),
                               (batch, "batch")):
                check_distributed(tree, what)
        leaves = tree_leaves(params)
        flags = [p.requires_grad for p in leaves]
        try:
            for p in leaves:
                p.requires_grad_(True)
                p.grad = None
            if n_micro == 1:
                micro = [batch]
            elif sharded:
                micro = _split_global(batch, n_micro)
            else:
                split = _split_microbatches(batch, n_micro)
                micro = [{k: v[i] for k, v in split.items()}
                         for i in range(n_micro)]
            loss = torch.zeros((), device=leaves[0].device)
            with torch.enable_grad():
                for mb in micro:
                    lm, metrics = loss_fn(cfg, params, mb)
                    lm.backward()
                    loss = loss + lm.detach()
        finally:
            for p, flag in zip(leaves, flags):
                p.requires_grad_(flag)
        grads = tree_map(lambda p: p.grad, params)
        if n_micro > 1:
            for g in tree_leaves(grads):
                g.div_(n_micro)
            loss = loss / n_micro
        grads, gnorm = clip_by_global_norm(grads, run.optim.grad_clip)
        if run.optim.grad_compress == "int8":
            compress_decompress(grads, opt_state["ef_error"])
        lr = lr_at(_plain(opt_state["count"]), run.optim)
        adamw_update(grads, opt_state, params, lr, run.optim)
        for p in leaves:
            p.grad = None
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        out.update({k: metrics[k].detach() for k in ("ce", "aux", "z")})
        return params, opt_state, {k: _plain(v) for k, v in out.items()}

    return train_step


def make_eval_step(run: RunConfig) -> Callable:
    cfg = run.model

    @torch.no_grad()
    def eval_step(params: Params, batch: Batch) -> Dict[str, torch.Tensor]:
        with tracing.unit("eval_step", batch["tokens"]):
            return loss_fn(cfg, params, batch)[1]

    return eval_step
