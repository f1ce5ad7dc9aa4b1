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
layout, and each microbatch takes its share of every rank's local batch.
The metrics come back as plain tensors.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.config.base import RunConfig
from repro_torch.models import loss_fn
from repro_torch.optim import (
    adamw_update, clip_by_global_norm, compress_decompress, init_error,
    init_state, lr_at,
)
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.parallel.context import current_ctx
from repro_torch.parallel.sharding import check_distributed

Params = Any
Batch = Dict[str, torch.Tensor]


def make_opt_state(run: RunConfig, params: Params) -> Dict[str, Any]:
    state = init_state(params, run.optim)
    if run.optim.grad_compress == "int8":
        state["ef_error"] = init_error(params)
    return state


def _split_microbatches(batch: Batch, n: int) -> Batch:
    """[B, ...] -> [n, B/n, ...] (positions for VLM split on dim 1)."""
    def split(name, x):
        if name == "positions" and x.ndim == 3 and x.shape[0] == 3:
            return x.reshape(3, n, x.shape[1] // n,
                             *x.shape[2:]).movedim(1, 0)
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])

    return {k: split(k, v) for k, v in batch.items()}


def _split_local(batch: Batch, n: int) -> list:
    """n microbatches of DTensors, each holding 1/n of every rank's local
    batch rows, in the batch's placements."""
    out = [dict() for _ in range(n)]
    for name, x in batch.items():
        dim = next((p.dim for p in x.placements if p.is_shard()), 0)
        shape = list(x.shape)
        shape[dim] //= n
        for i, part in enumerate(x.to_local().chunk(n, dim=dim)):
            out[i][name] = DTensor.from_local(
                part.contiguous(), x.device_mesh, x.placements,
                run_check=False, shape=torch.Size(shape),
                stride=torch.empty(shape, device="meta").stride())
    return out


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
                micro = _split_local(batch, n_micro)
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
        return loss_fn(cfg, params, batch)[1]

    return eval_step
