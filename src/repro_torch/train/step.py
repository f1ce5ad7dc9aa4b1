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
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.config.base import RunConfig
from repro_torch.models import loss_fn
from repro_torch.optim import (
    adamw_update, clip_by_global_norm, compress_decompress, init_error,
    init_state, lr_at,
)
from repro_torch.optim.adamw import tree_leaves, tree_map

Params = Any
Batch = Dict[str, torch.Tensor]


def make_opt_state(run: RunConfig, params: Params) -> Dict[str, Any]:
    state = init_state(params, run.optim)
    if run.optim.grad_compress == "int8":
        state["ef_error"] = init_error(params)
    return state


def _split_microbatches(batch: Batch, n: int) -> Batch:
    """[B, ...] -> [n, B/n, ...]."""
    return {k: x.reshape(n, x.shape[0] // n, *x.shape[1:])
            for k, x in batch.items()}


def make_train_step(run: RunConfig) -> Callable:
    cfg = run.model
    n_micro = run.microbatches

    def train_step(params: Params, opt_state: Dict[str, Any], batch: Batch,
                   ) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
        leaves = tree_leaves(params)
        flags = [p.requires_grad for p in leaves]
        try:
            for p in leaves:
                p.requires_grad_(True)
                p.grad = None
            if n_micro == 1:
                micro = [batch]
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
        lr = lr_at(opt_state["count"], run.optim)
        adamw_update(grads, opt_state, params, lr, run.optim)
        for p in leaves:
            p.grad = None
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        out.update({k: metrics[k].detach() for k in ("ce", "aux", "z")})
        return params, opt_state, out

    return train_step


def make_eval_step(run: RunConfig) -> Callable:
    cfg = run.model

    @torch.no_grad()
    def eval_step(params: Params, batch: Batch) -> Dict[str, torch.Tensor]:
        return loss_fn(cfg, params, batch)[1]

    return eval_step
