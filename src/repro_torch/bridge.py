"""Parameters between the JAX package's layout (as numpy) and the port's.

The reference keeps parameters as a nested dict whose per-layer leaves
carry a stacked leading layer axis (``repro/models/model.py``
``_stack_init``); its checkpoints name each leaf by the ``/``-joined dict
path (``repro/checkpoint/ckpt.py`` ``_path_str``: ``blocks/attn/wq``,
``embed/embedding``, ``final_norm``).  The port keeps the same names with
``blocks`` as a list of per-layer dicts.  ``params_from_numpy`` takes the
reference's tree as numpy arrays, nested or already flat by path name;
``params_to_numpy`` gives it back.  bf16 travels as a 16-bit view, because
``torch.from_numpy`` does not take numpy's (``ml_dtypes``) bfloat16.
This module imports no JAX: only tests hand it JAX-made arrays.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.config.base import DENSE, SSM, ModelConfig
from repro_torch.device import DeviceLike, resolve_device

Params = Dict[str, Any]


# per-layer leaves of an RWKV6 block (``repro/models/rwkv6.py`` rwkv_init)
RWKV_LEAVES = ("ln1", "ln2", "mu_base", "mu", "mix_w1", "mix_w2",
               "decay_base", "decay_w1", "decay_w2", "u", "wr", "wk", "wv",
               "wg", "wo", "ln_x", "cmu_k", "cmu_r", "cw_k", "cw_v", "cw_r")


def leaf_names(cfg: ModelConfig) -> List[str]:
    """The reference's leaf path names for a dense or RWKV6 ``cfg``."""
    if cfg.family not in (DENSE, SSM):
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    names = ["embed/embedding", "final_norm"]
    if not cfg.tie_embeddings:
        names.append("embed/unembed")
    if cfg.family == SSM:
        return names + [f"blocks/{n}" for n in RWKV_LEAVES]
    attn = ["wq", "wk", "wv", "wo"]
    if cfg.qkv_bias:
        attn += ["bq", "bk", "bv"]
    if cfg.qk_norm:
        attn += ["q_norm", "k_norm"]
    names += ["blocks/ln1", "blocks/ln2"]
    names += [f"blocks/attn/{n}" for n in attn]
    names += [f"blocks/mlp/{n}" for n in ("wi_gate", "wi_up", "wo")]
    return names


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _set(tree: Params, path: str, value: Any) -> None:
    *parents, leaf = path.split("/")
    for key in parents:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def _to_torch(a: Any, device: torch.device) -> torch.Tensor:
    a = np.require(np.asarray(a), requirements=["C", "W"])  # copies a view
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        bf16 = np.dtype("bfloat16")
    except TypeError:
        raise TypeError("a bfloat16 leaf needs numpy's bfloat16 dtype, which "
                        "ml_dtypes registers: import ml_dtypes first") from None
    return t.view(torch.int16).numpy().view(bf16)


def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any],
                      device: DeviceLike = "cuda") -> Params:
    """The reference's parameter tree (numpy leaves) -> the port's params.

    Every leaf of ``tree`` is used exactly once; a missing or unknown leaf
    raises.  The per-layer tensors are views of one stacked tensor.
    """
    dev = resolve_device(device)
    flat = _flatten(tree)
    want = leaf_names(cfg)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"parameter tree does not match {cfg.name}: "
                       f"missing {missing}, unexpected {extra}")
    p: Params = {"blocks": [{} for _ in range(cfg.num_layers)]}
    for name in want:
        t = _to_torch(flat[name], dev)
        head, _, rest = name.partition("/")
        if head != "blocks":
            _set(p, name, t)
            continue
        if t.shape[0] != cfg.num_layers:
            raise ValueError(f"{name}: leading axis {t.shape[0]} is not "
                             f"num_layers={cfg.num_layers}")
        for i, block in enumerate(p["blocks"]):
            _set(block, rest, t[i])
    return p


def params_to_numpy(cfg: ModelConfig, params: Params) -> Params:
    """The port's params -> the reference's nested tree of numpy arrays."""
    out: Params = {}
    for name in leaf_names(cfg):
        *parents, leaf = name.split("/")
        if parents and parents[0] == "blocks":
            per_layer = []
            for block in params["blocks"]:
                for key in parents[1:]:
                    block = block[key]
                per_layer.append(block[leaf])
            _set(out, name, _to_numpy(torch.stack(per_layer)))
        else:
            node = params
            for key in parents:
                node = node[key]
            _set(out, name, _to_numpy(node[leaf]))
    return out
