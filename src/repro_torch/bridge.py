"""Parameters between the JAX package's layout (as numpy) and the port's.

The reference keeps parameters as a nested dict whose per-layer leaves
carry a stacked leading layer axis (``repro/models/model.py``
``_stack_init``); its checkpoints name each leaf by the ``/``-joined dict
path (``repro/checkpoint/ckpt.py`` ``_path_str``: ``blocks/attn/wq``,
``embed/embedding``, ``final_norm``).  The port keeps the same names with
``blocks`` as a list of per-layer dicts.  The hybrid family stacks
superblocks, and inside each its Mamba, MLP and MoE layers on a second
axis (``blocks/mamba/in_proj`` is [nb, n_mamba, ...], ``blocks/moe/wo``
[nb, n_moe, E, f, d]); the port keeps those layers as lists of dicts in
each superblock (``blocks[i]["mamba"][j]``) and ``blocks/ln_mix``/
``ln_ffn`` as [period, d] tensors.  An MoE block's experts are
``blocks/moe/{router,wi_gate,wi_up,wo}`` [L, ...], the router in f32.
``params_from_numpy`` takes the
reference's tree as numpy arrays, nested or already flat by path name;
``params_to_numpy`` gives it back.  bf16 travels as a 16-bit view, because
``torch.from_numpy`` does not take numpy's (``ml_dtypes``) bfloat16.

``state_to_reference``/``state_from_reference`` map the trainer's whole
tree, ``{"params", "opt"}`` (``repro/train/loop.py`` ``_state_tree``), the
same way and keep torch tensors on their device: ``opt``'s ``m``, ``v``
and ``ef_error`` follow the params' layout (an int8 moment's ``{"q",
"s"}`` pair stacks along the same leading axes, its blocks running
along the last dim), and ``count`` passes through as it is.  The port's
``CheckpointManager`` saves and restores such a tree under the
reference's leaf names.
This module imports no JAX: only tests hand it JAX-made arrays.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

from repro_torch.config.base import DENSE, HYBRID, MOE, SSM, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.hybrid import n_mamba, n_moe
from repro_torch.optim.adamw import tree_map

Params = Dict[str, Any]


# per-layer leaves of an RWKV6 block (``repro/models/rwkv6.py`` rwkv_init)
RWKV_LEAVES = ("ln1", "ln2", "mu_base", "mu", "mix_w1", "mix_w2",
               "decay_base", "decay_w1", "decay_w2", "u", "wr", "wk", "wv",
               "wg", "wo", "ln_x", "cmu_k", "cmu_r", "cw_k", "cw_v", "cw_r")
# per-layer leaves of a Mamba layer (``repro/models/mamba.py`` mamba_init)
MAMBA_LEAVES = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                "dt_bias", "A_log", "D", "out_proj", "dt_norm", "b_norm",
                "c_norm")
MLP_LEAVES = ("wi_gate", "wi_up", "wo")
# per-layer leaves of an MoE layer (``repro/models/moe.py`` moe_init)
MOE_LEAVES = ("router", "wi_gate", "wi_up", "wo")


def leaf_names(cfg: ModelConfig) -> List[str]:
    """The reference's leaf path names for a dense, MoE, RWKV6 or hybrid
    ``cfg``."""
    if cfg.family not in (DENSE, MOE, SSM, HYBRID):
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
    if cfg.family == HYBRID:
        names += ["blocks/ln_mix", "blocks/ln_ffn"]
        names += [f"blocks/mamba/{n}" for n in MAMBA_LEAVES]
    else:
        names += ["blocks/ln1", "blocks/ln2"]
    names += [f"blocks/attn/{n}" for n in attn]
    if cfg.family == HYBRID or not cfg.is_moe:
        names += [f"blocks/mlp/{n}" for n in MLP_LEAVES]
    if cfg.is_moe:
        names += [f"blocks/moe/{n}" for n in MOE_LEAVES]
    return names


def _sublayers(cfg: ModelConfig) -> Dict[str, int]:
    """Superblock entries kept as per-layer lists -> their length."""
    if cfg.family != HYBRID:
        return {}
    subs = {"mamba": n_mamba(cfg), "mlp": cfg.hybrid_period - n_moe(cfg)}
    if n_moe(cfg):
        subs["moe"] = n_moe(cfg)
    return subs


def _n_blocks(cfg: ModelConfig) -> int:
    if cfg.family == HYBRID:
        return cfg.num_layers // cfg.hybrid_period
    return cfg.num_layers


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


def _map(fn, node: Any) -> Any:
    """``fn`` over a leaf, or over each tensor of an int8 ``{"q", "s"}``
    pair."""
    if isinstance(node, Mapping):
        return {k: fn(v) for k, v in node.items()}
    return fn(node)


def _stack(nodes: List[Any]) -> Any:
    if isinstance(nodes[0], Mapping):
        return {k: torch.stack([n[k] for n in nodes]) for k in nodes[0]}
    return torch.stack(nodes)


def _get(tree: Params, path: str) -> Any:
    """The leaf at ``path``; a list of per-layer dicts on the way (a
    superblock's layers) gives the leaf of each, stacked."""
    *parents, leaf = path.split("/")
    for key in parents:
        tree = tree[key]
    if isinstance(tree, list):
        return _stack([lp[leaf] for lp in tree])
    return tree[leaf]


def _tree_to_reference(cfg: ModelConfig, tree: Params) -> Params:
    """A params-shaped tree of the port -> the reference's stacked layout
    (torch tensors, each stacked leaf a new tensor)."""
    out: Params = {}
    for name in leaf_names(cfg):
        head, _, rest = name.partition("/")
        if head == "blocks":
            node = _stack([_get(block, rest) for block in tree["blocks"]])
        else:
            node = _get(tree, name)
        _set(out, name, node)
    return out


def _tree_from_reference(cfg: ModelConfig, tree: Mapping[str, Any],
                         what: str = "parameter tree") -> Params:
    """The reference's stacked layout (torch tensors, nested or flat by
    path name) -> a params-shaped tree of the port, each per-layer tensor
    a view of the stacked one.  A missing or unknown leaf raises."""
    flat = _flatten(tree)
    want = leaf_names(cfg)
    nodes: Dict[str, Any] = {}
    for name in want:
        if name in flat:
            nodes[name] = flat[name]
            continue
        pair = {k[len(name) + 1:]: v for k, v in flat.items()
                if k.startswith(name + "/")}
        if pair:
            nodes[name] = pair
    used = set()
    for name, node in nodes.items():
        used |= {f"{name}/{k}" for k in node} if isinstance(node, Mapping) \
            else {name}
    missing = sorted(set(want) - set(nodes))
    extra = sorted(set(flat) - used)
    if missing or extra:
        raise KeyError(f"{what} does not match {cfg.name}: "
                       f"missing {missing}, unexpected {extra}")
    nb, subs = _n_blocks(cfg), _sublayers(cfg)
    p: Params = {"blocks": [{} for _ in range(nb)]}
    for name in want:
        node = nodes[name]
        head, _, rest = name.partition("/")
        if head != "blocks":
            _set(p, name, node)
            continue
        lead = next(iter(node.values())) if isinstance(node, Mapping) \
            else node
        if lead.shape[0] != nb:
            raise ValueError(f"{name}: leading axis {lead.shape[0]} is not "
                             f"the {nb} stacked blocks of num_layers="
                             f"{cfg.num_layers}")
        sub, _, leaf = rest.partition("/")
        if sub in subs and lead.shape[1] != subs[sub]:
            raise ValueError(f"{name}: second axis {lead.shape[1]} is not "
                             f"the {subs[sub]} {sub} layers of a superblock")
        for i, block in enumerate(p["blocks"]):
            if sub in subs:
                layers = block.setdefault(sub, [{} for _ in range(subs[sub])])
                for j, lp in enumerate(layers):
                    lp[leaf] = _map(lambda t: t[i, j], node)
            else:
                _set(block, rest, _map(lambda t: t[i], node))
    return p


# entries of the optimizer state laid out as the params are
_PARAM_SHAPED = ("m", "v", "ef_error")


def state_to_reference(cfg: ModelConfig, state: Mapping[str, Any]) -> Params:
    """The port's ``{"params": ..., "opt": ...}`` (either or both) -> the
    reference's layout, torch tensors on their devices."""
    out: Params = {}
    for key, sub in state.items():
        if key == "params":
            out[key] = _tree_to_reference(cfg, sub)
        elif key == "opt":
            out[key] = {k: _tree_to_reference(cfg, v)
                        if k in _PARAM_SHAPED else v for k, v in sub.items()}
        else:
            raise KeyError(f"unknown entry {key!r} of a trainer tree")
    return out


def state_from_reference(cfg: ModelConfig, tree: Mapping[str, Any]
                         ) -> Params:
    """The reference's ``{"params": ..., "opt": ...}`` layout (torch
    tensors) -> the port's; the per-layer tensors are views of the
    stacked ones."""
    out: Params = {}
    for key, sub in tree.items():
        if key == "params":
            out[key] = _tree_from_reference(cfg, sub)
        elif key == "opt":
            out[key] = {k: _tree_from_reference(cfg, v, f"opt/{k}")
                        if k in _PARAM_SHAPED else v for k, v in sub.items()}
        else:
            raise KeyError(f"unknown entry {key!r} of a trainer tree")
    return out


def params_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any],
                      device: DeviceLike = "cuda") -> Params:
    """The reference's parameter tree (numpy leaves) -> the port's params.

    Every leaf of ``tree`` is used exactly once; a missing or unknown leaf
    raises.  The per-layer tensors are views of one stacked tensor.
    """
    dev = resolve_device(device)
    return _tree_from_reference(
        cfg, tree_map(lambda a: _to_torch(a, dev), tree))


def params_to_numpy(cfg: ModelConfig, params: Params) -> Params:
    """The port's params -> the reference's nested tree of numpy arrays."""
    return tree_map(_to_numpy, _tree_to_reference(cfg, params))


def state_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any],
                     device: DeviceLike = "cuda") -> Params:
    """``state_from_reference`` of a tree of numpy arrays."""
    dev = resolve_device(device)
    return state_from_reference(
        cfg, tree_map(lambda a: _to_torch(a, dev), tree))


def state_to_numpy(cfg: ModelConfig, state: Mapping[str, Any]) -> Params:
    """``state_to_reference`` as numpy arrays."""
    return tree_map(_to_numpy, state_to_reference(cfg, state))
