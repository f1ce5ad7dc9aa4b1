"""Logical-axis -> mesh-axis sharding policies.

Counterpart of ``repro/parallel/sharding.py``; the rules are the
reference's, key for key.  Two policies:

* ``baseline``  - plain DP x TP: parameters TP-sharded on ``model`` only,
  replicated across ``data`` (and ``pod``).
* ``fsdp``      - parameters replicated across pods but ZeRO-3 sharded on
  ``data`` within the pod along their d_model ("embed") dimension, with
  TP on ``model``.

Weight tensors use flattened head dims ("heads"/"kv").  The shardings are
``context.NamedSharding``s over a ``DeviceMesh``; their ``placements``
hand them to DTensor.  Trees are the port's (nested dicts and lists, axes
tuples as leaves: ``models.param_axes``, ``models.cache_logical_axes``,
``optim.state_axes``).
"""
from __future__ import annotations

from typing import Any, Dict

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.config.base import ShardingConfig
from repro_torch.optim.adamw import tree_map
from repro_torch.parallel.context import (
    MeshAxes, NamedSharding, ShardingCtx, mesh_axes,
)


def make_rules(cfg: ShardingConfig, *, multi_pod: bool,
               decode: bool = False) -> Dict[str, Any]:
    """Build the logical->mesh mapping for one (policy, topology, cell)."""
    tp = cfg.tp_axis
    batch_axes = (cfg.pod_axis, cfg.fsdp_axis) if multi_pod else cfg.fsdp_axis
    rules: Dict[str, Any] = {
        # ---- parameters -------------------------------------------------
        "vocab": tp,
        "heads": tp,
        "kv": tp,
        "mlp": tp,
        "expert_mlp": None,
        "experts": tp,          # EP: experts across the model axis
        "inner": tp,            # mamba d_inner
        "embed2": tp,           # rwkv channel-mix receptance out dim
        "embed": None,
        "layers": None,
        "sublayer": None,
        # ---- activations ---------------------------------------------------
        "batch": batch_axes,
        "embed_act": None,
        "vocab_act": tp,
        "heads_act": tp,
        "kv_act": tp,
        "inner_act": tp,
        "experts_act": tp,   # EP-sharded dispatch buffers
        "heads_dim": tp,     # expanded attention heads (post repeat_kv)
        "kv_seq": None,
    }
    if cfg.policy == "fsdp":
        # ZeRO-3 within the pod: shard the d_model dim of weights on data
        rules["embed"] = cfg.fsdp_axis
    if cfg.shard_seq and decode:
        # long-context decode (batch too small to shard): SP on the cache
        rules["batch"] = None
        rules["kv_seq"] = cfg.fsdp_axis
    return rules


def make_ctx(mesh: DeviceMesh, cfg: ShardingConfig, *, decode: bool = False,
             ) -> ShardingCtx:
    multi_pod = "pod" in (mesh.mesh_dim_names or ())
    return ShardingCtx(mesh=mesh,
                       rules=make_rules(cfg, multi_pod=multi_pod,
                                        decode=decode))


def tree_shardings(ctx: ShardingCtx, axes_tree: Any):
    """Map a tree of logical-axis tuples to NamedShardings."""
    return tree_map(ctx.sharding, axes_tree)


def batch_shardings(ctx: ShardingCtx, batch_tree: Any):
    """Shardings for an input batch: leading batch dim sharded.

    VLM positions are [3, B, S] (batch on dim 1); everything else [B, ...].
    """
    out = {}
    for name, leaf in batch_tree.items():
        if name == "positions" and leaf.ndim == 3:
            out[name] = ctx.sharding((None, "batch", None))
        else:
            out[name] = ctx.sharding(("batch",) + (None,) * (leaf.ndim - 1))
    return out


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def axis_size(mesh: DeviceMesh, axes: MeshAxes) -> int:
    """The number of shards a spec entry cuts a dim into."""
    n = 1
    for a in mesh_axes(axes):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def sanitize_shardings(shardings, shapes):
    """Drop mesh axes from dims they don't divide (the reference's rule for
    explicit in_shardings; DTensor would shard unevenly instead).

    E.g. seamless's vocab 256206 on a 4- or 16-way model axis, or RWKV6's
    40 heads on 16: those dims fall back to replication, everything else
    keeps its sharding.  Both trees must be isomorphic; ``shapes`` leaves
    need ``.shape`` (tensors, ``meta`` ones included).
    """
    def fix(sh, leaf):
        if not isinstance(sh, NamedSharding):
            return sh
        shape = tuple(leaf.shape)
        parts = list(sh.spec) + [None] * (len(shape) - len(sh.spec))
        changed = False
        for i, axes in enumerate(parts):
            n = axis_size(sh.mesh, axes)
            if n > 1 and shape[i] % n != 0:
                parts[i] = None
                changed = True
        if not changed:
            return sh
        return NamedSharding(sh.mesh, tuple(parts))

    return tree_map(fix, shardings, shapes)
