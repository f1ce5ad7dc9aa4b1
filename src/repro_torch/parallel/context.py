"""Active-mesh sharding context.

Counterpart of ``repro/parallel/context.py``.  Models annotate tensors with
*logical* axis names; under a :class:`ShardingCtx` those names resolve to
the named dims of a ``torch.distributed`` ``DeviceMesh``, otherwise
``shard`` is a no-op, so the same model code runs on one device and on a
mesh.  A :class:`NamedSharding` is the counterpart of JAX's: a mesh and a
spec that holds, for each tensor dim, ``None``, a mesh axis name or a
tuple of names (the major axis first), as a ``PartitionSpec`` holds them;
its ``placements`` are the same layout as DTensor placements, one a mesh
dim.  Nothing here touches a process group until a DTensor is
redistributed.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (
    DTensor, Replicate, Shard, distribute_tensor,
)
from torch.distributed.tensor.experimental import implicit_replication
from torch.distributed.tensor.placement_types import Placement

MeshAxes = Union[None, str, Tuple[str, ...]]

_STATE = threading.local()


def mesh_axes(axes: MeshAxes) -> Tuple[str, ...]:
    """The mesh axis names of one spec entry, the major axis first."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclass(frozen=True)
class NamedSharding:
    mesh: DeviceMesh
    spec: Tuple[MeshAxes, ...]

    @property
    def placements(self) -> Tuple[Placement, ...]:
        """``Shard(d)`` on every mesh dim named in tensor dim d's entry,
        ``Replicate()`` on the rest.  DTensor splits a tensor dim over its
        mesh dims in mesh order, the first the major one, so a tuple of
        axes must name them in that order (``("pod", "data")`` on a
        (pod, data, model) mesh) to give JAX's layout; another order, an
        unknown axis or an axis on two dims raises ``ValueError``."""
        names = list(self.mesh.mesh_dim_names or ())
        out = [Replicate()] * len(names)
        for dim, axes in enumerate(self.spec):
            idx = []
            for a in mesh_axes(axes):
                if a not in names:
                    raise ValueError(f"no mesh axis {a!r} in {names}")
                i = names.index(a)
                if out[i] != Replicate():
                    raise ValueError(f"mesh axis {a!r} shards two dims: "
                                     f"{self.spec}")
                out[i] = Shard(dim)
                idx.append(i)
            if idx != sorted(idx):
                raise ValueError(f"{axes} is not in the mesh's order "
                                 f"{names}: DTensor shards a dim over its "
                                 "mesh dims major first")
        return tuple(out)


@dataclass
class ShardingCtx:
    mesh: DeviceMesh
    # logical activation/param axis name -> mesh axis (or tuple of axes)
    rules: Dict[str, MeshAxes] = field(default_factory=dict)

    def spec(self, logical: Sequence[Optional[str]]
             ) -> Tuple[MeshAxes, ...]:
        return tuple(None if name is None else self.rules.get(name)
                     for name in logical)

    def sharding(self, logical: Sequence[Optional[str]]) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(logical))


def current_ctx() -> Optional[ShardingCtx]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def sharding_ctx(ctx: Optional[ShardingCtx]):
    """Make ``ctx`` the active context.  Under a context a plain tensor that
    meets a DTensor in an op (an ``arange`` of positions, RoPE's
    frequencies) counts as replicated, as a constant does under ``jit``
    with shardings.  Contexts nest (each remat group enters its own): on
    leaving, the implicit replication is put back as it was, where
    ``implicit_replication`` would turn it off for the enclosing one."""
    prev = current_ctx()
    dispatcher = DTensor._op_dispatcher
    implicit = dispatcher._allow_implicit_replication
    _STATE.ctx = ctx
    try:
        if ctx is None:
            yield ctx
        else:
            with implicit_replication():
                yield ctx
    finally:
        _STATE.ctx = prev
        dispatcher._allow_implicit_replication = implicit


def axis_size(mesh: DeviceMesh, axes: MeshAxes) -> int:
    """The number of shards a spec entry cuts a dim into."""
    n = 1
    for a in mesh_axes(axes):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def fit(sh: NamedSharding, shape: Sequence[int]) -> NamedSharding:
    """``sh`` with the mesh axes of every dim they do not divide dropped
    (that dim replicated), as the reference's explicit shardings require;
    DTensor would shard such a dim unevenly."""
    parts = list(sh.spec) + [None] * (len(shape) - len(sh.spec))
    changed = False
    for i, axes in enumerate(parts):
        n = axis_size(sh.mesh, axes)
        if n > 1 and shape[i] % n != 0:
            parts[i] = None
            changed = True
    return NamedSharding(sh.mesh, tuple(parts)) if changed else sh


def layout(x: torch.Tensor, *logical: Optional[str]
           ) -> Tuple[Placement, ...]:
    """The placements ``shard(x, *logical)`` gives ``x`` under the active
    context (axes that do not divide a dim dropped)."""
    ctx = current_ctx()
    if ctx is None:
        raise RuntimeError("no sharding context is active")
    if len(logical) != x.ndim:
        raise ValueError(f"rank mismatch: {logical} for shape "
                         f"{tuple(x.shape)}")
    return fit(ctx.sharding(logical), x.shape).placements


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Lay ``x`` out by the logical spec if a mesh context is active: a
    DTensor is redistributed to its placements (a mesh axis that does not
    divide its dim is dropped, as ``fit`` does), and so is its gradient,
    as the transpose of JAX's ``with_sharding_constraint`` constrains the
    cotangent (a partial-sum grad is reduced here, before it meets ops
    that cannot take one); a plain (per-rank) tensor passes through as it
    is."""
    ctx = current_ctx()
    if ctx is None:
        return x
    placements = layout(x, *logical)
    if not isinstance(x, DTensor):
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _Constrain.apply(x, placements)
    if x.placements != placements:
        return x.redistribute(ctx.mesh, placements)
    return x


class _Constrain(torch.autograd.Function):
    """Redistribute a DTensor and its gradient to the same placements."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.placements), None


def distribute(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """A tensor that every rank holds in full, as a DTensor laid out by
    the logical spec under the active context: each rank keeps its own
    block (a copy, no communication)."""
    ctx = current_ctx()
    if ctx is None:
        return x
    return to_dtensor(x, ctx.mesh, layout(x, *logical))


def to_dtensor(x: torch.Tensor, mesh: DeviceMesh,
               placements: Sequence[Placement]) -> DTensor:
    """``x`` (the same full tensor on every rank, or a ``meta`` one) as a
    DTensor whose local block is a copy of this rank's block of ``x``."""
    local = distribute_tensor(x.detach(), mesh, list(placements),
                              src_data_rank=None).to_local()
    return DTensor.from_local(local.clone(), mesh, list(placements),
                              run_check=False, shape=x.shape,
                              stride=x.stride())
