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
from torch.distributed.tensor import DTensor, Replicate, Shard
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
    prev = current_ctx()
    _STATE.ctx = ctx
    try:
        yield ctx
    finally:
        _STATE.ctx = prev


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Lay ``x`` out by the logical spec if a mesh context is active: a
    DTensor is redistributed to its placements, a plain (per-rank) tensor
    passes through as it is."""
    ctx = current_ctx()
    if ctx is None:
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"rank mismatch: {logical} for shape "
                         f"{tuple(x.shape)}")
    if isinstance(x, DTensor):
        return x.redistribute(ctx.mesh, ctx.sharding(logical).placements)
    return x
