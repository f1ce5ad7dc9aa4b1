"""Explicit collectives for per-rank code (the reference's shard_map
regions), over a ``DeviceMesh``'s sub-groups.

Counterpart of ``repro/parallel/collectives.py``.  ``hierarchical_psum``:
reduce-scatter on the fast intra-pod axis, sum on the slow cross-pod axis
over the scattered shard, then all-gather: the cross-pod link carries
1/|inner| of the bytes a flat sum would ship.  ``compressed_psum``:
int8-quantized sum across one axis (pairs with the error feedback in
``optim/compress.py``).  Both return a new tensor and leave ``x`` as it
is.  ``all_to_all_rows``: an all-to-all of dim-0 rows with a backward
(the same exchange reversed).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh


def hierarchical_psum(x: torch.Tensor, mesh: DeviceMesh, pod_axis: str,
                      inner_axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks of (pod_axis, inner_axis), pod traffic
    minimized.  A leading dim that the inner axis does not divide falls
    back to a flat sum (correct, just not bandwidth-optimal)."""
    pod, inner = mesh.get_group(pod_axis), mesh.get_group(inner_axis)
    n_inner = dist.get_world_size(inner)
    lead = x.shape[0]
    if lead % n_inner != 0:
        out = x.clone()
        dist.all_reduce(out, group=inner)
        dist.all_reduce(out, group=pod)
        return out
    # reduce-scatter within pod: each inner rank owns a 1/n_inner slice
    shard = x.new_empty((lead // n_inner,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(shard, x.contiguous(), group=inner)
    # cross-pod reduce touches only the owned slice
    dist.all_reduce(shard, group=pod)
    # all-gather the slices back within the pod
    out = x.new_empty(x.shape)
    dist.all_gather_into_tensor(out, shard, group=inner)
    return out


def compressed_psum(x: torch.Tensor, mesh: DeviceMesh, axis: str, *,
                    dequant_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """Quantize-locally-then-reduce sum across ``axis``.

    Each rank quantizes its contribution to int8 (per-tensor scale) before
    the reduction; the reduction sums the *dequantized* values, so the
    result is exact given the quantized contributions.
    """
    scale = x.abs().max() / 127.0
    scale = torch.where(scale == 0.0, 1.0, scale)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    contrib = q.to(dequant_dtype) * scale
    dist.all_reduce(contrib, group=mesh.get_group(axis))
    return contrib


_GATHER_LIB = []     # the registration, kept alive once made


def gloo_cuda_all_gather() -> None:
    """Route the functional all-gather (what DTensor's redistributions
    call) through c10d's ``all_gather_into_tensor`` for CUDA tensors.

    On a ``gloo`` group given CUDA tensors (several ranks sharing one
    card, where nccl cannot run), torch's functional
    ``_c10d_functional.all_gather_into_tensor`` ends every rank with a
    segmentation fault (torch 2.11 + CUDA 12.8 on an H100), while c10d's
    own all-gather, and the functional all-reduce, reduce-scatter and
    all-to-all, run.  The same bytes move, staged through the host as gloo
    stages all its collectives.  Process-wide and idempotent: a rank on
    gloo with CUDA DTensors calls it once, after joining its group."""
    if _GATHER_LIB:
        return
    from torch.distributed import distributed_c10d as c10d
    lib = torch.library.Library("_c10d_functional", "IMPL")

    def all_gather_into_tensor(x, group_size, group_name):
        out = x.new_empty((group_size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(),
                                    group=c10d._resolve_process_group(
                                        group_name))
        return out

    lib.impl("all_gather_into_tensor", all_gather_into_tensor, "CUDA")
    _GATHER_LIB.append(lib)


def _world_splits(pairs: Sequence[Tuple[int, int]]) -> List[int]:
    out = [0] * dist.get_world_size()
    for rank, rows in pairs:
        out[rank] += rows
    return out


class _AllToAllRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send, recv):
        ctx.send, ctx.recv = send, recv
        return funcol.wait_tensor(funcol.all_to_all_single(
            x.contiguous(), recv, send, dist.group.WORLD))

    @staticmethod
    def backward(ctx, grad):
        return funcol.wait_tensor(funcol.all_to_all_single(
            grad.contiguous(), ctx.send, ctx.recv, dist.group.WORLD)), \
            None, None


def all_to_all_rows(x: torch.Tensor, send: Sequence[Tuple[int, int]],
                    recv: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """This rank's part of an all-to-all of x's dim-0 rows on the default
    group: ``send`` lists (rank, rows) in the order x's rows go out,
    ``recv`` (rank, rows) in the order the result's rows come in, both by
    ascending rank (ranks not listed exchange no rows with this one).
    Differentiable: the grad goes back by the reverse exchange."""
    return _AllToAllRows.apply(x, _world_splits(send), _world_splits(recv))
