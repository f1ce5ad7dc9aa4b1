"""Explicit collectives for per-rank code (the reference's shard_map
regions), over a ``DeviceMesh``'s sub-groups.

Counterpart of ``repro/parallel/collectives.py``.  ``hierarchical_psum``:
reduce-scatter on the fast intra-pod axis, sum on the slow cross-pod axis
over the scattered shard, then all-gather: the cross-pod link carries
1/|inner| of the bytes a flat sum would ship.  ``compressed_psum``:
int8-quantized sum across one axis (pairs with the error feedback in
``optim/compress.py``).  Both return a new tensor and leave ``x`` as it
is.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
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
