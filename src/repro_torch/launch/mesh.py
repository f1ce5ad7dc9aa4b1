"""Mesh construction over ``torch.distributed``.

Counterpart of ``repro/launch/mesh.py``: the same shapes and axis names,
as a ``DeviceMesh``.  Functions, not module-level constants, so importing
this module touches no process group.  The caller starts the process
group first (``torch.distributed.init_process_group`` with its address,
world size and rank), with as many ranks as the mesh has devices.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """Single pod: (data=16, model=16) = 256 devices.

    Multi-pod: (pod=2, data=16, model=16) = 512 devices; the leading "pod"
    axis carries only data parallelism (params are pod-cached, XUFS-style),
    so its collectives are the slow-link-friendly gradient reductions.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(data: int = 2, model: int = 2, pods: int = 0, *,
                   device_type: str = "cuda") -> DeviceMesh:
    """A small (data, model) or (pod, data, model) mesh."""
    if pods:
        return init_device_mesh(device_type, (pods, data, model),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
