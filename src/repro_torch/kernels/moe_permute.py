"""MoE dispatch and combine: rows moved between token order and the
capacity buffer [E, C+1, d], as two CUDA kernels + plain.

Replaces no Pallas kernel: the reference's dispatch is ``xe.at[...].add``
and its combine a gather, a weight and a sum (``repro/models/moe.py``),
both left to XLA.  Token t's j-th assignment goes to expert
``ids[t, j]`` at slot ``pos[t, j]``; ``pos == C`` marks one its expert's
capacity dropped.

- ``moe_dispatch(x, ids, pos, E, C)`` -> xe [E, C+1, d]: a kept slot
  holds its token's row; every other row, the parking slot C included,
  is zeros (the ``"xla"`` path parks the sum of the dropped rows there;
  it is weighted 0 either way).
- ``moe_combine(ye, ids, pos, gate_w)`` -> [T, d]: ``_combine``'s
  function, each kept row times its weight rounded to ye's dtype, the
  product rounded, the k products summed in f32 and rounded once.

Each launches ``csrc/moe_permute.cu`` for a CUDA tensor (bfloat16,
float16 or float32) and runs its plain version for a CPU tensor.  Their
bound is bytes: the dispatch writes the buffer once and reads the kept
rows, the combine reads the kept rows and writes [T, d]; so neither
makes a T*k copy of the rows or uses atomics, and both move 16 bytes a
thread where the row allows (the source's note).  ``.launches`` on each
wrapper counts its CUDA launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._grad import check_no_grad

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_ELEMENTS = 2 ** 31 - 1   # the kernels index elements in 32 bits


def moe_dispatch_plain(x: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor,
                       num_experts: int, capacity: int) -> torch.Tensor:
    """x: [T,d]; ids, pos: [T,k] -> [E, C+1, d] in x's dtype, each kept
    assignment's row in its slot and zeros elsewhere."""
    T, d = x.shape
    xe = x.new_zeros(num_experts, capacity + 1, d)
    keep = pos < capacity
    tok = torch.arange(T, device=x.device)[:, None].expand_as(ids)
    xe[ids[keep], pos[keep]] = x[tok[keep]]
    return xe


def moe_combine_plain(ye: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor,
                      gate_w: torch.Tensor) -> torch.Tensor:
    """ye: [E, C+1, d]; ids, pos: [T,k]; gate_w: [T,k] f32 -> [T,d] in
    ye's dtype: the rows weighted (a dropped one by 0), each product
    rounded, summed in f32 in the kernel's order j = 0..k-1, rounded."""
    w = ((pos < ye.shape[1] - 1) * gate_w).to(ye.dtype)
    back = ye[ids, pos] * w[..., None]                        # [T, k, d]
    acc = back.new_zeros(back.shape[0], back.shape[2], dtype=torch.float32)
    for j in range(back.shape[1]):
        acc = acc + back[:, j].float()
    return acc.to(ye.dtype)


def _check_routes(ids: torch.Tensor, pos: torch.Tensor, T: int,
                  device: torch.device) -> None:
    for name, t in (("ids", ids), ("pos", pos)):
        if t.dim() != 2 or t.shape[0] != T or t.shape != ids.shape:
            raise ValueError(f"want {name} [T={T}, k] like ids; got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.int64 or t.device != device:
            raise TypeError(f"{name} must be int64 on {device}; got "
                            f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_rows(name: str, t: torch.Tensor) -> None:
    if t.dtype not in DTYPES:
        raise TypeError(f"{name} is {t.dtype}; the kernel takes bfloat16, "
                        "float16 or float32")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() > MAX_ELEMENTS:
        raise ValueError(f"{name} has {t.numel()} elements; the kernel "
                         f"indexes at most {MAX_ELEMENTS}")


def _entry(name: str, n_ptrs: int, n_ints: int):
    fn = getattr(_build.load("moe_permute"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


def moe_dispatch(x: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor,
                 num_experts: int, capacity: int) -> torch.Tensor:
    """x: [T,d]; ids, pos: [T,k] int64 -> xe [E, C+1, d] in x's dtype.

    On a CUDA tensor one launch of the map and one of the row sweep on
    the current stream, or raises.
    """
    if x.device.type == "cpu":
        return moe_dispatch_plain(x, ids, pos, num_experts, capacity)
    if x.device.type != "cuda":
        raise ValueError(f"moe_dispatch runs on cpu or cuda, not {x.device}")
    if x.dim() != 2:
        raise ValueError(f"want x [T, d]; got {tuple(x.shape)}")
    T, d = x.shape
    _check_rows("x", x)
    _check_routes(ids, pos, T, x.device)
    E, C, k = int(num_experts), int(capacity), ids.shape[1]
    if E < 1 or C < 0 or E * (C + 1) * d > MAX_ELEMENTS or T * k > MAX_ELEMENTS:
        raise ValueError(f"E={E}, C={C}, d={d}, T*k={T * k}: want E >= 1, "
                         f"C >= 0 and the buffer and routes within "
                         f"{MAX_ELEMENTS} elements")
    check_no_grad("moe_dispatch", "scan_impl", x)
    out = torch.empty(E, C + 1, d, dtype=x.dtype, device=x.device)
    slot_token = torch.empty(E * (C + 1), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("moe_dispatch", 5, 6)(
            x.data_ptr(), ids.data_ptr(), pos.data_ptr(),
            slot_token.data_ptr(), out.data_ptr(), T, k, E, C, d,
            DTYPES[x.dtype], stream)
    _raise_on(err, "moe_dispatch")
    moe_dispatch.launches += 1
    return out


moe_dispatch.launches = 0   # CUDA launches (CPU tensors take the plain path)


def moe_combine(ye: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor,
                gate_w: torch.Tensor) -> torch.Tensor:
    """ye: [E, C+1, d]; ids, pos: [T,k] int64; gate_w: [T,k] float32 ->
    [T, d] in ye's dtype.

    On a CUDA tensor one launch on the current stream, or raises.
    """
    if ye.device.type == "cpu":
        return moe_combine_plain(ye, ids, pos, gate_w)
    if ye.device.type != "cuda":
        raise ValueError(f"moe_combine runs on cpu or cuda, not {ye.device}")
    if ye.dim() != 3 or ye.shape[1] < 1:
        raise ValueError(f"want ye [E, C+1, d]; got {tuple(ye.shape)}")
    if gate_w.dim() != 2:
        raise ValueError(f"want gate_w [T, k]; got {tuple(gate_w.shape)}")
    T, k = gate_w.shape
    _check_rows("ye", ye)
    _check_routes(ids, pos, T, ye.device)
    if ids.shape[1] != k:
        raise ValueError(f"gate_w {tuple(gate_w.shape)} against ids "
                         f"{tuple(ids.shape)}")
    if gate_w.dtype != torch.float32 or gate_w.device != ye.device \
            or not gate_w.is_contiguous():
        raise TypeError(f"gate_w must be contiguous float32 on {ye.device}")
    d = ye.shape[2]
    if T * max(k, d) > MAX_ELEMENTS:
        raise ValueError(f"T={T}, k={k}, d={d}: the routes and the output "
                         f"must fit {MAX_ELEMENTS} elements")
    check_no_grad("moe_combine", "scan_impl", ye, gate_w)
    out = torch.empty(T, d, dtype=ye.dtype, device=ye.device)
    with torch.cuda.device(ye.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry("moe_combine", 5, 5)(
            ye.data_ptr(), ids.data_ptr(), pos.data_ptr(), gate_w.data_ptr(),
            out.data_ptr(), T, k, ye.shape[1] - 1, d, DTYPES[ye.dtype],
            stream)
    _raise_on(err, "moe_combine")
    moe_combine.launches += 1
    return out


moe_combine.launches = 0    # CUDA launches (CPU tensors take the plain path)
