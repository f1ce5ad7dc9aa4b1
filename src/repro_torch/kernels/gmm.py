"""Grouped matmul (gmm) for MoE expert FFNs: CUDA kernels + plain.

Counterpart of ``repro/kernels/gmm.py`` and its ``ops.py`` wrappers.
``gmm`` launches a hand-written kernel of ``csrc/gmm.cu`` for a CUDA
tensor and runs ``gmm_plain`` for a CPU tensor.  lhs [M, K] holds rows
sorted by group, rhs [G, K, N] stacks the groups' matrices, and row r of
group g gets ``lhs[r] @ rhs[g]``, summed in f32 and cast to lhs's dtype;
rows past ``sum(group_sizes)`` are zero, as the reference's
``gmm_sorted`` leaves them.

Two kernel routes, chosen by ``route`` from the dtype and the shape
alone (never by a fallback, an option or the environment):

- ``"wgmma"``: bf16 with K and N multiples of 8 (what TMA can address),
  K > 0 and at most ``MAX_WGMMA_GROUPS`` groups.  A persistent,
  warp-specialised Hopper kernel: TMA loads, ``wgmma`` products, one
  block a SM, 128 x 256 output tiles.
- ``"mma_sync"``: every other shape, and float32 (its FMA kernel).

The reference pads each group on the host to a multiple of 128 rows and
passes a tile -> group table.  Here ``group_sizes`` stays an int32 tensor
on the device and the kernel finds each tile's group itself, so a launch
never waits for the host.  ``gmm_equal`` is the same launch for G groups
of equal size (the MoE capacity buffer [E, C+1, d]).  ``gmm.launches``
counts every launch, ``gmm.route_launches`` the launches of each route.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._grad import check_no_grad

MAX_M_TILES = 65535   # mma_sync's grid y dimension (m-tiles of 64 or 128)
MAX_WGMMA_GROUPS = 2048   # csrc/gmm.cu kMaxGroups: the scan held in smem
ROUTES = ("wgmma", "mma_sync")


def route(dtype: torch.dtype, K: int, N: int, G: int) -> str:
    """The kernel that takes a product of this dtype and shape."""
    if dtype == torch.bfloat16 and K > 0 and K % 8 == 0 and N % 8 == 0 \
            and G <= MAX_WGMMA_GROUPS:
        return "wgmma"
    return "mma_sync"


def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor,
              group_sizes: torch.Tensor) -> torch.Tensor:
    """lhs: [M,K]; rhs: [G,K,N]; group_sizes: [G] -> [M,N] in lhs's dtype,
    one f32 product per group in PyTorch ops."""
    M = lhs.shape[0]
    out = torch.zeros(M, rhs.shape[2], dtype=lhs.dtype, device=lhs.device)
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        end = min(start + max(int(size), 0), M)
        if end > start:
            out[start:end] = (lhs[start:end].float()
                              @ rhs[g].float()).to(lhs.dtype)
        start = end
    return out


def _check(lhs: torch.Tensor, rhs: torch.Tensor,
           group_sizes: Optional[torch.Tensor]) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if lhs.dim() != 2 or rhs.dim() != 3 or lhs.shape[1] != rhs.shape[1]:
        raise ValueError(f"want lhs [M,K] and rhs [G,K,N]; got "
                         f"{tuple(lhs.shape)}, {tuple(rhs.shape)}")
    if lhs.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"lhs is {lhs.dtype}; the kernel takes bfloat16 or "
                        "float32")
    if rhs.dtype != lhs.dtype:
        raise TypeError(f"rhs is {rhs.dtype}, lhs {lhs.dtype}")
    for name, t in (("lhs", lhs), ("rhs", rhs)):
        if t.device != lhs.device:
            raise ValueError(f"{name} on {t.device}, lhs on {lhs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if group_sizes is not None:
        if tuple(group_sizes.shape) != (rhs.shape[0],):
            raise ValueError(f"want group_sizes [G={rhs.shape[0]}]; got "
                             f"{tuple(group_sizes.shape)}")
        if group_sizes.dtype != torch.int32 or \
                group_sizes.device != lhs.device:
            raise TypeError(f"group_sizes must be int32 on {lhs.device}; got "
                            f"{group_sizes.dtype} on {group_sizes.device}")
    M, G = lhs.shape[0], rhs.shape[0]
    if route(lhs.dtype, rhs.shape[1], rhs.shape[2], G) == "mma_sync":
        block_m = 128 if lhs.dtype == torch.bfloat16 else 64
        if -(-M // block_m) + G > MAX_M_TILES:
            raise ValueError(f"{M} rows in {G} groups exceed the grid's "
                             f"{MAX_M_TILES} m-tiles of {block_m}")
    if max(M, rhs.shape[1], rhs.shape[2]) >= 2 ** 31:
        raise ValueError("M, K and N must fit int32")


def _entry(name: str):
    fn = getattr(_build.load("gmm"), name)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it whose base is 16-byte aligned as TMA wants (a
    contiguous view may start anywhere in its storage)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(lhs: torch.Tensor, rhs: torch.Tensor,
            group_sizes: Optional[torch.Tensor], equal_rows: int,
            kernel: str) -> torch.Tensor:
    """One launch of the ``kernel`` route; raises if it fails, or if
    autograd would need a backward through it."""
    check_no_grad("gmm", "scan_impl", lhs, rhs)
    M, K = lhs.shape
    G, _, N = rhs.shape
    out = torch.empty(M, N, dtype=lhs.dtype, device=lhs.device)
    sizes = 0 if group_sizes is None else group_sizes.data_ptr()
    if kernel == "wgmma":
        lhs, rhs = _aligned(lhs), _aligned(rhs)
        name = "gmm_bf16_wgmma"
    else:
        name = "gmm_bf16" if lhs.dtype == torch.bfloat16 else "gmm_f32"
    with torch.cuda.device(lhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(name)(lhs.data_ptr(), rhs.data_ptr(), out.data_ptr(),
                           sizes, M, K, N, G, equal_rows, stream)
    if err < 0:
        raise RuntimeError(f"gmm {kernel} kernel: cuTensorMapEncodeTiled "
                           f"failed, CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"gmm {kernel} kernel launch failed: CUDA error "
                           f"{err}")
    gmm.launches += 1
    gmm.route_launches[kernel] += 1
    return out


def gmm(lhs: torch.Tensor, rhs: torch.Tensor,
        group_sizes: torch.Tensor) -> torch.Tensor:
    """lhs: [M,K]; rhs: [G,K,N]; group_sizes: [G] int32 -> [M,N].

    On a CUDA tensor this launches the kernel of ``route`` (bfloat16 or
    float32, contiguous, any M, K, N and group sizes, empty groups
    included) on the current stream without reading ``group_sizes`` on
    the host, or raises.
    """
    if lhs.device.type == "cpu":
        return gmm_plain(lhs, rhs, group_sizes)
    if lhs.device.type != "cuda":
        raise ValueError(f"gmm runs on cpu or cuda, not {lhs.device}")
    _check(lhs, rhs, group_sizes)
    return _launch(lhs, rhs, group_sizes, 0,
                   route(lhs.dtype, lhs.shape[1], rhs.shape[2], rhs.shape[0]))


gmm.launches = 0   # kernel launches (CUDA tensors only), gmm_equal's too
gmm.route_launches = dict.fromkeys(ROUTES, 0)   # the same, by route


def gmm_equal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [G,R,K]; w: [G,K,N] -> [G,R,N]: group g's R rows times w[g].

    The grouped product of ``gmm`` with G groups of R rows each, the MoE
    capacity layout; on a CUDA tensor one launch of the same kernel, which
    maps tiles to groups arithmetically.
    """
    G, R, K = x.shape
    lhs = x.reshape(G * R, K)
    if x.device.type == "cpu":
        sizes = torch.full((G,), R, dtype=torch.int32)
        return gmm_plain(lhs, w, sizes).reshape(G, R, w.shape[2])
    if x.device.type != "cuda":
        raise ValueError(f"gmm runs on cpu or cuda, not {x.device}")
    if w.dim() != 3 or w.shape[0] != G:
        raise ValueError(f"want w [G={G},K,N]; got {tuple(w.shape)}")
    _check(lhs, w, None)
    if R == 0:
        return x.new_empty(G, 0, w.shape[2])
    return _launch(lhs, w, None, R, route(x.dtype, K, w.shape[2], G)
                   ).reshape(G, R, w.shape[2])
