"""Mamba-1 selective scan: CUDA kernel + plain.

Counterpart of ``repro/kernels/mamba_scan.py``.  ``mamba_scan`` launches
the hand-written kernel ``csrc/mamba_scan.cu`` for a CUDA tensor and runs
``mamba_scan_plain`` for a CPU tensor; there is no other route and no
fallback.  Per batch row and channel d, with the state h [N] from zero:

    h_t = exp(dt_t[d] * A[d]) * h_{t-1} + (dt_t[d] * x_t[d]) * b_t
    y_t[d] = h_t . c_t

With ``return_state`` both also return the state after the last token,
hT [B, di, N], as the reference's token loop ``_scan_chunk`` does
(``repro/models/mamba.py:84``), so serving's prefill takes the kernel too.

The plain version steps the reference kernel's math token by token in
PyTorch ops.  Unlike the reference (which asserts ``S % chunk == 0`` and
``di % block_d == 0``), any S and di work.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._grad import check_no_grad

STATE_DIMS = (8, 16)
STATES_PER_THREAD = 8      # the kernel's SPT (csrc/mamba_scan.cu)


def mamba_scan_plain(A: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                     c: torch.Tensor, x: torch.Tensor, *,
                     return_state: bool = False,
                     dtype: torch.dtype = torch.float32):
    """A: [di,N]; dt,x: [B,S,di]; b,c: [B,S,N] -> y [B,S,di], in PyTorch
    ops; with ``return_state`` (y, hT [B,di,N]).  Computes in ``dtype``:
    float32 as the kernel does, or float64 to hold both against the
    function with f32's rounding taken out."""
    B, S, di = x.shape
    A, dt, b, c, x = (t.to(dtype) for t in (A, dt, b, c, x))
    h = torch.zeros(B, di, A.shape[1], dtype=dtype, device=x.device)
    y = torch.empty(B, S, di, dtype=dtype, device=x.device)
    for t in range(S):
        dA = torch.exp(dt[:, t, :, None] * A)            # [B,di,N]
        dBx = (dt[:, t] * x[:, t])[..., None] * b[:, t, None, :]
        h = dA * h + dBx
        y[:, t] = (h * c[:, t, None, :]).sum(-1)
    return (y, h) if return_state else y


def _check(A: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor, x: torch.Tensor) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"want dt = x [B,S,di]; got {tuple(dt.shape)}, "
                         f"{tuple(x.shape)}")
    B, S, di = x.shape
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"want A [di={di},N]; got {tuple(A.shape)}")
    N = A.shape[1]
    if tuple(b.shape) != (B, S, N) or tuple(c.shape) != (B, S, N):
        raise ValueError(f"want b = c [B,S,N] = {(B, S, N)}; got "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    if N not in STATE_DIMS:
        raise ValueError(f"d_state {N} not supported; kernel has {STATE_DIMS}")
    if S < 1 or di < 1 or not 1 <= B <= 65535:
        raise ValueError(f"want S, di >= 1 and 1 <= B <= 65535; got "
                         f"{(B, S, di)}")
    for name, t in (("A", A), ("dt", dt), ("b", b), ("c", c), ("x", x)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _entry():
    fn = _build.load("mamba_scan").mamba_scan_f32
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(A, dt, b, c, x, y, hT) -> None:
    """One launch of the kernel on the current stream; hT may be None.
    Raises on a launch error."""
    B, S, di = x.shape
    # b and c go in 16-byte copies (dt and x fall back to 4-byte ones)
    b, c = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (b, c))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(A.data_ptr(), dt.data_ptr(), b.data_ptr(),
                       c.data_ptr(), x.data_ptr(), y.data_ptr(),
                       None if hT is None else hT.data_ptr(), B, S, di,
                       A.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan kernel launch failed: CUDA error "
                           f"{err}")


def mamba_scan(A: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, x: torch.Tensor, *,
               return_state: bool = False):
    """A: [di,N]; dt,x: [B,S,di]; b,c: [B,S,N], all f32 -> y [B,S,di] f32,
    or with ``return_state`` (y, hT [B,di,N] f32), the state after the
    last token.

    On a CUDA tensor this launches the CUDA kernel (N in {8, 16}, any S
    and di; contiguous inputs) once on the current stream, or raises.
    """
    if x.device.type == "cpu":
        return mamba_scan_plain(A, dt, b, c, x, return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan runs on cpu or cuda, not {x.device}")
    _check(A, dt, b, c, x)
    check_no_grad("mamba_scan", "scan_impl", A, dt, b, c, x)
    B, S, di = x.shape
    N = A.shape[1]
    y = torch.empty_like(x)
    hT = (torch.empty(B, di, N, dtype=torch.float32, device=x.device)
          if return_state else None)
    _launch(A, dt, b, c, x, y, hT)
    mamba_scan.launches += 1
    return (y, hT) if return_state else y


mamba_scan.launches = 0   # kernel launches (CUDA tensors only)
