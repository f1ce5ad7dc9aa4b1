"""Chunked WKV6 scan (RWKV6 "Finch" time mixing): CUDA kernel + plain.

Counterpart of ``repro/kernels/rwkv6_scan.py``.  ``rwkv6_scan`` launches
the hand-written kernel ``csrc/rwkv6_scan.cu`` for a CUDA tensor and runs
``rwkv6_scan_plain`` for a CPU tensor; there is no other route and no
fallback.  The plain version repeats the reference kernel's chunked
log-space math in PyTorch ops.  For a chunk of C tokens with per-token
per-channel decay w_t in (0, 1]:

    L_t  = sum_{j<=t} log w_j                   (chunk-local)
    y_t  = (r_t * e^{L_{t-1}}) S_0              (inter-chunk)
         + sum_{s<t} [r_t . (k_s * e^{L_{t-1}-L_s})] v_s
         + (r_t . (u * k_t)) v_t                (bonus)
    S'   = diag(e^{L_C}) S_0 + sum_s (k_s * e^{L_C-L_s})^T v_s

Every exponent is <= 0.  Unlike the reference (which asserts
``S % chunk == 0``), any S works: the last chunk is cut short.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._grad import check_no_grad

CHUNK = 64
HEAD_DIMS = (32, 64)


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r,k,v,w: [B,H,S,D]; u: [H,D] -> y [B,H,S,D] float32, in PyTorch ops."""
    B, H, S, D = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    uu = u.float()[None, :, None, :]                   # [1,H,1,D]
    state = torch.zeros(B, H, D, D, dtype=torch.float32, device=r.device)
    out = torch.empty(B, H, S, D, dtype=torch.float32, device=r.device)
    for c0 in range(0, S, CHUNK):
        rc, kc, vc, wc = (t[:, :, c0:c0 + CHUNK] for t in (r, k, v, w))
        C = rc.shape[2]
        logw = torch.log(torch.clamp(wc, min=1e-37))
        L = torch.cumsum(logw, dim=2)                  # [B,H,C,D]
        L_prev = L - logw
        y = (rc * torch.exp(L_prev)) @ state           # inter-chunk
        expo = L_prev[:, :, :, None, :] - L[:, :, None, :, :]  # [B,H,C,C,D]
        tri = torch.ones(C, C, dtype=torch.bool, device=r.device).tril(-1)
        gated = torch.where(tri[:, :, None], torch.exp(expo), 0.0)
        A = torch.einsum("bhtd,bhsd,bhtsd->bhts", rc, kc, gated)
        A = A + torch.diag_embed((rc * uu * kc).sum(-1))
        out[:, :, c0:c0 + C] = y + A @ vc
        L_total = L[:, :, -1:]                         # [B,H,1,D]
        k_dec = kc * torch.exp(L_total - L)
        state = (torch.exp(L_total[:, :, 0])[..., None] * state
                 + k_dec.transpose(-1, -2) @ vc)
    return out


def _check(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           w: torch.Tensor, u: torch.Tensor) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"want r = k = v = w [B,H,S,D]; got {tuple(r.shape)},"
                         f" {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(w.shape)}")
    B, H, S, D = r.shape
    if tuple(u.shape) != (H, D):
        raise ValueError(f"want u [H,D] = {(H, D)}; got {tuple(u.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported; kernel has {HEAD_DIMS}")
    if S < 1 or B * H < 1:
        raise ValueError("empty input")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if t.device != r.device:
            raise ValueError(f"{name} on {t.device}, r on {r.device}")
    if r.stride(-1) != 1:
        raise ValueError(f"r's last dim must be dense; strides {r.stride()}")
    if any(t.stride() != r.stride() for t in (k, v, w)):
        raise ValueError(f"r, k, v, w must share strides; got {r.stride()}, "
                         f"{k.stride()}, {v.stride()}, {w.stride()}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")


def _entry():
    fn = _build.load("rwkv6_scan").rwkv6_scan_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_longlong)] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r,k,v,w: [B,H,S,D] f32; u: [H,D] f32 -> y [B,H,S,D] f32.

    On a CUDA tensor this launches the CUDA kernel (D in {32, 64}, any S,
    chunks of 64) on the current stream, or raises.  The kernel reads
    r, k, v, w through their strides, which they share (the last is 1),
    and y is laid out as ``torch.empty_like(r)`` lays it: a transposed
    view of [B,S,H,D] tensors goes in and comes out without a copy.
    """
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on cpu or cuda, not {r.device}")
    _check(r, k, v, w, u)
    check_no_grad("rwkv6_scan", "scan_impl", r, k, v, w, u)
    B, H, S, D = r.shape
    y = torch.empty_like(r)
    strides = lambda t: (ctypes.c_longlong * 3)(*t.stride()[:3])
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                       u.data_ptr(), y.data_ptr(), B * H, H, S, D, strides(r),
                       strides(y), stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error "
                           f"{err}")
    rwkv6_scan.launches += 1
    return y


rwkv6_scan.launches = 0   # kernel launches (CUDA tensors only)
