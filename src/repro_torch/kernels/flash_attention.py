"""Flash attention forward (GQA, causal, online softmax): CUDA kernel + plain.

Counterpart of ``repro/kernels/flash_attention.py``.  ``flash_attention``
launches the hand-written kernel ``csrc/flash_attention.cu`` for a CUDA
tensor and runs ``flash_attention_plain`` for a CPU tensor; there is no
other route and no fallback.  The plain version repeats the reference
kernel's tiling in PyTorch: q blocks, an inner loop over kv blocks, f32
running max / sum / accumulator, the -1e30 mask.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
_DTYPES = {torch.bfloat16: "flash_attention_bf16",
           torch.float32: "flash_attention_f32"}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_offset: int = 0,
                          block_q: int = 128, block_k: int = 128,
                          ) -> torch.Tensor:
    """q: [B,Hq,Sq,D]; k,v: [B,Hkv,Skv,D] -> [B,Hq,Sq,D], in PyTorch ops.

    Visits every kv block, as the reference kernel does; ragged last
    blocks are cut short, so any Sq and Skv work.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    bq, bk = min(block_q, Sq), min(block_k, Skv)
    dev = q.device
    qf = (q.float() * D ** -0.5).reshape(B, Hkv, G, Sq, D)
    kf = k.float()[:, :, None]                         # [B,Hkv,1,Skv,D]
    vf = v.float()[:, :, None]
    out = torch.empty(B, Hkv, G, Sq, D, dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, bq):
        qb = qf[..., q0:q0 + bq, :]
        n = qb.shape[-2]
        qpos = q_offset + q0 + torch.arange(n, device=dev)
        m = torch.full(qb.shape[:-1] + (1,), NEG_INF, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for k0 in range(0, Skv, bk):
            kb, vb = kf[..., k0:k0 + bk, :], vf[..., k0:k0 + bk, :]
            s = qb @ kb.transpose(-1, -2)              # [B,Hkv,G,n,bk]
            if causal:
                kpos = k0 + torch.arange(kb.shape[-2], device=dev)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ vb
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)              # fully masked -> zeros
        out[..., q0:q0 + n, :] = acc / l
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: int) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,Hq,Sq,D], k = v [B,Hkv,Skv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[1] != 0:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do "
                         "not agree on batch, head_dim or GQA grouping")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported; kernel has {HEAD_DIMS}")
    if Sq < 1 or k.shape[2] < 1:
        raise ValueError("empty sequence")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}; the kernel "
                        "takes all bfloat16 or all float32")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if max(q.numel(), k.numel()) >= 2 ** 31:
        raise ValueError("tensor too large for the kernel's int sizes")


def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("flash_attention"), _DTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q: [B,Hq,Sq,D]; k,v: [B,Hkv,Skv,D] -> [B,Hq,Sq,D].

    On a CUDA tensor this launches the CUDA kernel (bf16 or f32, D in
    {64, 128}, any Sq and Skv) on the current stream, or raises.  Its
    tiles are fixed in the source (64 q rows x 64 kv rows for bf16), so
    ``block_q``/``block_k`` only set the plain version's tiles, which a CPU
    tensor runs; neither changes the function computed.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, block_q=block_q,
                                     block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    _check(q, k, v, q_offset)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              o.data_ptr(), B, Hq, Hkv, Sq, Skv, D,
                              int(causal), int(q_offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0   # kernel launches (CUDA tensors only)
