"""Flash attention forward (GQA, causal, online softmax): CUDA kernels + plain.

Counterpart of ``repro/kernels/flash_attention.py``.  ``flash_attention``
launches a hand-written kernel of ``csrc/flash_attention.cu`` for a CUDA
tensor and runs ``flash_attention_plain`` for a CPU tensor; there is no
other route and no fallback.  The plain version repeats the reference
kernel's tiling in PyTorch: q blocks, an inner loop over kv blocks, f32
running max / sum / accumulator, the -1e30 mask.

Three kernel routes, chosen by ``route`` from the dtype and the head dim
alone (never by a fallback, an option or the environment):

- ``"wgmma"``: bf16 at D in {64, 128}.  A persistent, warp-specialised
  Hopper kernel: TMA loads of K and V through an mbarrier ring, ``wgmma``
  products with P fed from registers, one block a SM.
- ``"mma_sync"``: bf16 at D in {16, 32} (the tiny configs' head dims).
- ``"f32"``: float32 at any of the four head dims, by IEEE FMA.

Every kernel reads q, k, v and writes o through (batch, head, row)
strides with a dense last dimension, so ``ops.flash_attention`` hands
over the model's [B,S,H,D] tensors as transposed views and gets o back
in that layout, with no copies.  ``flash_attention.launches`` counts
every launch, ``flash_attention.route_launches`` the launches of each
route.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._grad import check_no_grad

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)
ROUTES = ("wgmma", "mma_sync", "f32")
_ENTRIES = {"wgmma": "flash_attention_bf16_wgmma",
            "mma_sync": "flash_attention_bf16",
            "f32": "flash_attention_f32"}


def route(dtype: torch.dtype, D: int) -> str:
    """The kernel that takes attention of this dtype and head dim."""
    if dtype == torch.bfloat16:
        return "wgmma" if D in WGMMA_HEAD_DIMS else "mma_sync"
    return "f32"


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
    """Raise on anything the CUDA kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,Hq,Sq,D], k = v [B,Hkv,Skv,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[1] != 0:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do "
                         "not agree on batch, head_dim or GQA grouping")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported; kernels have "
                         f"{HEAD_DIMS}")
    if Sq < 1 or k.shape[2] < 1 or B < 1:
        raise ValueError("empty input")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}; the kernels "
                        "take all bfloat16 or all float32")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be dense; strides "
                             f"{t.stride()}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if max(*q.shape, *k.shape, q_offset) >= 2 ** 31:
        raise ValueError("sizes must fit the kernels' int32")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a dense copy of it when its base or a (batch, head, row)
    stride is not a positive multiple of 16 bytes, which TMA and the
    kernels' 16-byte row loads want."""
    step = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(s > 0 and s % step == 0
                                      for s in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _entry(kernel: str):
    fn = getattr(_build.load("flash_attention"), _ENTRIES[kernel])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + \
        [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            q_offset: int, kernel: str) -> torch.Tensor:
    """One launch of the ``kernel`` route on checked inputs; raises if it
    fails, or if autograd would need a backward through it.  o is laid out
    as ``torch.empty_like(q)`` lays it: a transposed view of a [B,S,H,D]
    tensor gets its output in [B,S,H,D] memory."""
    check_no_grad("flash_attention", "attention_impl", q, k, v)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(kernel)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             o.data_ptr(), B, Hq, Hkv, Sq, Skv, D,
                             int(causal), int(q_offset), strides, stream)
    if err < 0:
        raise RuntimeError(f"flash_attention {kernel} kernel: "
                           f"cuTensorMapEncodeTiled failed, CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"flash_attention {kernel} kernel launch failed: "
                           f"CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.route_launches[kernel] += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q: [B,Hq,Sq,D]; k,v: [B,Hkv,Skv,D] -> [B,Hq,Sq,D].

    On a CUDA tensor this launches the kernel of ``route`` (bf16 or f32,
    D in ``HEAD_DIMS``, any Sq and Skv, any strides with a dense last dim)
    on the current stream, or raises.  The kernels' tiles are fixed in the
    source, so ``block_q``/``block_k`` only set the plain version's tiles,
    which a CPU tensor runs; neither changes the function computed.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, block_q=block_q,
                                     block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    _check(q, k, v, q_offset)
    return _launch(q, k, v, causal, q_offset, route(q.dtype, q.shape[3]))


flash_attention.launches = 0   # kernel launches (CUDA tensors only)
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)  # the same, by route
