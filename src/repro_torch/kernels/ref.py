"""Naive PyTorch oracles for the port's kernels (the correctness ground truth).

Counterpart of ``repro/kernels/ref.py``: full softmax attention, with no
tiling, so kernel tests compare the tiled forms against plain semantics.
"""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: [B,Hq,Sq,D]; k,v: [B,Hkv,Skv,D] -> [B,Hq,Sq,D] (float32 math)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float() * (D ** -0.5)
    qf = qf.reshape(B, Hkv, G, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        mask = qpos[:, None] >= torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(~mask, float("-inf"))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", w, v.float())
    return o.reshape(B, Hq, Sq, D).to(q.dtype)
