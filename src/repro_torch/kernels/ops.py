"""Model-layout wrappers for the port's kernels.

Counterpart of ``repro/kernels/ops.py``: the model keeps activations as
[B,S,H,D]; the kernels take [B,H,S,D].  The transposes are the same as
the reference's, made contiguous because the CUDA kernel reads dense rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q: [B,Sq,Hq,D]; k,v: [B,Skv,Hkv,D] -> [B,Sq,Hq,D] (model layout)."""
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    o = _fa.flash_attention(qt, kt, vt, causal=causal, q_offset=q_offset,
                            block_q=block_q, block_k=block_k)
    return o.transpose(1, 2)
