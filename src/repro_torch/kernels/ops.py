"""Model-layout wrappers for the port's kernels.

Counterpart of ``repro/kernels/ops.py``: the model keeps activations as
[B,S,H,D]; the kernels take [B,H,S,D].  The transposes are the same as
the reference's.  The flash and WKV6 kernels read and write through
strides, so their inputs go to them as transposed views and their outputs
come back in the model's layout, with no copies.  The selective scan
takes the model's layout as it is.  The grouped matmul takes rows sorted
by group (``gmm_sorted``, the reference's wrapper of that name) or the MoE
capacity buffer [E, C+1, d] (``gmm_equal``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gmm as _gmm
from repro_torch.kernels import mamba_scan as _mb
from repro_torch.kernels import rwkv6_scan as _rw


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """q: [B,Sq,Hq,D]; k,v: [B,Skv,Hkv,D] -> [B,Sq,Hq,D] (model layout).

    On the card o comes back in q's memory layout, so for a contiguous q
    it is contiguous and the caller's reshape to [B,Sq,Hq*D] is free."""
    tr = lambda t: t.transpose(1, 2)
    return tr(_fa.flash_attention(tr(q), tr(k), tr(v), causal=causal,
                                  q_offset=q_offset, block_q=block_q,
                                  block_k=block_k))


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r,k,v,w: [B,S,H,D]; u: [H,D] -> [B,S,H,D] (model layout)."""
    tr = lambda t: t.transpose(1, 2)
    return _rw.rwkv6_scan(tr(r), tr(k), tr(v), tr(w), u).transpose(1, 2)


def mamba_scan(A: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, x: torch.Tensor, *,
               return_state: bool = False):
    """A: [di,N]; dt,x: [B,S,di]; b,c: [B,S,N] -> y [B,S,di] float32, or
    with ``return_state`` (y, hT [B,di,N] float32)."""
    return _mb.mamba_scan(*(t.contiguous() for t in (A, dt, b, c, x)),
                          return_state=return_state)


def gmm_sorted(lhs: torch.Tensor, rhs: torch.Tensor,
               group_sizes: torch.Tensor) -> torch.Tensor:
    """lhs: [M,K] rows sorted by group; rhs: [G,K,N]; group_sizes: [G]
    (int32, on lhs's device) -> [M,N]; rows past the groups are zero.

    Any sizes, empty groups included; unlike the reference, no padded copy
    of lhs and no host-side look at the sizes.
    """
    return _gmm.gmm(lhs.contiguous(), rhs.contiguous(), group_sizes)


def gmm_equal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [G,R,K]; w: [G,K,N] -> [G,R,N] (``einsum("grk,gkn->grn")``)."""
    return _gmm.gmm_equal(x.contiguous(), w.contiguous())
