"""Model-layout wrappers for the port's kernels.

Counterpart of ``repro/kernels/ops.py``: the model keeps activations as
[B,S,H,D]; the kernels take [B,H,S,D].  The transposes are the same as
the reference's.  The flash and WKV6 kernels read and write through
strides, so their inputs go to them as transposed views and their outputs
come back in the model's layout, with no copies.  The selective scan
takes the model's layout as it is.  The grouped matmul takes rows sorted
by group (``gmm_sorted``, the reference's wrapper of that name), a table
of tile -> group (``gmm_padded``, the reference's Pallas interface) or the
MoE capacity buffer [E, C+1, d] (``gmm_equal``).  The MoE's dispatch into
that buffer and combine out of it take each token's k experts and slots
as [T, k] (``moe_dispatch``, ``moe_combine``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gmm as _gmm
from repro_torch.kernels import mamba_scan as _mb
from repro_torch.kernels import moe_permute as _mp
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


def gmm_padded(lhs: torch.Tensor, rhs: torch.Tensor,
               tile_group_ids: torch.Tensor, block_m: int = 128
               ) -> torch.Tensor:
    """lhs: [M,K]; rhs: [G,K,N]; tile_group_ids: [M / block_m] -> [M,N]:
    the rows of tile t, ``lhs[t*block_m:(t+1)*block_m]``, times
    ``rhs[tile_group_ids[t]]`` (``block_m`` capped at M, as the reference
    caps it).

    The reference's tile-table interface, over the port's ``gmm``: the
    table (host-side routing metadata there too) becomes group sizes of
    whole tiles; tiles whose ids are not sorted are permuted into group
    order for the launch and back after it.
    """
    M, K = lhs.shape
    G, _, N = rhs.shape
    bm = min(block_m, M)
    ids = [int(g) for g in tile_group_ids.tolist()]
    if bm <= 0 or M % bm or len(ids) != M // bm:
        raise ValueError(f"want M a multiple of block_m={bm} and one group "
                         f"id a tile; got M={M}, {len(ids)} ids")
    if any(not 0 <= g < G for g in ids):
        raise ValueError(f"tile group ids must lie in [0, {G}): {ids}")
    sizes = torch.tensor([ids.count(g) * bm for g in range(G)],
                         dtype=torch.int32, device=lhs.device)
    if ids == sorted(ids):
        return _gmm.gmm(lhs.contiguous(), rhs.contiguous(), sizes)
    order = torch.tensor(sorted(range(len(ids)), key=ids.__getitem__),
                         device=lhs.device)
    tiles = lhs.reshape(-1, bm, K)[order].reshape(M, K)
    y = _gmm.gmm(tiles, rhs.contiguous(), sizes)
    out = torch.empty_like(y)
    out.view(-1, bm, N)[order] = y.view(-1, bm, N)
    return out


def gmm_equal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [G,R,K]; w: [G,K,N] -> [G,R,N] (``einsum("grk,gkn->grn")``)."""
    return _gmm.gmm_equal(x.contiguous(), w.contiguous())


def moe_dispatch(x: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor,
                 num_experts: int, capacity: int) -> torch.Tensor:
    """x: [T,d]; ids, pos: [T,k] int64 (``pos == capacity``: dropped) ->
    [E, C+1, d]: each kept row in its slot, zeros in every other row."""
    return _mp.moe_dispatch(x.contiguous(), ids.contiguous(),
                            pos.contiguous(), num_experts, capacity)


def moe_combine(ye: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor,
                gate_w: torch.Tensor) -> torch.Tensor:
    """ye: [E, C+1, d]; ids, pos, gate_w: [T,k] -> [T,d]: each token's
    kept rows weighted by their gates and summed (a dropped one adds 0)."""
    return _mp.moe_combine(ye.contiguous(), ids.contiguous(),
                           pos.contiguous(), gate_w.contiguous())
