"""Naive PyTorch oracles for the port's kernels (the correctness ground truth).

Counterpart of ``repro/kernels/ref.py``: full softmax attention with no
tiling, the strictly sequential WKV6 and selective-scan recurrences, and
a grouped matmul that picks each row's weight matrix, so kernel tests
compare the tiled and chunked forms against plain semantics.
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


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Sequential WKV6.  r,k,v,w: [B,H,S,D]; u: [H,D] -> [B,H,S,D] (f32)."""
    B, H, S, D = r.shape
    r, k, v, w = (t.float() for t in (r, k, v, w))
    uu = u.float()[..., None]                          # [H,D,1]
    state = torch.zeros(B, H, D, D, dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]  # [B,H,Dk,Dv]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t], state + uu * kv))
        state = w[:, :, t, :, None] * state + kv
    return torch.stack(ys, dim=2)


def mamba_ref(A: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor, x: torch.Tensor, *,
              return_state: bool = False):
    """Sequential selective scan.

    A: [di,N]; dt,x: [B,S,di]; b,c: [B,S,N] -> y [B,S,di] (float32), or
    with ``return_state`` (y, the final state [B,di,N]).
    """
    B, S, di = x.shape
    A, dt, b, c, x = (t.float() for t in (A, dt, b, c, x))
    h = torch.zeros(B, di, A.shape[1], dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t, :, None] * A)
        dBx = (dt[:, t] * x[:, t])[..., None] * b[:, t, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    y = torch.stack(ys, dim=1)
    return (y, h) if return_state else y


def gmm_ref(lhs: torch.Tensor, rhs: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """Grouped matmul.  lhs: [M,K] rows sorted by group; rhs: [G,K,N].

    Row m belongs to group g iff offsets[g] <= m < offsets[g+1]; rows past
    the last group take the last group's matrix, as the reference clips.
    """
    M = lhs.shape[0]
    G = rhs.shape[0]
    sizes = group_sizes.to(lhs.device)
    ends = torch.cumsum(sizes, 0)
    row_group = (torch.arange(M, device=lhs.device)[:, None]
                 >= ends[None, :]).sum(1)
    row_group = torch.clamp(row_group, 0, G - 1)
    picked = rhs[row_group]                       # [M, K, N]
    return torch.einsum("mk,mkn->mn", lhs.float(),
                        picked.float()).to(lhs.dtype)
