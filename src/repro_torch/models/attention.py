"""GQA attention, dense path: init, full/prefill forward, decode.

Counterpart of ``repro/models/attention.py``.  Two implementations of the
full-sequence attention share one module, selected by
``cfg.attention_impl``:
  * ``xla``    - plain PyTorch, q-block-chunked softmax(QK^T)V;
  * ``pallas`` - the hand-written CUDA flash-attention kernel through
                 ``kernels/ops.py`` (its plain version on a CPU tensor).
Decode attention is plain PyTorch, as in the reference.  Cross-attention
(the enc-dec decoder's) takes its keys and values from ``kv_x`` at
``kv_positions``; VLM configs rotate with M-RoPE, positions [3, B, S].

Weights are stored with flattened head dims ([d_model, H*Dh]).  Under a
mesh context (``parallel/context.py``) on DTensors, q, k and v are laid
out as the reference's three ``shard`` calls lay them (batch on the data
axes, heads on ``model``) and the attention itself, flash or the chunked
path, runs on each rank's own batch rows and heads (``_attend_sharded``);
decode writes and reads each rank's block of the cache the same way
(``_decode_sharded``), a block of rows too on a sequence-sharded cache,
merged across the blocks by log-sum-exp.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (
    Axes, Params, apply_mrope, apply_rope, dense_init, merge_heads, rmsnorm,
    rmsnorm_init, matmul, split_heads, torch_dtype, use,
)
from repro_torch.parallel.context import layout, shard

ATTN_CHUNK = 2048  # q-block size for the chunked plain path
NEG_INF = -1e30


def attention_init(cfg: ModelConfig, gen: torch.Generator,
                   device: torch.device, *, cross: bool = False) -> Params:
    """Self- or (``cross``) cross-attention weights: the same leaves."""
    del cross
    dt = torch_dtype(cfg.param_dtype)
    p: Params = {
        "wq": dense_init(gen, (cfg.d_model, cfg.q_dim), dt, device),
        "wk": dense_init(gen, (cfg.d_model, cfg.kv_dim), dt, device),
        "wv": dense_init(gen, (cfg.d_model, cfg.kv_dim), dt, device),
        "wo": dense_init(gen, (cfg.q_dim, cfg.d_model), dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.q_dim,), dtype=dt, device=device)
        p["bk"] = torch.zeros((cfg.kv_dim,), dtype=dt, device=device)
        p["bv"] = torch.zeros((cfg.kv_dim,), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(cfg.head_dim, dt, device)
        p["k_norm"] = rmsnorm_init(cfg.head_dim, dt, device)
    return p


def attention_axes(cfg: ModelConfig) -> Axes:
    a: Axes = {
        "wq": ("embed", "heads"),
        "wk": ("embed", "kv"),
        "wv": ("embed", "kv"),
        "wo": ("heads", "embed"),
    }
    if cfg.qkv_bias:
        a["bq"] = ("heads",)
        a["bk"] = ("kv",)
        a["bv"] = ("kv",)
    if cfg.qk_norm:
        a["q_norm"] = (None,)
        a["k_norm"] = (None,)
    return a


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def _rotate(cfg: ModelConfig, t: torch.Tensor,
            positions: torch.Tensor) -> torch.Tensor:
    """RoPE (M-RoPE where ``cfg.mrope_sections``) of [B,S,H,Dh] heads."""
    if cfg.rope_theta <= 0.0:
        return t
    if cfg.mrope_sections:
        return apply_mrope(t, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(t, positions, cfg.rope_theta)


def _project_q(cfg: ModelConfig, p: Params, x: torch.Tensor,
               positions: Optional[torch.Tensor]) -> torch.Tensor:
    """q [B,S,Hq,Dh] with qk-norm + RoPE applied."""
    dt = torch_dtype(cfg.dtype)
    q = matmul(x, use(p["wq"], dt, None, "heads"))
    if cfg.qkv_bias:
        q = q + use(p["bq"], dt, "heads")
    q = split_heads(q, cfg.num_heads, cfg.head_dim, "batch", None)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.rms_eps)
    return q if positions is None else _rotate(cfg, q, positions)


def _project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 positions: Optional[torch.Tensor],
                 kv_x: Optional[torch.Tensor] = None,
                 kv_positions: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns q [B,S,Hq,Dh], k/v [B,Skv,Hkv,Dh] with qk-norm + RoPE applied.

    k and v come from ``kv_x`` (default ``x``), rotated by
    ``kv_positions`` (default ``positions``)."""
    dt = torch_dtype(cfg.dtype)
    kv_x = x if kv_x is None else kv_x
    q = _project_q(cfg, p, x, positions)
    k = matmul(kv_x, use(p["wk"], dt, None, "kv"))
    v = matmul(kv_x, use(p["wv"], dt, None, "kv"))
    if cfg.qkv_bias:
        k = k + use(p["bk"], dt, "kv")
        v = v + use(p["bv"], dt, "kv")
    k, v = (split_heads(t, cfg.num_kv_heads, cfg.head_dim, "batch", None)
            for t in (k, v))
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.rms_eps)
    if positions is not None:
        k = _rotate(cfg, k, positions if kv_positions is None
                    else kv_positions)
    return q, k, v


# ---------------------------------------------------------------------------
# chunked softmax attention (plain path)
# ---------------------------------------------------------------------------

def repeat_kv(cfg: ModelConfig, t: torch.Tensor) -> torch.Tensor:
    """[B,S,Hkv,Dh] -> [B,S,Hq,Dh]."""
    return _repeat_heads(t, cfg.num_heads // cfg.num_kv_heads)


def _repeat_heads(t: torch.Tensor, G: int) -> torch.Tensor:
    """Each head of t [B,S,H,Dh] G times in a row (``repeat_interleave``
    on dim 2, written as expand + reshape, which DTensor also takes)."""
    if G == 1:
        return t
    B, S, H, Dh = t.shape
    return t[:, :, :, None, :].expand(B, S, H, G, Dh).reshape(B, S, H * G, Dh)


def _attend_chunked(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, *, causal: bool,
                    q_offset: int = 0) -> torch.Tensor:
    """softmax(QK^T)V with the q axis processed in ATTN_CHUNK blocks.

    Bounds the materialized score tensor to [B,H,chunk,Skv].
    q: [B,Sq,Hq,Dh]  k,v: [B,Skv,Hkv,Dh]  ->  [B,Sq,Hq,Dh]; the group
    size is Hq / Hkv of these tensors (a rank's heads on a mesh).
    """
    B, Sq, Hq, Dh = q.shape
    Skv = k.shape[1]
    scale = Dh ** -0.5
    G = Hq // k.shape[2]
    kf = _repeat_heads(k, G).float()
    vf = _repeat_heads(v, G).float()
    kpos = torch.arange(Skv, device=q.device)
    if Sq > ATTN_CHUNK and Sq % ATTN_CHUNK:
        raise ValueError(f"Sq={Sq} must be <= or a multiple of {ATTN_CHUNK}")
    out = []
    for c0 in range(0, Sq, ATTN_CHUNK):
        qb = q[:, c0:c0 + ATTN_CHUNK]
        s = torch.einsum("bchd,bshd->bchs", qb.float() * scale, kf)
        if causal:
            qpos = q_offset + c0 + torch.arange(qb.shape[1], device=q.device)
            mask = qpos[:, None] >= kpos[None, :]                 # [C, Skv]
            s = torch.where(mask[None, :, None, :], s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        out.append(torch.einsum("bchs,bshd->bchd", w, vf).to(q.dtype))
    return torch.cat(out, dim=1)


def _attend_local(cfg: ModelConfig, q, k, v, *, causal, q_offset: int = 0):
    if cfg.attention_impl == "pallas":
        return kops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    return _attend_chunked(cfg, q, k, v, causal=causal, q_offset=q_offset)


def _attend(cfg: ModelConfig, q, k, v, *, causal, q_offset: int = 0):
    if isinstance(q, DTensor):
        return _attend_sharded(cfg, q, k, v, causal=causal,
                               q_offset=q_offset)
    return _attend_local(cfg, q, k, v, causal=causal, q_offset=q_offset)


_HEADS = ("batch", None, "heads_dim", None)


def _repeat_to(cfg: ModelConfig, t: DTensor, heads) -> DTensor:
    """``repeat_kv`` of t [B,S,Hkv,Dh] (its heads whole on every rank),
    laid out by ``heads`` (q's placements): each rank repeats its kv heads
    and keeps the block of Hq heads its q holds.  Its grad is a partial
    sum over the ranks of that block (each covers some kv heads)."""
    mesh = t.device_mesh
    dims = [i for i, p in enumerate(heads) if p.is_shard(2)]
    block, n = 0, 1
    for i in dims:
        block, n = block * mesh.size(i) + mesh.get_local_rank(i), \
            n * mesh.size(i)
    G = cfg.num_heads // cfg.num_kv_heads

    def mine(local):
        rep = _repeat_heads(local, G)
        h = rep.shape[2] // n
        return rep[:, :, block * h:(block + 1) * h]

    grad = tuple(Partial() if i in dims else p
                 for i, p in enumerate(t.placements))
    return local_map(mine, out_placements=list(heads),
                     in_placements=(t.placements,),
                     in_grad_placements=(grad,), device_mesh=mesh)(t)


def _attend_sharded(cfg: ModelConfig, q: DTensor, k: DTensor, v: DTensor, *,
                    causal: bool, q_offset: int) -> DTensor:
    """The attention on a mesh: q, k and v on the reference's layout
    (``_HEADS``), then ``_attend_local`` on each rank's block, so flash
    runs on the rank's own heads.  k and v keep their Hkv heads when the
    model axis divides them: each rank then holds a contiguous block of
    q heads and the kv heads those share (head h reads kv head h // G).
    Otherwise they are repeated to Hq heads first, as the reference
    repeats them (qwen3-moe's 4 kv heads on a 16-way axis)."""
    repeat = layout(k, *_HEADS) != layout(q, *_HEADS)
    q = shard(q, *_HEADS)
    if repeat:
        k, v = (_repeat_to(cfg, t, q.placements) for t in (k, v))
    else:
        k, v = shard(k, *_HEADS), shard(v, *_HEADS)
    fn = local_map(functools.partial(_attend_local, cfg, causal=causal,
                                     q_offset=q_offset),
                   out_placements=list(q.placements),
                   in_placements=(q.placements,) * 3,
                   device_mesh=q.device_mesh)
    return fn(q, k, v)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def attention_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    kv_x: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    ) -> torch.Tensor:
    """Full (train/prefill) attention.  x: [B,S,d] -> [B,S,d]; with
    ``kv_x`` [B,Skv,d], cross-attention to it."""
    dt = torch_dtype(cfg.dtype)
    q, k, v = _project_qkv(cfg, p, x, positions, kv_x, kv_positions)
    o = _attend(cfg, q, k, v, causal=causal)
    return matmul(merge_heads(o, "batch", None),
                  use(p["wo"], dt, "heads", None))


def attention_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      positions: torch.Tensor,
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill: returns output AND the (flattened-kv) cache entries."""
    dt = torch_dtype(cfg.dtype)
    q, k, v = _project_qkv(cfg, p, x, positions)
    o = _attend(cfg, q, k, v, causal=True)
    B, S = x.shape[:2]
    out = matmul(merge_heads(o, "batch", None),
                 use(p["wo"], dt, "heads", None))
    cache = {"k": k.reshape(B, S, cfg.kv_dim), "v": v.reshape(B, S, cfg.kv_dim)}
    return out, cache


def attention_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     positions: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, cache_index: torch.Tensor,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode step against a [B, Smax, kv_dim] cache.

    x: [B,1,d]; ``cache_index`` is a per-slot [B] vector.  The new k/v are
    written into ``cache_k``/``cache_v`` IN PLACE (the reference returns
    new arrays; here that would copy the whole cache per layer and step)
    and the same tensors are returned.  A slot whose index is >= Smax is
    not written, as the reference's ``mode="drop"`` scatter drops it.
    Returns (out [B,1,d], cache_k, cache_v).
    """
    dt = torch_dtype(cfg.dtype)
    B = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x, positions)
    k = k.reshape(B, cfg.kv_dim).to(cache_k.dtype)
    v = v.reshape(B, cfg.kv_dim).to(cache_v.dtype)
    if isinstance(q, DTensor):
        o = _decode_sharded(cfg, q, k, v, cache_k, cache_v, cache_index)
    else:
        o = _decode_local(cfg, q, k, v, cache_k, cache_v, cache_index)
    o = o.to(dt).reshape(B, 1, cfg.q_dim)
    return matmul(o, use(p["wo"], dt, "heads", None)), cache_k, cache_v


def _write_rows(k, v, cache_k, cache_v, cache_index, offset=0) -> None:
    """Row ``cache_index[b]`` of slot b of the caches := k[b], v[b], in
    place, for the slots whose index is in range.  The caches may be a
    block of rows starting at row ``offset`` (a rank's block of a
    sequence-sharded cache): a slot whose row lies outside it is not
    written."""
    B, Smax = cache_k.shape[:2]
    bidx = torch.arange(B, device=k.device)
    row = cache_index - offset
    keep = ((row >= 0) & (row < Smax))[:, None]
    pos = row.clamp(0, Smax - 1)
    # out-of-range slots rewrite a row with its own value: no sync
    cache_k[bidx, pos] = torch.where(keep, k, cache_k[bidx, pos])
    cache_v[bidx, pos] = torch.where(keep, v, cache_v[bidx, pos])


def _decode_scores(cfg: ModelConfig, q, cache_k, cache_v, cache_index,
                   offset: int = 0):
    """q [B,1,Hq,Dh] against the caches' rows (rows ``offset`` on of the
    whole cache) by the heads these tensors hold (a rank's heads on a
    mesh): the f32 scores [B,Hkv,G,Smax], the values [B,Smax,Hkv,Dh] and
    which rows each slot sees (up to its index) [B,1,1,Smax]."""
    B, Smax = cache_k.shape[:2]
    Dh = cfg.head_dim
    Hkv = cache_k.shape[-1] // Dh
    G = q.shape[2] // Hkv
    kk = cache_k.reshape(B, Smax, Hkv, Dh)
    vv = cache_v.reshape(B, Smax, Hkv, Dh)
    # grouped einsum instead of the reference's repeat_kv: same sums, no
    # [B,Smax,Hq,Dh] copy of the cache
    qg = q.reshape(B, Hkv, G, Dh)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float() * Dh ** -0.5, kk.float())
    # mask positions beyond each slot's index (index = this token's slot)
    rows = offset + torch.arange(Smax, device=q.device)
    valid = (rows[None, :] <= cache_index[:, None])[:, None, None, :]
    return s, vv, valid


def _decode_attend(cfg: ModelConfig, q, cache_k, cache_v, cache_index):
    """q [B,1,Hq,Dh] against the caches' rows up to each slot's index, by
    the heads these tensors hold (a rank's heads on a mesh) -> f32
    [B,Hkv,G,Dh]."""
    s, vv, valid = _decode_scores(cfg, q, cache_k, cache_v, cache_index)
    w = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    return torch.einsum("bhgs,bshd->bhgd", w, vv.float())


def _decode_attend_seq(cfg: ModelConfig, q, cache_k, cache_v, cache_index,
                       *, offset: int, groups) -> torch.Tensor:
    """``_decode_attend`` on a rank's block of rows of a sequence-sharded
    cache (rows ``offset`` on), merged with the other blocks' over
    ``groups`` (the mesh dims that split the rows) by log-sum-exp: each
    block's max, sum of exponentials and weighted values in f32; one
    all-reduce of the max, then one of the rescaled sums and values.  A
    block with no visible row adds zeros."""
    s, vv, valid = _decode_scores(cfg, q, cache_k, cache_v, cache_index,
                                  offset)
    m = torch.where(valid, s, NEG_INF).amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    acc = torch.einsum("bhgs,bshd->bhgd", p, vv.float())
    top = m
    for g in groups:
        top = funcol.wait_tensor(funcol.all_reduce(top, "max", g))
    scale = torch.exp(m - top)
    both = torch.cat([acc * scale, p.sum(dim=-1, keepdim=True) * scale], -1)
    for g in groups:
        both = funcol.wait_tensor(funcol.all_reduce(both, "sum", g))
    return both[..., :-1] / both[..., -1:]


def _decode_local(cfg: ModelConfig, q, k, v, cache_k, cache_v, cache_index):
    _write_rows(k, v, cache_k, cache_v, cache_index)
    return _decode_attend(cfg, q, cache_k, cache_v, cache_index)


def _decode_sharded(cfg: ModelConfig, q: DTensor, k: DTensor, v: DTensor,
                    cache_k: DTensor, cache_v: DTensor,
                    cache_index: DTensor) -> DTensor:
    """Decode on a mesh.  The new rows are laid out as the cache's blocks
    and each rank writes its own rows into its block, in place.  When a
    block holds whole kv heads the attention runs on it, with q on the
    same heads; otherwise (a kv head split across ranks) it reads a copy
    of the cache with those heads gathered.  On a sequence-sharded cache
    (``shard_seq``) a rank holds a block of rows: only the rank whose
    block holds a slot's index writes it, and each attends over its rows
    and merges with the others (``_decode_attend_seq``).  Returns
    [B,Hkv,G,Dh] f32."""
    mesh = q.device_mesh
    cp = tuple(cache_k.placements)
    seq = [i for i, p in enumerate(cp) if p.is_shard(1)]
    # this rank's block of rows: its coordinates on the seq dims, major
    # first, as DTensor splits a dim over several mesh dims
    block = 0
    for i in seq:
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    offset = block * cache_k.to_local().shape[1]

    def moved(placements, dims):
        """``placements`` of the cache, on the dims ``dims`` maps to."""
        return tuple(Shard(dims[p.dim]) if p.is_shard() and p.dim in dims
                     else Replicate() for p in placements)

    index = cache_index.redistribute(mesh, moved(cp, {0: 0}))
    rows = moved(cp, {0: 0, 2: 1})
    _write_rows(k.redistribute(mesh, rows).to_local(),
                v.redistribute(mesh, rows).to_local(), cache_k.to_local(),
                cache_v.to_local(), index.to_local(), offset)
    if cache_k.to_local().shape[-1] % cfg.head_dim:
        cp = tuple(Replicate() if p.is_shard(2) else p for p in cp)
        cache_k = cache_k.redistribute(mesh, cp)
        cache_v = cache_v.redistribute(mesh, cp)
    heads = moved(cp, {0: 0, 2: 2})
    fn = functools.partial(_decode_attend, cfg)
    if seq:
        fn = functools.partial(_decode_attend_seq, cfg, offset=offset,
                               groups=[(mesh, i) for i in seq])
    return local_map(fn, out_placements=list(moved(cp, {0: 0, 2: 1})),
                     in_placements=(heads, cp, cp, index.placements),
                     device_mesh=mesh)(q.redistribute(mesh, heads), cache_k,
                                       cache_v, index)
