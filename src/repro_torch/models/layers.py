"""Shared building blocks: norms, RoPE/M-RoPE, SwiGLU, embeddings.

Counterpart of ``repro/models/layers.py``.  Parameters are plain nested
dicts of tensors with the reference's names and layouts (weights stored
[in, out], so a projection is ``x @ w``).  Inits take an explicit
``torch.Generator`` and device; they match the reference in distribution
only (``jax.random`` bits cannot be reproduced), which is why the tests
bring the reference's own parameters over with ``repro_torch.bridge``.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.distributed.tensor.placement_types import Placement

from repro_torch.config.base import ModelConfig
from repro_torch.parallel.context import current_ctx, layout, shard

Params = Dict[str, Any]
# logical axis names of each parameter dim (``parallel/sharding.py``)
Axes = Dict[str, Any]


def use(w: torch.Tensor, dt: torch.dtype, *logical: Optional[str]
        ) -> torch.Tensor:
    """Weight ``w`` cast to ``dt`` and, under a mesh context, laid out by
    ``logical``: its parameter axes with ``"embed"`` left out.  So an
    ``fsdp`` weight is all-gathered over the data axis just before its
    product (ZeRO-3; autograd reduce-scatters its grad back), and the
    product keeps the activations batch-sharded instead of the layout
    DTensor's propagation would choose (partial sums over the whole
    global batch for the unembedding).  Unlike ``shard`` the grad is left
    to DTensor, which reduce-scatters a partial-sum grad straight into the
    param's own layout.  Without a context, ``w.to(dt)``."""
    w = w.to(dt)
    if current_ctx() is None or not isinstance(w, DTensor):
        return w
    placements = layout(w, *logical)
    if w.placements == placements:
        return w
    return w.redistribute(w.device_mesh, placements)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N].  On DTensors laid out for tensor parallelism
    the product runs on each rank's blocks with the layout fixed by the
    operands', mesh dim by mesh dim: x's K and w's K sharded alike give a
    partial sum (row parallel); w's N sharded, x's K not, give N sharded
    (column parallel); x's rows sharded and w replicated keep the rows
    sharded.  The grads are laid out to match (x's partial under column
    parallelism, w's partial over the row shards).  DTensor's own
    propagation would search every layout of every operand for each new
    product, which on a 3-D mesh takes seconds a product; any other
    layout is left to it.  A row-parallel product in bf16 or f16 comes
    back reduced (summed in f32), not partial."""
    if not isinstance(x, DTensor):
        return x @ w
    last = x.ndim - 1
    out, gx, gw = [], [], []
    for px, pw in zip(x.placements, w.placements):
        if px.is_shard(last) and pw.is_shard(0):
            out.append(Partial()); gx.append(px); gw.append(pw)
        elif pw.is_shard(1) and isinstance(px, Replicate):
            out.append(Shard(last)); gx.append(Partial()); gw.append(pw)
        elif px.is_shard() and px.dim < last and isinstance(pw, Replicate):
            out.append(px); gx.append(px); gw.append(Partial())
        elif isinstance(px, Replicate) and isinstance(pw, Replicate):
            out.append(px); gx.append(px); gw.append(pw)
        else:
            return x @ w
    partial = any(isinstance(p, Partial) for p in out)
    if not (partial and x.dtype in (torch.bfloat16, torch.float16)):
        return local_map(torch.matmul, out_placements=out,
                         in_placements=(x.placements, w.placements),
                         in_grad_placements=(tuple(gx), tuple(gw)),
                         device_mesh=x.device_mesh)(x, w)
    # a row-parallel product in low precision: each rank's partial sum is
    # kept in f32 (exact products of the bf16 operands, f32 sums), the
    # partials summed in f32 and the result rounded once, as one device's
    # product rounds its f32 accumulator once.  Partials rounded to bf16
    # first flip ~40% of the output's last bits, and two layers of that put
    # the logits ~1e-2 (relative RMS) from the one-device run.  The f32
    # product here runs off the tensor cores; a bf16 GEMM with an f32
    # output would not.
    y = local_map(lambda a, b: torch.matmul(a.float(), b.float()),
                  out_placements=out,
                  in_placements=(x.placements, w.placements),
                  in_grad_placements=(tuple(gx), tuple(gw)),
                  device_mesh=x.device_mesh)(x, w)
    whole = tuple(Replicate() if isinstance(p, Partial) else p for p in out)
    return y.redistribute(x.device_mesh, whole).to(x.dtype)


def per_rank(fn, args: Sequence[torch.Tensor], out_placements, ref: int = 0):
    """``fn(*args)`` on each rank's blocks of the DTensors ``args`` (plain
    tensors: ``fn(*args)``), its outputs laid out by
    ``out_placements(args[ref].placements)`` (one placements tuple an
    output).  The grad of an input that is whole
    on a mesh dim where ``args[ref]`` (the activation the work is split
    by) is split is a partial sum over that dim: a weight used by every
    batch block, b and c of the scan used by every channel block."""
    lead = args[ref]
    if not isinstance(lead, DTensor):
        return fn(*args)
    ins = tuple(tuple(a.placements) for a in args)
    out = out_placements(tuple(lead.placements))
    # local_map reads a list as one output's placements, a tuple as one
    # entry an output
    out = list(out) if isinstance(out[0], Placement) else \
        tuple(list(o) for o in out)
    grads = tuple(tuple(Partial() if isinstance(p, Replicate) and r.is_shard()
                        else p for p, r in zip(pl, lead.placements))
                  for pl in ins)
    return local_map(fn, out_placements=out, in_placements=ins,
                     in_grad_placements=grads,
                     device_mesh=lead.device_mesh)(*args)


def assign_(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; on a mesh each rank writes its own block of
    ``src``, laid out as ``dst`` is, into ``dst``'s block (a view of a
    cache entry's block, which the write reaches)."""
    if not isinstance(dst, DTensor):
        dst.copy_(src)
        return
    if src.placements != dst.placements:
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.to_local().copy_(src.to_local())


def stack_layers(parts, axes: Sequence[Optional[str]], stack=None
                 ) -> torch.Tensor:
    """``stack(*parts)`` (default ``torch.stack``): per-layer cache entries
    into one with a leading layer axis.  On a mesh each part is laid out
    by ``axes`` (its logical axes) and each rank stacks its own blocks, so
    the entry comes out laid out by ``(None,) + axes``."""
    stack = stack or (lambda *t: torch.stack(t))
    if not isinstance(parts[0], DTensor):
        return stack(*parts)
    parts = [shard(t, *axes) for t in parts]
    pl = parts[0].placements
    stacked = tuple(type(p)(p.dim + 1) if p.is_shard() else p for p in pl)
    return local_map(stack, out_placements=list(stacked),
                     in_placements=(pl,) * len(parts),
                     device_mesh=parts[0].device_mesh)(*parts)


def split_heads(t: torch.Tensor, H: int, D: int, *lead) -> torch.Tensor:
    """[..., H*D] -> [..., H, D], on a mesh laid out by ``lead`` (the
    logical axes of the leading dims) and the heads (``"heads_dim"``).  A
    last dim whose shards would cut a head (kv_dim 1024 on a 16-way axis:
    half a head a rank; rwkv6-3b's 2560 channels: 2.5) is gathered first,
    as DTensor cannot split such a shard.  The grad is pinned to the
    heads' layout too, so that it never reaches the view's backward with
    a head cut across ranks."""
    if isinstance(t, DTensor):
        last, n = t.ndim - 1, 1
        for i, p in enumerate(t.placements):
            if p.is_shard(last):
                n *= t.device_mesh.size(i)
        if H % n:
            t = shard(t, *lead, None)
    return shard(t.reshape(*t.shape[:-1], H, D), *lead, "heads_dim", None)


def merge_heads(o: torch.Tensor, *lead) -> torch.Tensor:
    """[..., H, D] -> [..., H*D], laid out by ``lead`` and ``"heads_act"``
    (columns on ``model``) for a row-parallel product.  Heads held whole
    by every rank (the axis does not divide them) are merged replicated
    first, and their grad gathered back there, for the view's
    backward."""
    out = o.reshape(*o.shape[:-2], o.shape[-2] * o.shape[-1])
    if not isinstance(o, DTensor):
        return out
    if not any(p.is_shard(o.ndim - 2) for p in o.placements):
        out = shard(out, *lead, None)
    return shard(out, *lead, "heads_act")


def state_placements(pl) -> Tuple:
    """The placements of a per-sequence state [B, ...] computed from an
    activation [B, S, ...] laid out by ``pl``: the sequence dim (never
    split) dropped, the dims after it one lower."""
    return tuple(Shard(p.dim - 1 if p.dim > 1 else p.dim) if p.is_shard()
                 else p for p in pl)


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (config dtypes are strings)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               device: torch.device, in_axis: int = 0) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init (MaxText-style), f32 then cast."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * (1.0 / math.sqrt(shape[in_axis]))).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    t.normal_(0.0, 1.0, generator=gen)
    return (t * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * use(scale, torch.float32, None)).to(dt)


def rmsnorm_sharded(x: torch.Tensor, scale: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """``rmsnorm`` over the whole last dim of ``x``, which on a mesh may
    be split (RWKV6's ``ln_x`` after WKV on each rank's heads): each rank
    sums the squares of its block, the [..., 1] sums are all-reduced over
    the ranks of the split, and each rank scales its block by its slice
    of ``scale``; x itself is never gathered."""
    last = x.ndim - 1
    if not isinstance(x, DTensor) or not any(p.is_shard(last)
                                             for p in x.placements):
        return rmsnorm(x, scale, eps)
    mesh, pl, d = x.device_mesh, tuple(x.placements), x.shape[-1]
    split = [p.is_shard(last) for p in pl]
    whole = tuple(Replicate() if s else p for s, p in zip(split, pl))
    sq = local_map(lambda t: t.float().square().sum(-1, keepdim=True),
                   out_placements=[Partial() if s else p
                                   for s, p in zip(split, pl)],
                   in_placements=(pl,), device_mesh=mesh)(x)
    sq = sq.redistribute(mesh, whole)
    w_pl = tuple(Shard(0) if s else Replicate() for s in split)
    w = scale.to(torch.float32).redistribute(mesh, w_pl)

    def norm(t, s, g):
        return (t.float() * torch.rsqrt(s / d + eps) * g).to(t.dtype)

    # the sums' grad is partial over the split (each rank's block's
    # share); the scale's over the mesh dims that split x's rows
    grads = (pl, tuple(Partial() if s else p for s, p in zip(split, whole)),
             tuple(Partial() if p.is_shard() and not s else q
                   for s, p, q in zip(split, pl, w_pl)))
    return local_map(norm, out_placements=list(pl),
                     in_placements=(pl, whole, w_pl), in_grad_placements=grads,
                     device_mesh=mesh)(x, sq, w)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2] (float32)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate ``x`` [..., S, H, D] by per-token ``positions`` [..., S]."""
    if theta <= 0.0:  # NoPE
        return x
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # [half]
    angles = positions[..., None].float() * freqs                # [..., S, half]
    cos = torch.cos(angles)[..., None, :]                        # [..., S, 1, half]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, ...]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): rotate ``x`` [..., S, H, D] by
    ``positions`` [3, ..., S] (t, h, w).

    Frequency index i in [0, D/2) takes its position id from the section
    it falls into: sections = (n_t, n_h, n_w), sum = D/2.  Positions
    without the leading (t, h, w) axis raise; the reference's gather
    fills the missing sections with NaN there.  On a DTensor x (batch on
    dim 0) each rank rotates its own rows and heads, by positions laid
    out with their batch (dim 1) on the same mesh dims.
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"head_dim / 2 = {half}")
    if positions.dim() != x.dim() - 1 or positions.shape[0] != len(sections):
        raise ValueError(f"M-RoPE wants positions [{len(sections)}, ..., S] "
                         f"for x {tuple(x.shape)}; got "
                         f"{tuple(positions.shape)}")
    if isinstance(x, DTensor):
        return _mrope_sharded(x, positions, theta, sections)
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # [half]
    # section j's frequencies take position ids positions[j]: the
    # reference's per-frequency gather, by slices (no host round trip)
    bounds = [0]
    for n in sections:
        bounds.append(bounds[-1] + n)
    angles = torch.cat([positions[j].float()[..., None] * freqs[a:b]
                        for j, (a, b) in enumerate(zip(bounds, bounds[1:]))],
                       dim=-1)                                   # [..., S, half]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _mrope_sharded(x: DTensor, positions: torch.Tensor, theta: float,
                   sections: Tuple[int, ...]) -> DTensor:
    mesh = x.device_mesh
    rows = [Shard(1) if p.is_shard(0) else Replicate() for p in x.placements]
    positions = positions.redistribute(mesh, rows)
    rotate = functools.partial(apply_mrope, theta=theta, sections=sections)
    return local_map(rotate, out_placements=list(x.placements),
                     in_placements=(x.placements, positions.placements),
                     device_mesh=mesh)(x, positions)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_init(cfg: ModelConfig, gen: torch.Generator, device: torch.device,
             d_ff: Optional[int] = None) -> Params:
    d_ff = d_ff or cfg.d_ff
    dt = torch_dtype(cfg.param_dtype)
    return {
        "wi_gate": dense_init(gen, (cfg.d_model, d_ff), dt, device),
        "wi_up": dense_init(gen, (cfg.d_model, d_ff), dt, device),
        "wo": dense_init(gen, (d_ff, cfg.d_model), dt, device),
    }


def mlp_axes(cfg: ModelConfig) -> Axes:
    return {
        "wi_gate": ("embed", "mlp"),
        "wi_up": ("embed", "mlp"),
        "wo": ("mlp", "embed"),
    }


def mlp_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    dt = torch_dtype(cfg.dtype)
    gate = matmul(x, use(p["wi_gate"], dt, None, "mlp"))
    up = matmul(x, use(p["wi_up"], dt, None, "mlp"))
    return matmul(F.silu(gate) * up, use(p["wo"], dt, "mlp", None))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embedding_init(cfg: ModelConfig, gen: torch.Generator,
                   device: torch.device) -> Params:
    dt = torch_dtype(cfg.param_dtype)
    p = {"embedding": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                                 device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt,
                                  device)
    if cfg.frontend_embed_dim:
        # modality frontend stub projection (identity-shaped if dims equal)
        p["frontend_proj"] = dense_init(
            gen, (cfg.frontend_embed_dim, cfg.d_model), dt, device)
    return p


def embedding_axes(cfg: ModelConfig) -> Axes:
    a: Axes = {"embedding": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        a["unembed"] = ("embed", "vocab")
    if cfg.frontend_embed_dim:
        a["frontend_proj"] = (None, "embed")
    return a


def embed_tokens(cfg: ModelConfig, p: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows at ``tokens``.  On a vocab-sharded table each rank
    looks up the tokens of its vocab block (zeros elsewhere), and the
    caller's ``shard`` sums the blocks."""
    table = use(p["embedding"], p["embedding"].dtype, "vocab", None)
    return F.embedding(tokens, table).to(torch_dtype(cfg.dtype))


def unembed(cfg: ModelConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    w = p["embedding"].T if cfg.tie_embeddings else p["unembed"]
    return matmul(h, use(w, torch_dtype(cfg.dtype), None, "vocab"))
