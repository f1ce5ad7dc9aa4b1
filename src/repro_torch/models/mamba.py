"""Mamba-1 selective SSM block (Jamba configuration, d_state=16).

Counterpart of ``repro/models/mamba.py``.  ``cfg.scan_impl`` picks the
full-sequence scan:
  * ``pallas`` - the hand-written CUDA kernel through ``kernels/ops.py``
                 (its plain version on a CPU tensor), with or without the
                 final state: the kernel also writes the state after the
                 last token, so prefill (``return_state``) takes it too.
                 The reference takes its token loop whenever the state is
                 asked for (``mamba.py:106``); the function is the same;
  * otherwise  - the token-by-token scan ``_scan_chunk``, which also
                 returns the final state.
Under grad (grad mode on and an input of the scan requiring grad) the
token scan runs over ``CHUNK``-token chunks, the last one shorter where
``CHUNK`` does not divide S, each under ``torch.utils.checkpoint``, the
state carried from chunk to chunk: the backward keeps a chunk's inputs
and its final state, not every token's [B, di, N] terms, as the
reference's ``jax.checkpoint``-ed chunks do (the reference also asserts
that its chunk count divides S).  Without grad one scan runs over the
whole sequence; the sums are the same either way.

On ``meta`` tensors (the dry-run) a run of tokens is not stepped:
``_MetaChunk`` returns outputs of the token loop's shapes and charges
the active ``launch/op_analysis.py`` ``OpAnalysis`` what the loop would
dispatch, forward and backward, probed at a few lengths on ``meta`` and
extrapolated (the reference traces its loop once, as a ``lax.scan``).

On a mesh (DTensors under ``parallel/context.py``) each rank holds its
own ``inner`` channels: ``in_proj`` is column-parallel, and its output's
contiguous column blocks are traded by one all-to-all so that each rank
gets its di/n channels of both ``xi`` and ``z`` (``_halves``, the
reshard GSPMD makes for the reference); the conv, ``dt_bias``,
``A_log``, ``D`` and the gate are per channel; ``x_proj`` is
row-parallel (its [.., R+2N] output reduced), ``dt_proj`` column- and
``out_proj`` row-parallel; the scan, kernel or token loop, runs on each
rank's channels with b and c whole (``layers.per_rank``), and the decode
state keeps ``conv``/``ssm`` on ``inner_act``.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch import tracing
from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.launch import op_analysis
from repro_torch.models.layers import (
    Axes, Params, dense_init, matmul, per_rank, rmsnorm, rmsnorm_init,
    state_placements, torch_dtype, use,
)
from repro_torch.parallel.collectives import all_to_all_rows
from repro_torch.parallel.context import shard

CHUNK = 256


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    m = cfg.mamba
    assert m is not None
    di = m.expand * cfg.d_model
    return di, m.d_state, m.d_conv, m.resolved_dt_rank(cfg.d_model)


def mamba_init(cfg: ModelConfig, gen: torch.Generator,
               device: torch.device) -> Params:
    """One layer's parameters.  ``A_log`` and ``D`` are f32 whatever
    ``param_dtype`` is, as in the reference."""
    dt = torch_dtype(cfg.param_dtype)
    di, N, K, R = _dims(cfg)
    dense = lambda *shape: dense_init(gen, shape, dt, device)
    # S4D-real initialization for A
    A = torch.arange(1, N + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(di, 1)
    u = torch.rand((di,), generator=gen, dtype=torch.float32, device=device)
    return {
        "in_proj": dense(cfg.d_model, 2 * di),
        "conv_w": dense(K, di),
        "conv_b": torch.zeros((di,), dtype=dt, device=device),
        "x_proj": dense(di, R + 2 * N),
        "dt_proj": dense(R, di),
        # softplus^-1 of uniform [1e-3, 1e-1] (log-spaced)
        "dt_bias": torch.log(torch.expm1(10 ** (u * 2.0 - 3.0))).to(dt),
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense(di, cfg.d_model),
        "dt_norm": rmsnorm_init(R, dt, device),
        "b_norm": rmsnorm_init(N, dt, device),
        "c_norm": rmsnorm_init(N, dt, device),
    }


def mamba_axes(cfg: ModelConfig) -> Axes:
    return {
        "in_proj": ("embed", "inner"),
        "conv_w": (None, "inner"),
        "conv_b": ("inner",),
        "x_proj": ("inner", None),
        "dt_proj": (None, "inner"),
        "dt_bias": ("inner",),
        "A_log": ("inner", None),
        "D": ("inner",),
        "out_proj": ("inner", "embed"),
        "dt_norm": (None,),
        "b_norm": (None,),
        "c_norm": (None,),
    }


def mamba_cache_axes() -> Axes:
    """Logical axes of one layer's decode state (``mamba_cache_init``)."""
    return {"conv": ("batch", None, "inner_act"),
            "ssm": ("batch", "inner_act", None)}


def _halves(xz: torch.Tensor):
    """in_proj's output xz [B,S,2di] -> (xi, z), each [B,S,di].

    On a mesh whose ``model`` axis (n ranks, n even) splits xz's columns,
    rank j holds the contiguous columns [2j·e, (2j+2)·e), e = di/n: of xi
    for j < n/2, of z past it (n = 2: all of xi on rank 0, all of z on
    rank 1).  Each rank sends its two e-column blocks to the ranks that
    own them (block b: xi's block b on rank b for b < n, z's block b - n
    on rank b - n past it) and receives its own blocks of xi and z, in
    one all-to-all: 2·e columns of its rows a rank, a self-send among
    them.  Slicing the weight at di instead would make DTensor gather the
    whole [d, 2di] weight.  Any other layout gathers xz's columns."""
    if not isinstance(xz, DTensor):
        return xz.chunk(2, dim=-1)
    last, mesh = xz.ndim - 1, xz.device_mesh
    split = [i for i, p in enumerate(xz.placements) if p.is_shard(last)]
    if not split:
        return xz.chunk(2, dim=-1)
    dim = split[0]
    n = mesh.size(dim)
    lead = ("batch",) + (None,) * (xz.ndim - 2)
    if len(split) > 1 or n % 2 or (xz.shape[-1] // 2) % n:
        xi, z = shard(xz, *lead, None).chunk(2, dim=-1)
        return shard(xi, *lead, "inner_act"), shard(z, *lead, "inner_act")
    pl = tuple(xz.placements)
    fn = functools.partial(_trade_halves, mesh=mesh, dim=dim)
    return local_map(fn, out_placements=(pl, pl), in_placements=(pl,),
                     device_mesh=mesh)(xz)


def _trade_halves(t: torch.Tensor, *, mesh, dim: int):
    """``_halves``' all-to-all on one rank's block t [..., 2e] of xz."""
    n, j = mesh.size(dim), mesh.get_local_rank(dim)
    coord = list(mesh.get_coordinate())

    def rank_of(c: int) -> int:
        coord[dim] = c
        return int(mesh.mesh[tuple(coord)])

    e = t.shape[-1] // 2
    rows = t.numel() // t.shape[-1]
    dest = [rank_of(2 * j % n), rank_of((2 * j + 1) % n)]
    src = [rank_of(j // 2), rank_of(n // 2 + j // 2)]     # xi's, z's
    chan = t.reshape(rows, 2 * e).t()                     # [2e, rows]
    send_order = sorted(range(2), key=dest.__getitem__)
    send = torch.cat([chan[i * e:(i + 1) * e] for i in send_order])
    got = all_to_all_rows(send, [(r, e) for r in sorted(dest)],
                          [(r, e) for r in sorted(src)])
    recv_order = sorted(range(2), key=src.__getitem__)
    xi, z = (got[recv_order.index(i) * e:(recv_order.index(i) + 1) * e]
             .t().reshape(*t.shape[:-1], e) for i in range(2))
    return xi, z


def _ssm_inputs(cfg: ModelConfig, p: Params, xc: torch.Tensor):
    """Post-conv activations -> (dt [.,di], B [.,N], C [.,N]) float32; on
    a mesh dt on each rank's channels, b and c whole (``x_proj``'s
    partial sums reduced)."""
    di, N, K, R = _dims(cfg)
    dbc = matmul(xc, use(p["x_proj"], xc.dtype, "inner", None))
    dbc = shard(dbc, "batch", None, None)
    dt_r, b, c = torch.split(dbc, [R, N, N], dim=-1)
    dt_r = rmsnorm(dt_r, p["dt_norm"], cfg.rms_eps)
    b = rmsnorm(b, p["b_norm"], cfg.rms_eps).float()
    c = rmsnorm(c, p["c_norm"], cfg.rms_eps).float()
    dt = matmul(dt_r, use(p["dt_proj"], dt_r.dtype, None, "inner"))
    dt = F.softplus(dt.float() + use(p["dt_bias"], torch.float32, "inner"))
    return dt, b, c


def _conv_local(xi: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                left=None):
    """Causal depthwise conv + SiLU over xi [B,S,di] with ``left`` [B,K-1,
    di] of left context (zeros if None), summed left to right in xi's
    dtype as the reference does -> (xc, the window's last K-1 rows: the
    next step's context)."""
    K, S = w.shape[0], xi.shape[1]
    window = F.pad(xi, (0, 0, K - 1, 0)) if left is None else \
        torch.cat([left, xi], dim=1)
    xc = sum(window[:, i:i + S, :] * w[i] for i in range(K))
    return F.silu(xc + bias), window[:, S:, :]


def _conv(p: Params, xi: torch.Tensor, dtype: torch.dtype, left=None):
    """``_conv_local`` on each rank's channels."""
    args = (xi, use(p["conv_w"], dtype, None, "inner"),
            use(p["conv_b"], dtype, "inner"))
    if left is not None:
        args += (left,)
    return per_rank(_conv_local, args, lambda pl: (pl, pl))


def _scan_chunk(A, dt, b, c, xs, h0):
    """Sequential selective scan over a run of C tokens.

    A [di,N]; dt [B,C,di]; b,c [B,C,N]; xs [B,C,di]; h0 [B,di,N] -> (y, hT)
    """
    h, ys = h0, []
    for t in range(dt.shape[1]):
        dA = torch.exp(dt[:, t, :, None] * A)             # [B,di,N]
        dBx = (dt[:, t] * xs[:, t])[..., None] * b[:, t, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    return torch.stack(ys, dim=1), h


def _eager_chunk(remat: bool, A, dt, b, c, xs, h0):
    """``_scan_chunk``, under ``checkpoint`` with ``remat``."""
    if remat:
        return checkpoint(_scan_chunk, A, dt, b, c, xs, h0,
                          use_reentrant=False)
    return _scan_chunk(A, dt, b, c, xs, h0)


def _chunk(remat: bool, A, dt, b, c, xs, h0):
    """A run of tokens: ``_eager_chunk``, or on ``meta`` ``_MetaChunk``."""
    if xs.device.type == "meta":
        return _MetaChunk.apply(remat, A, dt, b, c, xs, h0)
    return _eager_chunk(remat, A, dt, b, c, xs, h0)


# which of _scan_chunk's inputs (A, dt, b, c, xs, h0) run over the tokens
_TOKENS = (False, True, True, True, True, False)


def _layout(t: torch.Tensor, grad: bool):
    return tuple(t.shape), t.stride(), t.dtype, grad


def _like(lay, k: Optional[int]) -> torch.Tensor:
    """A ``meta`` tensor of ``_layout`` ``lay``, its dim 1 of k tokens."""
    shape, stride, dtype, grad = lay
    if k is not None:
        shape = (shape[0], k) + shape[2:]
    t = torch.empty_strided(shape, stride, dtype=dtype, device="meta")
    return t.requires_grad_(grad)


def _probe(remat: bool, hooked: bool, lays, out_grads, k: int):
    """The ``window`` record of ``_eager_chunk`` on k tokens of inputs
    laid out as ``lays``, run under a saved-tensor hook if ``hooked``: its
    forward, or with ``out_grads`` (the layouts of the grads of y and hT,
    None where an output has none) its backward, the recompute
    included."""
    with op_analysis.alone(hooked) as oa:
        ins = [_like(lay, k if tok else None)
               for lay, tok in zip(lays, _TOKENS)]
        with torch.enable_grad() if remat else torch.no_grad():
            if out_grads is None:
                with oa.window() as rec:
                    out = _eager_chunk(remat, *ins)
                return rec
            out = _eager_chunk(remat, *ins)
        pairs = [(o, _like(g, k if i == 0 else None))
                 for i, (o, g) in enumerate(zip(out, out_grads))
                 if g is not None]
        want = [t for t in ins if t.requires_grad]
        with oa.window() as rec:     # the grads live at its end, as the loop's
            got = torch.autograd.grad([o for o, _ in pairs], want,
                                      [g for _, g in pairs])
        del got
        return rec


def _charge(oa, remat: bool, hooked: bool, lays, out_grads, n: int):
    """Charge ``oa`` what ``_probe`` counts at n tokens (once a layout)."""
    key = (remat, hooked, lays, out_grads)
    oa.charge(oa.extrapolated(key, functools.partial(_probe, *key), n))


def _made(oa, shapes_like) -> Tuple[torch.Tensor, ...]:
    """Fresh ``meta`` tensors, made without a count and tracked as live."""
    with oa.muted() if oa is not None else contextlib.nullcontext():
        out = tuple(torch.empty(s, dtype=d, device="meta")
                    for s, d in shapes_like)
    if oa is not None:
        oa.track(out)
    return out


class _MetaChunk(torch.autograd.Function):
    """``_eager_chunk`` on ``meta`` tensors without stepping its tokens:
    y [B,C,di] and hT [B,di,N] in f32, and under an active ``OpAnalysis``
    the counts the loop dispatches (``_charge``): the forward, and in the
    backward the recompute and the backward.  The inputs are saved as the
    checkpoint saves them (through the hooks in use: an enclosing remat
    region drops them); the outputs are all the loop keeps live past its
    forward.  A run of more than 32 tokens costs six probes, once per
    layout."""

    @staticmethod
    def forward(ctx, remat, A, dt, b, c, xs, h0):
        ctx.set_materialize_grads(False)
        args = (A, dt, b, c, xs, h0)
        ctx.save_for_backward(*args)
        ctx.remat = remat
        ctx.hooked = op_analysis.saving_hooked()
        ctx.lays = tuple(_layout(t, g) for t, g in
                         zip(args, ctx.needs_input_grad[1:]))
        oa = op_analysis.active()
        B, C, di = xs.shape
        if oa is not None:
            _charge(oa, remat, ctx.hooked, ctx.lays, None, C)
        return _made(oa, [((B, C, di), torch.float32),
                          ((B, di, A.shape[1]), torch.float32)])

    @staticmethod
    def backward(ctx, gy, ghT):
        oa = op_analysis.active()
        grads = tuple(None if g is None else _layout(g, False)
                      for g in (gy, ghT))
        need = ctx.needs_input_grad[1:]
        if oa is not None:
            _charge(oa, ctx.remat, ctx.hooked, ctx.lays, grads,
                    ctx.lays[4][0][1])
        made = iter(_made(oa, [(lay[0], lay[2])
                               for lay, g in zip(ctx.lays, need) if g]))
        return (None,) + tuple(next(made) if g else None for g in need)


def _scan(impl: str, return_state: bool, dt, A, b, c, xf):
    """The full-sequence scan on the channels these tensors hold -> y, or
    (y, hT) with ``return_state``."""
    if impl == "pallas":
        return kops.mamba_scan(A, dt, b, c, xf, return_state=return_state)
    B, S, di = xf.shape
    h = torch.zeros(B, di, A.shape[1], dtype=torch.float32, device=xf.device)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (A, dt, b, c, xf)):
        ys = []
        for s in range(0, S, CHUNK):
            cut = slice(s, s + CHUNK)
            y_c, h = _chunk(True, A, dt[:, cut], b[:, cut], c[:, cut],
                            xf[:, cut], h)
            ys.append(y_c)
        y = torch.cat(ys, dim=1)
    else:
        y, h = _chunk(False, A, dt, b, c, xf, h)
    return (y, h) if return_state else y


def mamba_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                return_state: bool = False):
    """Full-sequence forward.  x: [B,S,d] -> [B,S,d], or with
    ``return_state`` (out, {"conv": [B,K-1,di], "ssm": [B,di,N] f32}).
    Spans: ``mamba.conv`` (the causal conv and SiLU), ``mamba.ssm_inputs``
    (``x_proj``, the dt/B/C norms, ``dt_proj``, softplus), ``mamba.scan``
    (the kernel or the token loop); the in and out projections and the
    gate are the enclosing span's own time."""
    dt_ = torch_dtype(cfg.dtype)
    xz = matmul(x, use(p["in_proj"], dt_, None, "inner"))
    xi, z = _halves(xz)
    with tracing.span("mamba.conv"):
        xc, conv_tail = _conv(p, xi, dt_)
    with tracing.span("mamba.ssm_inputs"):
        dt, b, c = _ssm_inputs(cfg, p, xc)
    A = -torch.exp(use(p["A_log"], torch.float32, "inner", None))   # [di, N]
    xf = xc.float()
    scan = functools.partial(_scan, cfg.scan_impl, return_state)
    with tracing.span("mamba.scan"):
        out = per_rank(scan, (dt, A, b, c, xf),
                       lambda pl: (pl, state_placements(pl)) if return_state
                       else pl)
    y, h = out if return_state else (out, None)
    y = y + xf * use(p["D"], torch.float32, "inner")
    out = y.to(dt_) * F.silu(z)
    out = matmul(out, use(p["out_proj"], dt_, "inner", None))
    if not return_state:
        return out
    return out, {"conv": conv_tail, "ssm": h}


# ---------------------------------------------------------------------------
# decode (single token, carried state)
# ---------------------------------------------------------------------------

def mamba_cache_init(cfg: ModelConfig, batch: int,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    di, N, K, _ = _dims(cfg)
    return {
        "conv": torch.zeros((batch, K - 1, di), dtype=torch_dtype(cfg.dtype),
                            device=device),
        "ssm": torch.zeros((batch, di, N), dtype=torch.float32,
                           device=device),
    }


def mamba_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor],
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B,1,d] -> ([B,1,d], new cache).  ``cache`` is only read.  The
    spans of ``mamba_apply``."""
    dt_ = torch_dtype(cfg.dtype)
    xz = matmul(x, use(p["in_proj"], dt_, None, "inner"))
    xi, z = _halves(xz)                                # [B,1,di]
    with tracing.span("mamba.conv"):
        xc, conv = _conv(p, xi, dt_, cache["conv"])    # [B,1,di]
    with tracing.span("mamba.ssm_inputs"):
        dt, b, c = _ssm_inputs(cfg, p, xc)             # [B,1,*]
    A = -torch.exp(use(p["A_log"], torch.float32, "inner", None))
    xf = xc.float()
    step = lambda dt, A, b, c, x, h0: _scan_chunk(A, dt, b, c, x, h0)
    with tracing.span("mamba.scan"):
        y, h = per_rank(step, (dt, A, b, c, xf, cache["ssm"]),
                        lambda pl: (pl, state_placements(pl)))
    y = y + xf * use(p["D"], torch.float32, "inner")
    out = y.to(dt_) * F.silu(z)
    out = matmul(out, use(p["out_proj"], dt_, "inner", None))
    return out, {"conv": conv, "ssm": h}
