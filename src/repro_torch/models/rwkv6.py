"""RWKV6 (Finch) block: time-mixing with data-dependent decay + channel-mix.

Counterpart of ``repro/models/rwkv6.py``.  Recurrence per head
(Dk = Dv = head_dim):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (S: [Dk, Dv])
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

``cfg.scan_impl`` picks the full-sequence WKV:
  * ``xla``     - chunked-parallel form in PyTorch (``_wkv_chunk_parallel``);
  * ``xla_seq`` - token-by-token form inside each chunk (``_wkv_chunk``);
  * ``pallas``  - the hand-written CUDA kernel through ``kernels/ops.py``
                  (its plain version on a CPU tensor), only when no final
                  state is asked for, as in the reference.
The chunk loop cuts 64-token chunks and a shorter last one, so any S
works (the reference asserts that its chunk count divides S).

On a mesh (DTensors under ``parallel/context.py``) the reference has no
``shard()`` site here: GSPMD propagates the layout from ``rwkv_axes``.
The port fixes it: ``wr``/``wk``/``wv``/``wg``, ``decay_w2`` and
``cw_k``/``cw_r`` are column-parallel products (``layers.matmul``),
``wo`` and ``cw_v`` row-parallel; WKV runs on each rank's whole heads
(``layers.split_heads``: a head cut across ranks, as rwkv6-3b's 40 on a
16-way axis, is gathered first), the kernel or the chunk loop through
``layers.per_rank``, with ``u`` and ``decay_base`` sliced to those heads;
``ln_x`` normalises over all of d with one all-reduce of the sums of
squares (``layers.rmsnorm_sharded``).
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (
    Axes, Params, dense_init, matmul, merge_heads, per_rank, rmsnorm_init,
    rmsnorm_sharded, split_heads, state_placements, torch_dtype, use,
)
from repro_torch.parallel.context import shard

CHUNK = 64
_MIX_COMPONENTS = 5  # w, k, v, r, g


def _dims(cfg: ModelConfig) -> Tuple[int, int]:
    c = cfg.rwkv
    assert c is not None
    return cfg.d_model // c.head_dim, c.head_dim


def _uniform(gen: torch.Generator, shape, dtype: torch.dtype,
             device: torch.device, lo: float = 0.0,
             hi: float = 1.0) -> torch.Tensor:
    t = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return (t * (hi - lo) + lo).to(dtype)


def rwkv_init(cfg: ModelConfig, gen: torch.Generator,
              device: torch.device) -> Params:
    """One layer's parameters.  ``decay_base`` and ``u`` are f32 whatever
    ``param_dtype`` is, as in the reference."""
    c = cfg.rwkv
    dt = torch_dtype(cfg.param_dtype)
    d, f32 = cfg.d_model, torch.float32
    dense = lambda *shape, **kw: dense_init(gen, shape, dt, device, **kw)
    return {
        "ln1": rmsnorm_init(d, dt, device),
        "ln2": rmsnorm_init(d, dt, device),
        # --- time mixing ------------------------------------------------
        "mu_base": _uniform(gen, (d,), dt, device),
        "mu": _uniform(gen, (_MIX_COMPONENTS, d), dt, device),
        "mix_w1": dense(d, _MIX_COMPONENTS * c.mix_lora),
        "mix_w2": dense(_MIX_COMPONENTS, c.mix_lora, d, in_axis=1),
        "decay_base": _uniform(gen, (d,), f32, device) * 2.0 - 6.0,
        "decay_w1": dense(d, c.decay_lora),
        "decay_w2": dense(c.decay_lora, d),
        "u": _uniform(gen, (d,), f32, device, -1.0, 1.0),
        "wr": dense(d, d),
        "wk": dense(d, d),
        "wv": dense(d, d),
        "wg": dense(d, d),
        "wo": dense(d, d),
        "ln_x": rmsnorm_init(d, dt, device),
        # --- channel mixing ----------------------------------------------
        "cmu_k": _uniform(gen, (d,), dt, device),
        "cmu_r": _uniform(gen, (d,), dt, device),
        "cw_k": dense(d, cfg.d_ff),
        "cw_v": dense(cfg.d_ff, d),
        "cw_r": dense(d, d),
    }


def rwkv_axes(cfg: ModelConfig) -> Axes:
    return {
        "ln1": ("embed",), "ln2": ("embed",),
        "mu_base": ("embed",), "mu": (None, "embed"),
        "mix_w1": ("embed", None), "mix_w2": (None, None, "embed"),
        "decay_base": ("embed",),
        "decay_w1": ("embed", None), "decay_w2": (None, "embed"),
        "u": ("embed",),
        "wr": ("embed", "heads"), "wk": ("embed", "heads"),
        "wv": ("embed", "heads"), "wg": ("embed", "heads"),
        "wo": ("heads", "embed"),
        "ln_x": ("embed",),
        "cmu_k": ("embed",), "cmu_r": ("embed",),
        "cw_k": ("embed", "mlp"), "cw_v": ("mlp", "embed"),
        "cw_r": ("embed", "embed2"),
    }


# ---------------------------------------------------------------------------
# time mixing
# ---------------------------------------------------------------------------

def _ddlerp(cfg: ModelConfig, p: Params, x: torch.Tensor,
            x_prev: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Data-dependent token-shift lerp -> (mw, mk, mv, mr, mg); on a mesh
    on each rank's rows, with the (small) mixing weights whole."""
    dt = x.dtype
    ws = (use(p["mu_base"], dt, None), use(p["mix_w1"], dt, None, None),
          use(p["mix_w2"], dt, None, None, None), use(p["mu"], dt, None, None))
    return per_rank(functools.partial(_ddlerp_local, cfg.rwkv.mix_lora),
                    (x, x_prev) + ws, lambda pl: (pl,) * _MIX_COMPONENTS)


def _ddlerp_local(mix_lora: int, x, x_prev, mu_base, mix_w1, mix_w2, mu):
    sx = x_prev - x
    lo = torch.tanh((x + sx * mu_base) @ mix_w1)
    lo = lo.reshape(*lo.shape[:-1], _MIX_COMPONENTS, mix_lora)
    off = torch.einsum("...cr,crd->...cd", lo, mix_w2)
    mixed = x[..., None, :] + sx[..., None, :] * (mu + off)   # [..., 5, d]
    return tuple(mixed[..., i, :] for i in range(_MIX_COMPONENTS))


def _decay(p: Params, mw: torch.Tensor) -> torch.Tensor:
    """Per-channel decay w_t in (0,1): exp(-exp(base + lora(mw))), f32;
    on a mesh the channels of each rank's heads."""
    lo = torch.tanh(matmul(mw, use(p["decay_w1"], mw.dtype, None, None)))
    dd = matmul(lo, use(p["decay_w2"], mw.dtype, None, "heads"))
    return torch.exp(-torch.exp(use(p["decay_base"], torch.float32, "heads")
                                + dd.float()))


def _wkv_chunk(r, k, v, w, u, S0):
    """Sequential WKV over one chunk (reference form).

    r,k,v,w: [B,C,H,D]; u: [H,D]; S0: [B,H,D,D] -> (y [B,C,H,D], S_T)
    """
    S, ys = S0, []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # [B,H,Dk,Dv]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               S + u[..., None] * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1), S


def _wkv_chunk_parallel(r, k, v, w, u, S0):
    """Chunked-matmul WKV (the kernel's math); every exponent is <= 0.

    r,k,v,w: [B,C,H,D]; u: [H,D]; S0: [B,H,D,D] -> (y [B,C,H,D], S_T)
    """
    logw = torch.log(torch.clamp(w, min=1e-37))        # [B,C,H,D]
    L = torch.cumsum(logw, dim=1)
    L_prev = L - logw
    C = r.shape[1]

    # inter-chunk: r decayed to chunk start, applied to carried state
    y = torch.einsum("bthk,bhkv->bthv", r * torch.exp(L_prev), S0)

    # intra-chunk: A[t,s] = sum_d r_t k_s e^{L_prev[t]-L[s]}  (s < t)
    expo = L_prev[:, :, None] - L[:, None, :]          # [B,C,C,H,D]
    tri = torch.ones(C, C, dtype=torch.bool, device=r.device).tril(-1)
    gated = torch.where(tri[None, :, :, None, None], torch.exp(expo), 0.0)
    A = torch.einsum("bthd,bshd,btshd->btsh", r, k, gated)
    diag = torch.einsum("bthd,hd,bthd->bth", r, u, k)  # bonus term
    A = A + diag[:, :, None, :] * torch.eye(C, device=r.device)[None, :, :,
                                                                 None]
    y = y + torch.einsum("btsh,bshv->bthv", A, v)

    # state update: S' = diag(e^{L_C}) S0 + sum_s (k_s e^{L_C-L_s})^T v_s
    L_total = L[:, -1:]                                # [B,1,H,D]
    k_dec = k * torch.exp(L_total - L)
    ST = (torch.exp(L_total[:, 0])[..., None] * S0
          + torch.einsum("bshk,bshv->bhkv", k_dec, v))
    return y, ST


def _wkv_kernel(r, k, v, w, u):
    return kops.rwkv6_scan(*(t.contiguous() for t in (r, k, v, w, u)))


def _wkv_chunks(impl: str, r, k, v, w, u):
    """The chunk loop over r, k, v, w [B,S,H,D] -> (y, final state)."""
    B, S, H, D = r.shape
    chunk_fn = _wkv_chunk if impl == "xla_seq" else _wkv_chunk_parallel
    ST = torch.zeros(B, H, D, D, dtype=torch.float32, device=r.device)
    ys = []
    for c0 in range(0, S, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        yc, ST = chunk_fn(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u, ST)
        ys.append(yc)
    return torch.cat(ys, dim=1), ST


def _receptance(cfg: ModelConfig, p: Params, x: torch.Tensor,
                x_prev: torch.Tensor, *lead):
    """r, k, v [..., H, D] and w [..., H, D] f32 by heads, u [H, D], and
    the gate g [..., d], from x and its shifted x_prev."""
    H, D = _dims(cfg)
    mw, mk, mv, mr, mg = _ddlerp(cfg, p, x, x_prev)
    dt = x.dtype
    r, k, v, g = (matmul(m, use(p[name], dt, None, "heads")) for m, name in
                  ((mr, "wr"), (mk, "wk"), (mv, "wv"), (mg, "wg")))
    rs, ks, vs = (split_heads(t, H, D, *lead).float() for t in (r, k, v))
    ws = split_heads(_decay(p, mw), H, D, *lead)
    u = split_heads(use(p["u"], torch.float32, "heads"), H, D)
    return rs, ks, vs, ws, u, F.silu(g)


def _output(cfg: ModelConfig, p: Params, y: torch.Tensor,
            g: torch.Tensor) -> torch.Tensor:
    """ln_x over WKV's y [..., H, D], the gate, ``wo``; on a mesh by the
    heads' channels, ``wo`` row-parallel."""
    dt = g.dtype
    y = merge_heads(y, *(("batch",) + (None,) * (y.ndim - 3)))
    y = rmsnorm_sharded(y.to(dt), p["ln_x"], cfg.rms_eps) * g
    return matmul(y, use(p["wo"], dt, "heads", None))


def rwkv_time_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  x_prev: torch.Tensor, return_state: bool = False):
    """Full-sequence time mixing.  x: [B,S,d]; x_prev: x shifted right.

    Returns out [B,S,d], or (out, final state [B,H,D,D] f32) with
    ``return_state``.
    """
    with tracing.span("rwkv.time_mix"):
        rs, ks, vs, ws, u, g = _receptance(cfg, p, x, x_prev, "batch", None)
        args = (rs, ks, vs, ws, u)
        ST = None
        with tracing.span("rwkv.wkv6"):
            if cfg.scan_impl == "pallas" and not return_state:
                y = per_rank(_wkv_kernel, args, lambda pl: pl)
            else:
                y, ST = per_rank(functools.partial(_wkv_chunks,
                                                   cfg.scan_impl), args,
                                 lambda pl: (pl, state_placements(pl)))
        out = _output(cfg, p, y, g)
    if return_state:
        return out, ST
    return out


def rwkv_channel_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     x_prev: torch.Tensor) -> torch.Tensor:
    """On a mesh ``cw_k`` and ``cw_r`` split their columns, ``cw_v`` its
    rows: kv's partial sums are reduced onto the receptance's columns
    (``"embed2"``) and the product leaves them split."""
    with tracing.span("rwkv.channel_mix"):
        dt = x.dtype
        sx = x_prev - x
        xk = x + sx * use(p["cmu_k"], dt, None)
        xr = x + sx * use(p["cmu_r"], dt, None)
        kk = torch.square(F.relu(matmul(xk, use(p["cw_k"], dt, None, "mlp"))))
        kv = matmul(kk, use(p["cw_v"], dt, "mlp", None))
        rr = torch.sigmoid(matmul(xr, use(p["cw_r"], dt, None, "embed2")))
        lead = ("batch",) + (None,) * (x.ndim - 2)
        return rr * shard(kv, *lead, "embed2")


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def rwkv_cache_init(cfg: ModelConfig, batch: int,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    H, D = _dims(cfg)
    d, dt = cfg.d_model, torch_dtype(cfg.dtype)
    return {
        "tshift": torch.zeros((batch, d), dtype=dt, device=device),
        "cshift": torch.zeros((batch, d), dtype=dt, device=device),
        "wkv": torch.zeros((batch, H, D, D), dtype=torch.float32,
                           device=device),
    }


def rwkv_cache_axes() -> Axes:
    """Logical axes of one layer's decode state (``rwkv_cache_init``)."""
    return {"tshift": ("batch", "embed_act"), "cshift": ("batch", "embed_act"),
            "wkv": ("batch", "heads_act", None, None)}


def _wkv_step(r, k, v, w, u, S):
    """One token of WKV: r, k, v, w [B,H,D], state S [B,H,D,D] ->
    (y [B,H,D], the new state)."""
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r, S + u[..., None] * kv)
    return y, w[..., None] * S + kv


def rwkv_decode_time(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor],
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token time-mix step.  x: [B,1,d] (post-ln1 input)."""
    xt = x[:, 0, :]
    rs, ks, vs, ws, u, g = _receptance(cfg, p, xt, cache["tshift"], "batch")
    S = cache["wkv"]
    # r [B,H,D] and the state [B,H,D,D] split alike on their first 2 dims
    y, S = per_rank(_wkv_step, (rs, ks, vs, ws, u, S), lambda pl: (pl, pl))
    out = _output(cfg, p, y, g)[:, None, :]
    return out, {"tshift": xt, "cshift": cache["cshift"], "wkv": S}


def rwkv_decode_channel(cfg: ModelConfig, p: Params, x: torch.Tensor,
                        cshift: torch.Tensor,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token channel-mix step.  x: [B,1,d] (post-ln2 input)."""
    xt = x[:, 0, :]
    out = rwkv_channel_mix(cfg, p, xt[:, None, :], cshift[:, None, :])
    return out, xt
