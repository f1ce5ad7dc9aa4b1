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
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (
    Params, dense_init, rmsnorm, rmsnorm_init, torch_dtype,
)

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


# ---------------------------------------------------------------------------
# time mixing
# ---------------------------------------------------------------------------

def _ddlerp(cfg: ModelConfig, p: Params, x: torch.Tensor,
            x_prev: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Data-dependent token-shift lerp -> (mw, mk, mv, mr, mg)."""
    dt = x.dtype
    sx = x_prev - x
    base = x + sx * p["mu_base"].to(dt)
    lo = torch.tanh(base @ p["mix_w1"].to(dt))
    lo = lo.reshape(*lo.shape[:-1], _MIX_COMPONENTS, cfg.rwkv.mix_lora)
    off = torch.einsum("...cr,crd->...cd", lo, p["mix_w2"].to(dt))
    mus = p["mu"].to(dt) + off                         # [..., 5, d]
    mixed = x[..., None, :] + sx[..., None, :] * mus
    return tuple(mixed[..., i, :] for i in range(_MIX_COMPONENTS))


def _decay(p: Params, mw: torch.Tensor) -> torch.Tensor:
    """Per-channel decay w_t in (0,1): exp(-exp(base + lora(mw))), f32."""
    lo = torch.tanh(mw @ p["decay_w1"].to(mw.dtype))
    dd = lo @ p["decay_w2"].to(mw.dtype)
    return torch.exp(-torch.exp(p["decay_base"] + dd.float()))


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


def rwkv_time_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  x_prev: torch.Tensor, return_state: bool = False):
    """Full-sequence time mixing.  x: [B,S,d]; x_prev: x shifted right.

    Returns out [B,S,d], or (out, final state [B,H,D,D] f32) with
    ``return_state``.
    """
    H, D = _dims(cfg)
    B, S, d = x.shape
    mw, mk, mv, mr, mg = _ddlerp(cfg, p, x, x_prev)
    dt = x.dtype
    r = mr @ p["wr"].to(dt)
    k = mk @ p["wk"].to(dt)
    v = mv @ p["wv"].to(dt)
    g = F.silu(mg @ p["wg"].to(dt))
    w = _decay(p, mw)                                  # [B,S,d] float32

    rs, ks, vs = (t.reshape(B, S, H, D).float() for t in (r, k, v))
    ws = w.reshape(B, S, H, D)
    u = p["u"].float().reshape(H, D)

    ST = None
    if cfg.scan_impl == "pallas" and not return_state:
        y = kops.rwkv6_scan(rs, ks, vs, ws, u)
    else:
        chunk_fn = (_wkv_chunk if cfg.scan_impl == "xla_seq"
                    else _wkv_chunk_parallel)
        ST = torch.zeros(B, H, D, D, dtype=torch.float32, device=x.device)
        ys = []
        for c0 in range(0, S, CHUNK):
            sl = slice(c0, c0 + CHUNK)
            yc, ST = chunk_fn(rs[:, sl], ks[:, sl], vs[:, sl], ws[:, sl], u,
                              ST)
            ys.append(yc)
        y = torch.cat(ys, dim=1)

    y = y.reshape(B, S, d).to(dt)
    y = rmsnorm(y, p["ln_x"], cfg.rms_eps) * g
    out = y @ p["wo"].to(dt)
    if return_state:
        return out, ST
    return out


def rwkv_channel_mix(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     x_prev: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    sx = x_prev - x
    xk = x + sx * p["cmu_k"].to(dt)
    xr = x + sx * p["cmu_r"].to(dt)
    kk = torch.square(F.relu(xk @ p["cw_k"].to(dt)))
    kv = kk @ p["cw_v"].to(dt)
    return torch.sigmoid(xr @ p["cw_r"].to(dt)) * kv


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


def rwkv_decode_time(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor],
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token time-mix step.  x: [B,1,d] (post-ln1 input)."""
    H, D = _dims(cfg)
    B, _, d = x.shape
    xt = x[:, 0, :]
    mw, mk, mv, mr, mg = _ddlerp(cfg, p, xt, cache["tshift"])
    dt = x.dtype
    r = mr @ p["wr"].to(dt)
    k = mk @ p["wk"].to(dt)
    v = mv @ p["wv"].to(dt)
    g = F.silu(mg @ p["wg"].to(dt))
    w = _decay(p, mw)
    rs, ks, vs = (t.reshape(B, H, D).float() for t in (r, k, v))
    ws = w.reshape(B, H, D)
    u = p["u"].float().reshape(H, D)
    S = cache["wkv"]
    kv = ks[..., :, None] * vs[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rs, S + u[..., None] * kv)
    S = ws[..., None] * S + kv
    y = y.reshape(B, d).to(dt)
    y = rmsnorm(y, p["ln_x"], cfg.rms_eps) * g
    out = (y @ p["wo"].to(dt))[:, None, :]
    return out, {"tshift": xt, "cshift": cache["cshift"], "wkv": S}


def rwkv_decode_channel(cfg: ModelConfig, p: Params, x: torch.Tensor,
                        cshift: torch.Tensor,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token channel-mix step.  x: [B,1,d] (post-ln2 input)."""
    xt = x[:, 0, :]
    out = rwkv_channel_mix(cfg, p, xt[:, None, :], cshift[:, None, :])
    return out, xt
