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
The reference runs ``_scan_chunk`` over 256-token chunks only to bound
what its backward keeps (and asserts that the chunk count divides S);
the sums are the same, so here it runs over the whole sequence, of any
length.  Chunks for the backward come with training (ROADMAP slice (b)).
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


def _ssm_inputs(cfg: ModelConfig, p: Params, xc: torch.Tensor):
    """Post-conv activations -> (dt [.,di], B [.,N], C [.,N]) float32."""
    di, N, K, R = _dims(cfg)
    dbc = xc @ p["x_proj"].to(xc.dtype)
    dt_r, b, c = torch.split(dbc, [R, N, N], dim=-1)
    dt_r = rmsnorm(dt_r, p["dt_norm"], cfg.rms_eps)
    b = rmsnorm(b, p["b_norm"], cfg.rms_eps).float()
    c = rmsnorm(c, p["c_norm"], cfg.rms_eps).float()
    dt = dt_r @ p["dt_proj"].to(dt_r.dtype)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    return dt, b, c


def _conv(p: Params, window: torch.Tensor, S: int,
          dtype: torch.dtype) -> torch.Tensor:
    """Causal depthwise conv + SiLU over ``window`` [B, S+K-1, di] (K-1
    tokens of left context), summed left to right in ``dtype`` as the
    reference does."""
    K = p["conv_w"].shape[0]
    xc = sum(window[:, i:i + S, :] * p["conv_w"][i].to(dtype)
             for i in range(K))
    return F.silu(xc + p["conv_b"].to(dtype))


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


def mamba_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                return_state: bool = False):
    """Full-sequence forward.  x: [B,S,d] -> [B,S,d], or with
    ``return_state`` (out, {"conv": [B,K-1,di], "ssm": [B,di,N] f32})."""
    dt_ = torch_dtype(cfg.dtype)
    di, N, K, R = _dims(cfg)
    B, S, _ = x.shape
    xz = x @ p["in_proj"].to(dt_)
    xi, z = xz.chunk(2, dim=-1)
    xc = _conv(p, F.pad(xi, (0, 0, K - 1, 0)), S, dt_)
    dt, b, c = _ssm_inputs(cfg, p, xc)
    A = -torch.exp(p["A_log"])                         # [di, N]
    xf = xc.float()

    if cfg.scan_impl == "pallas":
        out = kops.mamba_scan(A, dt, b, c, xf, return_state=return_state)
        y, h = out if return_state else (out, None)
    else:
        h0 = torch.zeros(B, di, N, dtype=torch.float32, device=x.device)
        y, h = _scan_chunk(A, dt, b, c, xf, h0)

    y = y + xf * p["D"]
    out = y.to(dt_) * F.silu(z)
    out = out @ p["out_proj"].to(dt_)
    if not return_state:
        return out
    conv_tail = (xi[:, S - (K - 1):, :] if S >= K - 1
                 else F.pad(xi, (0, 0, K - 1 - S, 0)))
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
    """x: [B,1,d] -> ([B,1,d], new cache).  ``cache`` is only read."""
    dt_ = torch_dtype(cfg.dtype)
    xz = x @ p["in_proj"].to(dt_)
    xi, z = xz.chunk(2, dim=-1)                        # [B,1,di]
    window = torch.cat([cache["conv"], xi], dim=1)     # [B,K,di]
    xc = _conv(p, window, 1, dt_)                      # [B,1,di]
    dt, b, c = _ssm_inputs(cfg, p, xc)                 # [B,1,*]
    A = -torch.exp(p["A_log"])
    xf = xc[:, 0].float()
    dA = torch.exp(dt[:, 0, :, None] * A)              # [B,di,N]
    dBx = (dt[:, 0] * xf)[..., None] * b[:, 0, None, :]
    h = dA * cache["ssm"] + dBx
    y = torch.einsum("bdn,bn->bd", h, c[:, 0])
    y = y + xf * p["D"]
    out = y[:, None, :].to(dt_) * F.silu(z)
    out = out @ p["out_proj"].to(dt_)
    return out, {"conv": window[:, 1:, :], "ssm": h}
