"""Plain reference of RWKV-6 (Finch): its leaves, and its layers in f32.

The function, as the configuration states it (the port's form of Finch;
each departure from the paper is noted in ``PERF.md``):

- h0 = embedding[tokens]; per layer h += time_mix(rms(h));
  h += channel_mix(rms(h)); logits = rms(h) unembed; loss = ce +
  1e-4 mean(lse^2).
- shift(x): x one token later, zeros at the first.
- time mix of x: sx = shift(x) - x; the five mixes (w, k, v, r, g)
  x + sx (mu_c + tanh((x + sx mu_base) W1)_c W2_c); r, k, v, g their
  products; decay w = exp(-exp(decay_base + tanh(x_w D1) D2)); per head
  of D channels the state S (D x D, zero at the start) runs
  y_t = r_t (S_{t-1} + diag(u) k_t^T v_t), S_t = diag(w_t) S_{t-1}
  + k_t^T v_t; out = (rms over all d of y, by ln_x) silu(g) Wo.
- channel mix of x: sx as above; relu((x + sx cmu_k) Wk)^2 Wv times
  sigmoid((x + sx cmu_r) Wr).

WKV is computed 64 tokens at a time: within a chunk the decay between
two tokens is a product of w, exp of a difference of cumulative logs
that is never positive, so nothing overflows.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference.common import Prec, head_loss, rmsnorm

CHUNK = 64
MIXES = 5          # w, k, v, r, g


def leaves(m: Dict, param_dtype: str) -> List:
    d, V, L, f = m["d_model"], m["vocab_size"], m["num_layers"], m["d_ff"]
    r = m["rwkv"]
    ml, dl = r["mix_lora"], r["decay_lora"]
    pd = param_dtype
    nrm = ("uniform", 0.8, 1.2)
    mix = ("uniform", 0.0, 1.0)

    def dense(fan_in):
        return ("normal", 1.0 / math.sqrt(fan_in))

    groups = [("embed", [
        (("embed", "embedding"), (V, d), ("normal", 0.02), pd),
        (("embed", "unembed"), (d, V), dense(d), pd),
        (("final_norm",), (d,), nrm, pd)])]
    for i in range(L):
        b = ("blocks", i)
        groups.append((f"layer{i}", [
            (b + ("ln1",), (d,), nrm, pd),
            (b + ("ln2",), (d,), nrm, pd),
            (b + ("mu_base",), (d,), mix, pd),
            (b + ("mu",), (MIXES, d), mix, pd),
            (b + ("mix_w1",), (d, MIXES * ml), dense(d), pd),
            (b + ("mix_w2",), (MIXES, ml, d), dense(ml), pd),
            (b + ("decay_base",), (d,), ("uniform", -6.0, -4.0), "float32"),
            (b + ("decay_w1",), (d, dl), dense(d), pd),
            (b + ("decay_w2",), (dl, d), dense(dl), pd),
            (b + ("u",), (d,), ("uniform", -1.0, 1.0), "float32"),
            (b + ("wr",), (d, d), dense(d), pd),
            (b + ("wk",), (d, d), dense(d), pd),
            (b + ("wv",), (d, d), dense(d), pd),
            (b + ("wg",), (d, d), dense(d), pd),
            (b + ("wo",), (d, d), dense(d), pd),
            (b + ("ln_x",), (d,), nrm, pd),
            (b + ("cmu_k",), (d,), mix, pd),
            (b + ("cmu_r",), (d,), mix, pd),
            (b + ("cw_k",), (d, f), dense(d), pd),
            (b + ("cw_v",), (f, d), dense(f), pd),
            (b + ("cw_r",), (d, d), dense(d), pd)]))
    return groups


def layer_of(group: Dict, i: int) -> Dict[str, torch.Tensor]:
    return {"/".join(map(str, p[2:])): t.float() for p, t in group.items()}


def embed(group: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return group[("embed", "embedding")].float()[tokens.long()]


def shift(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def wkv(r, k, v, w, u):
    """r, k, v, w [B, S, H, D] f32, u [H, D] -> y [B, S, H, D]."""
    B, S, H, D = r.shape
    state = r.new_zeros(B, H, D, D)
    tri = torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=r.device
                     ).tril(-1)
    ys = []
    for c0 in range(0, S, CHUNK):
        rc, kc, vc, wc = (t[:, c0:c0 + CHUNK] for t in (r, k, v, w))
        C = rc.shape[1]
        lw = torch.log(wc.clamp(min=1e-30))
        A = lw.cumsum(1)                                   # through t
        Ab = A - lw                                        # before t
        y = torch.einsum("bthd,bhde->bthe", rc * Ab.exp(), state)
        diff = Ab[:, :, None] - A[:, None, :]              # [B,t,s,H,D]
        gain = diff.masked_fill(~tri[:C, :C, None, None], float("-inf")
                                ).exp()
        coef = torch.einsum("bthd,bshd,btshd->btsh", rc, kc, gain)
        y = y + torch.einsum("btsh,bshe->bthe", coef, vc)
        y = y + (rc * u * kc).sum(-1, keepdim=True) * vc   # the bonus
        last = A[:, -1:]
        state = last[:, 0].exp()[..., None] * state + torch.einsum(
            "bshd,bshe->bhde", kc * (last - A).exp(), vc)
        ys.append(y)
    return torch.cat(ys, 1)


def time_mix(m: Dict, p: Dict, x: torch.Tensor, prec: Prec) -> torch.Tensor:
    B, S, d = x.shape
    D = m["rwkv"]["head_dim"]
    H = d // D
    ml = m["rwkv"]["mix_lora"]
    sx = shift(x) - x
    lo = torch.tanh(prec.mm(x + sx * p["mu_base"], p["mix_w1"]))
    off = prec.einsum("bscr,crd->bscd", lo.view(B, S, MIXES, ml),
                      p["mix_w2"])
    mixed = x[:, :, None] + sx[:, :, None] * (p["mu"] + off)
    xw, xk, xv, xr, xg = mixed.unbind(2)
    r = prec.mm(xr, p["wr"]).view(B, S, H, D)
    k = prec.mm(xk, p["wk"]).view(B, S, H, D)
    v = prec.mm(xv, p["wv"]).view(B, S, H, D)
    g = prec.mm(xg, p["wg"])
    dd = prec.mm(torch.tanh(prec.mm(xw, p["decay_w1"])), p["decay_w2"])
    w = torch.exp(-torch.exp(p["decay_base"] + dd)).view(B, S, H, D)
    y = wkv(r, k, v, w, p["u"].view(H, D)).reshape(B, S, d)
    y = rmsnorm(y, p["ln_x"], m.get("rms_eps", 1e-6)) * F.silu(g)
    return prec.mm(y, p["wo"])


def channel_mix(m: Dict, p: Dict, x: torch.Tensor, prec: Prec
                ) -> torch.Tensor:
    sx = shift(x) - x
    kk = F.relu(prec.mm(x + sx * p["cmu_k"], p["cw_k"])).square()
    rr = torch.sigmoid(prec.mm(x + sx * p["cmu_r"], p["cw_r"]))
    return rr * prec.mm(kk, p["cw_v"])


def layer(m: Dict, p: Dict, h: torch.Tensor, prec: Prec):
    eps = m.get("rms_eps", 1e-6)
    h = h + time_mix(m, p, rmsnorm(h, p["ln1"], eps), prec)
    h = h + channel_mix(m, p, rmsnorm(h, p["ln2"], eps), prec)
    return h, None


def head(m: Dict, group: Dict, h: torch.Tensor, targets: torch.Tensor,
         prec: Prec) -> Dict[str, torch.Tensor]:
    B, S, d = h.shape
    return head_loss(prec, h.reshape(B * S, d), group[("final_norm",)],
                     group[("embed", "unembed")], targets.reshape(-1),
                     m.get("rms_eps", 1e-6))
