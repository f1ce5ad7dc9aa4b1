"""Plain reference of a decoder with grouped-query attention and a
top-k mixture of experts (Qwen3-MoE): its leaves, and its layers in f32.

The function, as the configuration states it (published Qwen3-MoE with
the port's choices, each noted in ``PERF.md``):

- h0 = embedding[tokens]; per layer h += attn(rms(h)); h += moe(rms(h));
  logits = rms(h) unembed; loss = ce + 1e-4 mean(lse^2) + sum of the
  layers' aux.
- attention: q, k, v = x Wq, x Wk, x Wv split into heads; RMS norm over
  each q and k head (``qk_norm``), then RoPE (rotate-half, inverse
  frequencies theta^(-i / (Dh/2))) at positions 0..S-1; query head h
  reads kv head h // (Hq/Hkv); causal softmax(q k^T / sqrt(Dh)) v; o Wo.
- experts: router logits x R in f32, softmax, the top k, their weights
  renormalised to sum 1 (kept as they are where ``moe.norm_topk_prob``
  is false); assignment j of token t (token-major order) takes
  the next free slot of its expert, and one that finds the expert's
  C = max(floor(capacity_factor T k / E), k) slots full is dropped; a
  kept one adds weight x SwiGLU_e(x) = (silu(x Wg_e) * (x Wu_e)) Wo_e.
  aux = 0.01 E sum_e(mean_t p_te * share of assignments to e) / k.
  A batch of more than ``chunk_tokens`` tokens (when they divide it) is
  routed chunk by chunk with its own capacity; aux is then the chunks'
  mean.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference.common import Prec, head_loss, rmsnorm

AUX = 0.01


def leaves(m: Dict, param_dtype: str) -> List:
    """Groups of leaves: the embedding and head, then one group a layer,
    each leaf at the path the program's tree has it."""
    d, V, L = m["d_model"], m["vocab_size"], m["num_layers"]
    Dh = m["head_dim"]
    q, kv = m["num_heads"] * Dh, m["num_kv_heads"] * Dh
    E, f = m["moe"]["num_experts"], m["moe"]["d_ff_expert"]
    pd = param_dtype
    nrm = ("uniform", 0.8, 1.2)

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
            (b + ("attn", "wq"), (d, q), dense(d), pd),
            (b + ("attn", "wk"), (d, kv), dense(d), pd),
            (b + ("attn", "wv"), (d, kv), dense(d), pd),
            (b + ("attn", "wo"), (q, d), dense(q), pd),
            (b + ("attn", "q_norm"), (Dh,), nrm, pd),
            (b + ("attn", "k_norm"), (Dh,), nrm, pd),
            (b + ("ln2",), (d,), nrm, pd),
            (b + ("moe", "router"), (d, E), dense(d), "float32"),
            (b + ("moe", "wi_gate"), (E, d, f), dense(d), pd),
            (b + ("moe", "wi_up"), (E, d, f), dense(d), pd),
            (b + ("moe", "wo"), (E, f, d), dense(f), pd)]))
    return groups


def layer_of(group: Dict, i: int) -> Dict[str, torch.Tensor]:
    """A layer's leaves by their names under ``blocks[i]``, in f32."""
    return {"/".join(map(str, p[2:])): t.float() for p, t in group.items()}


def embed(group: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """[B, S] -> [B, S, d] f32."""
    return group[("embed", "embedding")].float()[tokens.long()]


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, Dh] rotated at positions 0..S-1."""
    S, Dh = x.shape[1], x.shape[-1]
    half = Dh // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)


def attention(m: Dict, p: Dict, x: torch.Tensor, prec: Prec) -> torch.Tensor:
    B, S, d = x.shape
    H, Hkv, Dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    eps = m.get("rms_eps", 1e-6)
    q = prec.mm(x, p["attn/wq"]).view(B, S, H, Dh)
    k = prec.mm(x, p["attn/wk"]).view(B, S, Hkv, Dh)
    v = prec.mm(x, p["attn/wv"]).view(B, S, Hkv, Dh)
    if m.get("qk_norm"):
        q = rmsnorm(q, p["attn/q_norm"], eps)
        k = rmsnorm(k, p["attn/k_norm"], eps)
    q, k = _rope(q, m["rope_theta"]), _rope(k, m["rope_theta"])
    rep = H // Hkv
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    out = torch.empty(B, S, H, Dh, device=x.device)
    for b in range(B):        # one row's [H, S, S] scores at a time
        s = prec.einsum("shd,thd->hst", q[b], k[b]) / math.sqrt(Dh)
        s = s.masked_fill(~mask, float("-inf")).softmax(-1)
        out[b] = prec.einsum("hst,thd->shd", s, v[b])
    return prec.mm(out.reshape(B, S, H * Dh), p["attn/wo"])


def _route(mo: Dict, p: Dict, x: torch.Tensor, prec: Prec):
    """x [T, d] -> (y [T, d], aux)."""
    T, d = x.shape
    E, k = mo["num_experts"], mo["experts_per_token"]
    C = max(int(mo["capacity_factor"] * T * k / E), k)
    probs = prec.mm(x, p["moe/router"]).softmax(-1)
    top, ids = probs.topk(k, dim=-1)
    gate = top / top.sum(-1, keepdim=True) \
        if mo.get("norm_topk_prob", True) else top
    share = F.one_hot(ids, E).float().sum(1).mean(0)
    aux = AUX * E * (probs.mean(0) * share).sum() / k
    flat = ids.reshape(-1)                                 # token-major
    onehot = F.one_hot(flat, E)
    pos = (onehot.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
    keep = pos < C
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    xe = torch.zeros(E, C, d, device=x.device)
    xe[flat[keep], pos[keep]] = x[tok[keep]]
    hid = F.silu(prec.einsum("ecd,edf->ecf", xe, p["moe/wi_gate"])) \
        * prec.einsum("ecd,edf->ecf", xe, p["moe/wi_up"])
    ye = prec.einsum("ecf,efd->ecd", hid, p["moe/wo"])
    w = (gate.reshape(-1) * keep).unsqueeze(1)
    back = ye[flat, pos.clamp(max=C - 1)] * w
    return back.view(T, k, d).sum(1), aux


def moe(m: Dict, p: Dict, x: torch.Tensor, prec: Prec):
    B, S, d = x.shape
    mo = m["moe"]
    xf = x.reshape(B * S, d)
    Tc = mo.get("chunk_tokens", 0)
    if Tc and xf.shape[0] > Tc and xf.shape[0] % Tc == 0:
        parts = [_route(mo, p, c, prec) for c in xf.split(Tc)]
        y = torch.cat([a for a, _ in parts])
        aux = sum(b for _, b in parts) / len(parts)
    else:
        y, aux = _route(mo, p, xf, prec)
    return y.view(B, S, d), aux


def layer(m: Dict, p: Dict, h: torch.Tensor, prec: Prec):
    """One block: (h, aux)."""
    eps = m.get("rms_eps", 1e-6)
    h = h + attention(m, p, rmsnorm(h, p["ln1"], eps), prec)
    y, aux = moe(m, p, rmsnorm(h, p["ln2"], eps), prec)
    return h + y, aux


def head(m: Dict, group: Dict, h: torch.Tensor, targets: torch.Tensor,
         prec: Prec) -> Dict[str, torch.Tensor]:
    B, S, d = h.shape
    return head_loss(prec, h.reshape(B * S, d), group[("final_norm",)],
                     group[("embed", "unembed")], targets.reshape(-1),
                     m.get("rms_eps", 1e-6))
