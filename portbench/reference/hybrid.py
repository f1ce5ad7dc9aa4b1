"""Plain reference of a Jamba-style hybrid: superblocks of Mamba-1 and
attention layers, each layer followed by an MLP or a top-k mixture of
experts.  Its leaves, and its superblocks in f32.

The function, as the configuration states it (AI21's Jamba with the
port's capacity, aux and z-loss, which a configuration notes under
``assumed``):

- h0 = embedding[tokens]; a superblock is ``hybrid_period`` layers;
  layer j's mixer is attention where j = ``hybrid_attn_pos``, Mamba-1
  elsewhere, and its FFN the MoE where j % ``moe_every`` = ``moe_offset``
  (with experts), the SwiGLU MLP elsewhere (``flops.hybrid_layers``):
  h += mixer(rms(h) ln_mix[j]); h += ffn(rms(h) ln_ffn[j]); logits =
  rms(h) unembed; loss = ce + 1e-4 mean(lse^2) + the MoE layers' aux.
- Mamba-1 of x [B, S, d], di = expand d: xi, z = x W_in split in two;
  xc = silu(conv(xi) + conv_b), the causal depthwise conv over d_conv
  taps, the last on the current token; dt_r, b, c = xc W_x split
  [R, N, N], each RMS-normed (dt_norm, b_norm, c_norm); dt =
  softplus(dt_r W_dt + dt_bias); A = -exp(A_log); per channel and state,
  from zero, h_t = exp(dt_t A) h_{t-1} + dt_t xc_t b_t and y_t = h_t c_t;
  out = ((y + D xc) silu(z)) W_out.
- attention: no positional encoding (NoPE) and no qk-norm; q, k, v =
  x Wq, x Wk, x Wv split into heads; query head h reads kv head
  h // (Hq/Hkv); causal softmax(q k^T / sqrt(Dh)) v; o Wo.  Query rows
  are taken ``QUERY_ROWS`` at a time, so a long sequence's scores fit.
- experts: ``moe_decoder``'s (the port's capacity, drops, aux and chunks),
  the top-k weights renormalised unless ``moe.norm_topk_prob`` is false
  (true where the configuration does not say).
- MLP: (silu(x Wg) * (x Wu)) Wo.

Weights: a group a layer, so the largest draw is one layer's (an MoE
layer's experts); a superblock's ``ln_mix``/``ln_ffn`` [P, d] are in the
group of its first layer.  ``block`` runs a superblock a layer at a
time: each layer's group is made, run on every input and dropped.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.flops import hybrid_layers
from portbench.reference import moe_decoder
from portbench.reference.common import Prec, head_loss, rmsnorm

QUERY_ROWS = 1024      # attention's query rows a block of scores
SCAN_TOKENS = 512      # tokens whose decays and inputs the scan makes at once


def _dims(m: Dict) -> Tuple[int, int, int, int]:
    """(di, N, K, R) of the Mamba layers."""
    mb, d = m["mamba"], m["d_model"]
    return (mb["expand"] * d, mb["d_state"], mb["d_conv"],
            mb.get("dt_rank") or -(-d // 16))


def blocks(m: Dict) -> int:
    """The program's blocks: superblocks of ``hybrid_period`` layers."""
    if m.get("qkv_bias") or m.get("qk_norm") or m.get("rope_theta", 0) > 0:
        raise ValueError("the hybrid reference has NoPE attention without "
                         "biases or qk-norm")
    return m["num_layers"] // m["hybrid_period"]


def leaves(m: Dict, param_dtype: str) -> List:
    """Groups of leaves: the embedding and head, then one group a layer,
    each leaf at the path the program's tree has it."""
    d, V, P = m["d_model"], m["vocab_size"], m["hybrid_period"]
    Dh, f = m["head_dim"], m["d_ff"]
    q, kv = m["num_heads"] * Dh, m["num_kv_heads"] * Dh
    di, N, K, R = _dims(m)
    pd = param_dtype
    nrm = ("uniform", 0.8, 1.2)
    kinds = list(hybrid_layers(m))

    def dense(fan_in):
        return ("normal", 1.0 / math.sqrt(fan_in))

    groups = [("embed", [
        (("embed", "embedding"), (V, d), ("normal", 0.02), pd),
        (("embed", "unembed"), (d, V), dense(d), pd),
        (("final_norm",), (d,), nrm, pd)])]
    for blk in range(blocks(m)):
        b = ("blocks", blk)
        im = il = io = 0
        for j in range(P):
            mixer, ffn = kinds[blk * P + j]
            out = [] if j else [(b + ("ln_mix",), (P, d), nrm, pd),
                                (b + ("ln_ffn",), (P, d), nrm, pd)]
            if mixer == "attn":
                a = b + ("attn",)
                out += [(a + ("wq",), (d, q), dense(d), pd),
                        (a + ("wk",), (d, kv), dense(d), pd),
                        (a + ("wv",), (d, kv), dense(d), pd),
                        (a + ("wo",), (q, d), dense(q), pd)]
            else:
                s = b + ("mamba", im)
                im += 1
                out += [
                    (s + ("in_proj",), (d, 2 * di), dense(d), pd),
                    (s + ("conv_w",), (K, di), dense(K), pd),
                    (s + ("conv_b",), (di,), ("uniform", -0.5, 0.5), pd),
                    (s + ("x_proj",), (di, R + 2 * N), dense(di), pd),
                    (s + ("dt_proj",), (R, di), dense(R), pd),
                    # softplus^-1 of [1e-3, 1e-1], the port's init's range
                    (s + ("dt_bias",), (di,), ("uniform", -6.9, -2.25), pd),
                    (s + ("A_log",), (di, N), ("uniform", 0.0, 2.8),
                     "float32"),
                    (s + ("D",), (di,), ("uniform", 0.5, 1.5), "float32"),
                    (s + ("out_proj",), (di, d), dense(di), pd),
                    (s + ("dt_norm",), (R,), nrm, pd),
                    (s + ("b_norm",), (N,), nrm, pd),
                    (s + ("c_norm",), (N,), nrm, pd)]
            if ffn == "moe":
                e = b + ("moe", io)
                io += 1
                E, fe = m["moe"]["num_experts"], m["moe"]["d_ff_expert"]
                out += [(e + ("router",), (d, E), dense(d), "float32"),
                        (e + ("wi_gate",), (E, d, fe), dense(d), pd),
                        (e + ("wi_up",), (E, d, fe), dense(d), pd),
                        (e + ("wo",), (E, fe, d), dense(fe), pd)]
            else:
                e = b + ("mlp", il)
                il += 1
                out += [(e + ("wi_gate",), (d, f), dense(d), pd),
                        (e + ("wi_up",), (d, f), dense(d), pd),
                        (e + ("wo",), (f, d), dense(f), pd)]
            groups.append((f"block{blk}.layer{j}", out))
    return groups


def embed(group: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """[B, S] -> [B, S, d] f32."""
    return group[("embed", "embedding")].float()[tokens.long()]


def scan(A: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
         c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The selective scan from a zero state: h_t = exp(dt_t A) h_{t-1} +
    dt_t x_t b_t, y_t = h_t c_t.  A [di, N]; dt, x [B, S, di]; b, c
    [B, S, N] -> y [B, S, di].  ``SCAN_TOKENS`` tokens' decays and inputs
    are made at once, then stepped a token at a time."""
    B, S, di = x.shape
    h = x.new_zeros(B, di, A.shape[1])
    tok = lambda t: t.transpose(0, 1).contiguous()     # token-major
    ys = []
    for t0 in range(0, S, SCAN_TOKENS):
        cut = slice(t0, t0 + SCAN_TOKENS)
        dtc, xc, bc = tok(dt[:, cut]), tok(x[:, cut]), tok(b[:, cut])
        decay = torch.exp(dtc[..., None] * A)          # [T, B, di, N]
        hs = (dtc * xc)[..., None] * bc[:, :, None, :]  # inputs, then states
        for t in range(hs.shape[0]):
            h = torch.addcmul(hs[t], decay[t], h, out=hs[t])
        ys.append(torch.einsum("tbdn,tbn->btd", hs, tok(c[:, cut])))
    return torch.cat(ys, 1)


def mamba(m: Dict, p: Dict, x: torch.Tensor, prec: Prec) -> torch.Tensor:
    B, S, d = x.shape
    di, N, K, R = _dims(m)
    eps = m.get("rms_eps", 1e-6)
    xi, z = prec.mm(x, p["mamba/in_proj"]).split(di, -1)
    w, left = p["mamba/conv_w"], F.pad(xi, (0, 0, K - 1, 0))
    xc = F.silu(sum(left[:, i:i + S] * w[i] for i in range(K))
                + p["mamba/conv_b"])
    dt_r, b, c = prec.mm(xc, p["mamba/x_proj"]).split([R, N, N], -1)
    dt = F.softplus(prec.mm(rmsnorm(dt_r, p["mamba/dt_norm"], eps),
                            p["mamba/dt_proj"]) + p["mamba/dt_bias"])
    y = scan(-torch.exp(p["mamba/A_log"]), dt,
             rmsnorm(b, p["mamba/b_norm"], eps),
             rmsnorm(c, p["mamba/c_norm"], eps), xc)
    return prec.mm((y + xc * p["mamba/D"]) * F.silu(z), p["mamba/out_proj"])


def attention(m: Dict, p: Dict, x: torch.Tensor, prec: Prec) -> torch.Tensor:
    B, S, d = x.shape
    H, Hkv, Dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    q = prec.mm(x, p["attn/wq"]).view(B, S, H, Dh)
    k = prec.mm(x, p["attn/wk"]).view(B, S, Hkv, Dh)
    v = prec.mm(x, p["attn/wv"]).view(B, S, Hkv, Dh)
    k = k.repeat_interleave(H // Hkv, dim=2)
    v = v.repeat_interleave(H // Hkv, dim=2)
    out = torch.empty(B, S, H, Dh, device=x.device)
    keys = torch.arange(S, device=x.device)
    for b in range(B):
        for r0 in range(0, S, QUERY_ROWS):
            r1 = min(r0 + QUERY_ROWS, S)       # these rows see keys < r1
            s = prec.einsum("shd,thd->hst", q[b, r0:r1], k[b, :r1]) \
                / math.sqrt(Dh)
            later = keys[None, :r1] > keys[r0:r1, None]
            s = s.masked_fill(later, float("-inf")).softmax(-1)
            out[b, r0:r1] = prec.einsum("hst,thd->shd", s, v[b, :r1])
    return prec.mm(out.reshape(B, S, H * Dh), p["attn/wo"])


def mlp(p: Dict, x: torch.Tensor, prec: Prec) -> torch.Tensor:
    return prec.mm(F.silu(prec.mm(x, p["mlp/wi_gate"]))
                   * prec.mm(x, p["mlp/wi_up"]), p["mlp/wo"])


def layer(m: Dict, p: Dict, ln: Dict, j: int, kind: Tuple[str, str],
          h: torch.Tensor, prec: Prec):
    """Layer j of a superblock, its (mixer, ffn) ``kind``: (h, aux or
    None)."""
    eps = m.get("rms_eps", 1e-6)
    x = rmsnorm(h, ln["ln_mix"][j], eps)
    h = h + (attention if kind[0] == "attn" else mamba)(m, p, x, prec)
    x = rmsnorm(h, ln["ln_ffn"][j], eps)
    if kind[1] == "moe":
        y, aux = moe_decoder.moe(m, p, x, prec)
        return h + y, aux
    return h + mlp(p, x, prec), None


def block(m: Dict, make: Callable[[int], Dict], b: int,
          xs: List[torch.Tensor], prec: Prec
          ) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """Superblock b on each of ``xs``: [(h, its layers' aux or None)].
    ``make(g)`` makes weight group g; one layer's group lives at a
    time."""
    P = m["hybrid_period"]
    kinds = list(hybrid_layers(m))[b * P:(b + 1) * P]
    hs, aux = list(xs), [None] * len(xs)
    ln = {}
    for j in range(P):
        p = {}
        for path, t in make(1 + b * P + j).items():
            if path[2] in ("ln_mix", "ln_ffn"):
                ln[path[2]] = t.float()
            else:
                p[f"{path[2]}/{path[-1]}"] = t.float()
        for n, h in enumerate(hs):
            hs[n], a = layer(m, p, ln, j, kinds[j], h, prec)
            if a is not None:
                aux[n] = a if aux[n] is None else aux[n] + a
        del p
    return list(zip(hs, aux))


def head(m: Dict, group: Dict, h: torch.Tensor, targets: torch.Tensor,
         prec: Prec) -> Dict[str, torch.Tensor]:
    B, S, d = h.shape
    return head_loss(prec, h.reshape(B * S, d), group[("final_norm",)],
                     group[("embed", "unembed")], targets.reshape(-1),
                     m.get("rms_eps", 1e-6))
