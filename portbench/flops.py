"""The yardstick's arithmetic: the H100's peaks, a kernel entry's least
time (its roofline bound), and a model's FLOPs a token.

Frozen with the benchmark: a later change to the program cannot move
these counts.  ``attention_bound``, ``wkv_bound`` and ``mamba_bound`` are
the arithmetic the port's kernels were held to while they were written
(``chip_smoke.py``'s, the scan's at the H100's top clock); ``gmm_bound``
counts the routed rows that the capacity kept, not every slot of the
capacity buffer; ``model_flops_per_token`` counts the products a token
needs: its active experts only, attention's visible pairs, a hybrid's
layers by its layer pattern, no embedding lookup, recomputation not
counted.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

# NVIDIA H100 SXM data sheet, dense: bf16 on the tensor cores, f32 off them
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12          # HBM3, bytes a second
MFU_PEAK = PEAK_FLOPS["bfloat16"]
# exponentials on the special-function units: 16 a clock per SM (sm_90),
# 132 SMs, at the top SM clock
EXP_PER_S = 16 * 132 * 1.98e9

# the port's kernels by their __global__ functions' names
PORT_KERNELS = {
    "flash_attention": ("flash_fwd_bf16", "flash_fwd_f32",
                        "flash_wgmma_kernel"),
    "rwkv6_scan": ("wkv6_chunk",),
    "mamba_scan": ("mamba_scan_kernel",),
    "gmm": ("gmm_bf16_kernel", "gmm_f32_kernel", "gmm_wgmma_kernel"),
}
# a demangled kernel name's own symbol, after "void " and its namespaces:
# "void (anonymous namespace)::mamba_scan_kernel<16>(float const*, ...)"
_SYMBOL = re.compile(r"(?:void )?(?:(?:\(anonymous namespace\)|\w+)::)*(\w+)")


def port_kernel(key: str) -> Optional[str]:
    """The port kernel that a profiled kernel is, by its exact symbol, or
    None; "other" for any other kernel named like flash or gmm (a
    library's), which the port's counts must not take in."""
    sym = _SYMBOL.match(key).group(1)
    for name, syms in PORT_KERNELS.items():
        if sym in syms:
            return name
    return "other" if "flash" in key or "gmm" in key else None


def _itemsize(dtype_name: str) -> int:
    return 2 if dtype_name in ("bfloat16", "float16") else 4


def _bound(flops: float, nbytes: float, dtype_name: str
           ) -> Tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def causal_pairs(Sq: int, Skv: int, q_offset: int) -> int:
    """Visible (query, key) pairs of a causal mask: query i sees keys
    [0, min(Skv, q_offset + i + 1))."""
    if q_offset < 0:
        return sum(min(Skv, max(0, q_offset + i + 1)) for i in range(Sq))
    # rows i < Skv - q_offset - 1 see q_offset + i + 1 keys, the rest Skv
    n_part = min(Sq, max(0, Skv - q_offset - 1))
    part = n_part * q_offset + n_part * (n_part + 1) // 2
    return part + (Sq - n_part) * Skv


def attention_bound(B, Hq, Hkv, Sq, Skv, D, causal, q_offset, dtype_name
                    ) -> Tuple[float, str]:
    """(bound ms, what bounds it): QK^T and PV over the visible pairs
    against q, k, v read and o written once."""
    pairs = causal_pairs(Sq, Skv, q_offset) if causal else Sq * Skv
    flops = 4.0 * D * pairs * B * Hq          # QK^T and PV, 2 FLOP per MAC
    nbytes = _itemsize(dtype_name) * D * (2 * B * Hq * Sq + 2 * B * Hkv * Skv)
    return _bound(flops, nbytes, dtype_name)


def wkv_bound(B, H, S, D) -> Tuple[float, str]:
    """(bound ms, what bounds it) of the WKV6 function on 4-byte floats:
    r, k, v, w, u read once and y written once, against the f32
    operations of its cheapest form, the token-by-token recurrence
    S_t = diag(w_t) S_{t-1} + k_t^T v_t (3 D^2) and
    y_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t (2 D^2 + 5 D)."""
    flops = B * H * S * (5 * D * D + 5 * D)
    nbytes = 4 * (5 * B * H * S * D + H * D)
    return _bound(flops, nbytes, "float32")


def mamba_bound(B, S, di, N) -> Tuple[float, str]:
    """(bound ms, what bounds it) of the selective scan: dt and x read and
    y written (b, c and A read) in 4-byte floats, against its B S di N
    exponentials exp(dt A) on the special-function units and its 6 f32
    operations for each of them at peak.  The exponentials are inherent:
    A is a learned [di, N] matrix."""
    nbytes = 4 * (3 * B * S * di + 2 * B * S * N + di * N)
    exps = B * S * di * N
    t_ops = max(exps / EXP_PER_S, 6 * exps / PEAK_FLOPS["float32"])
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def gmm_bound(kept_rows: int, groups_used: int, K: int, N: int,
              dtype_name: str) -> Tuple[float, str]:
    """(bound ms, what bounds it) of one grouped product over the MoE's
    capacity buffer: 2 K N FLOPs for each routed row the capacity kept,
    against those rows read and their outputs written once and the
    weights of the groups that received a row read once.  Empty slots
    and the slot that parks dropped assignments are work these inputs do
    not need."""
    flops = 2.0 * kept_rows * K * N
    nbytes = _itemsize(dtype_name) * (kept_rows * (K + N)
                                      + groups_used * K * N)
    return _bound(flops, nbytes, dtype_name)


def model_flops_per_token(m: Dict, seq: int) -> float:
    """Forward FLOPs a token of a sequence of ``seq`` tokens, from the
    configuration's sizes ``m`` (the keys of ``configs/<name>.json``
    ``model``): 2 per multiply-add of every product the token needs, its
    ``experts_per_token`` experts and not the others, attention's causal
    pairs (on average (seq + 1) / 2 keys a query), WKV6's recurrence
    (``wkv_bound``'s 5 D^2 + 5 D a head), the unembedding; the
    embedding lookup and the elementwise work count nothing.  A hybrid
    counts each layer as its pattern makes it (``hybrid_layers``)."""
    d, L, V = m["d_model"], m["num_layers"], m["vocab_size"]
    if m.get("family") == "hybrid":
        return sum(_hybrid_layer(m, seq, mixer, ffn)
                   for mixer, ffn in hybrid_layers(m)) + 2 * d * V
    if m.get("rwkv"):
        r = m["rwkv"]
        H, D = d // r["head_dim"], r["head_dim"]
        per = 2 * 5 * d * d                              # r, k, v, g, o
        per += 2 * (d * 5 * r["mix_lora"] + 5 * r["mix_lora"] * d)
        per += 2 * (d * r["decay_lora"] + r["decay_lora"] * d)
        per += H * (5 * D * D + 5 * D)                   # WKV6
        per += 2 * (2 * d * m["d_ff"] + d * d)           # channel mix
        return L * per + 2 * d * V
    per = _attention(m, seq)
    moe = m.get("moe")
    if moe and moe["num_experts"] > 0:
        per += _experts(m)
    else:
        per += 2 * 3 * d * m["d_ff"]
    return L * per + 2 * d * V


def _attention(m: Dict, seq: int) -> float:
    """Attention's projections and its causal pairs, a token."""
    d = m["d_model"]
    q_dim = m["num_heads"] * m["head_dim"]
    kv_dim = m["num_kv_heads"] * m["head_dim"]
    per = 2 * d * (q_dim + 2 * kv_dim) + 2 * q_dim * d
    return per + 4 * q_dim * (seq + 1) / 2               # QK^T and PV


def _experts(m: Dict) -> float:
    """An MoE layer's router and its active experts, a token."""
    d, moe = m["d_model"], m["moe"]
    return 2 * d * moe["num_experts"] \
        + 2 * 3 * d * moe["d_ff_expert"] * moe["experts_per_token"]


def hybrid_layers(m: Dict):
    """Each layer of a hybrid, in order: (mixer, ffn), the mixer
    ``"attn"`` at position ``hybrid_attn_pos`` of each period of
    ``hybrid_period`` layers and ``"mamba"`` elsewhere, the FFN ``"moe"``
    where the position's index % ``moe_every`` is ``moe_offset`` (with
    experts) and ``"mlp"`` elsewhere."""
    P, moe = m["hybrid_period"], m.get("moe")
    experts = bool(moe and moe["num_experts"] > 0)
    for layer in range(m["num_layers"]):
        j = layer % P
        mixer = "attn" if j == m["hybrid_attn_pos"] else "mamba"
        sparse = experts and j % moe.get("moe_every", 1) \
            == moe.get("moe_offset", 0)
        yield mixer, "moe" if sparse else "mlp"


def _hybrid_layer(m: Dict, seq: int, mixer: str, ffn: str) -> float:
    """One hybrid layer's FLOPs a token.  A Mamba-1 mixer: in_proj
    2 d 2di, x_proj 2 di (R + 2N), dt_proj 2 R di, out_proj 2 di d, and
    the scan's 6 di N (``mamba_bound``'s operations)."""
    d = m["d_model"]
    if mixer == "attn":
        per = _attention(m, seq)
    else:
        mb = m["mamba"]
        di, N = mb["expand"] * d, mb["d_state"]
        R = mb.get("dt_rank") or -(-d // 16)
        per = 2 * d * 2 * di + 2 * di * (R + 2 * N) + 2 * R * di \
            + 2 * di * d + 6 * di * N
    return per + (_experts(m) if ffn == "moe" else 2 * 3 * d * m["d_ff"])
