"""The MoE dispatch and combine kernels at qwen3-moe's scoring layer, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.probe_moe_permute

One MoE layer of the scoring cell (T 8192 tokens, top-8 of 128 experts,
capacity 640, d 2048, bf16), routed by the layer's own ``_slots`` with a
Zipf prior over the experts, so that about as many assignments are kept
as in the cell (25,229 of 65,536).  Times, by CUDA events over 20 calls
after 3 warm-up calls:

- ``moe_dispatch`` and ``moe_combine`` (``csrc/moe_permute.cu``), each
  beside its bound (bytes at 3.35 TB/s: the buffer written once and the
  kept rows read; the kept rows read and [T, d] written);
- their plain versions on the card;
- the ``"xla"`` path's ``index_add_dispatch`` and ``gather_combine``
  (``models/moe.py``).

Prints nvcc's register report for the library, then one JSON line.  Needs a
CUDA card and nvcc.
"""
from __future__ import annotations

import json
import re
import types

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import _probe
from repro_torch.kernels import moe_permute as mp
from repro_torch.kernels import ops
from repro_torch.models import moe as tmoe

T, E, K, D = 8192, 128, 8, 2048
CAPACITY_FACTOR = 1.25
ZIPF = 0.85          # the prior's exponent: ~38% of the assignments kept
HBM_BYTES_PER_S = 3.35e12


def routes(seed: int = 0, tokens: int = T, *, experts: int = E, k: int = K,
           d: int = D, zipf: float = ZIPF, norm_topk_prob: bool = True):
    """(x [tokens,d] bf16, ids, pos [tokens,k], gate_w [tokens,k], C) on
    the card (C = k at a decode tick's few tokens).  By default qwen3-moe's
    layer; jamba2-mini's is ``experts=16, k=2, d=4096, zipf=0`` (no prior:
    about 80% of its slots filled) with ``norm_topk_prob=False``."""
    m = types.SimpleNamespace(num_experts=experts, experts_per_token=k,
                              capacity_factor=CAPACITY_FACTOR,
                              norm_topk_prob=norm_topk_prob)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(tokens, d, generator=gen, device="cuda")
    router = torch.randn(d, experts, generator=gen, device="cuda") * d ** -0.5
    x[:, 0] = 1.0
    router[0] = -zipf * torch.log(torch.arange(1, experts + 1, device="cuda",
                                               dtype=torch.float32))
    C = tmoe._capacity(m, tokens)
    ids, pos, _, gate_w, _ = tmoe._slots(m, router, x, C)
    return (x.bfloat16(), ids.view(tokens, k), pos.view(tokens, k), gate_w,
            C)


def bounds_ms(tokens: int, C: int, kept: int, itemsize: int = 2, *,
              experts: int = E, d: int = D):
    """(dispatch, combine) bound ms, bytes at 3.35 TB/s: the buffer
    [experts, C+1, d] written once and the kept rows read; the kept rows
    read and [tokens, d] written."""
    row = itemsize * d
    return ((experts * (C + 1) + kept) * row / HBM_BYTES_PER_S * 1e3,
            (kept + tokens) * row / HBM_BYTES_PER_S * 1e3)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_moe_permute needs a CUDA card")
    print(_probe.card(), flush=True)
    _build.load("moe_permute")
    _, log = _build.build_report("moe_permute")
    for line in log.splitlines():
        if re.search(r"Compiling entry|Used \d+ registers", line):
            print(line.strip(), flush=True)
    x, ids, pos, gate_w, C = routes()
    kept = int((pos < C).sum())
    flat = ids.reshape(-1), pos.reshape(-1)
    keep = (pos < C).reshape(-1)
    ye = ops.moe_dispatch(x, ids, pos, E, C)
    out = dict(T=T, E=E, k=K, C=C, d=D, kept=kept)
    out["dispatch_bound_ms"], out["combine_bound_ms"] = bounds_ms(T, C, kept)
    timed = {
        "dispatch_ms": lambda: ops.moe_dispatch(x, ids, pos, E, C),
        "dispatch_plain_ms": lambda: mp.moe_dispatch_plain(x, ids, pos, E, C),
        "dispatch_index_add_ms": lambda: tmoe.index_add_dispatch(x, *flat,
                                                                 E, C),
        "combine_ms": lambda: ops.moe_combine(ye, ids, pos, gate_w),
        "combine_plain_ms": lambda: mp.moe_combine_plain(ye, ids, pos,
                                                         gate_w),
        "combine_gather_ms": lambda: tmoe.gather_combine(ye, *flat, keep,
                                                         gate_w),
    }
    for name, fn in timed.items():
        out[name] = _probe.device_ms(fn)
    for half in ("dispatch", "combine"):
        out[f"{half}_roofline_pct"] = 100 * out[f"{half}_bound_ms"] \
            / out[f"{half}_ms"]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
