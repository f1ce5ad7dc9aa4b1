"""Where the wgmma flash kernel's time goes, at the main paths' shapes.

    PYTHONPATH=src python -m repro_torch.kernels.probe_flash

Builds ``csrc/flash_attention.cu`` as it is and in three variants, and
times each at the full-width causal bf16 shapes (S = 2048, D = 128) of
the qwen3-8b prefill (B=1, 32/8 heads), the jamba forward (B=4, 64/8) and
the qwen3-moe forward (B=4, 32/4), beside the mma.sync kernel and the two
``scaled_dot_product_attention`` calls (masked, and ``is_causal``):

- ``loads off``: the producer signals Q and each K/V stage full without
  loading it, so the consumers run on whatever shared memory holds: the
  kernel less its waits on TMA loads (full and empty barriers);
- ``stores off``: the epilogue stages its tile in shared memory but
  stores nothing to device memory;
- ``single P``: P V takes P's bf16 high part only (one wgmma a k16 step
  instead of two): the cost of the split, and, since this variant still
  computes attention, the error the split buys (``max_err`` against the
  plain version in f32).

``loads off`` and ``stores off`` compute garbage: only their times mean
anything.  Inputs are [B,S,H,D] tensors handed over as transposed views,
as ``ops.flash_attention`` hands them.  Variant sources and libraries go
to ``kernels/build/probe/`` (ignored by git).  Needs a CUDA card and nvcc;
prints the card and one JSON line a shape.
"""
from __future__ import annotations

import json

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import _probe
from repro_torch.kernels import flash_attention as fa

SHAPES = ((1, 32, 8), (4, 64, 8), (4, 32, 4))   # (B, Hq, Hkv)
S, D = 2048, 128
VARIANTS = {
    "loads off": (("mbar_expect_tx(q_full, (D / 64) * L::kQBox);",
                   "mbar_arrive(q_full); if (false)"),
                  ("mbar_expect_tx(kf, L::kKVBytes);",
                   "mbar_arrive(kf); if (false)"),
                  ("mbar_expect_tx(vf, L::kKVBytes);",
                   "mbar_arrive(vf); if (false)")),
    "stores off": (("tma_store_4d(&map_o, epi + j * L::kOBox, 64 * j, row0, "
                    "it.h, it.b);", "(void)j;"),),
    "single P": (("wgmma_rs<D>(acc, pl[kk], vd, 1);", ""),),
}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_flash needs a CUDA card")
    print(_probe.card(), flush=True)
    libs = {"as built": _build.load("flash_attention")}
    libs.update((n, _probe.variant_lib("flash_attention", n, e))
                for n, e in VARIANTS.items())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    mask = torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
    for B, Hq, Hkv in SHAPES:
        def rnd(H):
            return torch.randn(B, S, H, D, generator=gen, device="cuda",
                               dtype=torch.bfloat16).transpose(1, 2)
        q, k, v = rnd(Hq), rnd(Hkv), rnd(Hkv)
        want = fa.flash_attention_plain(q.float(), k.float(), v.float())
        row = dict(B=B, Hq=Hq, Hkv=Hkv, S=S, D=D)
        for name, lib in libs.items():
            # the wrapper finds the library it launches under this name
            _build._LOADED["flash_attention"] = (lib, 0.0, "")
            run = lambda: fa._launch(q, k, v, True, 0, "wgmma")
            row[f"wgmma {name} ms"] = _probe.device_ms(run)
            if name in ("as built", "single P"):
                row[f"wgmma {name} max_err"] = float(
                    (run().float() - want).abs().max())
        _build._LOADED["flash_attention"] = (libs["as built"], 0.0, "")
        row["mma_sync ms"] = _probe.device_ms(
            lambda: fa._launch(q, k, v, True, 0, "mma_sync"))
        row["sdpa masked ms"] = _probe.device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                   enable_gqa=True))
        row["sdpa is_causal ms"] = _probe.device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   enable_gqa=True))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
