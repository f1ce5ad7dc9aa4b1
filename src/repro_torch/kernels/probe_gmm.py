"""Where the wgmma gmm kernel's time goes, at the qwen3-moe shapes, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.probe_gmm

Builds ``csrc/gmm.cu`` as it is and in two variants, and times each on
the six qwen3-moe expert products (128 groups; 641, 161 and 9 rows a
group; gate/up and down widths) beside the mma.sync kernel and
``torch.bmm``:

- ``loads off``: the producer signals each stage full without loading it,
  so the consumers run their products on whatever the ring holds: the
  kernel less its waits on TMA loads (full and empty barriers);
- ``stores off``: the epilogue stages its tile in shared memory but
  stores nothing to device memory.

The variants compute garbage: only their times mean anything.  Variant
sources and libraries go to ``kernels/build/probe/`` (ignored by git).
Needs a CUDA card and nvcc; prints one JSON line a shape.
"""
from __future__ import annotations

import json

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import _probe
from repro_torch.kernels import gmm as gm

SHAPES = ((641, 2048, 768), (641, 768, 2048), (161, 2048, 768),
          (161, 768, 2048), (9, 2048, 768), (9, 768, 2048))
GROUPS = 128
VARIANTS = {
    "loads off": (("mbar_expect_tx(full, bytes);",
                   "mbar_arrive(full); if (true) { if (++stage == wStages) "
                   "{ stage = 0; phase ^= 1; } continue; }"),),
    "stores off": (("tma_store_2d(&map_out, epi + j * wBox, n0 + 64 * j, "
                    "row0);", "(void)j;"),
                   ("if (n0 + 8 * i < N)\n", "if (n0 + 8 * i < 0)\n")),
}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_gmm needs a CUDA card")
    print(_probe.card(), flush=True)
    libs = {"as built": _build.load("gmm")}
    libs.update((n, _probe.variant_lib("gmm", n, e))
                for n, e in VARIANTS.items())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for R, K, N in SHAPES:
        x = torch.randn(GROUPS, R, K, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(GROUPS, K, N, generator=gen, device="cuda")
             * K ** -0.5).bfloat16()
        lhs = x.view(GROUPS * R, K)
        row = dict(rows=R, K=K, N=N)
        for name, lib in libs.items():
            # the wrapper finds the library it launches under "gmm"
            _build._LOADED["gmm"] = (lib, 0.0, "")
            row[f"wgmma {name} ms"] = _probe.device_ms(
                lambda: gm._launch(lhs, w, None, R, "wgmma"))
        _build._LOADED["gmm"] = (libs["as built"], 0.0, "")
        row["mma_sync ms"] = _probe.device_ms(
            lambda: gm._launch(lhs, w, None, R, "mma_sync"))
        row["bmm ms"] = _probe.device_ms(lambda: torch.bmm(x, w))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
