"""Where the selective-scan kernel's time goes, at jamba's shapes.

    PYTHONPATH=src python -m repro_torch.kernels.probe_mamba
    PYTHONPATH=<tree>/src python src/repro_torch/kernels/probe_mamba.py \\
        --wrapper-only

Builds ``csrc/mamba_scan.cu`` as it is and in variants with one part of
the work taken out, and times one launch (CUDA events, mean of 20 calls)
at S = 2048, d_inner = 16384, N = 16 and B in {1, 4} (the jamba forward
is B = 4, its prefill B = 1):

- ``with hT``: the kernel also writes the final state (prefill's call);
- ``spt=4``: 4 states a thread (8 lanes a channel) instead of 8;
- ``no exponentials``: a multiply takes the place of each ``ex2``;
- ``no device memory``: no tile of dt, x, b, c is copied in and no y
  stored (the ring holds whatever it holds);
- ``no y reduction``: the lanes of a channel do not sum their parts;
- ``b and c from registers``: b_t and c_t are not read from shared
  memory (each lane takes values it holds);
- ``two blocks an SM`` and ``one block an SM``: the launch asks for
  dynamic shared memory that only two (one) blocks fit: how much the
  other blocks' overlap buys;
- ``two stages``, ``four stages``: a ring of two or four tiles;
- ``64 registers``, ``128 registers``: the register cap of four (two)
  blocks an SM instead of three;
- ``streaming stores``: y's rows stored with the evict-first hint.

``under load`` is the SM clock and power draw that nvidia-smi reads while
the kernel runs back to back.

Each of those variants computes garbage: only its times mean anything.
Two more compute the same function another way, and are timed too:

- ``hi-lo argument``: the exponent dt * A * log2 e with log2 e split in
  a high and a low float, nearly exact before ``ex2``;
- ``IEEE expf``: ``expf(dt * A)``, as the plain version computes it.

Their accuracy, and the kernel's, is printed under weak decay over
serving's longest prompt, (B, S) = (1, 4096) with every dt 1e-3 or
1e-2: the scaled error (max |error| / (max |reference| + 1)) of y and
hT against the plain version in float32 and in float64.  With
``--wrapper-only`` it times only the package's ``mamba_scan`` wrapper at
both shapes, as whatever tree is first on the path builds it, so a parent
commit's kernel can be timed beside this one in one call (before and
after a change to the kernel).  Variant sources and
libraries go to ``kernels/build/probe/`` (ignored by git).  Needs a CUDA
card and nvcc; prints the card and one JSON line a shape or dt.
"""
from __future__ import annotations

import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import _probe
from repro_torch.kernels import mamba_scan as mb

S, DI, N = 2048, 16384, 16
BATCHES = (1, 4)
_BYTES = "const int bytes = Sh::SMEM_FLOATS * (int)sizeof(float);"
VARIANTS = {
    "no exponentials": (("h[i] = fmaf(ex2(dtv * a2[i]), h[i], dtx * bb[i]);",
                         "h[i] = fmaf(dtv * a2[i], h[i], dtx * bb[i]);"),),
    "no loads": (("if (s < ntiles) load(", "if (di < 0) load("),
                 ("if (kn < ntiles) load(", "if (di < 0) load(")),
    "no stores": (("if (k > 0) store_y(", "if (di < 0) store_y("),
                  ("  store_y((ntiles - 1)", "  if (di < 0) store_y((ntiles - 1)")),
    "no device memory": (("if (s < ntiles) load(", "if (di < 0) load("),
                         ("if (kn < ntiles) load(", "if (di < 0) load("),
                         ("if (k > 0) store_y(", "if (di < 0) store_y("),
                         ("  store_y((ntiles - 1)",
                          "  if (di < 0) store_y((ntiles - 1)")),
    "no y reduction": (("for (int m = CPW; m < 32; m <<= 1)",
                        "for (int m = 32; m < 32; m <<= 1)"),),
    "b and c from registers": (
        ("lds<SPT>(bb, tb + j * N);\n      lds<SPT>(cc, tc + j * N);",
         "for (int i = 0; i < SPT; ++i) {\n        bb[i] = a2[i];\n"
         "        cc[i] = a2[SPT - 1 - i];\n      }"),),
    "two stages": (("constexpr int NS = 3;", "constexpr int NS = 2;"),),
    "four stages": (("constexpr int NS = 3;", "constexpr int NS = 4;"),),
    "64 registers": (("__launch_bounds__(NT, 3)", "__launch_bounds__(NT, 4)"),),
    "128 registers": (("__launch_bounds__(NT, 3)", "__launch_bounds__(NT, 2)"),),
    "streaming stores": (("*reinterpret_cast<float4*>(y + (row0 + t0 + j) * di + d0 + k) =\n              *reinterpret_cast<const float4*>(ty + j * CB + k);",
                          "__stcs(reinterpret_cast<float4*>(y + (row0 + t0 + j) * di + d0 + k), *reinterpret_cast<const float4*>(ty + j * CB + k));"),),
    "spt=4": (("constexpr int SPT = 8;", "constexpr int SPT = 4;"),),
    "two blocks an SM": ((_BYTES, "const int bytes = 100 * 1024;"),),
    "one block an SM": ((_BYTES, "const int bytes = 200 * 1024;"),),
}


_EX2 = "ex2(dtv * a2[i])"
EXP_VARIANTS = {
    "hi-lo argument": (
        ("float a2[SPT], h[SPT];", "float a2[SPT], al[SPT], h[SPT];"),
        ("a2[i] = active ? A[(long long)d * N + q * SPT + i] * LOG2E : 0.f;",
         "const float av = active ? A[(long long)d * N + q * SPT + i] : 0.f;"
         "\n    a2[i] = av * LOG2E;"
         "\n    al[i] = fmaf(av, LOG2E, -a2[i]) + av * 1.925963033e-8f;"),
        (_EX2, "ex2(fmaf(dtv, a2[i], dtv * al[i]))")),
    "IEEE expf": (("* LOG2E : 0.f;", ": 0.f;"), (_EX2, "expf(dtv * a2[i])")),
}
ACCURACY_S, ACCURACY_DTS = 4096, (1e-3, 1e-2)


def _inputs(B: int, gen: torch.Generator, S: int = S, dt=None):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    A = -torch.exp(rnd(DI, N))
    dt = (torch.nn.functional.softplus(rnd(B, S, DI)) if dt is None
          else torch.full((B, S, DI), dt, device="cuda"))
    return A, dt, rnd(B, S, N), rnd(B, S, N), rnd(B, S, DI)


def _err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.double() - ref).abs().max()) / \
        (float(ref.abs().max()) + 1.0)


def accuracy(libs, gen: torch.Generator, dt: float) -> dict:
    """Scaled errors of y and hT under weak decay for the kernel as built
    and each of ``EXP_VARIANTS``, and of the f32 plain version, against
    the plain version in float64 (and the kernels' against f32's)."""
    args = _inputs(1, gen, ACCURACY_S, dt)
    f32 = mb.mamba_scan_plain(*args, return_state=True)
    f64 = mb.mamba_scan_plain(*args, return_state=True, dtype=torch.float64)
    row = dict(B=1, S=ACCURACY_S, di=DI, N=N, dt=dt,
               plain_vs_f64=[_err(g, r) for g, r in zip(f32, f64)])
    y, hT = torch.empty_like(args[-1]), torch.empty(1, DI, N, device="cuda")
    for name in ("as built", *EXP_VARIANTS):
        _build._LOADED["mamba_scan"] = (libs[name], 0.0, "")
        mb._launch(*args, y, hT)
        row[name] = dict(vs_f32=[_err(y, f32[0].double()),
                                 _err(hT, f32[1].double())],
                         vs_f64=[_err(y, f64[0]), _err(hT, f64[1])])
    _build._LOADED["mamba_scan"] = (libs["as built"], 0.0, "")
    return row


def under_load(fn, seconds: float = 1.0) -> str:
    """The SM clock and power draw that nvidia-smi reads while ``fn`` runs
    back to back for about ``seconds``."""
    ms = _probe.device_ms(fn, iters=5)
    for _ in range(int(seconds * 1e3 / ms)):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    torch.cuda.synchronize()
    return out


def wrapper_only() -> None:
    """Times ``mamba_scan`` as the importable package defines it."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for B in BATCHES:
        args = _inputs(B, gen)
        ms = _probe.device_ms(lambda: mb.mamba_scan(*args))
        print(json.dumps(dict(B=B, S=S, di=DI, N=N, wrapper_ms=ms,
                              source=str(_build.CSRC / "mamba_scan.cu"))),
              flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_mamba needs a CUDA card")
    print(_probe.card(), flush=True)
    if "--wrapper-only" in sys.argv[1:]:
        wrapper_only()
        return
    libs = {"as built": _build.load("mamba_scan")}
    for line in _build.build_report("mamba_scan")[1].splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    variants = {**VARIANTS, **EXP_VARIANTS}
    with ThreadPoolExecutor(len(variants)) as pool:   # one nvcc each
        libs.update(zip(variants, pool.map(
            lambda item: _probe.variant_lib("mamba_scan", *item),
            variants.items())))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for B in BATCHES:
        A, dt, b, c, x = _inputs(B, gen)
        y = torch.empty_like(x)
        hT = torch.empty(B, DI, N, device="cuda")
        row = dict(B=B, S=S, di=DI, N=N, spt=mb.STATES_PER_THREAD)

        def launch(lib, h=None):
            # the wrapper finds the library it launches under this name
            _build._LOADED["mamba_scan"] = (lib, 0.0, "")
            return _probe.device_ms(
                lambda: mb._launch(A, dt, b, c, x, y, h))

        row["as built"] = launch(libs["as built"])
        row["with hT"] = launch(libs["as built"], h=hT)
        for name in variants:
            row[name] = launch(libs[name])
        _build._LOADED["mamba_scan"] = (libs["as built"], 0.0, "")
        # last: a second of back-to-back launches warms the card
        row["under load"] = under_load(
            lambda: mb._launch(A, dt, b, c, x, y, None))
        print(json.dumps(row), flush=True)
    for dt in ACCURACY_DTS:
        print(json.dumps(accuracy(libs, gen, dt)), flush=True)


if __name__ == "__main__":
    main()
