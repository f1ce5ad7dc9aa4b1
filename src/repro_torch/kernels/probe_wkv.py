"""Where the WKV6 kernel's time goes, at the rwkv6-3b shapes.

    PYTHONPATH=src python -m repro_torch.kernels.probe_wkv

Builds ``csrc/rwkv6_scan.cu`` as it is and in variants with one part of
the work taken out, and times the wrapper's two launches (zeroing the
flags, the kernel: CUDA events around each, mean of 20 calls) and the
whole call at S = 2048, H = 40, D = 64 and B in {1, 4}:

- ``no diagonal``: A's diagonal 16 x 16 blocks (running products of w,
  and the bonus) are not computed;
- ``no off-diagonal``: A's off-diagonal blocks (rq g kl^T) are not;
- ``no state product``: U_c is not summed;
- ``no wait``: a block does not wait for the state of the chunk before
  it (the state pass's chain, less its loads and stores);
- ``no y product``: neither (r 2^{L_{t-1}}) E_c nor A v is summed;
- ``y a from registers`` / ``y b from registers``: the y product takes
  one of its operands from registers instead of shared memory;
- ``no tiles``: the factored tiles rq and kl are not scaled (two
  exponentials a row and channel);
- ``no device memory``: no row of r, k, v, w is loaded (the tiles hold
  the padding of a ragged chunk) and no row of y stored; the states
  still pass through device memory;
- ``two blocks an SM`` and ``one block an SM``: the kernel asks for 32
  or 96 KB more shared memory than it uses, so only two blocks (one) fit
  on an SM instead of three: how much the other blocks' overlap buys.

Each variant computes garbage: only its times mean anything.  Inputs are
[B,S,H,D] tensors handed over as transposed views, as ``ops.rwkv6_scan``
hands them.  Variant sources and libraries go to ``kernels/build/probe/``
(ignored by git).  Needs a CUDA card and nvcc; prints the card and one
JSON line a shape.
"""
from __future__ import annotations

import json

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import _probe
from repro_torch.kernels import rwkv6_scan as rw

H, S, D = 40, 2048, 64
BATCHES = (1, 4)
VARIANTS = {
    "no diagonal": (("for (int gq = 0; gq < G4; ++gq) {",
                     "for (int gq = 0; gq < 0; ++gq) {"),),
    "no off-diagonal": (("for (int d = half * (D / 2); d < (half + 1) * "
                         "(D / 2); d += 4) {",
                         "for (int d = 0; d < 0; d += 4) {"),),
    "no state product": (("for (int j = 0; j < (c < NC - 1 ? NSUB : 0); ++j) {",
                          "for (int j = 0; j < 0; ++j) {"),),
    "no wait": (("while (*f == 0) {", "while (false) {"),),
    "no y product": (("  if (c > 0)\n    for (int d = 0; d < D; d += 4)\n"
                      "      mac4<YM>", "  if (false)\n    for (int d = 0; "
                      "d < D; d += 4)\n      mac4<YM>"),
                     ("const int send = SUB * (t0 / SUB + 1);",
                      "const int send = 0;")),
    "y a from registers": (("const float4 x = *reinterpret_cast<const float4*>"
                            "(a + m * as);",
                            "const float4 x = make_float4(m, as, 1.f, 2.f);"),),
    "y b from registers": (("bq[q] = *reinterpret_cast<const float4*>"
                            "(b + q * bs);",
                            "bq[q] = make_float4(q, bs, 1.f, 2.f);"),),
    "no tiles": (("for (int e = tid; e < C * D / 4; e += NT) {\n"
                  "    const int t = e / (D / 4), d = 4 * (e % (D / 4));\n"
                  "    float* x = sR", "for (int e = C * D; e < C * D / 4; "
                  "e += NT) {\n    const int t = e / (D / 4), d = 4 * "
                  "(e % (D / 4));\n    float* x = sR"),),
    "no device memory": (("const int c0 = c * C, n = min(C, S - c0);",
                          "const int c0 = c * C, n = 0 * min(C, S - c0);"),),
    "two blocks an SM": (("const int bytes = smem_floats<D>() * "
                          "(int)sizeof(float);", "const int bytes = "
                          "(smem_floats<D>() + 8192) * (int)sizeof(float);"),),
    "one block an SM": (("const int bytes = smem_floats<D>() * "
                         "(int)sizeof(float);", "const int bytes = "
                         "(smem_floats<D>() + 24576) * (int)sizeof(float);"),),
}


def pass_ms(run, iters: int = 20) -> dict:
    """Mean device ms of each launch of ``run(mark)`` over ``iters`` calls,
    after 3 warm-up calls."""
    for _ in range(3):
        run(None)
    marks = []

    def mark(name):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((name, event))

    for _ in range(iters):
        run(mark)
    torch.cuda.synchronize()
    out = {}
    for (name, a), (_, b) in zip(marks, marks[1:]):
        if name is not None:
            out[name] = out.get(name, 0.0) + a.elapsed_time(b) / iters
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_wkv needs a CUDA card")
    print(_probe.card(), flush=True)
    libs = {"as built": _build.load("rwkv6_scan")}
    libs.update((n, _probe.variant_lib("rwkv6_scan", n, e))
                for n, e in VARIANTS.items())
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for B in BATCHES:
        def rnd():
            return torch.randn(B, S, H, D, generator=gen,
                               device="cuda").transpose(1, 2)
        r, k, v = rnd(), rnd(), rnd()
        w = torch.exp(-torch.exp(rnd()))
        u = torch.randn(H, D, generator=gen, device="cuda")
        row = dict(B=B, H=H, S=S, D=D)
        for name, lib in libs.items():
            # the wrapper finds the library it launches under this name
            _build._LOADED["rwkv6_scan"] = (lib, 0.0, "")
            row[name] = pass_ms(lambda m: rw._launch(r, k, v, w, u, mark=m))
            row[name]["total"] = _probe.device_ms(
                lambda: rw._launch(r, k, v, w, u))
        _build._LOADED["rwkv6_scan"] = (libs["as built"], 0.0, "")
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
