#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):
  1. card   - requires CUDA; prints the card's name and power limit;
  2. build  - compiles every kernel of the serving path from the sources
              in this checkout (nvcc, sm_90a) and prints the build time;
  3. kernel - holds the flash-attention kernel against its plain PyTorch
              version at the serving path's shapes, and times kernel,
              plain version, torch's scaled_dot_product_attention (a
              yardstick only; the port never calls it) and the bound;
  4. serve  - full-width qwen3-8b (bf16, seeded random weights) behind
              ServeEngine: 8 requests, 4 slots; checks the kernel's
              launch count, finite logits, and the prefill logits against
              the plain-attention path of the same model (in f32
              activations; the bf16 distances are printed); then profiles
              one decode tick and one tick with a 2048-token prefill;
then prints a JSON line of kernel numbers and, last, the JSON result line.
Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# published H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor cores,
# f32 outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

ARCH = "qwen3-8b"
PROMPT_LENS = (128, 256, 512, 777, 1024, 1500, 2048, 64)
MAX_NEW = 32
SLOTS = 4
MAX_LEN = 4096
SEED = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(B, Hq, Hkv, Sq, Skv, D, causal, q_offset, dtype_name):
    """(bound ms, what bounds it): unmasked FLOPs vs bytes read + written."""
    if causal:
        pairs = sum(min(Skv, max(0, q_offset + i + 1)) for i in range(Sq))
    else:
        pairs = Sq * Skv
    flops = 4.0 * D * pairs * B * Hq          # QK^T and PV, 2 FLOP per MAC
    itemsize = 2 if dtype_name == "bfloat16" else 4
    nbytes = itemsize * D * (2 * B * Hq * Sq + 2 * B * Hkv * Skv)
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kernel_cases(torch, fa):
    """Kernel vs plain version on the card; returns one dict per case."""
    import torch.nn.functional as F
    cases = []
    for s in (128, 1024, 2048, 777):
        cases.append(dict(B=1, Hq=32, Hkv=8, Sq=s, Skv=s, D=128, causal=True,
                          q_offset=0, dtype="bfloat16"))
    cases.append(dict(B=1, Hq=32, Hkv=8, Sq=128, Skv=384, D=128, causal=True,
                      q_offset=256, dtype="bfloat16"))
    cases.append(dict(B=1, Hq=32, Hkv=8, Sq=512, Skv=512, D=128,
                      causal=False, q_offset=0, dtype="bfloat16"))
    cases.append(dict(B=2, Hq=4, Hkv=2, Sq=256, Skv=256, D=64, causal=True,
                      q_offset=0, dtype="float32"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    results = []
    for c in cases:
        dt = getattr(torch, c["dtype"])
        tol = 2e-2 if c["dtype"] == "bfloat16" else 2e-5

        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda",
                               dtype=torch.float32).to(dt)

        q = rnd(c["B"], c["Hq"], c["Sq"], c["D"])
        k = rnd(c["B"], c["Hkv"], c["Skv"], c["D"])
        v = rnd(c["B"], c["Hkv"], c["Skv"], c["D"])
        kw = dict(causal=c["causal"], q_offset=c["q_offset"])
        out = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        diff = (out.float() - want.float()).abs()
        max_err = float(diff.max())
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"non-finite kernel output: {c}")
        if bool((diff > tol + tol * want.float().abs()).any()):
            raise AssertionError(f"kernel disagrees with plain version: {c}, "
                                 f"max_err={max_err}, tol={tol}")
        # yardstick: one torch call for the same function (bool mask = keep)
        mask = None
        if c["causal"]:
            qpos = c["q_offset"] + torch.arange(c["Sq"], device="cuda")
            mask = qpos[:, None] >= torch.arange(c["Skv"], device="cuda")[None]

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)

        lib_err = float((library().float() - want.float()).abs().max())
        kernel_ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, **kw),
                            iters=20)
        plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v,
                                                                   **kw),
                           iters=3, warmup=1)
        library_ms = cuda_ms(torch, library, iters=20)
        bound_ms, bound_by = attention_bound(
            c["B"], c["Hq"], c["Hkv"], c["Sq"], c["Skv"], c["D"], c["causal"],
            c["q_offset"], c["dtype"])
        r = dict(c, max_err=max_err, tol=tol, kernel_ms=kernel_ms,
                 plain_ms=plain_ms, library_ms=library_ms,
                 library_max_err=lib_err, bound_ms=bound_ms,
                 bound_by=bound_by)
        results.append(r)
        print("kernel case " + json.dumps(r), flush=True)
    return results


def to_f32(tree):
    """A copy of a params tree (dicts, lists, tensors) in float32."""
    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_f32(v) for v in tree]
    return tree.float()


def profile_step(torch, eng, label: str):
    """One engine tick under torch.profiler: device busy share, top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    res = {"wall_ms": wall_ms,
           "device_busy_ms": busy_ms if kernels else "not measured",
           "device_busy_share": busy_ms / wall_ms if kernels else None,
           "kernel_launches": sum(e.count for e in kernels),
           "top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3
                              for e in top}}
    print(f"profile {label} " + json.dumps(res), flush=True)
    return res


def serve(torch, card: str):
    """Full-width qwen3-8b behind ServeEngine; returns the serve numbers."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_params, prefill
    from repro_torch.serve import engine as engine_mod

    cfg = get_config(ARCH).replace(param_dtype="bfloat16",
                                   attention_impl="pallas")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    print(f"serve: {cfg.name} {cfg.param_count() / 1e9:.3f} B params "
          f"(bf16, seed {SEED}) initialised in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # time each prefill and check every logit the engine sees is finite
    prefill_ms, decode_logits_ok = [], []
    real_prefill, real_decode = engine_mod.prefill, engine_mod.decode_step

    def timed_prefill(cfg_, p, batch, max_len):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = real_prefill(cfg_, p, batch, max_len=max_len)
        torch.cuda.synchronize()
        prefill_ms.append((int(batch["tokens"].shape[1]),
                           (time.perf_counter() - t) * 1e3))
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite prefill logits")
        return logits, cache

    def checked_decode(cfg_, p, tokens, cache):
        logits, cache = real_decode(cfg_, p, tokens, cache)
        decode_logits_ok.append(torch.isfinite(logits).all())
        return logits, cache

    engine_mod.prefill, engine_mod.decode_step = timed_prefill, checked_decode
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(1, cfg.vocab_size - 1, size=n).tolist()
               for n in PROMPT_LENS]
    try:
        eng = engine_mod.ServeEngine(cfg, params, slots=SLOTS,
                                     max_len=MAX_LEN, seed=SEED,
                                     device="cuda")
        for i, pr in enumerate(prompts):
            eng.add_request(engine_mod.Request(rid=i, prompt=pr,
                                               max_new_tokens=MAX_NEW))
        torch.cuda.reset_peak_memory_stats()
        fa.flash_attention.launches = 0
        tick_ms = []
        t_serve = time.perf_counter()
        while eng.queue or any(s.active for s in eng.slot_states):
            n_pre = len(prefill_ms)
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            # the tick's decode: its time less its prefills'
            tick_ms.append(ms - sum(x[1] for x in prefill_ms[n_pre:]))
        serve_s = time.perf_counter() - t_serve
        launches = fa.flash_attention.launches
    finally:
        engine_mod.prefill, engine_mod.decode_step = real_prefill, real_decode
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for i in range(len(prompts)):
        req = eng.requests[i]
        if not req.done or len(req.output) != MAX_NEW:
            raise AssertionError(f"request {i} done={req.done} with "
                                 f"{len(req.output)} of {MAX_NEW} tokens")
    if launches != cfg.num_layers * len(prompts):
        raise AssertionError(f"flash kernel launched {launches} times, want "
                             f"{cfg.num_layers} x {len(prompts)} prefills")
    if not all(bool(ok) for ok in decode_logits_ok):
        raise AssertionError("non-finite decode logits")

    # The same prompt through the plain chunked attention path.  In bf16 the
    # two paths' logits part by ~0.07 after 36 layers, and each is about as
    # far from the same model in f32 activations: bf16 rounding amplified by
    # depth, not the kernel.  So the check runs in f32 activations (the same
    # bf16-valued weights, cast), where the kernel path must agree within
    # 5e-2; the bf16 distances are reported beside it.
    i_ref = PROMPT_LENS.index(777)
    toks = torch.tensor(prompts[i_ref], device="cuda")[None]
    batch = {"tokens": toks,
             "positions": torch.arange(toks.shape[1], device="cuda")[None]}

    def last_logits(c, p):
        return prefill(c, p, batch, max_len=toks.shape[1])[0].float()

    xla = dict(attention_impl="xla")
    lo_k, lo_x = last_logits(cfg, params), last_logits(cfg.replace(**xla),
                                                       params)
    p32 = to_f32(params)
    c32 = cfg.replace(dtype="float32", param_dtype="float32")
    n0 = fa.flash_attention.launches
    lo_k32, lo_x32 = last_logits(c32, p32), last_logits(c32.replace(**xla),
                                                        p32)
    if fa.flash_attention.launches != n0 + cfg.num_layers:
        raise AssertionError("f32 prefill did not run the f32 kernel")
    del p32
    parity_err = float((lo_k32 - lo_x32).abs().max())
    if bool(((lo_k32 - lo_x32).abs() > 5e-2 + 5e-2 * lo_x32.abs()).any()):
        raise AssertionError(f"f32 prefill logits: kernel path vs plain path "
                             f"max_err={parity_err} beyond 5e-2")
    bf16_err = {"kernel_vs_plain_path": float((lo_k - lo_x).abs().max()),
                "kernel_path_vs_f32": float((lo_k - lo_x32).abs().max()),
                "plain_path_vs_f32": float((lo_x - lo_x32).abs().max())}

    # where one tick's time goes: a decode tick of 4 slots, and a tick that
    # also prefills the 2048-token prompt
    peng = engine_mod.ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                                  seed=SEED, device="cuda")
    for i in range(SLOTS):    # 3 tokens: admission, one tick, the profiled
        peng.add_request(engine_mod.Request(rid=i, prompt=prompts[i],
                                            max_new_tokens=3))
    peng.step()
    prof = {"decode_tick": profile_step(torch, peng, "decode_tick")}
    peng.add_request(engine_mod.Request(rid=SLOTS, max_new_tokens=2,
                                        prompt=prompts[PROMPT_LENS.index(2048)]))
    prof["prefill_2048_tick"] = profile_step(torch, peng, "prefill_2048_tick")
    del peng

    # output tokens: the decode ticks' plus the first token of each prefill
    tokens = eng.tokens_generated + len(prompts)
    res = dict(card=card, arch=cfg.name, requests=len(prompts),
               slots=SLOTS, max_len=MAX_LEN, max_new_tokens=MAX_NEW,
               prefill_ms={str(s): ms for s, ms in prefill_ms},
               ticks=len(tick_ms),
               decode_ms_per_tick_mean=sum(tick_ms) / len(tick_ms),
               decode_ms_per_tick_median=sorted(tick_ms)[len(tick_ms) // 2],
               tokens=tokens, serve_s=serve_s, tokens_per_s=tokens / serve_s,
               max_memory_allocated_gb=peak_gb, flash_launches=launches,
               prefill_parity_f32_max_err=parity_err,
               prefill_bf16_max_err=bf16_err, profile=prof)
    print("serve " + json.dumps(res), flush=True)
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    _build.load("flash_attention")
    seconds, log = _build.build_report("flash_attention")
    print(f"build: flash_attention.cu in {seconds:.1f} s "
          f"(load {time.perf_counter() - t0:.1f} s)", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernel vs plain version
    cases = kernel_cases(torch, fa)

    # 4. serve
    res = serve(torch, card)

    # 5. kernel line: the main path's largest prefill shape
    big = next(c for c in cases if c["Sq"] == 2048)
    print(json.dumps({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:23",
        "tpu_kernel": "kernels/flash_attention.py:_flash_kernel",
        "launches": res["flash_launches"],
        "max_abs_err": max(c["max_err"] for c in cases),
        "max_err": max(c["max_err"] for c in cases),
        "ms": big["kernel_ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": big["library_ms"],
    }]}), flush=True)

    # 6. result
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
