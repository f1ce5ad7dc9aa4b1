"""Tiny cells for the CPU tests: a cell's own files with every size cut
down, run through the harness on the CPU (the kernels' plain versions),
optionally with the program in f32, where it agrees with the reference
to rounding.

The tests take the cells of ``BENCHMARK.json`` and those of
``waiting.json``: cells whose files are here and proven on the card,
held out of the benchmark until the program can carry them (PERF.md,
Open questions); a later PR moves their entries over as they stand.
"""
from __future__ import annotations

import contextlib
import copy
import time
from typing import Dict, Optional

from portbench import harness as H

H.import_program()


def bench() -> Dict:
    """BENCHMARK.json with the waiting cells and their metrics."""
    out = copy.deepcopy(H.benchmark())
    waiting = H.load_json(H.HERE / "waiting.json")
    for key, entries in waiting.items():
        out[key] = out[key] + entries
    return out


TINY_MODEL = {
    "moe": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                head_dim=16, vocab_size=512),
    "ssm": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                head_dim=16, d_ff=128, vocab_size=512),
}
TINY_SUB = {"moe": dict(num_experts=8, experts_per_token=2, d_ff_expert=32),
            "rwkv": dict(head_dim=16, decay_lora=8, mix_lora=8,
                         gate_lora=8)}


def tiny_overrides(name: str, f32: bool = False,
                   limits: Optional[Dict] = None, batch: int = 2) -> Dict:
    entry = H.find_cell(bench(), name)
    conf = copy.deepcopy(H.load_json(H.HERE / "configs"
                                     / f"{entry['config']}.json"))
    m = conf["model"]
    m.update(TINY_MODEL[m["family"]])
    for key, sizes in TINY_SUB.items():
        if key in m:
            m[key].update(sizes)
    traffic = copy.deepcopy(H.load_json(H.HERE / "traffic"
                                        / f"{entry['traffic']}.json"))
    kind = traffic["kind"]
    traffic.update(batch=batch, seq=64, pool_batches=8)
    if "check_batches" in traffic:
        traffic["check_batches"] = 2
    if f32:
        conf[kind].update(dtype="float32", param_dtype="float32")
    out = {"conf": conf, "traffic": traffic}
    if limits is not None:
        out["limits"] = limits
    return out


@contextlib.contextmanager
def few_threads(n: int = 2):
    """Tiny tensors gain nothing from many threads, and test workers
    that each take every core slow one another down."""
    import torch
    was = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(was)


def run_tiny(name: str, seed: int = 20260, seconds: float = 0.2,
             trace: bool = False, **kw) -> Dict:
    """A tiny run of cell ``name`` on the CPU: its result line."""
    t0 = time.perf_counter()
    cell = H.Cell(bench(), name, seed, seconds, trace, "cpu",
                  overrides=tiny_overrides(name, **kw))
    with few_threads():
        return H.result_line(cell, H.run_cell(cell, t0))


FAULTS = {"score": ("half_batch", "token_altered", "answer_altered"),
          "train": ("state_unchanged", "half_batch", "answer_altered")}
KERNEL_FAULTS = {("score", "ssm"): ("wkv_bonus_dropped",),
                 ("score", "moe"): ("flash_not_causal",)}


def faults(kind: str, family: str):
    """The faults that a cell of this kind of traffic and model family
    can have."""
    return FAULTS[kind] + KERNEL_FAULTS.get((kind, family), ())


@contextlib.contextmanager
def planted(fault: str):
    """The timed path broken underneath, in the program's train/eval
    step module: ``half_batch``, the loss over half of each (micro)batch's
    rows, its mean taken over them; ``token_altered``, the first row's
    input tokens each one higher; ``answer_altered``, the step's ce and z
    1% high; ``state_unchanged``, AdamW leaves the params and moments as
    they were; in the kernel wrappers, ``wkv_bonus_dropped``, WKV6 run
    with u = 0 (the current token's bonus left out), and
    ``flash_not_causal``, attention over the later keys too."""
    import torch
    import repro_torch.kernels.ops as ops
    import repro_torch.train.step as st
    loss_fn, adamw = st.loss_fn, st.adamw_update
    wkv, flash = ops.rwkv6_scan, ops.flash_attention

    def half(cfg, p, batch):
        n = batch["tokens"].shape[0] // 2
        return loss_fn(cfg, p, {k: v[:n] for k, v in batch.items()})

    def token(cfg, p, batch):
        toks = batch["tokens"].clone()
        toks[0] = (toks[0] + 1) % cfg.vocab_size
        return loss_fn(cfg, p, dict(batch, tokens=toks))

    def answer(cfg, p, batch):
        loss, metrics = loss_fn(cfg, p, batch)
        return loss, dict(metrics, ce=metrics["ce"] * 1.01,
                          z=metrics["z"] * 1.01)

    if fault == "state_unchanged":
        st.adamw_update = lambda grads, state, params, lr, cfg: (params,
                                                                 state)
    elif fault == "wkv_bonus_dropped":
        ops.rwkv6_scan = lambda r, k, v, w, u: wkv(r, k, v, w,
                                                   torch.zeros_like(u))
    elif fault == "flash_not_causal":
        ops.flash_attention = lambda q, k, v, **kw: flash(
            q, k, v, **dict(kw, causal=False))
    else:
        st.loss_fn = {"half_batch": half, "token_altered": token,
                      "answer_altered": answer}[fault]
    try:
        yield
    finally:
        st.loss_fn, st.adamw_update = loss_fn, adamw
        ops.rwkv6_scan, ops.flash_attention = wkv, flash
