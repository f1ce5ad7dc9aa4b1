"""Tiny cells for the CPU tests: a cell's own files with every size cut
down, run through the harness on the CPU (the kernels' plain versions),
optionally with the program in f32, where it agrees with the reference
to rounding.

The tests take the cells of ``BENCHMARK.json`` and those of
``waiting.json``: cells whose files are here and proven on the card,
held out of the benchmark until the program can carry them (PERF.md,
Open questions); a later PR moves their entries over as they stand.
The tests that run tiny cells also run ``TEST_ONLY``, a cell of the
hybrid family that no file describes: the port's registry entry cut to
the tiny sizes, so that the family's path through the harness is held
before a configuration of it has a cell.
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
    "hybrid": dict(num_layers=8, hybrid_period=8, d_model=64, num_heads=4,
                   num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512),
}
TINY_SUB = {"moe": dict(num_experts=8, experts_per_token=2, d_ff_expert=32),
            "rwkv": dict(head_dim=16, decay_lora=8, mix_lora=8,
                         gate_lora=8),
            "mamba": dict(d_state=16, expand=2)}

# the hybrid cell of the tests alone: one superblock of the registry's
# jamba-1.5-large-398b (Mamba-1, NoPE attention at position 4, 16 experts
# top-2 on odd positions), scored on the kernels' paths; every row's
# superblock checked (an MoE layer routes the whole batch at once); the
# limits those of the layer-checked rwkv6-3b.score
TEST_ONLY = {"name": "jamba-1.5-large-398b.score",
             "config": "jamba-1.5-large-398b", "traffic": "score_tiny",
             "chips": 1, "why": "the hybrid family held on the CPU"}
TEST_TRAFFIC = {"kind": "score", "warmup_units": 1, "check_from": 4,
                "check_batches": 2, "trace_units": 1}
TEST_LIMITS = {"z_gap": 2.5e-07, "step_gap": 0.045}


def tiny_bench() -> Dict:
    """``bench()`` with the ``TEST_ONLY`` cell."""
    out = bench()
    out["workloads"] = out["workloads"] + [TEST_ONLY]
    return out


def tiny_cells():
    """The names of the cells that the tests run tiny."""
    return [w["name"] for w in tiny_bench()["workloads"]]


def registry_conf(arch: str) -> Dict:
    """The port's registry entry ``arch`` as a configuration file holds
    a model: its sizes under ``model``, scored in bf16 on the kernels,
    checked by ``reference/<family>.py``."""
    import dataclasses
    from repro_torch.configs import get_config
    run = ("name", "dtype", "param_dtype", "attention_impl", "scan_impl",
           "remat", "layers_per_step")
    model = {k: v for k, v in dataclasses.asdict(get_config(arch)).items()
             if k not in run and v is not None}
    return {"name": arch, "reference": model["family"], "model": model,
            "score": {"dtype": "bfloat16", "param_dtype": "bfloat16",
                      "attention_impl": "pallas", "scan_impl": "pallas"}}


def tiny_overrides(name: str, f32: bool = False,
                   limits: Optional[Dict] = None, batch: int = 2) -> Dict:
    if name == TEST_ONLY["name"]:
        conf = registry_conf(TEST_ONLY["config"])
        traffic = dict(TEST_TRAFFIC, check_rows=batch)
        limits = TEST_LIMITS if limits is None else limits
    else:
        entry = H.find_cell(bench(), name)
        conf = copy.deepcopy(H.load_json(H.HERE / "configs"
                                         / f"{entry['config']}.json"))
        traffic = copy.deepcopy(H.load_json(H.HERE / "traffic"
                                            / f"{entry['traffic']}.json"))
    m = conf["model"]
    m.update(TINY_MODEL[m["family"]])
    for key, sizes in TINY_SUB.items():
        if key in m:
            m[key].update(sizes)
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
    cell = H.Cell(tiny_bench(), name, seed, seconds, trace, "cpu",
                  overrides=tiny_overrides(name, **kw))
    with few_threads():
        return H.result_line(cell, H.run_cell(cell, t0))


FAULTS = {"score": ("half_batch", "token_altered", "answer_altered"),
          "train": ("state_unchanged", "half_batch", "answer_altered")}
KERNEL_FAULTS = {("score", "ssm"): ("wkv_bonus_dropped",),
                 ("score", "moe"): ("flash_not_causal",),
                 ("score", "hybrid"): ("flash_not_causal",
                                       "mamba_state_reset")}


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
    with u = 0 (the current token's bonus left out),
    ``flash_not_causal``, attention over the later keys too, and
    ``mamba_state_reset``, the selective scan run on each half of the
    sequence from a zero state."""
    import torch
    import repro_torch.kernels.ops as ops
    import repro_torch.train.step as st
    loss_fn, adamw = st.loss_fn, st.adamw_update
    wkv, flash, mamba = ops.rwkv6_scan, ops.flash_attention, ops.mamba_scan

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
    elif fault == "mamba_state_reset":
        def halves(A, dt, b, c, x, return_state=False):
            n = x.shape[1] // 2
            first = mamba(A, dt[:, :n], b[:, :n], c[:, :n], x[:, :n])
            rest = mamba(A, dt[:, n:], b[:, n:], c[:, n:], x[:, n:],
                         return_state=return_state)
            if return_state:
                return torch.cat([first, rest[0]], 1), rest[1]
            return torch.cat([first, rest], 1)
        ops.mamba_scan = halves
    else:
        st.loss_fn = {"half_batch": half, "token_altered": token,
                      "answer_altered": answer}[fault]
    try:
        yield
    finally:
        st.loss_fn, st.adamw_update = loss_fn, adamw
        ops.rwkv6_scan, ops.flash_attention = wkv, flash
        ops.mamba_scan = mamba
