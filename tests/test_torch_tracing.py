"""The port's spans and counters (``repro_torch.tracing``) on the eval
step of the tiny qwen3-moe and rwkv6 configs, on the CPU: off they record
nothing and cost a flag check; on they leave the step's outputs as they
were, form the documented tree, and sit in a profiler trace as plain CPU
operations on the same clock.

Every test sets the tracing state itself and restores it: a traced run
of the benchmark in the same process turns tracing on."""
import threading

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.config import PREFILL, RunConfig, ShapeConfig
from repro_torch.configs import get_tiny_config
from repro_torch.models import init_params
from repro_torch.models import moe as tmoe
from repro_torch.train import make_eval_step

ARCHS = ["qwen3-moe-30b-a3b", "rwkv6-3b"]
B, S = 2, 32
MOE_SPANS = ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]


@pytest.fixture
def state():
    """Tracing as the test sets it, then as it was, the units dropped."""
    was = tracing.enabled()
    tracing.clear()
    yield
    (tracing.enable if was else tracing.disable)()
    tracing.clear()


def _setup(arch, scan_impl="pallas", seq=S):
    cfg = get_tiny_config(arch).replace(dtype="float32",
                                        param_dtype="float32",
                                        scan_impl=scan_impl)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, seq),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, 1),
             "positions": torch.arange(seq).expand(B, seq)}
    step = make_eval_step(RunConfig(model=cfg, shape=ShapeConfig(
        "tiny", PREFILL, seq, B)))
    return cfg, params, batch, step


def test_off_records_nothing_and_spans_are_one_null_context(state):
    tracing.disable()
    assert tracing.span("a") is tracing.span("b") is tracing.unit("c")
    with tracing.span("a") as got:
        assert got is None
    tracing.count("moe.kept", torch.ones(3))
    for arch in ARCHS:
        _, params, batch, step = _setup(arch)
        step(params, batch)
    assert tracing.totals() == {"units": 0, "spans": {}, "counters": {}}


def test_on_a_span_outside_a_unit_records_nothing(state):
    tracing.enable()
    assert tracing.span("a") is tracing.span("b")
    tracing.count("x", 1)
    assert tracing.totals()["units"] == 0


@pytest.mark.parametrize("scan_impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_outputs_are_bit_identical_on_and_off(state, arch, scan_impl):
    _, params, batch, step = _setup(arch, scan_impl)
    tracing.disable()
    off = step(params, batch)
    tracing.enable()
    on = step(params, batch)
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k
    assert tracing.totals()["units"] == 1


def _children(rows, i):
    return [r["name"] for r in rows if r["parent"] == i]


@pytest.mark.parametrize("arch", ARCHS)
def test_the_recorded_tree(state, arch):
    cfg, params, batch, step = _setup(arch)
    tracing.enable()
    for _ in range(2):
        step(params, batch)
    units = tracing.records()
    assert len(units) == 2
    assert units[0][0]["unit"] != units[1][0]["unit"]
    for rows in units:
        assert len({r["unit"] for r in rows}) == 1
        roots = [i for i, r in enumerate(rows) if r["parent"] is None]
        assert [rows[i]["name"] for i in roots] == ["eval_step"]
        top = _children(rows, roots[0])
        assert top == ["embed"] + ["block"] * cfg.num_layers \
            + ["logits", "loss"]
        blocks = [i for i, r in enumerate(rows) if r["name"] == "block"]
        for i in blocks:
            if cfg.moe is not None:
                assert _children(rows, i) == ["attention", "ffn"]
                ffn = next(j for j, r in enumerate(rows)
                           if r["parent"] == i and r["name"] == "ffn")
                assert _children(rows, ffn) == MOE_SPANS
            else:
                assert _children(rows, i) == ["rwkv.time_mix",
                                              "rwkv.channel_mix"]
                tm = next(j for j, r in enumerate(rows)
                          if r["parent"] == i and r["name"] == "rwkv.time_mix")
                assert _children(rows, tm) == ["rwkv.wkv6"]
        for r in rows:
            if r["parent"] is not None:
                up = rows[r["parent"]]
                assert up["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                    <= up["end_ns"]
    t = tracing.totals()
    assert t["units"] == 2 and t["spans"]["eval_step"]["calls"] == 2
    assert t["spans"]["block"]["calls"] == 2 * cfg.num_layers
    for row in t["spans"].values():
        assert 0 <= row["self_ms"] <= row["ms"]
    if cfg.moe is not None:
        for name in MOE_SPANS:
            assert t["spans"][name]["calls"] == 2 * cfg.num_layers
        c = t["counters"]
        assert 0 < c["moe.kept"] <= c["moe.slots"]
        assert c["moe.kept"] <= 2 * cfg.num_layers * B * S \
            * cfg.moe.experts_per_token
    else:
        assert t["counters"] == {}
        tm = t["spans"]["rwkv.time_mix"]
        assert tm["self_ms"] == pytest.approx(
            tm["ms"] - t["spans"]["rwkv.wkv6"]["ms"], abs=1e-9)
    assert tracing.totals(last_units=1)["units"] == 1


def test_the_hybrid_records_its_mixers_and_the_mamba_layers_parts(state):
    """A tiny jamba unit (one superblock, experts on odd positions): each
    position's mixer in ``attention`` or ``mamba``, its FFN in ``ffn``
    (the ``moe.*`` spans inside an MoE's), each Mamba layer's conv, dt/B/C
    inputs and scan as its children; the top-level spans cover at least
    99% of ``eval_step`` (a warm step of 256 tokens a row, so that the
    host's work between them is as small a share as on the card)."""
    cfg, params, batch, step = _setup("jamba-1.5-large-398b", seq=256)
    tracing.disable()
    step(params, batch)
    tracing.enable()
    step(params, batch)
    rows = tracing.records()[0]
    root = next(i for i, r in enumerate(rows) if r["parent"] is None)
    assert _children(rows, root) == ["embed"] + ["block"] * (
        cfg.num_layers // cfg.hybrid_period) + ["logits", "loss"]
    mixers = ["attention" if i == cfg.hybrid_attn_pos else "mamba"
              for i in range(cfg.hybrid_period)]
    for i in (j for j, r in enumerate(rows) if r["name"] == "block"):
        kids = [j for j, r in enumerate(rows) if r["parent"] == i]
        assert [rows[j]["name"] for j in kids] == [
            n for mixer in mixers for n in (mixer, "ffn")]
        for pos, j in enumerate(kids[1::2]):
            moe = pos % cfg.moe.moe_every == cfg.moe.moe_offset
            assert _children(rows, j) == (MOE_SPANS if moe else [])
        for j in kids[::2]:
            want = ["mamba.conv", "mamba.ssm_inputs", "mamba.scan"] \
                if rows[j]["name"] == "mamba" else []
            assert _children(rows, j) == want
    top = sum(r["ms"] for r in rows if r["parent"] == root)
    assert top >= 0.99 * rows[root]["ms"]
    t = tracing.totals()
    assert t["spans"]["mamba"]["calls"] == cfg.num_layers - 1
    assert t["spans"]["mamba.scan"]["calls"] == cfg.num_layers - 1
    assert 0 < t["counters"]["moe.kept"] <= t["counters"]["moe.slots"]


def test_moe_kept_counts_the_assignments_within_capacity(state):
    """Held to a count of its own: each expert keeps the first C of the
    assignments routed to it."""
    cfg = get_tiny_config("qwen3-moe-30b-a3b").replace(
        dtype="float32", param_dtype="float32")
    m = cfg.moe
    gen = torch.Generator().manual_seed(3)
    p = tmoe.moe_init(cfg, gen, torch.device("cpu"))
    x = torch.randn(2, 48, cfg.d_model, generator=gen)
    tracing.enable()
    with tracing.unit("u"):
        tmoe.moe_apply(cfg, p, x)
    C = tmoe._capacity(m, 96)
    ids = torch.topk(x.reshape(96, -1) @ p["router"], m.experts_per_token,
                     dim=-1).indices
    per_expert = torch.bincount(ids.flatten(), minlength=m.num_experts)
    c = tracing.totals()["counters"]
    assert c["moe.kept"] == float(per_expert.clamp(max=C).sum())
    assert c["moe.slots"] == m.num_experts * (C + 1)
    assert c["moe.kept"] < m.experts_per_token * 96     # some dropped


def test_spans_are_plain_cpu_operations_on_the_profilers_clock(state):
    _, params, batch, step = _setup("qwen3-moe-30b-a3b")
    tracing.enable()
    step(params, batch)                        # warm
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, batch)
    rows = tracing.records()[0]
    names = {r["name"] for r in rows}
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in names]
    assert len(events) == len(rows)
    tol = 100_000                              # ns
    for name in names:
        got = sorted(e.start_ns() for e in events if e.name() == name)
        want = sorted((r["start_ns"], r["end_ns"]) for r in rows
                      if r["name"] == name)
        assert len(got) == len(want)
        for start, (lo, hi) in zip(got, want):
            assert lo - tol <= start <= hi + tol
    for e in events:
        assert e.device_type() == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation()


def test_a_span_on_another_thread_joins_the_open_unit(state):
    tracing.enable()

    def work():
        with tracing.span("recompute"):
            tracing.count("n", torch.tensor([1, 2]))

    with tracing.unit("root"):
        with tracing.span("inner"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    rows = tracing.records()[0]
    by_name = {r["name"]: r for r in rows}
    assert by_name["recompute"]["parent"] is None   # its thread's stack
    assert rows[by_name["inner"]["parent"]]["name"] == "root"
    assert tracing.totals()["counters"] == {"n": 3.0}


def test_only_the_last_units_are_kept(state):
    tracing.enable()
    for i in range(tracing.KEEP_UNITS + 3):
        with tracing.unit("u"):
            tracing.count("i", i)
    t = tracing.totals()
    assert t["units"] == tracing.KEEP_UNITS
    assert t["counters"]["i"] == sum(range(3, tracing.KEEP_UNITS + 3))
    assert tracing.totals(last_units=2)["counters"]["i"] == \
        2 * tracing.KEEP_UNITS + 3
