"""The plain references against their own definitions on tiny shapes, and
against the program run in f32, where the two agree to rounding (CPU)."""
from __future__ import annotations

import hashlib
import math

import pytest
import torch
import torch.nn.functional as F

from portbench import control
from portbench import harness as H
from portbench import testing
from portbench.kinds import score
from portbench.reference import common, hybrid, moe_decoder, rwkv6

HYBRID = testing.TEST_ONLY["name"]


def test_wkv_chunks_equal_the_token_recurrence():
    g = torch.Generator().manual_seed(3)
    B, S, Hh, D = 2, 150, 3, 8                 # a ragged last chunk
    r, k, v = (torch.randn(B, S, Hh, D, generator=g, dtype=torch.float64)
               for _ in range(3))
    w = torch.rand(B, S, Hh, D, generator=g, dtype=torch.float64) * 0.5 + 0.5
    u = torch.randn(Hh, D, generator=g, dtype=torch.float64)
    state = torch.zeros(B, Hh, D, D, dtype=torch.float64)
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               state + u[..., None] * kv))
        state = w[:, t, :, :, None] * state + kv
    want = torch.stack(ys, 1)
    assert torch.allclose(rwkv6.wkv(r, k, v, w, u), want, rtol=1e-10,
                          atol=1e-10)


def _moe_case(norm: bool):
    """A tiny MoE layer through the reference's ``_route`` and token by
    token, slot by slot: (got, want, aux, the hand aux, most slots an
    expert was asked for, C)."""
    g = torch.Generator().manual_seed(4)
    T, d, E, k, f = 24, 8, 4, 2, 6
    mo = {"num_experts": E, "experts_per_token": k, "capacity_factor": 0.5,
          "chunk_tokens": 0}
    if not norm:
        mo["norm_topk_prob"] = False
    p = {"moe/router": torch.randn(d, E, generator=g),
         "moe/wi_gate": torch.randn(E, d, f, generator=g),
         "moe/wi_up": torch.randn(E, d, f, generator=g),
         "moe/wo": torch.randn(E, f, d, generator=g)}
    x = torch.randn(T, d, generator=g)
    y, aux = moe_decoder._route(mo, p, x, common.Prec())
    C = max(int(0.5 * T * k / E), k)
    probs = (x @ p["moe/router"]).softmax(-1)
    top, ids = probs.topk(k, -1)
    gate = top / top.sum(-1, keepdim=True) if norm else top
    used = [0] * E
    want = torch.zeros(T, d)
    for t in range(T):                         # token-major, slot by slot
        for j in range(k):
            e = int(ids[t, j])
            used[e] += 1
            if used[e] > C:
                continue
            h = F.silu(x[t] @ p["moe/wi_gate"][e]) * (x[t] @ p["moe/wi_up"][e])
            want[t] += gate[t, j] * (h @ p["moe/wo"][e])
    share = torch.zeros(E)
    for t in range(T):
        for j in range(k):
            share[ids[t, j]] += 1.0 / T
    hand_aux = 0.01 * E * float((probs.mean(0) * share).sum()) / k
    return y, want, aux, hand_aux, max(used), C


def test_moe_keeps_the_first_assignments_of_each_expert():
    y, want, aux, hand_aux, most, C = _moe_case(norm=True)
    assert most > C                            # some were dropped
    assert torch.allclose(y, want, rtol=1e-5, atol=1e-5)
    assert float(aux) == pytest.approx(hand_aux, rel=1e-6)


def test_moe_keeps_the_top_k_weights_as_they_are_where_stated():
    y, want, aux, hand_aux, most, C = _moe_case(norm=False)
    assert most > C
    assert torch.allclose(y, want, rtol=1e-5, atol=1e-5)
    assert float(aux) == pytest.approx(hand_aux, rel=1e-6)
    renormed = _moe_case(norm=True)[0]
    assert not torch.allclose(y, renormed, rtol=1e-3, atol=1e-3)


def test_attention_equals_a_loop_over_heads():
    g = torch.Generator().manual_seed(5)
    m = {"num_heads": 4, "num_kv_heads": 2, "head_dim": 8, "qk_norm": True,
         "rope_theta": 10000.0, "rms_eps": 1e-6}
    d, B, S = 16, 2, 5
    p = {"attn/wq": torch.randn(d, 32, generator=g),
         "attn/wk": torch.randn(d, 16, generator=g),
         "attn/wv": torch.randn(d, 16, generator=g),
         "attn/wo": torch.randn(32, d, generator=g),
         "attn/q_norm": torch.rand(8, generator=g) + 0.5,
         "attn/k_norm": torch.rand(8, generator=g) + 0.5}
    x = torch.randn(B, S, d, generator=g)
    got = moe_decoder.attention(m, p, x, common.Prec())

    def rope(t, pos):                          # t [D], position pos
        half = 4
        out = torch.empty_like(t)
        for i in range(half):
            a = pos / 10000.0 ** (i / half)
            out[i] = t[i] * math.cos(a) - t[i + half] * math.sin(a)
            out[i + half] = t[i + half] * math.cos(a) + t[i] * math.sin(a)
        return out

    def norm(t, s):
        return t / torch.sqrt(t.square().mean() + 1e-6) * s

    want = torch.zeros(B, S, 32)
    for b in range(B):
        for h in range(4):
            kvh = h // 2
            q = [rope(norm((x[b, i] @ p["attn/wq"])[h * 8:(h + 1) * 8],
                           p["attn/q_norm"]), i) for i in range(S)]
            ks = [rope(norm((x[b, j] @ p["attn/wk"])[kvh * 8:(kvh + 1) * 8],
                            p["attn/k_norm"]), j) for j in range(S)]
            vs = [(x[b, j] @ p["attn/wv"])[kvh * 8:(kvh + 1) * 8]
                  for j in range(S)]
            for i in range(S):
                s = torch.stack([q[i] @ ks[j] for j in range(i + 1)]) / 8 ** .5
                w = s.softmax(0)
                want[b, i, h * 8:(h + 1) * 8] = sum(w[j] * vs[j]
                                                    for j in range(i + 1))
    assert torch.allclose(got, want @ p["attn/wo"], rtol=1e-4, atol=1e-4)


def test_int8_moments_round_trip_within_half_a_step():
    x = torch.randn(3, 700, generator=torch.Generator().manual_seed(6))
    codes, s = common.q8(x, 256)
    assert codes.dtype == torch.int8 and s.shape == (3, 3)
    back = common.dq8(codes, s, 256)
    step = s.repeat_interleave(256, -1)[:, :700]
    assert bool(((back - x).abs() <= step / 2 + 1e-7).all())
    zeros = common.q8(torch.zeros(2, 10), 256)
    assert bool((common.dq8(*zeros, 256) == 0).all())


def test_fp8_control_rounds_and_passes_gradients():
    a = torch.randn(8, 16, requires_grad=True)
    b = torch.randn(16, 4, requires_grad=True)
    y = common.Prec(fp8=True).mm(a, b)
    assert not torch.equal(y, a @ b)
    assert torch.allclose(y, a @ b, rtol=0.2, atol=0.5)
    ga, gb = torch.autograd.grad(y.sum(), (a, b))
    assert torch.allclose(ga, torch.ones(8, 4) @ b.detach().T, rtol=0.2,
                          atol=0.5)
    assert float(gb.abs().sum()) > 0


@pytest.mark.parametrize("cell", testing.tiny_cells())
def test_the_program_in_f32_agrees_with_the_reference(cell):
    out = testing.run_tiny(cell, f32=True)
    gaps = out["readings"]
    if "gaps" in gaps:
        assert gaps["gaps"]["ce_gap"] < 1e-4
        assert gaps["gaps"]["z_gap"] < 1e-7
        assert gaps["gaps"]["aux_gap"] < 1e-5
        assert gaps["gaps"]["hidden_gap"] < 1e-4
        assert gaps["gaps"].get("step_gap", 0.0) < 1e-4
    else:
        assert gaps["loss_gap"] < 1e-4
        assert gaps["first_grad_gap"] < 1e-3
        assert gaps["change_gap"] < 1e-3
    assert out["correct"]


def test_a_sampled_unit_the_window_missed_runs_late_and_is_checked():
    out = testing.run_tiny("rwkv6-3b.score", f32=True, seconds=0.0)
    assert out["attempted"] == 1
    late = out["readings"]["late_units"]
    assert late and all(i >= 1 for i in late)
    assert set(late) <= set(out["readings"]["sampled"])
    assert out["correct"]


def test_the_entry_timers_run_outside_the_profile_and_are_undone():
    import repro_torch.kernels.ops as ops
    before = ops.gmm_equal
    out = testing.run_tiny("qwen3-moe-30b-a3b.score", trace=True)
    assert ops.gmm_equal is before
    assert out["metrics"]["gmm_roofline"]["value"] > 0
    assert out["device"]["busy_s"] == 0.0      # no card: nothing traced


def test_the_scan_equals_the_token_recurrence(monkeypatch):
    monkeypatch.setattr(hybrid, "SCAN_TOKENS", 16)      # a ragged last run
    g = torch.Generator().manual_seed(7)
    B, S, di, N = 2, 50, 6, 4
    A = -torch.rand(di, N, generator=g, dtype=torch.float64) * 4
    dt = torch.rand(B, S, di, generator=g, dtype=torch.float64) * 0.3
    b, c = (torch.randn(B, S, N, generator=g, dtype=torch.float64)
            for _ in range(2))
    x = torch.randn(B, S, di, generator=g, dtype=torch.float64)
    h = torch.zeros(B, di, N, dtype=torch.float64)
    ys = []
    for t in range(S):
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * x[:, t])[..., None] * b[:, t, None, :]
        ys.append((h * c[:, t, None, :]).sum(-1))
    want = torch.stack(ys, 1)
    assert torch.allclose(hybrid.scan(A, dt, b, c, x), want, rtol=1e-12,
                          atol=1e-12)


def test_attention_in_query_blocks_equals_one_block(monkeypatch):
    g = torch.Generator().manual_seed(8)
    m = {"num_heads": 4, "num_kv_heads": 2, "head_dim": 8}
    d, B, S = 16, 2, 11
    p = {"attn/wq": torch.randn(d, 32, generator=g),
         "attn/wk": torch.randn(d, 16, generator=g),
         "attn/wv": torch.randn(d, 16, generator=g),
         "attn/wo": torch.randn(32, d, generator=g)}
    x = torch.randn(B, S, d, generator=g)
    whole = hybrid.attention(m, p, x, common.Prec())
    monkeypatch.setattr(hybrid, "QUERY_ROWS", 3)
    blocked = hybrid.attention(m, p, x, common.Prec())
    assert torch.allclose(blocked, whole, rtol=1e-5, atol=1e-5)
    first = hybrid.attention(m, p, x[:, :4], common.Prec())
    assert torch.allclose(blocked[:, :4], first, rtol=1e-5, atol=1e-5)


def _readings(name, **kw):
    c = H.Cell(testing.tiny_bench(), name, 41, 0, False, "cpu",
               overrides=testing.tiny_overrides(name, f32=True, batch=4,
                                                **kw))
    with testing.few_threads():
        return c, control.score_readings(c, control=False)["program"]


def test_a_superblock_is_checked_whole_on_the_runs_own_input():
    c, r = _readings(HYBRID)
    m = c.conf["model"]
    assert len(r["steps"]) == 1 + m["num_layers"] // m["hybrid_period"]
    assert r["step_gap"] < 1e-4 and control.judged(c, r)


def test_a_fault_in_one_layer_of_a_superblock_fails_step_gap(monkeypatch):
    import repro_torch.models.hybrid as HY
    mamba, calls = HY.mamba_apply, [0]

    def second_low(cfg, p, x, **kw):       # the 2nd Mamba layer 10% low
        calls[0] += 1
        out = mamba(cfg, p, x, **kw)
        return out * 0.9 if calls[0] % HY.n_mamba(cfg) == 2 else out

    monkeypatch.setattr(HY, "mamba_apply", second_low)
    c, r = _readings(HYBRID)
    assert r["step_gap"] > testing.TEST_LIMITS["step_gap"]
    assert not control.judged(c, r)


def _digest(x, h=None) -> str:
    """A hash of a reference's output: every tensor's bytes, every float
    to its last bit."""
    h = h or hashlib.sha256()
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.numpy().tobytes())
    elif isinstance(x, dict):
        for k in sorted(x, key=str):
            h.update(repr(k).encode())
            _digest(x[k], h)
    elif isinstance(x, (list, tuple)):
        h.update(b"[")
        for y in x:
            _digest(y, h)
        h.update(b"]")
    else:
        h.update(x.hex().encode() if isinstance(x, float)
                 else repr(x).encode())
    return h.hexdigest()[:16]


# what the layer loop that ran before blocks gave, on the CPU, two
# threads: the reference with f32 operands, then the control's fp8
PARENT_READINGS = {("qwen3-moe-30b-a3b.score", 0): ("416508bb439eb402",
                                                    "5211997bb7e661f4"),
                   ("qwen3-moe-30b-a3b.score", 4): ("68bb1c69a394e6c6",
                                                    "2699e708920d3364"),
                   ("rwkv6-3b.score", 2): ("602e5a0c2ad2f039",
                                           "95f2f703d4d44eb2")}


@pytest.mark.parametrize("cell,rows", list(PARENT_READINGS))
def test_a_block_a_layer_runs_the_calls_the_layer_loop_ran(cell, rows):
    over = testing.tiny_overrides(cell, batch=4)
    over["traffic"]["check_rows"] = rows
    c = H.Cell(testing.bench(), cell, 43, 0, False, "cpu", overrides=over)
    pool = control.pool_of(c)
    idx = [0, 3]
    with testing.few_threads():
        states = score.reference(c, pool, idx, common.Prec(True))
        forced = {"control": {i: states[i]["layers"] for i in idx}} \
            if rows else {}
        got = tuple(_digest(score.reference(c, pool, idx,
                                            common.Prec(fp8), forced))
                    for fp8 in (False, True))
    assert got == PARENT_READINGS[(cell, rows)]


def test_with_experts_the_check_takes_every_row_or_none():
    over = testing.tiny_overrides("qwen3-moe-30b-a3b.score", batch=4)
    over["traffic"]["check_rows"] = 2
    c = H.Cell(testing.bench(), "qwen3-moe-30b-a3b.score", 5, 0, False,
               "cpu", overrides=over)
    with pytest.raises(H.BenchError):
        score.check_rows(c)
    over["traffic"]["check_rows"] = 4
    assert score.check_rows(c) == [0, 1, 2, 3]
