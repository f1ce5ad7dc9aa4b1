"""Port's MoE family (qwen3-moe-30b-a3b, dbrx-132b: the MoE layer,
forward / loss / prefill / decode, serving) vs the JAX package's, on the
CPU.

Both packages run the same JAX-made parameters (bridged through numpy) on
the same numpy token batches of the tiny configs (2 layers, d_model 64,
8 experts, top-2, d_ff_expert 64).  Parity runs in f32 at 1e-4;
``scan_impl="pallas"`` sends the expert products through the port's
grouped matmul (its plain version on the CPU), while the reference keeps
its einsum (no reference model path calls its gmm kernel).
"""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.checkpoint.ckpt import _leaf_paths, _path_str
from repro.configs import get_config as jax_config
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import loss_fn as jloss_fn
from repro.models import prefill as jprefill
from repro.models import moe as jmoe
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bridge import params_to_numpy
from repro_torch.configs import get_config, get_tiny_config
from repro_torch.kernels import gmm as tgmm
from repro_torch.models import (
    cache_batch_axes, decode_step, forward, init_params, loss_fn, prefill,
)
from repro_torch.models import moe as tmoe
from repro_torch.serve.engine import Request, ServeEngine
from _torch_parity import batches, configs, f32, params

ARCHS = ["qwen3-moe-30b-a3b", "dbrx-132b"]
IMPLS = ["xla", "pallas"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _moe_cfg(cfg, **kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


def _with_targets(cfg, jb, tb, seed=0):
    """Add the same next-token targets, a few masked (-1), to both batches."""
    rng = np.random.default_rng(seed)
    tg = rng.integers(0, cfg.vocab_size, tb["tokens"].shape).astype(np.int32)
    tg[:, ::5] = -1
    return (dict(jb, targets=jnp.asarray(tg)),
            dict(tb, targets=torch.from_numpy(tg).long()))


def _layer_inputs(jcfg, tcfg, T, seed=0):
    """One MoE layer's params from both packages and x [1, T, d]."""
    jp, tp = params(jcfg, tcfg, seed=seed)
    x = np.random.default_rng(seed).standard_normal(
        (1, T, tcfg.d_model), dtype=np.float32)
    return (jax.tree.map(lambda a: a[0], jp["blocks"]["moe"]),
            tp["blocks"][0]["moe"], x)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, impl):
    jcfg, tcfg = configs(arch, dtype="float32", scan_impl=impl)
    jp, tp, x = _layer_inputs(jcfg, tcfg, 24)
    jy, ja = jmoe.moe_apply(jcfg, jp, jnp.asarray(x))
    ty, ta = tmoe.moe_apply(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(f32(ty), f32(jy), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_capacity_drops_tokens_and_still_matches_jax(impl):
    """capacity_factor=0.25: C = 2 slots for 8 experts, 64 assignments, so
    at least 48 are dropped; the drops follow the reference's, and the
    layer differs from the same one with room for every token."""
    jcfg, tcfg = configs("qwen3-moe-30b-a3b", dtype="float32",
                         scan_impl=impl)
    jcfg, tcfg = _moe_cfg(jcfg, capacity_factor=0.25), \
        _moe_cfg(tcfg, capacity_factor=0.25)
    T = 32
    m = tcfg.moe
    C = tmoe._capacity(m, T)
    assert C == jmoe._capacity(jcfg.moe, T) == 2
    assert m.num_experts * C < T * m.experts_per_token
    jp, tp, x = _layer_inputs(jcfg, tcfg, T, seed=3)
    jy, ja = jmoe.moe_apply(jcfg, jp, jnp.asarray(x))
    ty, ta = tmoe.moe_apply(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(f32(ty), f32(jy), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    roomy, _ = tmoe.moe_apply(_moe_cfg(tcfg, capacity_factor=8.0), tp,
                              torch.from_numpy(x))
    assert float((roomy - ty).abs().max()) > 1e-2
    # whole model: finite logits and an aux loss, as the reference's test
    jpm, tpm = params(jcfg, tcfg, seed=4)
    jb, tb = batches(tcfg, 2, 16, seed=4)
    tl, ta = forward(tcfg, tpm, tb)
    jl, ja = jforward(jcfg, jpm, jb)
    assert bool(torch.isfinite(tl).all()) and float(ta) > 0.0
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_chunk_loop_matches_jax_scan(impl):
    """chunk_tokens=16 over 48 tokens: three chunks, each with its own
    capacity, aux averaged over them (the reference's lax.scan)."""
    jcfg, tcfg = configs("dbrx-132b", dtype="float32", scan_impl=impl)
    jcfg, tcfg = _moe_cfg(jcfg, chunk_tokens=16), \
        _moe_cfg(tcfg, chunk_tokens=16)
    jp, tp, x = _layer_inputs(jcfg, tcfg, 48, seed=5)
    jy, ja = jmoe.moe_apply(jcfg, jp, jnp.asarray(x))
    ty, ta = tmoe.moe_apply(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(f32(ty), f32(jy), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    whole, _ = tmoe.moe_apply(_moe_cfg(tcfg, chunk_tokens=0), tp,
                              torch.from_numpy(x))
    assert tuple(whole.shape) == tuple(ty.shape)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch, impl):
    jcfg, tcfg = configs(arch, dtype="float32", scan_impl=impl)
    jp, tp = params(jcfg, tcfg)
    jb, tb = _with_targets(tcfg, *batches(tcfg, 2, 16))
    jl, ja = jax.jit(lambda p, b: jforward(jcfg, p, b))(jp, jb)
    tl, ta = forward(tcfg, tp, tb)
    assert tl.shape == (2, 16, tcfg.vocab_size)
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    assert float(ta) > 0.0
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    jt, jm = jloss_fn(jcfg, jp, jb)
    tt, tm = loss_fn(tcfg, tp, tb)
    for name in ("loss", "ce", "aux", "z", "tokens"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert float(tt) == float(tm["loss"])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, impl):
    jcfg, tcfg = configs(arch, dtype="float32", scan_impl=impl)
    jp, tp = params(jcfg, tcfg, seed=1)
    jb, tb = batches(tcfg, 2, 12, seed=1)
    jl, jc = jprefill(jcfg, jp, jb, max_len=20)
    tl, tc = prefill(tcfg, tp, tb, max_len=20)
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(f32(tc[name]), f32(jc[name]), **TOL)
    jstep = jax.jit(lambda p, t, c: jdecode(jcfg, p, t, c))
    toks = np.array([[3], [7]], np.int32)
    for _ in range(3):
        jl, jc = jstep(jp, jnp.asarray(toks), jc)
        tl, tc = decode_step(tcfg, tp, torch.from_numpy(toks).long(), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
        toks = np.array(jnp.argmax(jl[:, 0], -1), np.int32)[:, None]
    np.testing.assert_array_equal(tc["index"].numpy(), np.asarray(jc["index"]))


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_forward(impl):
    """prefill(S-1) + decode(last) == forward(S)[-1].  Capacity depends on
    the number of tokens routed together, so this holds only where no
    token is dropped; capacity_factor=8 (at least E / k = 4 here) gives
    C >= T, room for every one (the reference behaves the same way)."""
    _, cfg = configs("qwen3-moe-30b-a3b", dtype="float32", scan_impl=impl)
    cfg = _moe_cfg(cfg, capacity_factor=8.0)
    _, p = params(*configs("qwen3-moe-30b-a3b", dtype="float32"), seed=2)
    _, batch = batches(cfg, 2, 16, seed=2)
    logits, _ = forward(cfg, p, batch)
    _, cache = prefill(cfg, p, {k: v[:, :-1] for k, v in batch.items()},
                       max_len=24)
    dec, _ = decode_step(cfg, p, batch["tokens"][:, -1:], cache)
    np.testing.assert_allclose(f32(dec[:, 0]), f32(logits[:, -1]), **TOL)


@pytest.mark.parametrize("slots", [2, 3])
def test_engine_matches_jax_engine_tick_for_tick(slots):
    """Capacity couples the slots that decode together, so the port's
    engine is held to the reference engine on the same slot count."""
    jcfg, tcfg = configs("qwen3-moe-30b-a3b", dtype="float32")
    jp, tp = params(jcfg, tcfg, seed=6)
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13, 14, 15, 16],
               [20, 21], [30, 31, 32, 33]]
    je = JServeEngine(jcfg, jp, slots=slots, max_len=48)
    te = ServeEngine(tcfg.replace(scan_impl="pallas"), tp, slots=slots,
                     max_len=48, device="cpu")
    for i, pr in enumerate(prompts):
        je.add_request(JRequest(rid=i, prompt=pr, max_new_tokens=6))
        te.add_request(Request(rid=i, prompt=pr, max_new_tokens=6))
    ticks = 0
    while je.queue or any(s.active for s in je.slot_states):
        je.step()
        te.step()
        ticks += 1
        for i in range(len(prompts)):
            assert te.requests[i].output == je.requests[i].output, (ticks, i)
    assert not te.queue and not any(s.active for s in te.slot_states)
    assert all(te.requests[i].done for i in range(len(prompts)))
    assert te.tokens_generated == je.tokens_generated
    assert cache_batch_axes(tcfg) == {"k": 1, "v": 1, "index": 0}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference_shapes_and_dtypes(arch):
    """Seeded init under bf16 params: the reference's leaves, shapes and
    dtypes (the router stays f32), and the fan-in scale of the experts."""
    jcfg, tcfg = configs(arch, param_dtype="bfloat16")
    jp = params(jcfg, tcfg)[0]
    tp = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = {_path_str(q): x for q, x in _leaf_paths(jp)}
    got = {_path_str(q): x for q, x in _leaf_paths(params_to_numpy(tcfg, tp))}
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        assert (got[name].dtype, got[name].shape) == (a.dtype, a.shape), name
    assert got["blocks/moe/router"].dtype == np.float32
    wg = got["blocks/moe/wi_gate"].astype(np.float32)
    assert abs(wg.std() * np.sqrt(tcfg.d_model) - 0.88) < 0.05


@pytest.mark.parametrize("arch", ARCHS)
def test_config_dims_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.param_count(active_only=True) == \
        jcfg.param_count(active_only=True)
    for T in (1, 4, 2048, 8192):
        assert tmoe._capacity(cfg.moe, T) == jmoe._capacity(jcfg.moe, T)
        assert tmoe.moe_flops(cfg, T) == jmoe.moe_flops(jcfg, T)


def test_qwen3_moe_fits_one_card():
    """30.5 B params, 61.1 GB in bf16: one 80 GB card holds the full depth
    (the smoke's full-width cell); dbrx does not."""
    assert get_config("qwen3-moe-30b-a3b").param_count() == 30_532_120_576
    assert 2 * get_config("qwen3-moe-30b-a3b").param_count() < 80e9 * 0.8
    assert 2 * get_config("dbrx-132b").param_count() > 80e9


@pytest.mark.parametrize("norm", [True, False])
def test_slots_gate_weights_are_the_softmax_top_k(norm):
    """``_slots``' gate weights are the softmax's top k, divided by their
    sum only where ``norm_topk_prob`` (the reference's router; Jamba's
    keeps them as they are)."""
    cfg = get_tiny_config("qwen3-moe-30b-a3b")
    m = dataclasses.replace(cfg.moe, norm_topk_prob=norm)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(24, cfg.d_model, generator=g)
    router = torch.randn(cfg.d_model, m.num_experts, generator=g)
    C = tmoe._capacity(m, 24)
    _, _, _, gate_w, _ = tmoe._slots(m, router, x, C)
    top = (x @ router).softmax(-1).topk(m.experts_per_token, -1).values
    want = top / top.sum(-1, keepdim=True) if norm else top
    torch.testing.assert_close(gate_w, want, rtol=0, atol=0)
    assert bool((gate_w.sum(-1) < 1 - 1e-3).any()) != norm


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("impl", IMPLS)
def test_moe_layer_weights_its_experts_by_the_routers_setting(impl, norm):
    """The layer under either path (``"pallas"``: the kernels' plain
    versions) equals a token-by-token sum of its top-k experts, each
    weighted by the softmax's top-k weight, renormalised only where
    ``norm_topk_prob``; capacity for every assignment."""
    cfg = get_tiny_config("qwen3-moe-30b-a3b").replace(
        dtype="float32", param_dtype="float32", scan_impl=impl)
    cfg = _moe_cfg(cfg, norm_topk_prob=norm, capacity_factor=8.0)
    m = cfg.moe
    g = torch.Generator().manual_seed(7)
    p = tmoe.moe_init(cfg, g, torch.device("cpu"))
    x = torch.randn(1, 24, cfg.d_model, generator=g)
    y, _ = tmoe.moe_apply(cfg, p, x)
    top, ids = (x[0] @ p["router"]).softmax(-1).topk(m.experts_per_token, -1)
    gate = top / top.sum(-1, keepdim=True) if norm else top
    want = torch.zeros_like(x[0])
    for t in range(24):
        for j in range(m.experts_per_token):
            e = int(ids[t, j])
            h = torch.nn.functional.silu(x[0, t] @ p["wi_gate"][e]) \
                * (x[0, t] @ p["wi_up"][e])
            want[t] += gate[t, j] * (h @ p["wo"][e])
    torch.testing.assert_close(y[0], want, rtol=1e-5, atol=1e-5)


def test_cpu_route_launches_nothing():
    jcfg, tcfg = configs("qwen3-moe-30b-a3b", dtype="float32",
                         scan_impl="pallas")
    _, tp = params(jcfg, tcfg)
    _, tb = batches(tcfg, 1, 8)
    n = tgmm.gmm.launches
    forward(tcfg, tp, tb)
    assert tgmm.gmm.launches == n
