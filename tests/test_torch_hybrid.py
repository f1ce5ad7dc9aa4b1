"""Port's hybrid family (Jamba without and with experts: forward / loss /
prefill / decode) vs the JAX package's, on the CPU; serving is in
``test_torch_hybrid_serve.py``.

Both packages run the same JAX-made parameters (bridged through numpy) on
the same numpy token batches of the tiny ``jamba-1.5-large-398b``, most
tests with ``moe=None`` (one superblock of 8 layers, d_model 64, d_inner
128, d_state 8), the ``with_experts`` ones with its 4 MoE layers (8
experts, top-2).  Parity runs in f32 at 1e-4 unless a test says otherwise;
the JAX ``pallas`` scan runs in interpret mode.  Prompt lengths stay
below 256, where the reference's chunked scan takes any length.
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
from repro_torch.bridge import leaf_names, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import ops as tops
from repro_torch.models import (
    decode_step, forward, init_cache, init_params, loss_fn, prefill,
)
from _torch_parity import batches, configs, f32, params, reference_fields

ARCH = "jamba-1.5-large-398b"
TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_KEYS = ("k", "v", "conv", "ssm")


def _configs(**kw):
    return configs(ARCH, moe=None, **kw)


def _with_targets(cfg, jb, tb, seed=0):
    """Add the same next-token targets, a few masked (-1), to both batches."""
    rng = np.random.default_rng(seed)
    tg = rng.integers(0, cfg.vocab_size, tb["tokens"].shape).astype(np.int32)
    tg[:, ::5] = -1
    jb = dict(jb, targets=jnp.asarray(tg))
    tb = dict(tb, targets=torch.from_numpy(tg).long())
    return jb, tb


def test_full_config_dims_match_reference():
    """dt_rank resolves to 512 at d_model 8192, and the hybrid branch of
    param_count agrees with the reference with and without experts."""
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    assert cfg.mamba.resolved_dt_rank(cfg.d_model) == 512
    for kw in ({}, {"moe": None}, {"moe": None, "num_layers": 16}):
        assert cfg.replace(**kw).param_count() == \
            jcfg.replace(**kw).param_count()
    assert cfg.replace(moe=None, num_layers=16).param_count() == \
        16_924_311_552


@pytest.mark.parametrize("scan_impl", ["xla", "pallas"])
def test_forward_and_loss_match_jax(scan_impl):
    jcfg, tcfg = _configs(dtype="float32", scan_impl=scan_impl)
    jp, tp = params(jcfg, tcfg)
    jb, tb = _with_targets(tcfg, *batches(tcfg, 2, 64))
    jl, _ = jax.jit(lambda p, b: jforward(jcfg, p, b))(jp, jb)
    tl, aux = forward(tcfg, tp, tb)
    assert tl.shape == (2, 64, tcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    jtotal, jm = jax.jit(lambda p, b: jloss_fn(jcfg, p, b))(jp, jb)
    ttotal, tm = loss_fn(tcfg, tp, tb)
    np.testing.assert_allclose(f32(ttotal), f32(jtotal), **TOL)
    for name in ("ce", "z", "aux", "tokens"):
        np.testing.assert_allclose(f32(tm[name]), f32(jm[name]), **TOL)


def test_pallas_forward_runs_the_scan_once_per_mamba_layer_and_prefill_with_the_state(
        monkeypatch):
    """scan_impl="pallas" reaches ops.mamba_scan once per Mamba layer (7 a
    superblock) in forward, without the state, and as often in prefill,
    with it: prefill never takes the token loop ``_scan_chunk`` (the
    kernel returns the final state).  The pallas prefill's logits and
    "ssm"/"conv" entries are the xla prefill's, which takes the loop."""
    from repro_torch.models import mamba as tmamba
    _, tcfg = _configs(dtype="float32", scan_impl="pallas")
    tp = params(*_configs(dtype="float32"))[1]
    _, tb = batches(tcfg, 1, 70)
    calls, loops = [], []
    real, real_loop = tops.mamba_scan, tmamba._scan_chunk

    def scan(*a, **kw):
        calls.append((tuple(a[-1].shape), kw.get("return_state", False)))
        return real(*a, **kw)

    def loop(*a):
        loops.append(tuple(a[-2].shape))
        return real_loop(*a)

    monkeypatch.setattr(tops, "mamba_scan", scan)
    monkeypatch.setattr(tmamba, "_scan_chunk", loop)
    lo_k, _ = forward(tcfg, tp, tb)
    assert calls == [((1, 70, 128), False)] * 7 and loops == []
    lo_x, _ = forward(tcfg.replace(scan_impl="xla"), tp, tb)
    np.testing.assert_allclose(f32(lo_k), f32(lo_x), **TOL)
    del calls[:], loops[:]
    pl_k, pc_k = prefill(tcfg, tp, tb, max_len=70)
    assert calls == [((1, 70, 128), True)] * 7 and loops == []
    pl_x, pc_x = prefill(tcfg.replace(scan_impl="xla"), tp, tb, max_len=70)
    assert len(calls) == 7 and loops == [(1, 70, 128)] * 7
    np.testing.assert_allclose(f32(pl_k), f32(pl_x), **TOL)
    for name in ("ssm", "conv"):
        assert pc_k[name].shape == pc_x[name].shape, name
        np.testing.assert_allclose(f32(pc_k[name]), f32(pc_x[name]), **TOL)


@pytest.mark.parametrize("S", [2, 12, 100])
def test_prefill_and_decode_match_jax(S):
    """Logits and every cache entry, after prefill and after 3 decodes.
    S = 2 is shorter than the conv window (the padded conv tail)."""
    jcfg, tcfg = _configs(dtype="float32")
    jp, tp = params(jcfg, tcfg, seed=1)
    jb, tb = batches(tcfg, 2, S, seed=S)
    jl, jc = jprefill(jcfg, jp, jb, max_len=S + 8)
    tl, tc = prefill(tcfg, tp, tb, max_len=S + 8)
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    assert sorted(tc) == sorted(jc)
    for name in CACHE_KEYS:
        assert tc[name].shape == jc[name].shape, name
        assert f32(tc[name]).dtype == f32(jc[name]).dtype
        np.testing.assert_allclose(f32(tc[name]), f32(jc[name]), **TOL)
    assert tc["conv"].dtype == torch.float32 and tc["ssm"].dtype == \
        torch.float32
    np.testing.assert_array_equal(tc["index"].numpy(), np.asarray(jc["index"]))

    jstep = jax.jit(lambda p, t, c: jdecode(jcfg, p, t, c))
    toks = np.array([[3], [7]], np.int32)
    for _ in range(3):
        jl, jc = jstep(jp, jnp.asarray(toks), jc)
        tl, tc = decode_step(tcfg, tp, torch.from_numpy(toks).long(), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
        toks = np.array(jnp.argmax(jl[:, 0], -1), np.int32)[:, None]
    for name in CACHE_KEYS:
        np.testing.assert_allclose(f32(tc[name]), f32(jc[name]), **TOL)
    np.testing.assert_array_equal(tc["index"].numpy(), np.asarray(jc["index"]))


@pytest.mark.parametrize("S", [2, 4, 37])
@pytest.mark.parametrize("scan_impl", ["xla", "pallas"])
def test_decode_matches_forward(S, scan_impl):
    """Port prefill(S-1 tokens) + decode(last) == port forward(S)[-1]; at
    S = 2 and 4 the prefill is no longer than the conv window."""
    _, cfg = _configs(dtype="float32", scan_impl=scan_impl)
    _, p = params(*_configs(dtype="float32"), seed=2)
    _, batch = batches(cfg, 2, S, seed=2)
    logits, _ = forward(cfg, p, batch)
    b_prefix = {k: v[:, :-1] for k, v in batch.items()}
    _, cache = prefill(cfg, p, b_prefix, max_len=S + 4)
    dec, cache2 = decode_step(cfg, p, batch["tokens"][:, -1:], cache)
    np.testing.assert_allclose(f32(dec[:, 0]), f32(logits[:, -1]), **TOL)
    assert cache2["index"].tolist() == [S, S]


def test_decode_updates_the_cache_in_place():
    _, cfg = _configs(dtype="float32")
    _, p = params(*_configs(dtype="float32"))
    cache = init_cache(cfg, 2, 16, "cpu")
    before = {k: t.clone() for k, t in cache.items()}
    _, new = decode_step(cfg, p, torch.tensor([[3], [5]]), cache)
    for name in CACHE_KEYS:
        assert new[name] is cache[name], name
        assert not torch.equal(cache[name], before[name]), name
    assert new["index"].tolist() == [1, 1]
    assert cache["index"].tolist() == [0, 0]


def test_init_cache_matches_reference_layout():
    from repro.models import init_cache as jinit_cache
    jcfg, tcfg = _configs()
    jc = jinit_cache(jcfg, 3, 20)
    tc = init_cache(tcfg, 3, 20, "cpu")
    assert sorted(tc) == sorted(jc)
    for name in jc:
        assert tuple(tc[name].shape) == jc[name].shape, name
        assert str(tc[name].dtype).split(".")[-1] == str(jc[name].dtype)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_then_reference_forward(param_dtype):
    """Reference params -> port -> numpy is exact, every leaf keeps its
    stacked axes, and the round-tripped tree runs the reference forward."""
    jcfg, tcfg = _configs(param_dtype=param_dtype)
    jp, tp = params(jcfg, tcfg)
    want = {_path_str(q): np.asarray(x) for q, x in _leaf_paths(jp)}
    assert sorted(want) == sorted(leaf_names(tcfg))
    assert len(want) == 3 + 4 + 12 + 3 + 2
    back = params_to_numpy(tcfg, tp)
    got = {_path_str(q): x for q, x in _leaf_paths(back)}
    for name, a in want.items():
        assert got[name].dtype == a.dtype and got[name].shape == a.shape
        np.testing.assert_array_equal(got[name].view(np.uint8),
                                      a.view(np.uint8), err_msg=name)
    assert want["blocks/mamba/in_proj"].shape[:2] == (1, 7)
    assert want["blocks/mlp/wo"].shape[:2] == (1, 8)
    assert want["blocks/ln_mix"].shape == (1, 8, 64)
    assert tp["blocks"][0]["mamba"][6]["A_log"].dtype == torch.float32
    np.testing.assert_array_equal(
        f32(tp["blocks"][0]["mamba"][3]["x_proj"]),
        want["blocks/mamba/x_proj"][0, 3].astype(np.float32))
    jb, _ = batches(tcfg, 1, 16)
    back_j = jax.tree.map(jnp.asarray, back)
    np.testing.assert_array_equal(
        np.asarray(jforward(jcfg, back_j, jb)[0], np.float32),
        np.asarray(jforward(jcfg, jp, jb)[0], np.float32))


def test_init_matches_reference_shapes_and_dtypes():
    """Seeded init: the reference's leaf shapes and dtypes (A_log and D
    stay f32 under bf16 params) and its A_log / dt_bias values."""
    jcfg, tcfg = _configs(param_dtype="bfloat16")
    jp = params(jcfg, tcfg)[0]
    tp = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    want = {_path_str(q): x for q, x in _leaf_paths(jp)}
    got = {_path_str(q): x for q, x in _leaf_paths(params_to_numpy(tcfg, tp))}
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        assert (got[name].dtype, got[name].shape) == (a.dtype, a.shape), name
    np.testing.assert_allclose(got["blocks/mamba/A_log"],
                               np.asarray(want["blocks/mamba/A_log"]),
                               rtol=1e-6)
    dt = np.log1p(np.exp(got["blocks/mamba/dt_bias"].astype(np.float32)))
    assert 9e-4 <= dt.min() and dt.max() <= 0.11


def test_experts_sit_at_the_references_positions():
    """The published config has experts on odd positions: a superblock
    holds 4 MLP and 4 MoE layers, in the reference's order."""
    from repro.models.hybrid import _positions as jpositions
    from repro_torch.models.hybrid import _positions, n_moe
    jcfg, tcfg = configs(ARCH)
    assert tcfg.is_moe and _positions(tcfg) == jpositions(jcfg)
    assert [f for _, f in _positions(tcfg)] == ["mlp", "moe"] * 4
    p = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert n_moe(tcfg) == 4
    assert len(p["blocks"][0]["moe"]) == len(p["blocks"][0]["mlp"]) == 4
    assert sorted(init_cache(tcfg, 1, 8, "cpu")) == sorted(CACHE_KEYS +
                                                           ("index",))


@pytest.mark.parametrize("scan_impl", ["xla", "pallas"])
def test_forward_and_loss_with_experts_match_jax(scan_impl):
    """Jamba with its experts: the Mamba scan and the MoE expert products
    both follow scan_impl; the four MoE layers' aux losses are summed."""
    jcfg, tcfg = configs(ARCH, dtype="float32", scan_impl=scan_impl)
    jp, tp = params(jcfg, tcfg)
    jb, tb = _with_targets(tcfg, *batches(tcfg, 2, 64))
    jl, ja = jax.jit(lambda p, b: jforward(jcfg, p, b))(jp, jb)
    tl, ta = forward(tcfg, tp, tb)
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    assert float(ta) > 0.0
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    jtotal, jm = jax.jit(lambda p, b: jloss_fn(jcfg, p, b))(jp, jb)
    ttotal, tm = loss_fn(tcfg, tp, tb)
    np.testing.assert_allclose(f32(ttotal), f32(jtotal), **TOL)
    for name in ("ce", "z", "aux", "tokens"):
        np.testing.assert_allclose(f32(tm[name]), f32(jm[name]), **TOL)


@pytest.mark.parametrize("scan_impl", ["xla", "pallas"])
def test_prefill_and_decode_with_experts_match_jax(scan_impl):
    jcfg, tcfg = configs(ARCH, dtype="float32", scan_impl=scan_impl)
    jp, tp = params(jcfg, tcfg, seed=1)
    jb, tb = batches(tcfg, 2, 12, seed=1)
    jl, jc = jprefill(jcfg, jp, jb, max_len=20)
    tl, tc = prefill(tcfg, tp, tb, max_len=20)
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    for name in CACHE_KEYS:
        np.testing.assert_allclose(f32(tc[name]), f32(jc[name]), **TOL)
    jstep = jax.jit(lambda p, t, c: jdecode(jcfg, p, t, c))
    toks = np.array([[3], [7]], np.int32)
    for _ in range(3):
        jl, jc = jstep(jp, jnp.asarray(toks), jc)
        tl, tc = decode_step(tcfg, tp, torch.from_numpy(toks).long(), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
        toks = np.array(jnp.argmax(jl[:, 0], -1), np.int32)[:, None]
    for name in CACHE_KEYS:
        np.testing.assert_allclose(f32(tc[name]), f32(jc[name]), **TOL)


def test_decode_with_experts_matches_forward():
    """prefill(S-1) + decode == forward(S)[-1] with experts, where
    capacity_factor=8 (at least E / k = 4 here) gives C >= T, room for
    every token (capacity depends on how many tokens are routed together,
    in the reference too)."""
    _, cfg = configs(ARCH, dtype="float32", scan_impl="pallas")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    _, p = params(*configs(ARCH, dtype="float32"), seed=2)
    _, batch = batches(cfg, 2, 21, seed=2)
    logits, _ = forward(cfg, p, batch)
    _, cache = prefill(cfg, p, {k: v[:, :-1] for k, v in batch.items()},
                       max_len=32)
    dec, _ = decode_step(cfg, p, batch["tokens"][:, -1:], cache)
    np.testing.assert_allclose(f32(dec[:, 0]), f32(logits[:, -1]), **TOL)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_with_experts(param_dtype):
    """MoE leaves stack [nb, n_moe, ...], the MLP list shrinks to n_mlp,
    and the router stays f32."""
    jcfg, tcfg = configs(ARCH, param_dtype=param_dtype)
    jp, tp = params(jcfg, tcfg)
    want = {_path_str(q): np.asarray(x) for q, x in _leaf_paths(jp)}
    assert sorted(want) == sorted(leaf_names(tcfg))
    assert want["blocks/moe/wi_gate"].shape == (1, 4, 8, 64, 64)
    assert want["blocks/mlp/wo"].shape[:2] == (1, 4)
    assert tp["blocks"][0]["moe"][3]["router"].dtype == torch.float32
    np.testing.assert_array_equal(
        f32(tp["blocks"][0]["moe"][2]["wo"]),
        want["blocks/moe/wo"][0, 2].astype(np.float32))
    got = {_path_str(q): x
           for q, x in _leaf_paths(params_to_numpy(tcfg, tp))}
    for name, a in want.items():
        assert got[name].dtype == a.dtype and got[name].shape == a.shape
        np.testing.assert_array_equal(got[name].view(np.uint8),
                                      a.view(np.uint8), err_msg=name)


def test_config_matches_reference_field_by_field():
    got, want = reference_fields(get_config(ARCH), jax_config(ARCH))
    assert got == want
