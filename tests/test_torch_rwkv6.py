"""Port's RWKV6 family (forward / loss / prefill / decode / serving) vs the
JAX package's, on the CPU.

Both packages run the same JAX-made parameters (bridged through numpy) on
the same numpy token batches of the tiny ``rwkv6-3b`` (2 layers, d_model
64, head_dim 16).  Parity runs in f32 at 1e-4 unless a test says
otherwise; the JAX ``pallas`` scan runs in interpret mode.
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
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bridge import leaf_names, params_from_numpy, params_to_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import ops as tops
from repro_torch.models import (
    decode_step, forward, init_cache, init_params, loss_fn, prefill,
)
from repro_torch.serve.engine import Request, ServeEngine
from _torch_parity import batches, configs, f32, params

ARCH = "rwkv6-3b"
TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_KEYS = ("tshift", "cshift", "wkv")


def _with_targets(cfg, jb, tb, seed=0):
    """Add the same next-token targets, a few masked (-1), to both batches."""
    rng = np.random.default_rng(seed)
    tg = rng.integers(0, cfg.vocab_size, tb["tokens"].shape).astype(np.int32)
    tg[:, ::5] = -1
    jb = dict(jb, targets=jnp.asarray(tg))
    tb = dict(tb, targets=torch.from_numpy(tg).long())
    return jb, tb


def test_config_matches_reference_field_by_field():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jax_config(ARCH))
    jcfg, tcfg = configs(ARCH)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.num_layers, tcfg.d_model, tcfg.rwkv.head_dim) == (2, 64, 16)


@pytest.mark.parametrize("scan_impl", ["xla", "xla_seq", "pallas"])
def test_forward_and_loss_match_jax(scan_impl):
    jcfg, tcfg = configs(ARCH, dtype="float32", scan_impl=scan_impl)
    jp, tp = params(jcfg, tcfg)
    jb, tb = _with_targets(tcfg, *batches(tcfg, 2, 128))
    jl, _ = jax.jit(lambda p, b: jforward(jcfg, p, b))(jp, jb)
    tl, aux = forward(tcfg, tp, tb)
    assert tl.shape == (2, 128, tcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    jtotal, jm = jax.jit(lambda p, b: jloss_fn(jcfg, p, b))(jp, jb)
    ttotal, tm = loss_fn(tcfg, tp, tb)
    np.testing.assert_allclose(f32(ttotal), f32(jtotal), **TOL)
    for name in ("ce", "z", "aux", "tokens"):
        np.testing.assert_allclose(f32(tm[name]), f32(jm[name]), **TOL)


def test_pallas_forward_runs_the_scan_once_per_layer_and_prefill_never(
        monkeypatch):
    """scan_impl="pallas" reaches ops.rwkv6_scan in forward only: prefill
    needs the final state, which the kernel does not return."""
    _, tcfg = configs(ARCH, dtype="float32", scan_impl="pallas")
    tp = params(*configs(ARCH, dtype="float32"))[1]
    _, tb = batches(tcfg, 1, 70)
    calls = []
    real = tops.rwkv6_scan
    monkeypatch.setattr(tops, "rwkv6_scan",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    lo_k, _ = forward(tcfg, tp, tb)
    assert calls == [(1, 70, 4, 16)] * tcfg.num_layers
    lo_x, _ = forward(tcfg.replace(scan_impl="xla"), tp, tb)
    np.testing.assert_allclose(f32(lo_k), f32(lo_x), **TOL)
    prefill(tcfg, tp, tb, max_len=70)
    assert len(calls) == tcfg.num_layers


@pytest.mark.parametrize("S", [12, 100])
def test_prefill_and_decode_match_jax(S):
    """S=100 is one reference chunk of 100 tokens and, in the port, a
    64-token chunk and a 36-token one: the same math, other rounding."""
    jcfg, tcfg = configs(ARCH, dtype="float32")
    jp, tp = params(jcfg, tcfg, seed=1)
    jb, tb = batches(tcfg, 2, S, seed=1)
    jl, jc = jax.jit(lambda p, b: jprefill(jcfg, p, b, max_len=S + 8))(jp, jb)
    tl, tc = prefill(tcfg, tp, tb, max_len=S + 8)
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    assert sorted(tc) == sorted(jc)
    for name in CACHE_KEYS:
        assert tuple(tc[name].shape) == jc[name].shape, name
        assert f32(tc[name]).dtype == np.float32
        np.testing.assert_allclose(f32(tc[name]), f32(jc[name]), **TOL)
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


def test_decode_matches_forward():
    """prefill(S-1 tokens) + decode(last) == forward(S tokens)[-1]."""
    _, cfg = configs(ARCH)
    _, p = params(*configs(ARCH))
    _, batch = batches(cfg, 2, 16)
    logits, _ = forward(cfg, p, batch)
    b_prefix = {k: v[:, :-1] for k, v in batch.items()}
    _, cache = prefill(cfg, p, b_prefix, max_len=16 + 8)
    dec, cache2 = decode_step(cfg, p, batch["tokens"][:, -1:], cache)
    err = float((dec[:, 0].float() - logits[:, -1].float()).abs().max())
    assert err < 1e-2, err
    assert int(cache2["index"][0]) == 16


def test_decode_updates_the_cache_in_place():
    _, cfg = configs(ARCH, dtype="float32")
    _, p = params(*configs(ARCH, dtype="float32"))
    cache = init_cache(cfg, 2, 8, device="cpu")
    assert cache["wkv"].shape == (2, 2, 4, 16, 16)
    assert cache["wkv"].dtype == torch.float32
    assert cache["tshift"].shape == (2, 2, 64)
    ptrs = {k: cache[k].data_ptr() for k in CACHE_KEYS}
    _, new = decode_step(cfg, p, torch.tensor([[1], [2]]), cache)
    assert {k: new[k].data_ptr() for k in CACHE_KEYS} == ptrs
    assert float(cache["wkv"].abs().sum()) > 0.0
    assert new["index"].tolist() == [1, 1] and cache["index"].tolist() == [0, 0]


PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13, 14, 15, 16], [20, 21],
           [30, 31, 32, 33]]


def _serve(engine_cls, request_cls, cfg, p, prompts, *, slots, max_len,
           max_new, **kw):
    eng = engine_cls(cfg, p, slots=slots, max_len=max_len, **kw)
    for i, pr in enumerate(prompts):
        eng.add_request(request_cls(rid=i, prompt=pr, max_new_tokens=max_new))
    eng.run_until_done()
    return eng


@pytest.mark.parametrize("scan_impl", ["xla", "pallas"])
def test_engine_matches_jax_engine(scan_impl):
    """Same f32 params and requests: identical greedy tokens, tick for
    tick, and the same final state in every slot."""
    jcfg, tcfg = configs(ARCH, dtype="float32")
    jp, tp = params(jcfg, tcfg)
    je = _serve(JServeEngine, JRequest, jcfg, jp, PROMPTS, slots=3,
                max_len=64, max_new=6)
    te = _serve(ServeEngine, Request, tcfg.replace(scan_impl=scan_impl), tp,
                PROMPTS, slots=3, max_len=64, max_new=6, device="cpu")
    for i in range(len(PROMPTS)):
        assert te.requests[i].output == je.requests[i].output, i
        assert te.requests[i].done
    assert te.tokens_generated == je.tokens_generated
    for name in CACHE_KEYS:
        np.testing.assert_allclose(f32(te.cache[name]), f32(je.cache[name]),
                                   **TOL)
    np.testing.assert_array_equal(te.cache["index"].numpy(),
                                  np.asarray(je.cache["index"]))


def test_splice_cache_writes_one_slot_along_axis_1():
    """The SSM cache keeps batch on axis 1, like dense k/v: admitting a
    request into slot 1 writes that slot's state and nothing else."""
    _, cfg = configs(ARCH, dtype="float32")
    _, p = params(*configs(ARCH, dtype="float32"))
    eng = ServeEngine(cfg, p, slots=3, max_len=16, device="cpu")
    eng.slot_states[0].active = True              # slot 0 busy -> slot 1
    eng.add_request(Request(rid=0, prompt=[4, 5, 6, 7], max_new_tokens=2))
    eng._admit()
    _, one = prefill(cfg, p, {"tokens": torch.tensor([[4, 5, 6, 7]]),
                              "positions": torch.arange(4)[None]}, max_len=16)
    for name in CACHE_KEYS:
        pool = eng.cache[name]
        np.testing.assert_array_equal(pool[:, 1:2].numpy(), one[name].numpy())
        assert float(pool[:, 0].abs().sum()) == 0.0
        assert float(pool[:, 2].abs().sum()) == 0.0
    assert eng.cache["index"].tolist() == [0, 4, 0]


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_every_ssm_leaf(param_dtype):
    jcfg, tcfg = configs(ARCH, param_dtype=param_dtype)
    jp, tp = params(jcfg, tcfg)
    want = {_path_str(q): np.asarray(x) for q, x in _leaf_paths(jp)}
    assert sorted(want) == sorted(leaf_names(tcfg))
    assert len(want) == 3 + 21                     # embed, unembed, norm
    back = {_path_str(q): x
            for q, x in _leaf_paths(params_to_numpy(tcfg, tp))}
    assert sorted(back) == sorted(want)
    for name, a in want.items():
        assert back[name].dtype == a.dtype and back[name].shape == a.shape
        np.testing.assert_array_equal(back[name].view(np.uint8),
                                      a.view(np.uint8), err_msg=name)
    assert tp["blocks"][1]["u"].dtype == torch.float32
    assert tp["blocks"][1]["decay_base"].dtype == torch.float32
    flat = params_from_numpy(tcfg, want, "cpu")
    np.testing.assert_array_equal(f32(flat["blocks"][1]["mix_w2"]),
                                  want["blocks/mix_w2"][1].astype(np.float32))


def test_init_matches_reference_shapes_and_dtypes():
    """Seeded init: the reference's leaf shapes and dtypes (decay_base and
    u stay f32 under bf16 params) and its value ranges."""
    jcfg, tcfg = configs(ARCH, param_dtype="bfloat16")
    jp = params(jcfg, tcfg)[0]
    gen = torch.Generator().manual_seed(0)
    tp = init_params(tcfg, gen, "cpu")
    want = {_path_str(q): x for q, x in _leaf_paths(jp)}
    got = {_path_str(q): x for q, x in _leaf_paths(params_to_numpy(tcfg, tp))}
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        assert (got[name].dtype, got[name].shape) == (a.dtype, a.shape), name
    blk = tp["blocks"][0]
    assert -6.0 <= float(blk["decay_base"].min()) <= \
        float(blk["decay_base"].max()) <= -4.0
    assert -1.0 <= float(blk["u"].min()) and float(blk["u"].max()) <= 1.0
    assert 0.0 <= float(blk["mu"].float().min())
