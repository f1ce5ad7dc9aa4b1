"""Port's ServeEngine vs the JAX package's, tick for tick, on the CPU."""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import cache_logical_axes
from repro.models.attention import attention_decode as jattention_decode
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.models.attention import attention_decode
from repro_torch.models import cache_batch_axes, prefill
from repro_torch.serve.engine import Request, ServeEngine
from _torch_parity import configs, f32, params

PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13, 14, 15, 16], [20, 21],
           [30, 31, 32, 33]]


def _serve(engine_cls, request_cls, cfg, p, prompts, *, slots, max_len,
           max_new, **kw):
    eng = engine_cls(cfg, p, slots=slots, max_len=max_len, **kw)
    for i, pr in enumerate(prompts):
        eng.add_request(request_cls(rid=i, prompt=pr, max_new_tokens=max_new))
    eng.run_until_done()
    return eng


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_engine_matches_jax_engine(impl):
    """Same f32 params and requests: identical greedy tokens."""
    jcfg, tcfg = configs("qwen3-8b", dtype="float32")
    jp, tp = params(jcfg, tcfg)
    je = _serve(JServeEngine, JRequest, jcfg, jp, PROMPTS, slots=3,
                max_len=64, max_new=6)
    te = _serve(ServeEngine, Request, tcfg.replace(attention_impl=impl), tp,
                PROMPTS, slots=3, max_len=64, max_new=6, device="cpu")
    for i in range(len(PROMPTS)):
        assert te.requests[i].output == je.requests[i].output, i
        assert te.requests[i].done
    assert te.tokens_generated == je.tokens_generated
    np.testing.assert_array_equal(te.cache["index"].numpy(),
                                  np.asarray(je.cache["index"]))


def test_slot_past_max_len_drops_writes_like_jax():
    """Decoding past max_len: the reference's scatter drops the write."""
    jcfg, tcfg = configs("qwen3-8b", dtype="float32")
    jp, tp = params(jcfg, tcfg, seed=3)
    prompts = [[5, 6, 7, 8, 9, 10]]
    je = _serve(JServeEngine, JRequest, jcfg, jp, prompts, slots=1,
                max_len=8, max_new=6)
    te = _serve(ServeEngine, Request, tcfg, tp, prompts, slots=1, max_len=8,
                max_new=6, device="cpu")
    assert int(te.cache["index"][0]) == 6 + 5 > 8
    assert te.requests[0].output == je.requests[0].output
    np.testing.assert_allclose(f32(te.cache["k"]), f32(je.cache["k"]),
                               rtol=1e-5, atol=1e-5)


def test_attention_decode_drop_leaves_cache_row_untouched():
    jcfg, tcfg = configs("qwen3-8b", dtype="float32")
    jp, tp = params(jcfg, tcfg, seed=4)
    rng = np.random.default_rng(4)
    B, Smax = 3, 5
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((B, Smax, tcfg.kv_dim)).astype(np.float32)
    cv = rng.standard_normal((B, Smax, tcfg.kv_dim)).astype(np.float32)
    index = np.array([2, Smax, Smax + 3], np.int32)   # slots 1, 2 overflow
    lp_j = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    jo, jk, jv = jattention_decode(jcfg, lp_j, jnp.asarray(x),
                                   jnp.asarray(index[:, None]),
                                   jnp.asarray(ck), jnp.asarray(cv),
                                   jnp.asarray(index))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    to, tk2, tv2 = attention_decode(tcfg, tp["blocks"][0]["attn"],
                                    torch.from_numpy(x),
                                    torch.from_numpy(index[:, None]), tk, tv,
                                    torch.from_numpy(index))
    assert tk2 is tk and tv2 is tv                    # updated in place
    np.testing.assert_array_equal(tk[1:].numpy(), ck[1:])
    assert not np.array_equal(tk[0, 2].numpy(), ck[0, 2])
    np.testing.assert_allclose(f32(tk), f32(jk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f32(tv), f32(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f32(to), f32(jo), rtol=1e-4, atol=1e-4)


def test_continuous_batching_matches_single_slot():
    _, cfg = configs("qwen3-8b")
    _, p = params(*configs("qwen3-8b"))
    prompts = PROMPTS[:4]
    eng = _serve(ServeEngine, Request, cfg, p, prompts, slots=3, max_len=64,
                 max_new=5, device="cpu")
    for i, pr in enumerate(prompts):
        solo = _serve(ServeEngine, Request, cfg, p, [pr], slots=1,
                      max_len=64, max_new=5, device="cpu")
        assert eng.requests[i].output == solo.requests[0].output, i


def test_engine_reuses_slots():
    _, cfg = configs("qwen3-4b")
    _, p = params(*configs("qwen3-4b"))
    eng = _serve(ServeEngine, Request, cfg, p,
                 [[1 + i, 2 + i] for i in range(5)], slots=2, max_len=64,
                 max_new=3, device="cpu")
    assert all(eng.requests[i].done for i in range(5))
    assert eng.tokens_generated >= 5 * 2   # decode tokens (prefill emits 1st)


def test_temperature_samples_first_token_from_own_generator():
    """Only the admission token uses the temperature (reference quirk);
    the same seed gives the same tokens."""
    _, cfg = configs("qwen3-8b", dtype="float32")
    _, p = params(*configs("qwen3-8b", dtype="float32"))
    outs = []
    for _ in range(2):
        eng = ServeEngine(cfg, p, slots=2, max_len=32, seed=7, device="cpu")
        eng.add_request(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=4,
                                temperature=1.0))
        eng.run_until_done()
        outs.append(eng.requests[0].output)
    assert outs[0] == outs[1] and len(outs[0]) == 4


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, cfg = configs("qwen3-8b")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, {}, slots=1, max_len=8)


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-3b",
                                  "jamba-1.5-large-398b"])
def test_cache_batch_axes_are_the_references_batch_axes(arch):
    """The engine splices each entry along the axis the reference's
    ``cache_logical_axes`` names "batch": axis 1 for dense and RWKV6 (as
    before), axis 2 for the hybrid conv/ssm."""
    jcfg, tcfg = configs(arch, moe=None)
    want = {k: ax.index("batch") for k, ax in cache_logical_axes(jcfg).items()}
    assert cache_batch_axes(tcfg) == want


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-3b"])
def test_splice_cache_still_writes_axis_1(arch):
    """Dense and RWKV6: admitting a request into slot 1 writes batch index
    1 of every entry and nothing else, as the axis-1 splice did."""
    _, cfg = configs(arch, dtype="float32")
    _, p = params(*configs(arch, dtype="float32"))
    eng = ServeEngine(cfg, p, slots=3, max_len=16, device="cpu")
    eng.slot_states[0].active = True              # slot 0 busy -> slot 1
    eng.add_request(Request(rid=0, prompt=[4, 5, 6, 7], max_new_tokens=2))
    eng._admit()
    _, one = prefill(cfg, p, {"tokens": torch.tensor([[4, 5, 6, 7]]),
                              "positions": torch.arange(4)[None]}, max_len=16)
    for name, pool in eng.cache.items():
        if name == "index":
            continue
        assert torch.equal(pool[:, 1:2], one[name]), name
        assert float(pool[:, 0].abs().sum()) == 0.0
        assert float(pool[:, 2].abs().sum()) == 0.0
    assert eng.cache["index"].tolist() == [0, 4, 0]
