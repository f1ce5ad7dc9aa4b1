"""Port's dense model (forward / prefill / decode) vs the JAX package's.

Both packages run the same JAX-made parameters (bridged through numpy) on
the same token batches.  Parity runs in f32 (1e-4), where the algorithm
is the point; the mirrors of the reference's own tests keep its bf16
activations and tolerances.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax
import numpy as np

from repro.configs import get_config as jax_config
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import prefill as jprefill
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import decode_step, forward, prefill
from _torch_parity import batches, configs, f32, params, reference_fields

TOL = dict(rtol=1e-4, atol=1e-4)
QWEN3 = ["qwen3-8b", "qwen3-4b"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_match_reference_field_by_field(arch):
    """Every field of the reference's config, with its value; the port's
    own fields (``PORT_ONLY``: the router's ``norm_topk_prob``) at the
    defaults that compute the reference's function."""
    got, want = reference_fields(get_config(arch), jax_config(arch))
    assert got == want
    jcfg, tcfg = configs(arch)
    got, want = reference_fields(tcfg, jcfg)
    assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_jax(arch):
    """Every ported arch with its FFNs dense (``moe=None``); the experts
    are held to the reference in ``test_torch_moe.py`` and
    ``test_torch_hybrid.py``."""
    jcfg, tcfg = configs(arch, dtype="float32", moe=None)
    jp, tp = params(jcfg, tcfg)
    jb, tb = batches(tcfg, 2, 16)
    jl, _ = jax.jit(lambda p, b: jforward(jcfg, p, b))(jp, jb)
    tl, aux = forward(tcfg, tp, tb)
    assert tl.shape == (2, 16, tcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)


@pytest.mark.parametrize("arch", QWEN3)
def test_prefill_and_decode_match_jax(arch):
    jcfg, tcfg = configs(arch, dtype="float32")
    jp, tp = params(jcfg, tcfg, seed=1)
    jb, tb = batches(tcfg, 2, 12, seed=1)
    jl, jc = jax.jit(lambda p, b: jprefill(jcfg, p, b, max_len=20))(jp, jb)
    tl, tc = prefill(tcfg, tp, tb, max_len=20)
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    for name in ("k", "v"):
        assert tc[name].shape == jc[name].shape
        np.testing.assert_allclose(f32(tc[name]), f32(jc[name]), **TOL)
    np.testing.assert_array_equal(tc["index"].numpy(), np.asarray(jc["index"]))

    jstep = jax.jit(lambda p, t, c: jdecode(jcfg, p, t, c))
    toks = np.array([[3], [7]], np.int32)
    for _ in range(3):
        jl, jc = jstep(jp, jax.numpy.asarray(toks), jc)
        tl, tc = decode_step(tcfg, tp, torch.from_numpy(toks).long(), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
        toks = np.array(jax.numpy.argmax(jl[:, 0], -1), np.int32)[:, None]
    for name in ("k", "v"):
        np.testing.assert_allclose(f32(tc[name]), f32(jc[name]), **TOL)
    np.testing.assert_array_equal(tc["index"].numpy(), np.asarray(jc["index"]))


@pytest.mark.parametrize("arch", QWEN3)
def test_decode_matches_forward(arch):
    """prefill(S-1 tokens) + decode(last) == forward(S tokens)[-1]."""
    _, cfg = configs(arch)
    _, p = params(*configs(arch))
    _, batch = batches(cfg, 2, 16)
    logits, _ = forward(cfg, p, batch)
    b_prefix = {k: v[:, :-1] for k, v in batch.items()}
    _, cache = prefill(cfg, p, b_prefix, max_len=16 + 8)
    dec, cache2 = decode_step(cfg, p, batch["tokens"][:, -1:], cache)
    err = float((dec[:, 0].float() - logits[:, -1].float()).abs().max())
    assert err < 1e-2, err
    assert int(cache2["index"][0]) == 16


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_prefill_kernel_path_matches_jax(impl):
    """attention_impl reaches the flash path (plain version on the CPU)."""
    jcfg, tcfg = configs("qwen3-8b", dtype="float32", head_dim=64,
                         attention_impl=impl)
    jp, tp = params(jcfg, tcfg, seed=2)
    jb, tb = batches(tcfg, 1, 128, seed=2)
    jl, _ = jprefill(jcfg, jp, jb, max_len=128)
    tl, _ = prefill(tcfg, tp, tb, max_len=128)
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)


def test_flash_matches_model_xla_path():
    """The model's chunked plain attention and the flash path agree, and
    the flash path agrees with the JAX package's (both in bf16)."""
    jcfg, tcfg = configs("qwen3-8b", head_dim=32)
    jp, tp = params(jcfg, tcfg, seed=42)
    jb, tb = batches(tcfg, 2, 128)
    lo_x, _ = forward(tcfg.replace(attention_impl="xla"), tp, tb)
    lo_k, _ = forward(tcfg.replace(attention_impl="pallas"), tp, tb)
    np.testing.assert_allclose(f32(lo_x), f32(lo_k), rtol=5e-2, atol=5e-2)
    jl, _ = jforward(jcfg.replace(attention_impl="pallas"), jp, jb)
    np.testing.assert_allclose(f32(lo_k), f32(jl), rtol=5e-2, atol=5e-2)
