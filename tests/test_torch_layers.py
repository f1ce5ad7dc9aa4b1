"""repro_torch.models.layers vs repro.models.layers on the same f32 inputs."""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax.numpy as jnp
import numpy as np

from repro.models import layers as JL
from repro_torch.models import layers as TL
from _torch_parity import configs, f32

TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(0)


def _pair(*shape, scale=1.0):
    a = (RNG.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def test_rmsnorm():
    jx, tx = _pair(2, 5, 64, scale=3.0)
    js, ts = _pair(64)
    np.testing.assert_allclose(f32(TL.rmsnorm(tx, ts, 1e-6)),
                               f32(JL.rmsnorm(jx, js, 1e-6)), **TOL)


def test_rmsnorm_keeps_bf16():
    x = torch.randn(3, 64).to(torch.bfloat16)
    assert TL.rmsnorm(x, torch.ones(64), 1e-6).dtype == torch.bfloat16


@pytest.mark.parametrize("theta", [1_000_000.0, 10_000.0, 0.0])
def test_apply_rope(theta):
    jx, tx = _pair(2, 7, 4, 32)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [9, 10, 11, 12, 13, 14, 15]],
                   np.int32)
    np.testing.assert_allclose(
        f32(TL.apply_rope(tx, torch.from_numpy(pos), theta)),
        f32(JL.apply_rope(jx, jnp.asarray(pos), theta)), **TOL)
    np.testing.assert_allclose(f32(TL.rope_freqs(32, 1e6)),
                               f32(JL.rope_freqs(32, 1e6)), **TOL)


def test_mlp_apply():
    jcfg, tcfg = configs("qwen3-8b", dtype="float32")
    p = {n: _pair(*s, scale=0.1) for n, s in
         (("wi_gate", (64, 128)), ("wi_up", (64, 128)), ("wo", (128, 64)))}
    jx, tx = _pair(2, 5, 64)
    np.testing.assert_allclose(
        f32(TL.mlp_apply(tcfg, {n: t for n, (_, t) in p.items()}, tx)),
        f32(JL.mlp_apply(jcfg, {n: j for n, (j, _) in p.items()}, jx)), **TOL)


@pytest.mark.parametrize("tied", [False, True])
def test_embed_unembed(tied):
    jcfg, tcfg = configs("qwen3-8b", dtype="float32", tie_embeddings=tied)
    je, te = _pair(512, 64, scale=0.02)
    jp, tp = {"embedding": je}, {"embedding": te}
    if not tied:
        jp["unembed"], tp["unembed"] = _pair(64, 512, scale=0.1)
    toks = RNG.integers(0, 512, (2, 9))
    jh = JL.embed_tokens(jcfg, jp, jnp.asarray(toks, jnp.int32))
    th = TL.embed_tokens(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(f32(th), f32(jh), **TOL)
    np.testing.assert_allclose(f32(TL.unembed(tcfg, tp, th)),
                               f32(JL.unembed(jcfg, jp, jh)), **TOL)


def test_inits_match_reference_in_distribution():
    gen = torch.Generator().manual_seed(0)
    w = TL.dense_init(gen, (256, 512), torch.float32, torch.device("cpu"))
    std = 1.0 / 16.0                                   # fan-in 256
    assert float(w.abs().max()) <= 2 * std + 1e-7      # truncated at 2 sigma
    assert abs(float(w.std()) / std - 0.88) < 0.02     # std of N(0,1) cut at 2
    e = TL.embed_init(gen, (512, 64), torch.bfloat16, torch.device("cpu"))
    assert e.dtype == torch.bfloat16
    assert abs(float(e.float().std()) - 0.02) < 1e-3
