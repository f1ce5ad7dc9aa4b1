"""Port's flash attention (plain version on the CPU) vs the JAX package's.

Same numpy inputs through the JAX Pallas kernel in interpret mode and its
oracle, and through the port's wrapper (which runs its plain version on a
CPU tensor) and oracle.  Sweep and tolerances are those of
tests/test_kernels.py::test_flash_attention_sweep.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax.numpy as jnp
import numpy as np

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, dtype, *shapes):
    rng = np.random.default_rng(seed)
    jdt, tdt = _DT[dtype]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", [
    (1, 2, 2, 128, 128, 64),       # MHA square
    (2, 4, 2, 256, 256, 64),       # GQA
    (1, 8, 1, 128, 128, 128),      # MQA, 128-wide head
    (2, 2, 2, 128, 384, 64),       # kv-longer (q_offset causal)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(B, Hq, Hkv, Sq, Skv, D, dtype, causal):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        Sq + Skv + D, dtype, (B, Hq, Sq, D), (B, Hkv, Skv, D),
        (B, Hkv, Skv, D))
    q_offset = Skv - Sq if causal else 0
    want = jflash(jq, jk, jv, causal=causal, q_offset=q_offset,
                  block_q=64, block_k=64, interpret=True)
    want_ref = jref.attention_ref(jq, jk, jv, causal=causal,
                                  q_offset=q_offset)
    launches = tfa.flash_attention.launches
    got = tfa.flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset,
                              block_q=64, block_k=64)
    got_ref = tref.attention_ref(tq, tk, tv, causal=causal, q_offset=q_offset)
    assert tfa.flash_attention.launches == launches   # CPU: plain version
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))
    np.testing.assert_allclose(_f32(got_ref), _f32(want_ref), **_tol(dtype))
    np.testing.assert_allclose(_f32(got), _f32(got_ref), **_tol(dtype))


@pytest.mark.parametrize("Sq,Skv,causal,q_offset", [
    (77, 77, True, 0),       # ragged, one partial block
    (200, 333, True, 133),   # ragged, kv-longer
    (130, 90, False, 0),
])
def test_flash_plain_ragged_matches_oracle(Sq, Skv, causal, q_offset):
    """The plain version takes any lengths, as the CUDA kernel does."""
    _, (q, k, v) = _inputs(Sq * Skv, "float32", (1, 4, Sq, 64),
                           (1, 2, Skv, 64), (1, 2, Skv, 64))
    got = tfa.flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                    block_q=64, block_k=64)
    want = tref.attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_ops_model_layout_matches_jax():
    """kernels/ops.py: [B,S,H,D] in and out, same transposes as JAX."""
    from repro.kernels import ops as jops
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        7, "float32", (2, 128, 4, 64), (2, 128, 2, 64), (2, 128, 2, 64))
    want = jops.flash_attention(jq, jk, jv, causal=True)
    got = tops.flash_attention(tq, tk, tv, causal=True)
    assert got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    """The checks run before any CUDA launch (no card needed)."""
    _, (q, k, v) = _inputs(1, "float32", (1, 2, 8, 64), (1, 2, 8, 64),
                           (1, 2, 8, 64))
    tfa._check(q, k, v, 0)
    with pytest.raises(ValueError):
        tfa._check(q, k, v, -1)
    with pytest.raises(ValueError):
        tfa._check(q[..., :32].contiguous(), k[..., :32].contiguous(),
                   v[..., :32].contiguous(), 0)          # head_dim 32
    with pytest.raises(ValueError):
        tfa._check(q.transpose(2, 3), k, v, 0)            # not contiguous
    with pytest.raises(TypeError):
        tfa._check(q.half(), k.half(), v.half(), 0)
    with pytest.raises(ValueError):
        tfa._check(q, k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1),
                   0)                                     # 2 q heads, 3 kv

