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
    """The checks run before any CUDA launch (no card needed).  The kernels
    take D in {16, 32, 64, 128} and any strides whose last is 1, so what is
    refused is another head dim and a last dim that is not dense."""
    _, (q, k, v) = _inputs(1, "float32", (1, 2, 8, 64), (1, 2, 8, 64),
                           (1, 2, 8, 64))
    tfa._check(q, k, v, 0)
    tfa._check(q[..., :32].contiguous(), k[..., :32].contiguous(),
               v[..., :32].contiguous(), 0)             # head_dim 32
    tfa._check(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, 0)
    with pytest.raises(ValueError):
        tfa._check(q, k, v, -1)
    with pytest.raises(ValueError):
        tfa._check(q[..., :48].contiguous(), k[..., :48].contiguous(),
                   v[..., :48].contiguous(), 0)          # head_dim 48
    with pytest.raises(ValueError):                      # last stride 8
        tfa._check(torch.randn(1, 2, 64, 8).transpose(2, 3), k, v, 0)
    with pytest.raises(TypeError):
        tfa._check(q.half(), k.half(), v.half(), 0)
    with pytest.raises(ValueError):
        tfa._check(q, k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1),
                   0)                                     # 2 q heads, 3 kv


@pytest.mark.parametrize("D", [16, 32, 48, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
def test_route_by_dtype_and_head_dim(dtype, D):
    """bf16 at D in {64, 128} takes the wgmma kernel, other bf16 the
    mma.sync kernel, float32 the FMA kernel; ``_check`` refuses the head
    dims and dtypes that no kernel takes."""
    dt = getattr(torch, dtype)
    want = ("wgmma" if D in (64, 128) else "mma_sync") \
        if dtype == "bfloat16" else "f32"
    assert tfa.route(dt, D) == want
    assert want in tfa.ROUTES
    assert (D in tfa.HEAD_DIMS) == (D in (16, 32, 64, 128))


def test_aligned_copies_only_what_tma_cannot_address():
    """Strides of the model layout pass as they are; a row stride that is
    not a multiple of 16 bytes is copied to a dense tensor."""
    x = torch.randn(2, 40, 6, 64, dtype=torch.bfloat16)
    view = x[:, :, 1:5].transpose(1, 2)                  # heads 1..4
    assert tfa._aligned(view) is view
    odd = torch.randn(1, 2, 8, 65, dtype=torch.bfloat16)[..., :64]
    fixed = tfa._aligned(odd)
    assert fixed is not odd and fixed.is_contiguous()
    assert torch.equal(fixed, odd)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,q_offset", [
    (2, 77, 77, 4, 2, 64, True, 0),           # ragged Sq, one partial block
    (1, 77, 256, 4, 2, 64, True, 179),        # ragged Sq, q_offset > 0
    (2, 128, 256, 8, 2, 16, False, 0),        # Sq != Skv, tiny head dim
    (1, 64, 384, 4, 4, 32, True, 320),
])
def test_ops_strided_views_match_contiguous_and_jax(B, Sq, Skv, Hq, Hkv, D,
                                                     causal, q_offset):
    """kernels/ops.py hands the kernel [B,S,H,D] views through strides: q,
    k and v cut from one fused [B,S,Hq+2Hkv,D] tensor (none contiguous)
    give the contiguous call's result and the reference's, in f32."""
    from repro.kernels import ops as jops
    rng = np.random.default_rng(B * Sq + Skv + D)
    qf = rng.standard_normal((B, Sq, Hq + 2 * Hkv, D)).astype(np.float32)
    kvf = rng.standard_normal((B, Skv, Hq + 2 * Hkv, D)).astype(np.float32)
    fq, fkv = torch.from_numpy(qf), torch.from_numpy(kvf)
    q = fq[:, :, :Hq]
    k, v = fkv[:, :, Hq:Hq + Hkv], fkv[:, :, Hq + Hkv:]
    assert not any(t.is_contiguous() for t in (q, k, v))
    kw = dict(causal=causal, q_offset=q_offset)
    got = tops.flash_attention(q, k, v, **kw)
    dense = tops.flash_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), **kw)
    want = jops.flash_attention(jnp.asarray(qf[:, :, :Hq]),
                                jnp.asarray(kvf[:, :, Hq:Hq + Hkv]),
                                jnp.asarray(kvf[:, :, Hq + Hkv:]), **kw)
    assert got.shape == (B, Sq, Hq, D)
    np.testing.assert_allclose(_f32(got), _f32(dense), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)
