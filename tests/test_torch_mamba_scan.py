"""The port's selective scan (plain version, oracle, model-layout wrapper)
vs the JAX package's Pallas kernel (interpret mode) and oracle, on the CPU.

Inputs come from a numpy seed and go to both packages.  The tolerance is
that of ``tests/test_kernels.py::test_mamba_scan_sweep``: 1e-4.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax.numpy as jnp
import numpy as np

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.mamba_scan import mamba_scan as jmamba_scan
from repro.models.mamba import _scan_chunk as jscan_chunk
from repro_torch.kernels import mamba_scan as tmb
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(B, S, di, N, seed=0, dt=None):
    """A [di,N], dt [B,S,di], b, c [B,S,N], x [B,S,di] as float32 numpy,
    drawn as the JAX sweep draws them (A = -exp(normal), dt =
    softplus(normal)); ``dt`` fixes every step size instead."""
    rng = np.random.default_rng(seed)
    A = -np.exp(rng.standard_normal((di, N)))
    if dt is None:
        dt = np.log1p(np.exp(rng.standard_normal((B, S, di))))
    else:
        dt = np.full((B, S, di), dt)
    b, c = (rng.standard_normal((B, S, N)) for _ in range(2))
    x = rng.standard_normal((B, S, di))
    return [a.astype(np.float32) for a in (A, dt, b, c, x)]


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("B,S,di,N,chunk,block_d", [
    (1, 64, 32, 8, 16, 32),
    (2, 128, 64, 16, 64, 32),
    (1, 256, 128, 16, 32, 64),
])
def test_plain_and_oracle_match_jax_sweep(B, S, di, N, chunk, block_d):
    x = _inputs(B, S, di, N)
    want = np.asarray(jmamba_scan(*_jax(x), chunk=chunk, block_d=block_d,
                                  interpret=True))
    got = tmb.mamba_scan_plain(*_torch(x))
    assert got.shape == (B, S, di) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(tref.mamba_ref(*_torch(x)).numpy(),
                               np.asarray(jref.mamba_ref(*_jax(x))), **TOL)


@pytest.mark.parametrize("S,di", [(1, 32), (3, 40), (77, 24), (130, 130)])
def test_ragged_lengths_match_sequential_oracle(S, di):
    """Any S and di (the JAX kernel asserts both divide its tiles), so
    these go against the sequential oracles."""
    x = _inputs(2, S, di, 8, seed=S)
    got = tmb.mamba_scan(*_torch(x))           # CPU tensor: the plain version
    want = tref.mamba_ref(*_torch(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(want.numpy(),
                               np.asarray(jref.mamba_ref(*_jax(x))), **TOL)


@pytest.mark.parametrize("dt", [30.0, 1e-3])
def test_decay_extremes(dt):
    """dt * |A| up to ~500: exp underflows to 0 and the state forgets at
    once; dt = 1e-3: it barely decays, and the state sums 256 steps."""
    x = _inputs(1, 256, 32, 16, seed=5, dt=dt)
    got = tmb.mamba_scan_plain(*_torch(x)).numpy()
    assert np.isfinite(got).all()
    want = np.asarray(jmamba_scan(*_jax(x), chunk=64, block_d=32,
                                  interpret=True))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, tref.mamba_ref(*_torch(x)).numpy(),
                               **TOL)


def test_cpu_tensor_runs_plain_version_without_a_launch():
    x = _torch(_inputs(1, 70, 48, 16, seed=3))
    before = tmb.mamba_scan.launches
    np.testing.assert_array_equal(tmb.mamba_scan(*x).numpy(),
                                  tmb.mamba_scan_plain(*x).numpy())
    np.testing.assert_array_equal(tops.mamba_scan(*x).numpy(),
                                  tmb.mamba_scan_plain(*x).numpy())
    assert tmb.mamba_scan.launches == before


def test_ops_matches_jax_ops():
    """ops.mamba_scan takes the model layout as the kernel does."""
    x = _inputs(2, 128, 64, 16, seed=4)
    np.testing.assert_allclose(tops.mamba_scan(*_torch(x)).numpy(),
                               np.asarray(jops.mamba_scan(*_jax(x))), **TOL)


@pytest.mark.parametrize("case, exc, match", [
    ("d_state", ValueError, "d_state 4"),
    ("dtype", TypeError, "float32"),
    ("x", ValueError, "want dt = x"),
    ("A", ValueError, "want A"),
    ("b", ValueError, "want b = c"),
    ("layout", ValueError, "contiguous"),
    ("batch", ValueError, "1 <= B <= 65535"),
    ("empty", ValueError, "want S, di >= 1"),
])
def test_check_rejects_what_the_kernel_does_not_take(case, exc, match):
    N = 4 if case == "d_state" else 8
    B, S = {"batch": (65536, 1), "empty": (1, 0)}.get(case, (1, 16))
    A, dt, b, c, x = _torch(_inputs(B, S, 32, N))
    if case == "dtype":
        dt = dt.to(torch.bfloat16)
    elif case == "x":
        x = x[:, :8]
    elif case == "A":
        A = A[:16]
    elif case == "b":
        b = b[:, :, :4]
    elif case == "layout":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(exc, match=match):
        tmb._check(A, dt, b, c, x)


@pytest.mark.parametrize("B,S,di,N,dt", [
    (1, 64, 32, 8, None),          # the JAX sweep's shapes
    (2, 128, 64, 16, None),
    (1, 256, 128, 16, None),
    (2, 1, 32, 8, None),           # ragged S
    (2, 3, 40, 16, None),
    (2, 77, 24, 8, None),
    (2, 130, 130, 16, None),
    (1, 256, 32, 16, 30.0),        # exp underflows: the state forgets
    (1, 256, 32, 8, 1e-3),         # weak decay: it sums every step
    (1, 4096, 16, 16, 1e-3),       # ... over serving's longest prompt
    (1, 4096, 16, 8, 1e-2),
])
def test_final_state_matches_reference_token_loop(B, S, di, N, dt):
    """``return_state`` gives the reference's ``_scan_chunk`` (y, hT) from
    h0 = 0, the path the reference's prefill takes; y stays what the call
    without the state gives, and so does the oracle's state."""
    x = _inputs(B, S, di, N, seed=S + N, dt=dt)
    A, dtv, b, c, xs = _jax(x)
    jy, jh = jscan_chunk(A, dtv, b, c, xs, jnp.zeros((B, di, N), jnp.float32))
    y, hT = tmb.mamba_scan(*_torch(x), return_state=True)  # CPU: plain
    assert hT.shape == (B, di, N) and hT.dtype == torch.float32
    np.testing.assert_allclose(hT.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(y.numpy(), tmb.mamba_scan(*_torch(x)).numpy())
    oy, oh = tref.mamba_ref(*_torch(x), return_state=True)
    np.testing.assert_allclose(oh.numpy(), np.asarray(jh), **TOL)
    oy2, oh2 = tops.mamba_scan(*_torch(x), return_state=True)
    np.testing.assert_array_equal(oh2.numpy(), hT.numpy())


@pytest.mark.parametrize("S,N,dt", [
    (130, 16, None),
    (1024, 8, 1e-3),               # weak decay
])
def test_plain_in_float64_matches_reference_token_loop(S, N, dt):
    """``dtype=torch.float64`` computes the same function in float64 (the
    card's check holds the kernel against it)."""
    x = _inputs(2, S, 24, N, seed=S, dt=dt)
    jy, jh = jscan_chunk(*_jax(x), jnp.zeros((2, 24, N), jnp.float32))
    y, hT = tmb.mamba_scan_plain(*_torch(x), return_state=True,
                                 dtype=torch.float64)
    assert y.dtype == hT.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jh), **TOL)
