"""The CUDA WKV6 kernel's decomposition, mirrored in PyTorch ops
(``rwkv6_scan_factored``: chunk-local pass with 16-token sub-chunks and
factored off-diagonal decay, state pass, inter-chunk pass), against the
JAX package's Pallas kernel (interpret mode) and its sequential oracle,
on the CPU.

Inputs come from a numpy seed and go to both packages.  Every case is
held at 2e-4 of the output's scale (max |want| + 1), the sweep tolerance
of ``tests/test_kernels.py``: f32 sums in another order.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax.numpy as jnp
import numpy as np

from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as jrwkv6_scan
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan as trw


def _inputs(B, H, S, D, seed=0, w=None):
    """r, k, v, w [B,H,S,D] and u [H,D] as float32 numpy arrays; ``w`` is
    None (random decays), a number (one decay everywhere) or "mixed" (each
    channel its own decay, log-spaced from 1e-6 to 1)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32)
               for _ in range(3))
    if w is None:
        w = np.exp(-np.exp(rng.standard_normal((B, H, S, D))))
    elif w == "mixed":
        w = np.broadcast_to(np.logspace(-6, 0, D), (B, H, S, D))
    else:
        w = np.full((B, H, S, D), w)
    u = rng.standard_normal((H, D)).astype(np.float32)
    return r, k, v, w.astype(np.float32), u


def _factored(x):
    got = trw.rwkv6_scan_factored(*[torch.from_numpy(a) for a in x])
    assert got.dtype == torch.float32 and got.shape == x[0].shape
    got = got.numpy()
    assert np.isfinite(got).all()
    return got


def _assert_scaled_close(got, want, tol=2e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want))) + 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def _oracle(x):
    return np.asarray(jref.rwkv6_ref(*[jnp.asarray(a) for a in x]))


@pytest.mark.parametrize("B,H,S,D,chunk,w", [
    (1, 2, 64, 32, 16, None),     # the sweep of test_torch_rwkv6_scan.py
    (2, 3, 128, 64, 64, None),
    (1, 1, 256, 64, 32, None),
    (2, 2, 192, 32, 64, None),    # D = 32, three chunks
    (1, 1, 128, 32, 64, 1e-6),    # strong decay: ~-884 of log decay a chunk
    (1, 2, 256, 64, 64, "mixed"),
])
def test_factored_matches_jax_kernel_and_oracle(B, H, S, D, chunk, w):
    x = _inputs(B, H, S, D, seed=S + D, w=w)
    got = _factored(x)
    jx = [jnp.asarray(a) for a in x]
    _assert_scaled_close(got, np.asarray(jrwkv6_scan(*jx, chunk=chunk,
                                                     interpret=True)))
    _assert_scaled_close(got, _oracle(x))


@pytest.mark.parametrize("S", [1, 17, 64, 65, 100, 777])
def test_factored_ragged_lengths_match_sequential_oracle(S):
    """Any S: 64-token chunks and a padded last one (S = 64 and below is a
    single chunk, with no state to carry).  The JAX kernel asserts
    S % chunk == 0, so these go against the sequential oracles."""
    x = _inputs(1, 2, S, 32, seed=S)
    got = _factored(x)
    _assert_scaled_close(got, _oracle(x))
    _assert_scaled_close(got, tref.rwkv6_ref(*[torch.from_numpy(a)
                                               for a in x]))


@pytest.mark.parametrize("w", [1e-6, "mixed"])
def test_factored_strong_and_mixed_decay_at_777_tokens(w):
    """Decay strong enough that e^{-L} of one chunk or of one 16-token
    sub-chunk overflows: no exponent the decomposition takes may."""
    x = _inputs(1, 2, 777, 64, seed=7, w=w)
    got = _factored(x)
    want = _oracle(x)
    _assert_scaled_close(got, want)
    _assert_scaled_close(got, trw.rwkv6_scan_plain(
        *[torch.from_numpy(a) for a in x]).numpy())


def test_factored_is_not_on_the_cpu_path():
    """The wrapper runs the plain version on a CPU tensor; the factored
    mirror is for tests only."""
    x = [torch.from_numpy(a) for a in _inputs(1, 1, 70, 32, seed=3)]
    before = trw.rwkv6_scan.launches
    np.testing.assert_array_equal(trw.rwkv6_scan(*x).numpy(),
                                  trw.rwkv6_scan_plain(*x).numpy())
    assert trw.rwkv6_scan.launches == before
