"""The port's WKV6 scan (plain version, oracle, model-layout wrapper) vs the
JAX package's Pallas kernel (interpret mode) and oracle, on the CPU.

Inputs come from a numpy seed and go to both packages.  Tolerances are
those of ``tests/test_kernels.py``: scale-normalised 2e-4 for the sweep,
1e-3 for the strong-decay case.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax.numpy as jnp
import numpy as np

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_scan as jrwkv6_scan
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan as trw


def _inputs(B, H, S, D, seed=0, w=None):
    """r, k, v, w [B,H,S,D] and u [H,D] as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32)
               for _ in range(3))
    if w is None:
        w = np.exp(-np.exp(rng.standard_normal((B, H, S, D))))
    else:
        w = np.full((B, H, S, D), w)
    u = rng.standard_normal((H, D)).astype(np.float32)
    return r, k, v, w.astype(np.float32), u


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _assert_scaled_close(got, want, tol=2e-4):
    """|got - want| / (max|want| + 1) within ``tol`` (f32 sums in another
    order; the error grows with S * D)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want))) + 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


@pytest.mark.parametrize("B,H,S,D,chunk", [
    (1, 2, 64, 32, 16),
    (2, 3, 128, 64, 64),
    (1, 1, 256, 64, 32),
])
def test_plain_and_oracle_match_jax_sweep(B, H, S, D, chunk):
    x = _inputs(B, H, S, D)
    jx = [jnp.asarray(a) for a in x]
    want = np.asarray(jrwkv6_scan(*jx, chunk=chunk, interpret=True))
    # the port's plain version cuts 64-token chunks whatever the JAX
    # kernel's chunk: the same function in another summation order
    _assert_scaled_close(trw.rwkv6_scan_plain(*_torch(x)), want)
    _assert_scaled_close(tref.rwkv6_ref(*_torch(x)), jref.rwkv6_ref(*jx))


@pytest.mark.parametrize("chunk", [32, 64])
def test_strong_decay_numerics(chunk):
    """w = 1e-6: the log decay of one chunk reaches ~-884; no exponent may
    overflow (every one is taken pairwise, <= 0).  ``chunk`` is the JAX
    kernel's; the port's plain version cuts 64-token chunks."""
    x = _inputs(1, 1, 128, 32, seed=1, w=1e-6)
    got = trw.rwkv6_scan_plain(*_torch(x)).numpy()
    want = np.asarray(jref.rwkv6_ref(*[jnp.asarray(a) for a in x]))
    assert not np.any(np.isnan(got))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    jgot = np.asarray(jrwkv6_scan(*[jnp.asarray(a) for a in x], chunk=chunk,
                                  interpret=True))
    np.testing.assert_allclose(got, jgot, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("S", [1, 100, 777])
def test_ragged_lengths_match_sequential_oracle(S):
    """Any S: 64-token chunks and a shorter last one.  The JAX kernel
    asserts S % chunk == 0, so these go against the sequential oracles."""
    x = _inputs(1, 2, S, 32, seed=S)
    want = tref.rwkv6_ref(*_torch(x))
    got = trw.rwkv6_scan(*_torch(x))          # CPU tensor: the plain version
    assert got.shape == (1, 2, S, 32) and got.dtype == torch.float32
    _assert_scaled_close(got, want)
    _assert_scaled_close(want, jref.rwkv6_ref(*[jnp.asarray(a) for a in x]))


def test_cpu_tensor_runs_plain_version_without_a_launch():
    x = _torch(_inputs(1, 1, 70, 32, seed=3))
    before = trw.rwkv6_scan.launches
    np.testing.assert_array_equal(trw.rwkv6_scan(*x).numpy(),
                                  trw.rwkv6_scan_plain(*x).numpy())
    assert trw.rwkv6_scan.launches == before


def test_ops_layout_matches_jax_ops():
    """ops.rwkv6_scan takes and returns the model layout [B,S,H,D]."""
    r, k, v, w, u = _inputs(2, 3, 128, 32, seed=4)
    to_model = lambda a: np.ascontiguousarray(np.swapaxes(a, 1, 2))
    xm = [to_model(a) for a in (r, k, v, w)] + [u]
    got = tops.rwkv6_scan(*_torch(xm))
    assert got.shape == (2, 128, 3, 32)
    _assert_scaled_close(got, to_model(trw.rwkv6_scan_plain(
        *_torch((r, k, v, w, u))).numpy()))
    _assert_scaled_close(got, jops.rwkv6_scan(*[jnp.asarray(a) for a in xm]))


@pytest.mark.parametrize("case, exc, match", [
    ("head_dim", ValueError, "head_dim 48"),
    ("dtype", TypeError, "float32"),
    ("shape", ValueError, "want r = k = v = w"),
    ("u", ValueError, "want u"),
    ("layout", ValueError, "share strides"),
    ("last_dim", ValueError, "last dim must be dense"),
])
def test_check_rejects_what_the_kernel_does_not_take(case, exc, match):
    D = 48 if case == "head_dim" else 32
    r, k, v, w, u = _torch(_inputs(1, 2, 16, D))
    if case == "dtype":
        k = k.to(torch.bfloat16)
    elif case == "shape":
        v = v[:, :, :8].contiguous()
    elif case == "u":
        u = u[:1]
    elif case == "layout":
        r = r.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "last_dim":
        r, k, v, w = (t.transpose(2, 3).contiguous().transpose(2, 3)
                      for t in (r, k, v, w))
    with pytest.raises(exc, match=match):
        trw._check(r, k, v, w, u)


def test_check_takes_the_model_layout_as_views():
    """The main path hands the kernel [B,S,H,D] tensors as [B,H,S,D] views."""
    r, k, v, w, u = _torch(_inputs(2, 3, 16, 32))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (r, k, v, w)]
    assert not views[0].is_contiguous()
    trw._check(*views, u)
