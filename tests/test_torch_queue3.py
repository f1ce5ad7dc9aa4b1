"""Two repairs of the port against the reference: the microbatch split of
M-RoPE positions, and the Mamba scan's chunks under grad."""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax.numpy as jnp
import numpy as np

from repro.train.step import _split_microbatches as jax_split
from repro_torch.configs import get_tiny_config
from repro_torch.models import mamba
from repro_torch.train.step import _split_microbatches as torch_split


def test_split_microbatches_matches_reference():
    """tokens [4, S] split on axis 0; positions [3, 4, S] -> [2, 3, 2, S]."""
    rng = np.random.default_rng(0)
    S = 5
    batch = {"tokens": rng.integers(0, 100, (4, S)).astype(np.int32),
             "positions": rng.integers(0, 100, (3, 4, S)).astype(np.int32)}
    want = jax_split({k: jnp.asarray(v) for k, v in batch.items()}, 2)
    got = torch_split({k: torch.from_numpy(v) for k, v in batch.items()}, 2)
    assert got["positions"].shape == (2, 3, 2, S)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _layer(S, B=1, seed=0):
    cfg = get_tiny_config("jamba-1.5-large-398b").replace(
        dtype="float32", param_dtype="float32", scan_impl="xla")
    gen = torch.Generator().manual_seed(seed)
    p = mamba.mamba_init(cfg, gen, torch.device("cpu"))
    x = torch.randn(B, S, cfg.d_model, generator=gen)
    return cfg, p, x


def _whole_sequence(monkeypatch):
    """The scan as it ran before the chunks: one ``_scan_chunk`` over every
    token, its backward keeping every token's terms."""
    monkeypatch.setattr(mamba, "CHUNK", 1 << 30)
    monkeypatch.setattr(mamba, "checkpoint",
                        lambda fn, *a, use_reentrant: fn(*a))


def _grads(cfg, p, x):
    leaves = [x, *p.values()]
    for t in leaves:
        t.requires_grad_(True)
        t.grad = None
    mamba.mamba_apply(cfg, p, x).square().sum().backward()
    out = [t.grad.clone() for t in leaves]
    for t in leaves:
        t.requires_grad_(False)
        t.grad = None
    return out


def test_chunked_scan_grads_equal_whole_sequence(monkeypatch):
    """S = 600: two 256-token chunks and a last one of 88."""
    cfg, p, x = _layer(600, B=2)
    got = _grads(cfg, p, x)
    with monkeypatch.context() as m:
        _whole_sequence(m)
        want = _grads(cfg, p, x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-9)
    with torch.no_grad():   # no grad: one scan, the same values
        y = mamba.mamba_apply(cfg, p, x)
    x.requires_grad_(True)
    torch.testing.assert_close(mamba.mamba_apply(cfg, p, x).detach(), y,
                               rtol=0, atol=0)


def _saved_bytes(cfg, p, x):
    total = 0

    def pack(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    x.requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        mamba.mamba_apply(cfg, p, x)
    x.requires_grad_(False)
    return total


def test_chunked_scan_saves_four_times_fewer_bytes(monkeypatch):
    cfg, p, x = _layer(1024)
    chunked = _saved_bytes(cfg, p, x)
    with monkeypatch.context() as m:
        _whole_sequence(m)
        whole = _saved_bytes(cfg, p, x)
    assert whole >= 4 * chunked, (whole, chunked)
