"""The CUDA kernels (flash attention, WKV6 scan, selective scan) against
their plain versions, on the card.

Skips without a CUDA card.  On the card (no JAX needed):

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import mamba_scan as tmb
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rwkv6_scan as trw


def _inputs(seed, dtype, *shapes):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(getattr(torch, dtype)).cuda()
            for s in shapes]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,q_offset", [
    (1, 2, 2, 128, 128, 64, True, 0),
    (2, 4, 2, 256, 256, 64, False, 0),
    (1, 8, 1, 128, 128, 128, True, 0),
    (2, 2, 2, 128, 384, 64, True, 256),
    (1, 32, 8, 777, 777, 128, True, 0),      # ragged, qwen3-8b heads
    (1, 4, 2, 5, 300, 128, True, 295),       # few rows, long kv
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(B, Hq, Hkv, Sq, Skv, D, causal, q_offset,
                                   dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = _inputs(Sq + Skv, dtype, (B, Hq, Sq, D), (B, Hkv, Skv, D),
                      (B, Hkv, Skv, D))
    launches = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == launches + 1
    want = tfa.flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,S,D,decay", [
    (2, 3, 128, 64, None),        # the JAX sweep's shape
    (1, 2, 64, 32, None),         # D = 32
    (1, 40, 777, 64, None),       # ragged, rwkv6-3b heads
    (2, 4, 100, 32, None),        # ragged, two chunks
    (1, 2, 1, 64, None),          # one token
    (1, 1, 256, 64, 1e-6),        # strong decay
])
def test_rwkv6_scan_kernel_matches_plain(B, H, S, D, decay):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(S * D + H)
    r, k, v = (torch.randn(B, H, S, D, generator=gen) for _ in range(3))
    if decay is None:
        w = torch.exp(-torch.exp(torch.randn(B, H, S, D, generator=gen)))
    else:
        w = torch.full((B, H, S, D), decay)
    u = torch.randn(H, D, generator=gen)
    x = [t.cuda() for t in (r, k, v, w, u)]
    launches = trw.rwkv6_scan.launches
    got = trw.rwkv6_scan(*x)
    torch.cuda.synchronize()
    assert trw.rwkv6_scan.launches == launches + 1
    want = trw.rwkv6_scan_plain(*x).cpu().numpy()
    got = got.cpu().numpy()
    assert not np.isnan(got).any()
    if decay is None:      # scale-normalised, as tests/test_kernels.py
        scale = float(np.abs(want).max()) + 1.0
        np.testing.assert_allclose(got / scale, want / scale, rtol=2e-4,
                                   atol=2e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,D", [(2, 100, 4, 64), (1, 777, 40, 64),
                                     (2, 128, 3, 32)])
def test_rwkv6_scan_kernel_model_layout(B, S, H, D):
    """ops.rwkv6_scan hands the kernel [B,S,H,D] tensors as strided views."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(S + H)
    r, k, v = (torch.randn(B, S, H, D, generator=gen).cuda() for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(B, S, H, D, generator=gen))).cuda()
    u = torch.randn(H, D, generator=gen).cuda()
    launches = trw.rwkv6_scan.launches
    got = tops.rwkv6_scan(r, k, v, w, u)
    torch.cuda.synchronize()
    assert trw.rwkv6_scan.launches == launches + 1
    assert got.shape == (B, S, H, D) and got.is_contiguous()
    tr = lambda t: t.transpose(1, 2).contiguous()
    want = trw.rwkv6_scan_plain(tr(r), tr(k), tr(v), tr(w), u).transpose(1, 2)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    scale = float(np.abs(want).max()) + 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,di,N,dt", [
    (1, 64, 32, 8, None),         # the JAX sweep's shapes
    (2, 128, 64, 16, None),
    (1, 256, 128, 16, None),
    (1, 777, 16384, 16, None),    # ragged S, jamba's d_inner
    (2, 100, 200, 8, None),       # ragged S and di
    (1, 1, 128, 16, None),        # one token
    (1, 256, 256, 16, 30.0),      # strong decay: exp underflows to 0
    (1, 2048, 256, 16, 1e-3),     # weak decay
])
def test_mamba_scan_kernel_matches_plain(B, S, di, N, dt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(S + di + N)
    A = -torch.exp(torch.randn(di, N, generator=gen))
    if dt is None:
        dtv = torch.nn.functional.softplus(torch.randn(B, S, di,
                                                       generator=gen))
    else:
        dtv = torch.full((B, S, di), dt)
    b, c = (torch.randn(B, S, N, generator=gen) for _ in range(2))
    x = torch.randn(B, S, di, generator=gen)
    xs = [t.cuda() for t in (A, dtv, b, c, x)]
    launches = tmb.mamba_scan.launches
    got = tmb.mamba_scan(*xs)
    torch.cuda.synchronize()
    assert tmb.mamba_scan.launches == launches + 1
    want = tmb.mamba_scan_plain(*xs).cpu().numpy()
    got = got.cpu().numpy()
    assert np.isfinite(got).all()
    scale = float(np.abs(want).max()) + 1.0   # as tests/test_kernels.py, 1e-4
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-4,
                               atol=1e-4)
