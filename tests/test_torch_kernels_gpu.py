"""The CUDA flash-attention kernel against its plain version, on the card.

Skips without a CUDA card.  On the card (no JAX needed):

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch.kernels import flash_attention as tfa


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
