"""The kernel wrappers' grad guard: a CUDA kernel has no backward, so a
launch that autograd would need raises, as ``jax.grad`` through the
reference's Pallas calls does.  The CPU branches run the plain versions,
which differentiate, and stay unguarded.

The card-only halves (each CUDA wrapper raises under grad mode and runs
under ``torch.no_grad()``) are in tests/test_torch_kernels_gpu.py.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gmm as tgmm
from repro_torch.kernels import mamba_scan as tmb
from repro_torch.kernels import moe_permute as tmp
from repro_torch.kernels import rwkv6_scan as trw
from repro_torch.kernels._grad import check_no_grad


def _leaf(*shape, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=gen).requires_grad_(True)


def test_check_no_grad_raises_under_grad_mode():
    x, w = torch.ones(3), _leaf(3)
    with pytest.raises(RuntimeError, match=r'flash_attention.*'
                                           r'attention_impl="xla"'):
        check_no_grad("flash_attention", "attention_impl", x, w)
    with pytest.raises(RuntimeError, match=r'gmm.*scan_impl="xla"'):
        check_no_grad("gmm", "scan_impl", w)


@pytest.mark.parametrize("mode", [torch.no_grad, torch.inference_mode])
def test_check_no_grad_passes_without_grad_mode(mode):
    with mode():
        check_no_grad("rwkv6_scan", "scan_impl", _leaf(3), torch.ones(3))


def test_check_no_grad_passes_when_nothing_requires_grad():
    assert torch.is_grad_enabled()
    check_no_grad("mamba_scan", "scan_impl", torch.ones(3), torch.zeros(2))
    check_no_grad("gmm", "scan_impl")


def test_launch_paths_check_before_anything_else():
    """``flash_attention._launch`` and ``gmm._launch`` (which serves gmm
    and gmm_equal) guard before they allocate or touch a device: with
    inputs that require grad they raise even on the CPU."""
    q = _leaf(1, 2, 8, 64)
    with pytest.raises(RuntimeError, match="no backward"):
        tfa._launch(q, q.detach(), q.detach(), True, 0, "wgmma")
    lhs, rhs = _leaf(8, 16), torch.ones(2, 16, 8)
    with pytest.raises(RuntimeError, match="no backward"):
        tgmm._launch(lhs, rhs, None, 4, "wgmma")


def _flash():
    q, k, v = _leaf(1, 4, 33, 16, seed=1), _leaf(1, 2, 33, 16, seed=2), \
        _leaf(1, 2, 33, 16, seed=3)
    return tfa.flash_attention(q, k, v, causal=True), (q, k, v)


def _rwkv6():
    r, k, v = (_leaf(1, 2, 70, 32, seed=s) for s in (1, 2, 3))
    w = torch.sigmoid(_leaf(1, 2, 70, 32, seed=4)).detach().requires_grad_()
    u = _leaf(2, 32, seed=5)
    return trw.rwkv6_scan(r, k, v, w, u), (r, k, v, w, u)


def _mamba():
    A = (-torch.exp(_leaf(16, 8, seed=1))).detach().requires_grad_()
    dt = torch.sigmoid(_leaf(1, 20, 16, seed=2)).detach().requires_grad_()
    b, c, x = (_leaf(*sh, seed=s) for s, sh in
               ((3, (1, 20, 8)), (4, (1, 20, 8)), (5, (1, 20, 16))))
    return tmb.mamba_scan(A, dt, b, c, x), (A, dt, b, c, x)


def _gmm():
    lhs, rhs = _leaf(12, 16, seed=1), _leaf(3, 16, 8, seed=2)
    sizes = torch.tensor([5, 0, 6], dtype=torch.int32)
    return tgmm.gmm(lhs, rhs, sizes), (lhs, rhs)


def _gmm_equal():
    x, w = _leaf(3, 4, 16, seed=1), _leaf(3, 16, 8, seed=2)
    return tgmm.gmm_equal(x, w), (x, w)


_IDS = torch.tensor([[0, 1], [1, 2], [2, 0]])
_POS = torch.tensor([[0, 0], [1, 0], [1, 2]])     # C = 2: one dropped


def _moe_dispatch():
    x = _leaf(3, 16, seed=1)
    return tmp.moe_dispatch(x, _IDS, _POS, 3, 2), (x,)


def _moe_combine():
    ye, gate_w = _leaf(3, 3, 16, seed=1), _leaf(3, 2, seed=2)
    return tmp.moe_combine(ye, _IDS, _POS, gate_w), (ye, gate_w)


@pytest.mark.parametrize("call", [_flash, _rwkv6, _mamba, _gmm, _gmm_equal,
                                  _moe_dispatch, _moe_combine],
                         ids=lambda f: f.__name__[1:])
def test_cpu_wrappers_still_differentiate(call):
    """On a CPU tensor each wrapper runs its plain version, unguarded, so
    gradients reach every input."""
    out, inputs = call()
    assert out.grad_fn is not None
    out.float().square().sum().backward()
    for t in inputs:
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert float(t.grad.abs().max()) > 0.0
