"""Port's grouped matmul (plain version, wrappers, oracle) vs the JAX
package's ``ops.gmm_sorted`` (Pallas, interpret mode) and ``ref.gmm_ref``,
on the CPU.  The CUDA kernel itself is held to the plain version on the
card (``test_torch_kernels_gpu.py``).  Tolerance 1e-5 in f32, as
``tests/test_kernels.py::test_gmm_sweep``.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax.numpy as jnp
import numpy as np

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import gmm as tgmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(rtol=1e-5, atol=1e-5)
SWEEP = [[128, 128, 128, 128], [100, 0, 300, 112], [0, 0, 512, 0],
         [1, 2, 3, 506]]


def _inputs(M, K, N, G, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K), dtype=np.float32),
            rng.standard_normal((G, K, N), dtype=np.float32))


@pytest.mark.parametrize("sizes", SWEEP)
def test_gmm_plain_matches_reference_kernel_and_oracle(sizes):
    M, K, N, G = sum(sizes), 64, 128, len(sizes)
    lhs, rhs = _inputs(M, K, N, G)
    gs = torch.tensor(sizes, dtype=torch.int32)
    got = tgmm.gmm_plain(torch.from_numpy(lhs), torch.from_numpy(rhs), gs)
    want_kernel = jops.gmm_sorted(jnp.asarray(lhs), jnp.asarray(rhs),
                                  np.asarray(sizes), block_m=128)
    want_ref = jref.gmm_ref(jnp.asarray(lhs), jnp.asarray(rhs),
                            jnp.asarray(sizes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ref), **TOL)


@pytest.mark.parametrize("sizes", SWEEP)
def test_port_oracle_and_wrappers_match_reference_oracle(sizes):
    """ref.gmm_ref, gmm (the CPU route) and ops.gmm_sorted, one answer."""
    M, K, N, G = sum(sizes), 64, 128, len(sizes)
    lhs, rhs = _inputs(M, K, N, G, seed=1)
    tl, tr = torch.from_numpy(lhs), torch.from_numpy(rhs)
    gs = torch.tensor(sizes, dtype=torch.int32)
    launches = tgmm.gmm.launches
    want = np.asarray(jref.gmm_ref(jnp.asarray(lhs), jnp.asarray(rhs),
                                   jnp.asarray(sizes)))
    for got in (tref.gmm_ref(tl, tr, gs), tgmm.gmm(tl, tr, gs),
                tops.gmm_sorted(tl, tr, gs)):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert tgmm.gmm.launches == launches     # CPU tensors launch nothing


def test_rows_past_the_groups_are_zero_as_gmm_sorted_leaves_them():
    sizes = [3, 0, 5]
    lhs, rhs = _inputs(12, 16, 24, 3, seed=2)
    got = tgmm.gmm_plain(torch.from_numpy(lhs), torch.from_numpy(rhs),
                         torch.tensor(sizes, dtype=torch.int32))
    want = jops.gmm_sorted(jnp.asarray(lhs), jnp.asarray(rhs),
                           np.asarray(sizes), block_m=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(got[8:].abs().max()) == 0.0


@pytest.mark.parametrize("E,R,d,f", [(8, 11, 64, 64), (4, 9, 32, 48)])
def test_gmm_equal_is_the_capacity_einsum(E, R, d, f):
    """[E, C+1, d] x [E, d, f]: the reference MoE's einsum, and the
    reference kernel on E equal groups."""
    rng = np.random.default_rng(E * R)
    x = rng.standard_normal((E, R, d), dtype=np.float32)
    w = rng.standard_normal((E, d, f), dtype=np.float32)
    got = tops.gmm_equal(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (E, R, f)
    want = np.einsum("ecd,edf->ecf", x, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    want_kernel = jops.gmm_sorted(jnp.asarray(x.reshape(E * R, d)),
                                  jnp.asarray(w), np.full(E, R), block_m=8)
    np.testing.assert_allclose(got.numpy().reshape(E * R, f),
                               np.asarray(want_kernel), **TOL)


def test_bf16_plain_rounds_once_from_f32():
    rng = np.random.default_rng(3)
    lhs = torch.from_numpy(rng.standard_normal((20, 32),
                                               dtype=np.float32)).bfloat16()
    rhs = torch.from_numpy(rng.standard_normal((2, 32, 16),
                                               dtype=np.float32)).bfloat16()
    gs = torch.tensor([7, 13], dtype=torch.int32)
    got = tgmm.gmm_plain(lhs, rhs, gs)
    assert got.dtype == torch.bfloat16
    want = torch.cat([lhs[:7].float() @ rhs[0].float(),
                      lhs[7:].float() @ rhs[1].float()]).bfloat16()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,K,N,G,want", [
    (torch.bfloat16, 2048, 768, 128, "wgmma"),     # qwen3-moe gate/up
    (torch.bfloat16, 768, 2048, 128, "wgmma"),     # and down
    (torch.bfloat16, 200, 136, 5, "wgmma"),        # past whole tiles
    (torch.bfloat16, 8, 8, 2048, "wgmma"),
    (torch.bfloat16, 100, 90, 5, "mma_sync"),      # element-wise staging
    (torch.bfloat16, 100, 128, 5, "mma_sync"),     # K not a multiple of 8
    (torch.bfloat16, 128, 90, 5, "mma_sync"),      # N not a multiple of 8
    (torch.bfloat16, 0, 128, 5, "mma_sync"),       # nothing to sum
    (torch.bfloat16, 64, 128, 2049, "mma_sync"),   # more groups than smem
    (torch.float32, 2048, 768, 128, "mma_sync"),   # f32: the FMA kernel
    (torch.float32, 64, 128, 4, "mma_sync"),
])
def test_route_takes_wgmma_for_bf16_that_tma_can_address(dtype, K, N, G,
                                                         want):
    assert tgmm.route(dtype, K, N, G) == want


def test_aligned_copies_only_a_base_that_tma_cannot_address():
    t = torch.arange(40, dtype=torch.float32).bfloat16()
    assert tgmm._aligned(t) is t
    view = t[1:33]                      # contiguous, 2 bytes past the base
    got = tgmm._aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)


def test_check_rejects_what_the_kernel_does_not_take():
    lhs, rhs = torch.zeros(8, 4), torch.zeros(2, 4, 3)
    gs = torch.tensor([4, 4], dtype=torch.int32)
    tgmm._check(lhs, rhs, gs)
    with pytest.raises(ValueError, match="lhs"):
        tgmm._check(torch.zeros(8, 5), rhs, gs)
    with pytest.raises(TypeError, match="rhs"):
        tgmm._check(lhs, rhs.double(), gs)
    with pytest.raises(TypeError, match="bfloat16 or"):
        tgmm._check(lhs.half(), rhs.half(), gs)
    with pytest.raises(TypeError, match="int32"):
        tgmm._check(lhs, rhs, gs.long())
    with pytest.raises(ValueError, match="group_sizes"):
        tgmm._check(lhs, rhs, torch.tensor([8], dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        tgmm._check(torch.zeros(4, 8).T, rhs, gs)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgmm.gmm(lhs.to("meta"), rhs.to("meta"), gs.to("meta"))
