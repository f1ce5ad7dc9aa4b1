"""Expert parallelism and ``ops.gmm_padded`` on the card: four ``gloo``
ranks sharing card 0 run ``ep_moe_apply`` through the gmm kernel, held to
``ep_moe_plain`` in f32; ``gmm_padded``'s tile tables through the kernel,
held to its plain version.

Skips without a CUDA card.  On the card (no JAX needed):

    python -m pytest -m gpu tests/test_torch_ep_moe_gpu.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import _torch_dist as D
from repro_torch.configs import get_tiny_config
from repro_torch.kernels import gmm as tgmm
from repro_torch.kernels import ops as tops

N_TP = 4


def _cfg(dtype):
    cfg = get_tiny_config("dbrx-132b").replace(
        d_model=256, dtype=dtype, param_dtype=dtype, scan_impl="pallas")
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, num_experts=16, experts_per_token=4, d_ff_expert=512,
        capacity_factor=1.0))


def _card_rank(rank, world, dtype, params, x):
    """One rank on card 0: its output and gmm launches by route."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import ep_moe as ep
    torch.cuda.set_device(0)
    mesh = make_test_mesh(1, N_TP, device_type="cuda")
    lp = ep.local_params({k: v.cuda() for k, v in params.items()}, mesh)
    tgmm.gmm.route_launches = dict.fromkeys(tgmm.ROUTES, 0)
    with torch.no_grad():
        y = ep.ep_moe_apply(_cfg(dtype), lp, x.cuda(), mesh)
    torch.cuda.synchronize()
    return dict(y=y.cpu(), launches=dict(tgmm.gmm.route_launches))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,route,tol", [("bfloat16", "wgmma", 1e-2),
                                             ("float32", "mma_sync", 1e-5)])
def test_ep_moe_on_the_card_matches_plain(tmp_path, dtype, route, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.models.moe import moe_init
    from repro_torch.parallel import ep_moe as ep
    cfg = _cfg(dtype)
    gen = torch.Generator().manual_seed(0)
    params = moe_init(cfg, gen, torch.device("cpu"))
    x = torch.randn(2, 256, cfg.d_model, generator=gen).to(
        getattr(torch, dtype))
    ranks = D.run_ranks(_card_rank, N_TP, tmp_path, dtype, params, x)
    plain = ep.ep_moe_plain(
        cfg.replace(dtype="float32", scan_impl="xla"),
        {k: v.float().cuda() for k, v in params.items()}, x.float().cuda(),
        n_tp=N_TP)[0].cpu()
    for j, r in enumerate(ranks):
        assert r["launches"][route] == 3
        err = torch.linalg.vector_norm(r["y"].float() - plain[j]) / \
            torch.linalg.vector_norm(plain[j])
        assert float(err) < tol, (j, float(err))


@pytest.mark.gpu
@pytest.mark.parametrize("tile_ids", [[0, 0, 1, 3], [2, 0, 3, 0]])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gmm_padded_on_the_card(dtype, tile_ids):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(len(tile_ids) + tile_ids[0])
    dt = getattr(torch, dtype)
    lhs = torch.randn(4 * 128, 256, generator=gen).to(dt)
    rhs = (torch.randn(4, 256, 384, generator=gen) / 16).to(dt)
    ids = torch.tensor(tile_ids, dtype=torch.int32)
    want = tops.gmm_padded(lhs.float(), rhs.float(), ids)
    n = tgmm.gmm.launches
    got = tops.gmm_padded(lhs.cuda(), rhs.cuda(), ids)
    torch.cuda.synchronize()
    assert tgmm.gmm.launches == n + 1
    err = float((got.float().cpu() - want).abs().max() / want.abs().max())
    assert err < (4e-3 if dtype == "bfloat16" else 1e-5), err
