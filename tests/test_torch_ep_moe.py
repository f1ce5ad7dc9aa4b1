"""Expert-parallel MoE on a (data=2, model=4) mesh of 8 ``gloo`` processes
against the reference's ``ep_moe_apply`` (``shard_map`` on 8 host
devices), the port's single-process ``moe_apply`` and ``ep_moe_plain``.

The reference runs once in a subprocess (its devices must be set before
JAX starts) and the ranks once in spawned processes; each test reads
their results.  Tiny qwen3-moe in f32, 8 experts, top-2, inputs from
numpy; capacity factor 32 drops nothing, 1.0 drops assignments.  The
limits of both runs are in ``_torch_dist.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_dist as D
from repro_torch.configs import get_tiny_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.moe import moe_apply
from repro_torch.parallel import ep_moe as ep

B, S = 8, 16
N_BATCH, N_TP = 2, 4
CASES = {"free": 32.0, "drops": 1.0}
LEAVES = ("router", "wi_gate", "wi_up", "wo")
TOL = 1e-5


def _cfg(scan_impl="xla"):
    cfg = get_tiny_config("qwen3-moe-30b-a3b").replace(
        dtype="float32", param_dtype="float32", scan_impl=scan_impl)
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=32.0, num_experts=8, experts_per_token=2,
        chunk_tokens=0))


def _scaled(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's params, input, EP outputs and kept masks."""
    d = tmp_path_factory.mktemp("ep_ref")
    rng = np.random.default_rng(0)
    cfg = _cfg()
    np.save(d / "x.npy", rng.standard_normal((B, S, cfg.d_model),
                                             dtype=np.float32))
    np.save(d / "cot.npy", rng.standard_normal((B, S, cfg.d_model),
                                               dtype=np.float32))
    D.run_reference(f"""
        import dataclasses
        import jax, jax.numpy as jnp
        import numpy as np
        from repro.configs import get_tiny_config
        from repro.launch.mesh import make_test_mesh
        from repro.models.moe import moe_init, moe_apply
        from repro.parallel import ep_moe as EP

        d = {str(d)!r}
        cfg = get_tiny_config('qwen3-moe-30b-a3b').replace(
            dtype='float32', param_dtype='float32')
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=32.0, num_experts=8,
            experts_per_token=2, chunk_tokens=0))
        p = moe_init(cfg, jax.random.PRNGKey(0))
        x = jnp.asarray(np.load(d + '/x.npy'))
        mesh = make_test_mesh({N_BATCH}, {N_TP})
        res = {{'p_' + k: np.asarray(v) for k, v in p.items()}}
        b_loc = {B // N_BATCH}

        def keeps(x, router, cap):
            # each batch shard's kept assignments, by the reference's pack
            out = []
            for b in range({N_BATCH}):
                xf = x[b * b_loc:(b + 1) * b_loc].reshape(-1, cfg.d_model)
                out.append(EP._local_pack(cfg, xf @ router, xf, {N_TP},
                                          cap)[5])
            return jnp.stack(out)

        for name, cf in {CASES!r}.items():
            res[name] = np.asarray(jax.jit(lambda p, x: EP.ep_moe_apply(
                cfg, p, x, mesh, tp_axis='model', batch_axes=('data',),
                capacity_factor=cf))(p, x))
            cap = max(int(cf * b_loc * {S} * 2 / {N_TP}), 2)
            res[name + '_keep'] = np.asarray(jax.jit(
                keeps, static_argnums=2)(x, p['router'], cap))
        res['moe_apply'] = np.asarray(
            jax.jit(lambda p, x: moe_apply(cfg, p, x)[0])(p, x))
        np.savez(d + '/ref.npz', **res)
    """, n_dev=N_BATCH * N_TP)
    out = dict(np.load(d / "ref.npz"))
    out["x"] = np.load(d / "x.npy")
    out["cot"] = np.load(d / "cot.npy")
    out["params"] = {k: out.pop("p_" + k) for k in LEAVES}
    return out


def _ep_rank(rank, world, params, x, cot):
    """One rank: both cases on the plain path, the drop-free case through
    ``scan_impl="pallas"`` (the gmm wrapper's plain version on the CPU),
    and the drop-free grads; the kept mask of each pack."""
    mesh = make_test_mesh(N_BATCH, N_TP, device_type="cpu")
    b = mesh.get_local_rank("data")
    b_loc = B // N_BATCH
    x_loc = torch.from_numpy(x[b * b_loc:(b + 1) * b_loc])
    cot_loc = torch.from_numpy(cot[b * b_loc:(b + 1) * b_loc])
    lp = ep.local_params({k: torch.from_numpy(v) for k, v in params.items()},
                         mesh)
    keeps = []
    real = ep._local_pack

    def recording(*a):
        pack = real(*a)
        keeps.append(pack.keep.reshape(-1, 2).clone())
        return pack

    ep._local_pack = recording
    out = {"coord": mesh.get_coordinate()}
    with torch.no_grad():
        for name, cf in CASES.items():
            out[name] = ep.ep_moe_apply(_cfg(), lp, x_loc, mesh,
                                        capacity_factor=cf)
            out[name + "_keep"] = keeps[-1]
        out["free_pallas"] = ep.ep_moe_apply(_cfg("pallas"), lp, x_loc, mesh,
                                             capacity_factor=32.0)
    x_g = x_loc.clone().requires_grad_()
    lp_g = {k: v.clone().requires_grad_() for k, v in lp.items()}
    y = ep.ep_moe_apply(_cfg(), lp_g, x_g, mesh, capacity_factor=32.0)
    (y * cot_loc).sum().backward()
    out["grads"] = {"x": x_g.grad, **{k: v.grad for k, v in lp_g.items()}}
    return out


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    return D.run_ranks(_ep_rank, N_BATCH * N_TP,
                       tmp_path_factory.mktemp("ep_ranks"), ref["params"],
                       ref["x"], ref["cot"])


def _shard(a, b):
    b_loc = B // N_BATCH
    return a[b * b_loc:(b + 1) * b_loc]


def test_ranks_sit_on_the_mesh_in_rank_order(ranks):
    assert [tuple(r["coord"]) for r in ranks] == \
        [(b, j) for b in range(N_BATCH) for j in range(N_TP)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_ep_moe_matches_reference(ref, ranks, case):
    for r in ranks:
        b = r["coord"][0]
        assert _scaled(r[case].numpy(), _shard(ref[case], b)) < TOL


def test_drops_are_the_references_assignment_for_assignment(ref, ranks):
    dropped = int((~ref["drops_keep"]).sum())
    assert dropped > 0
    assert ref["free_keep"].all()
    for r in ranks:
        b = r["coord"][0]
        for case in CASES:
            np.testing.assert_array_equal(
                r[case + "_keep"].numpy().reshape(-1),
                ref[case + "_keep"][b].reshape(-1))


def test_drop_free_ep_matches_ports_moe_apply(ref, ranks):
    params = {k: torch.from_numpy(v) for k, v in ref["params"].items()}
    want, _ = moe_apply(_cfg(), params, torch.from_numpy(ref["x"]))
    assert _scaled(want.numpy(), ref["moe_apply"]) < TOL
    for r in ranks:
        b = r["coord"][0]
        for case in ("free", "free_pallas"):
            assert _scaled(r[case].numpy(), _shard(want.numpy(), b)) < TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_ep_moe_plain_equals_every_rank(ref, ranks, case):
    params = {k: torch.from_numpy(v) for k, v in ref["params"].items()}
    plain = ep.ep_moe_plain(_cfg(), params, torch.from_numpy(ref["x"]),
                            n_tp=N_TP, n_batch=N_BATCH,
                            capacity_factor=CASES[case])
    assert plain.shape == (N_BATCH, N_TP, B // N_BATCH, S, _cfg().d_model)
    for r in ranks:
        b, j = r["coord"]
        assert _scaled(r[case].numpy(), plain[b, j].numpy()) < 1e-6


def test_grads_through_the_all_to_alls_match_moe_apply(ref, ranks):
    """Each rank's x grad is its shard's; the router's sums over the batch
    shards; an expert's over the batch shards, each of which it served
    n_tp times (every rank along the model axis sends the same tokens)."""
    params = {k: torch.from_numpy(v).clone().requires_grad_()
              for k, v in ref["params"].items()}
    x = torch.from_numpy(ref["x"]).clone().requires_grad_()
    y, _ = moe_apply(_cfg(), params, x)
    (y * torch.from_numpy(ref["cot"])).sum().backward()
    e_loc = _cfg().moe.num_experts // N_TP
    for j in range(N_TP):
        mine = [r for r in ranks if r["coord"][1] == j]
        for r in mine:
            assert _scaled(r["grads"]["x"].numpy(),
                           _shard(x.grad.numpy(), r["coord"][0])) < TOL
        router = sum(r["grads"]["router"] for r in mine)
        assert _scaled(router.numpy(), params["router"].grad.numpy()) < TOL
        for k in ep.EXPERT_LEAVES:
            got = sum(r["grads"][k] for r in mine) / N_TP
            want = params[k].grad[j * e_loc:(j + 1) * e_loc]
            assert _scaled(got.numpy(), want.numpy()) < TOL


@pytest.mark.parametrize("norm", [True, False])
def test_ep_moe_plain_keeps_the_routers_setting(norm):
    """With ``norm_topk_prob`` either way, every simulated rank of the
    (2, 4) mesh returns its batch shard of the unsharded layer (capacity
    for every assignment); the two settings differ."""
    from repro_torch.models.moe import moe_init
    cfg = _cfg()
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, norm_topk_prob=norm))
    g = torch.Generator().manual_seed(8)
    params = moe_init(cfg, g, torch.device("cpu"))
    x = torch.randn(B, S, cfg.d_model, generator=g)
    want, _ = moe_apply(cfg, params, x)
    plain = ep.ep_moe_plain(cfg, params, x, n_tp=N_TP, n_batch=N_BATCH)
    for b in range(N_BATCH):
        for j in range(N_TP):
            assert _scaled(plain[b, j].numpy(), _shard(want.numpy(), b)) \
                < TOL
    other = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                norm_topk_prob=not norm))
    assert _scaled(moe_apply(other, params, x)[0].numpy(),
                   want.numpy()) > 1e-2


def test_local_params_and_capacity():
    cfg = _cfg()
    p = {k: torch.arange(8.).reshape(8, 1, 1) if k != "router"
         else torch.zeros(2, 8) for k in LEAVES}
    part = ep.expert_slice(p, 3, 4)
    assert part["wi_gate"].reshape(-1).tolist() == [6.0, 7.0]
    assert part["router"] is p["router"]
    # the reference's rule: max(int(cf * T_loc * k / n_tp), k)
    assert ep.capacity(cfg, 64, 4, 1.25) == 40
    assert ep.capacity(cfg, 1, 4, 1.0) == 2
