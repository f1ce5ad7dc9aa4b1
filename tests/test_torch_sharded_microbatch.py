"""The sharded train step's microbatches against the reference's: on a
(data 2, model 2) ``gloo`` mesh the port's ``fsdp`` step with
``microbatches=2`` takes microbatch i as the global rows [i·B/2,
(i+1)·B/2) of the batch, as the reference's ``_split_microbatches`` does,
and equals the reference's 2-microbatch ``make_train_step`` on every
metric (``loss``, ``grad_norm``, ``ce``, ``z``, ``aux``; 1e-5) and on the
moments (1e-4 of each leaf's scale), all in f32 on the tiny configs.

The targets are masked unevenly across rows (row 0 keeps one target, row
1 none of its first half, rows 2-3 every fifth), so a microbatch of other
rows gives another loss, grad norm and ``ce``.  Dense (qwen3-8b, remat
"full"), MoE (qwen3-moe: each microbatch's capacity and aux loss follow
its tokens) and VLM (qwen2-vl: the [3, B, S] positions split on dim 1,
the frontend patches on dim 0).  Then the split itself on 4- and 8-rank
meshes with 2 and 4 microbatches: every microbatch's blocks gathered
equal to the one-device split.  The rank functions are in
``_torch_sharded_ranks.py``.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax
import numpy as np

import _torch_dist as D
import _torch_sharded_ranks as R
from repro.config import base as jbase
from repro.train.step import make_opt_state as jmake_opt_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.bridge import params_to_numpy
from _torch_parity import batches, configs, port_params

ARCHS = {"dense": ("qwen3-8b", dict(remat="full")),
         "moe": ("qwen3-moe-30b-a3b", {}),
         "vlm": ("qwen2-vl-72b", {})}
B, S, MICRO = 4, 16, 2
MESH = (2, 2)


def _uneven_targets(cfg, jb, tb):
    tg = np.random.default_rng(1).integers(
        0, cfg.vocab_size, tb["tokens"].shape).astype(np.int32)
    tg[0, 1:] = -1
    tg[1, :tg.shape[1] // 2] = -1
    tg[2:, ::5] = -1
    return (dict(jb, targets=jax.numpy.asarray(tg)),
            dict(tb, targets=torch.from_numpy(tg).long()))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _scaled(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def cases():
    out = {}
    for name, (arch, kw) in ARCHS.items():
        jcfg, tcfg = configs(arch, dtype="float32", **kw)
        jp, tp = port_params(tcfg)
        jb, tb = _uneven_targets(tcfg, *batches(tcfg, B, S))
        out[name] = (jcfg, tcfg, jp, tp, jb, tb)
    return out


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """Every family's 2-microbatch step, in one spawn of the 4 ranks."""
    jobs = {name: (R.train_step_rank, ("cpu", c[1], MESH, c[3], c[5], MICRO))
            for name, c in cases.items()}
    jobs["split"] = (R.split_rank, ("cpu", (2, 2), ((8, 2), (8, 4))))
    return D.run_ranks(R.jobs_rank, 4, tmp_path_factory.mktemp("micro"),
                       jobs)


@pytest.fixture(scope="module")
def references(cases):
    out = {}
    for name, (jcfg, _, jp, _, jb, _) in cases.items():
        run = jbase.RunConfig(
            model=jcfg, shape=jbase.ShapeConfig("t", "train", S, B),
            sharding=jbase.ShardingConfig(policy="fsdp"),
            optim=jbase.OptimConfig(), microbatches=MICRO)
        js = jmake_opt_state(run, jp)
        _, js, jm = jax.jit(jmake_train_step(run))(jp, js, jb)
        out[name] = dict(metrics={k: float(v) for k, v in jm.items()},
                         m=_flat(js["m"]), v=_flat(js["v"]))
    return out


@pytest.mark.parametrize("family", list(ARCHS))
def test_sharded_two_microbatch_step_matches_reference(ranks, references,
                                                       cases, family):
    ref, tcfg = references[family], cases[family][1]
    if family == "moe":
        assert ref["metrics"]["aux"] > 0
    for r in ranks:
        got = r[family]
        for k in ("loss", "grad_norm", "ce", "z", "aux"):
            np.testing.assert_allclose(float(got["metrics"][k]),
                                       ref["metrics"][k], rtol=1e-5,
                                       atol=1e-8, err_msg=k)
        assert got["in_place"] and got["kept"]
        for mom in ("m", "v"):
            flat = _flat(params_to_numpy(tcfg, got[mom]))
            for leaf, want in ref[mom].items():
                assert _scaled(flat[leaf], want) <= 1e-4, (mom, leaf)


def test_uneven_targets_make_the_split_matter(cases, references):
    """The reference's 2-microbatch loss differs from the mean of the
    losses of the microbatches a local split would form (microbatch i =
    the i-th row of each data rank's two rows), so the test above tells
    the two splits apart."""
    from repro.models import loss_fn as jloss_fn
    jcfg, jb = cases["dense"][0], cases["dense"][4]
    local = [np.array([0, 2]), np.array([1, 3])]
    mean = np.mean([float(jloss_fn(jcfg, cases["dense"][2], {
        k: (v[:, rows] if k == "positions" and v.ndim == 3 else v[rows])
        for k, v in jb.items()})[0]) for rows in local])
    want = references["dense"]["metrics"]["loss"]
    assert abs(mean - want) > 1e-3 * abs(want)


@pytest.mark.parametrize("world,mesh", [(4, (2, 2)), (8, (2, 2, 2))],
                         ids=["2x2", "2x2x2"])
def test_global_split_equals_the_one_device_split(ranks, tmp_path, world,
                                                  mesh):
    """Each microbatch of a batch laid out by ``batch_shardings`` (tokens
    [B, 3], VLM positions [3, B, 2], a frontend [B, 2, 4]) holds, gathered,
    the one-device split's rows, in the batch's placements."""
    got = ranks if world == 4 else D.run_ranks(
        R.split_rank, world, tmp_path, "cpu", mesh, ((8, 2), (16, 4)))
    for r in got:
        assert (r["split"] if world == 4 else r) is True
