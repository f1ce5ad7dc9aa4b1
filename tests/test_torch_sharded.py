"""The port's sharded runs on ``gloo`` meshes of 4 (data=2, model=2) and 8
(pod=2, data=2, model=2) processes, held to the single-device JAX
reference on the same numpy weights (``_torch_parity``): the reference's
own sharded tests (``tests/test_sharding_multidev.py``: the 2x2 train
step, the sharded MoE loss, the multipod decode) fail inside JAX's
explicit-sharding gather, so the single-device run is the yardstick.

All in f32 on the tiny configs, where only the order of the sums differs:
- qwen3-8b ``fsdp`` train step (remat "full"): the loss within 1e-5, the
  moments within 1e-4 of each leaf's scale (``lr_at(0)`` is 0), in place
  with every leaf's placements kept; with 2 microbatches too, held to
  the reference's 2-microbatch step (the split's own test, with unevenly
  masked targets: ``test_torch_sharded_microbatch.py``);
- qwen3-moe ``fsdp`` loss, on the ``xla`` paths and on ``pallas`` (the
  kernels' plain versions on the CPU, per rank): within 1e-5;
- qwen3-8b prefill under ``fsdp`` and ``baseline``: logits and cache;
- qwen3-8b ``baseline`` decode on the 8-rank mesh: 3 greedy ticks, logits
  within 1e-5 of their scale, the same tokens, every rank's block of
  every cache entry equal to the reference cache's slice;
- the sharded step refuses a plain leaf; ``global_norm`` on DTensors
  counts a replicated element once.
The rank functions are in ``_torch_sharded_ranks.py``; each mesh's ranks
run once a module (limits in ``_torch_dist.py``).
"""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax
import numpy as np

import _torch_dist as D
import _torch_sharded_ranks as R
from repro.config import base as jbase
from repro.models import decode_step as jdecode_step
from repro.models import loss_fn as jloss_fn
from repro.models import prefill as jprefill
from repro.optim import q8_decode as jq8_decode
from repro.train.step import make_opt_state as jmake_opt_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.bridge import params_to_numpy
from repro_torch.optim import q8_decode, q8_encode
from _torch_parity import batches, configs, port_params

DENSE, MOE = "qwen3-8b", "qwen3-moe-30b-a3b"
B, S = 4, 16
PROMPT, MAX_LEN, TICKS = 8, 16, 3
MESH, POD_MESH = (2, 2), (2, 2, 2)


def _targets(cfg, jb, tb):
    tg = np.random.default_rng(1).integers(
        0, cfg.vocab_size, tb["tokens"].shape).astype(np.int32)
    tg[:, ::5] = -1
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


def _run(cfg, microbatches=1, **optim):
    return jbase.RunConfig(
        model=cfg, shape=jbase.ShapeConfig("t", "train", S, B),
        sharding=jbase.ShardingConfig(policy="fsdp"),
        optim=jbase.OptimConfig(**optim), microbatches=microbatches)


@pytest.fixture(scope="module")
def dense():
    jcfg, tcfg = configs(DENSE, dtype="float32", remat="full")
    jp, tp = port_params(tcfg)
    jb, tb = _targets(tcfg, *batches(tcfg, B, S))
    return jcfg, tcfg, jp, tp, jb, tb


@pytest.fixture(scope="module")
def moe():
    jcfg, tcfg = configs(MOE, dtype="float32")
    jp, tp = port_params(tcfg)
    jb, tb = _targets(tcfg, *batches(tcfg, B, S))
    return jcfg, tcfg, jp, tp, jb, tb


@pytest.fixture(scope="module")
def prompt(dense):
    return batches(dense[1], B, PROMPT, seed=2)


@pytest.fixture(scope="module")
def mesh22(dense, moe, prompt, tmp_path_factory):
    """Every 2x2 run, in one spawn of the 4 ranks."""
    tcfg, tp, tb = dense[1], dense[3], dense[5]
    mcfg, mp, mb = moe[1], moe[3], moe[5]
    jobs = {f"train{n}": (R.train_step_rank, ("cpu", tcfg, MESH, tp, tb, n))
            for n in (1, 2)}
    jobs["train_int8"] = (R.train_step_rank,
                          ("cpu", tcfg, MESH, tp, tb, 1, "int8"))
    jobs["moe"] = (R.loss_rank, (
        "cpu", {"xla": mcfg, "pallas": mcfg.replace(attention_impl="pallas",
                                                    scan_impl="pallas")},
        MESH, mp, mb))
    jobs["prefill"] = (R.prefill_rank, ("cpu", tcfg, MESH, tp, prompt[1],
                                        MAX_LEN, ("fsdp", "baseline")))
    jobs["refuse"] = (R.refuse_plain_leaf_rank,
                      ("cpu", tcfg, MESH, tp, tb))
    gen = torch.Generator().manual_seed(3)
    tree = {"rep": torch.randn(6, generator=gen),
            "data": torch.randn(4, 3, generator=gen),
            "model": torch.randn(3, 4, generator=gen),
            "both": torch.randn(4, 6, generator=gen)}
    jobs["norm"] = (R.global_norm_rank, ("cpu", MESH, tree))
    jobs["remat"] = (R.remat_outside_ctx_rank, ("cpu", tcfg, MESH, tp, tb))
    return D.run_ranks(R.jobs_rank, 4, tmp_path_factory.mktemp("mesh22"),
                       jobs)


@pytest.fixture(scope="module")
def train_ref(dense):
    """The reference's step with 1 and with 2 microbatches."""
    jcfg, jp, jb = dense[0], dense[2], dense[4]
    out = {}
    for n in (1, 2):
        js = jmake_opt_state(_run(jcfg, n), jp)
        _, js, jm = jax.jit(jmake_train_step(_run(jcfg, n)))(jp, js, jb)
        out[n] = dict(loss=float(jloss_fn(jcfg, jp, jb)[0]), metrics=jm,
                      m=_flat(js["m"]), v=_flat(js["v"]))
    return out


@pytest.mark.parametrize("microbatches", [1, 2])
def test_fsdp_train_step_matches_reference(mesh22, train_ref, dense,
                                           microbatches):
    ref, tcfg = train_ref[microbatches], dense[1]
    keys = ("loss", "grad_norm", "ce", "z", "aux")
    for ranks in mesh22:
        r = ranks[f"train{microbatches}"]
        np.testing.assert_allclose(float(r["loss"]), ref["loss"], rtol=1e-5)
        for k in keys:
            np.testing.assert_allclose(float(r["metrics"][k]),
                                       float(ref["metrics"][k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        assert r["count"] == 1 and float(r["metrics"]["lr"]) == 0.0
        assert r["in_place"] and r["kept"] and r["plain_metrics"]
        assert r["state_on_dtensors"]
        for mom in ("m", "v"):
            got = _flat(params_to_numpy(tcfg, r[mom]))
            for name, want in ref[mom].items():
                assert _scaled(got[name], want) <= 1e-4, (mom, name)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_sharded_moe_loss_matches_reference(mesh22, moe, impl):
    jcfg, jp, jb = moe[0], moe[2], moe[4]
    want = {k: float(v) for k, v in jloss_fn(jcfg, jp, jb)[1].items()}
    assert want["aux"] > 0
    for ranks in mesh22:
        got = ranks["moe"][impl]
        for k in ("loss", "ce", "aux", "z", "tokens"):
            np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-5,
                                       atol=1e-8, err_msg=k)


@pytest.mark.parametrize("policy", ["fsdp", "baseline"])
def test_sharded_prefill_matches_reference(mesh22, dense, prompt, policy):
    jcfg, jp = dense[0], dense[2]
    lg, cache = jprefill(jcfg, jp, prompt[0], MAX_LEN)
    for ranks in mesh22:
        got = ranks["prefill"][policy]
        assert _scaled(got["logits"], lg) <= 1e-5
        for k, v in cache.items():
            if k == "index":
                np.testing.assert_array_equal(got["cache"][k].numpy(), v)
            else:
                assert _scaled(got["cache"][k], v) <= 1e-5, k
        assert got["placements"]["k"] == (("Shard", 1), ("Shard", 3))


def test_sharded_step_refuses_a_plain_leaf(mesh22):
    for ranks in mesh22:
        msg = ranks["refuse"]
        assert msg is not None and "params['blocks'][1]['ln2']" in msg


def test_global_norm_counts_a_replicated_element_once(mesh22):
    for ranks in mesh22:
        r = ranks["norm"]
        assert r["leaves"] == 4
        np.testing.assert_allclose(r["sharded"], r["plain"], rtol=1e-6)


@pytest.fixture(scope="module")
def decode(dense, prompt, tmp_path_factory):
    jcfg, tcfg, jp, tp = dense[:4]
    jb, tb = prompt
    lg, cache = jprefill(jcfg, jp, jb, MAX_LEN)
    step = jax.jit(lambda p, t, c: jdecode_step(jcfg, p, t, c))
    logits, tokens = [np.asarray(lg)], []
    for _ in range(TICKS):
        tok = np.asarray(lg)[:, -1].argmax(-1)[:, None].astype(np.int32)
        tokens.append(tok)
        lg, cache = step(jp, jax.numpy.asarray(tok), cache)
        logits.append(np.asarray(lg))
    ranks = D.run_ranks(R.decode_rank, 8, tmp_path_factory.mktemp("dec"),
                        "cpu", tcfg, POD_MESH, tp, tb, MAX_LEN, TICKS)
    return logits, tokens, {k: np.asarray(v) for k, v in cache.items()}, \
        ranks


def test_multipod_decode_matches_reference(decode):
    logits, tokens, _, ranks = decode
    for r in ranks:
        assert r["kept"]
        for got, want in zip(r["logits"], logits):
            assert _scaled(got, want) <= 1e-5
        for got, want in zip(r["tokens"], tokens):
            np.testing.assert_array_equal(got.numpy(), want)


def test_multipod_decode_cache_blocks_are_reference_slices(decode, dense):
    """Each rank holds the reference cache's block at its coordinate:
    batch rows by (pod, data), kv columns by model."""
    tcfg = dense[1]
    cache, ranks = decode[2], decode[3]
    rows, cols = B // 4, tcfg.kv_dim // 2
    seen = set()
    for r in ranks:
        pod, data, model = r["coord"]
        b0, c0 = (2 * pod + data) * rows, model * cols
        seen.add((pod, data, model))
        np.testing.assert_array_equal(r["blocks"]["index"].numpy(),
                                      cache["index"][b0:b0 + rows])
        for k in ("k", "v"):
            want = cache[k][:, b0:b0 + rows, :, c0:c0 + cols]
            assert r["blocks"][k].shape == want.shape
            assert _scaled(r["blocks"][k], want) <= 1e-5, k
    assert len(seen) == 8


def test_remat_recompute_keeps_its_sharding_context(mesh22):
    """The backward of remat "full" recomputes each group under the
    context it ran in, wherever the backward runs (on a card, autograd's
    own thread): the grads after leaving the context equal those inside."""
    for ranks in mesh22:
        inside, outside = ranks["remat"]
        assert len(inside) == len(outside) > 0
        for a, b in zip(inside, outside):
            assert torch.equal(a, b)


@pytest.fixture(scope="module")
def int8_ref(dense):
    jcfg, jp, jb = dense[0], dense[2], dense[4]
    run = _run(jcfg, state_dtype="int8")
    js = jmake_opt_state(run, jp)
    _, js, _ = jax.jit(jmake_train_step(run))(jp, js, jb)
    block = run.optim.int8_block
    is_q = lambda x: isinstance(x, dict) and set(x) == {"q", "s"}
    return {k: _flat(jax.tree.map(
        lambda d: np.asarray(jq8_decode(d["q"], d["s"], block)), js[k],
        is_leaf=is_q)) for k in ("m", "v")}, block


def test_fsdp_train_step_int8_moments_match_reference(mesh22, int8_ref,
                                                      dense):
    """The int8 moments on the mesh: a leaf whose last dim is sharded
    would cut its blocks of 256 (qwen3-8b's tiny widths: 32 columns a
    rank), so it is updated on rows gathered along that dim; every
    decoded moment within 1e-4 of its scale or one code step of the
    reference's, where the two straddle a rounding tie."""
    want, block = int8_ref
    tcfg = dense[1]
    for ranks in mesh22:
        r = ranks["train_int8"]
        assert r["in_place"] and r["kept"] and r["state_on_dtensors"]
        for mom in ("m", "v"):
            got = _flat(params_to_numpy(tcfg, _decoded(r[mom], block)))
            for name, w in want[mom].items():
                scale = q8_encode(torch.from_numpy(w.copy()), block)[1]
                step = np.repeat(scale.numpy(), block,
                                 axis=-1)[..., :w.shape[-1]]
                err = np.abs(got[name] - w)
                assert np.all(err <= 1e-4 * np.abs(w).max() + step * 1.001), \
                    (mom, name, float(err.max()))


def _decoded(tree, block):
    """An int8 moment tree ({"q", "s"} leaves) decoded to f32 tensors."""
    if isinstance(tree, dict) and set(tree) == {"q", "s"}:
        return q8_decode(tree["q"], tree["s"], block)
    if isinstance(tree, dict):
        return {k: _decoded(v, block) for k, v in tree.items()}
    return [_decoded(v, block) for v in tree]
