"""The RWKV6 and hybrid families sharded on a (data 2, model 2) ``gloo``
mesh, held to the single-device JAX reference on the same numpy weights,
in f32 on the tiny configs (rwkv6-3b: 2 layers, 4 heads of 16, WKV on
each rank's 2 heads; jamba-1.5-large-398b: one superblock of 8 layers
with 8 experts, the Mamba layers on each rank's 64 of 128 ``inner``
channels), under ``fsdp`` and ``baseline``:

- the loss, within 1e-5;
- one train step with 2 microbatches: every metric within 1e-5, the
  moments within 1e-4 of each leaf's scale;
- prefill of 8 tokens and 3 greedy decode ticks: logits within 1e-5 of
  their scale, the same tokens;
- each rank's block of every cache entry (RWKV6 ``tshift``/``cshift``/
  ``wkv``, hybrid ``k``/``v``/``conv``/``ssm``, and ``index``) after the
  prefill and after each tick equal to the reference cache's slice at its
  mesh coordinate, the cache laid out by ``cache_logical_axes``;
- the same train step (``fsdp``) of rwkv6-3b at d_model 48, 3 heads of
  16 on the 2-way ``model`` axis: a rank's 24 channels cut a head, so r,
  k, v, w and u are gathered to whole heads around WKV (as rwkv6-3b's
  40 heads on a 16-way axis in the dry-run);
- a decode under the ``shard_seq`` rules (batch whole, the K/V rows split
  over data: 8 rows a rank of 16) whose 4 ticks write rows 6 to 9, so
  both data ranks' blocks take writes, each family under its dry-run
  policy (rwkv6-3b ``baseline``, jamba ``fsdp``): logits, tokens and
  cache blocks as above.

The rank functions are in ``_torch_sharded_ranks.py``; the 4 ranks run
once for the module.
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
from repro.train.step import make_opt_state as jmake_opt_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.bridge import params_to_numpy
from repro_torch.models import cache_logical_axes
from _torch_parity import batches, configs, port_params

ARCHS = {"rwkv": "rwkv6-3b", "hybrid": "jamba-1.5-large-398b"}
POLICIES = ("fsdp", "baseline")
SEQ_POLICY = {"rwkv": "baseline", "hybrid": "fsdp"}
B, S, MICRO = 4, 16, 2
PROMPT, MAX_LEN, TICKS = 8, 16, 3
SEQ_B, SEQ_PROMPT, SEQ_TICKS = 2, 6, 4      # rows 6..9 of 16: both blocks
UNEVEN = dict(d_model=48, num_heads=3, num_kv_heads=3)
MESH = (2, 2)


def _targets(cfg, jb, tb):
    tg = np.random.default_rng(1).integers(
        0, cfg.vocab_size, tb["tokens"].shape).astype(np.int32)
    tg[0, 1:] = -1
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
    for name, arch in ARCHS.items():
        jcfg, tcfg = configs(arch, dtype="float32")
        jp, tp = port_params(tcfg)
        jb, tb = _targets(tcfg, *batches(tcfg, B, S))
        out[name] = dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jb=jb, tb=tb,
                         prompt=batches(tcfg, B, PROMPT, seed=2),
                         seq_prompt=batches(tcfg, SEQ_B, SEQ_PROMPT, seed=3))
    jcfg, tcfg = configs("rwkv6-3b", dtype="float32", **UNEVEN)
    jp, tp = port_params(tcfg)
    jb, tb = _targets(tcfg, *batches(tcfg, B, S))
    out["uneven"] = dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jb=jb, tb=tb)
    return out


@pytest.fixture(scope="module")
def started(cases, tmp_path_factory):
    """Every family's step and decodes under both policies, in one spawn
    of the 4 ranks, started; the reference runs while they work."""
    c = cases["uneven"]
    jobs = {"uneven/fsdp/train": (R.train_step_rank, (
        "cpu", c["tcfg"], MESH, c["tp"], c["tb"], MICRO, "float32", "fsdp"))}
    for name in ARCHS:
        c = cases[name]
        for policy in POLICIES:
            jobs[f"{name}/{policy}/train"] = (R.train_step_rank, (
                "cpu", c["tcfg"], MESH, c["tp"], c["tb"], MICRO, "float32",
                policy))
            jobs[f"{name}/{policy}/decode"] = (R.decode_rank, (
                "cpu", c["tcfg"], MESH, c["tp"], c["prompt"][1], MAX_LEN,
                TICKS, policy))
        jobs[f"{name}/seq"] = (R.decode_rank, (
            "cpu", c["tcfg"], MESH, c["tp"], c["seq_prompt"][1], MAX_LEN,
            SEQ_TICKS, SEQ_POLICY[name], True))
    return D.start_ranks(R.jobs_rank, 4, tmp_path_factory.mktemp("rwkvhy"),
                         jobs, limit=300)


def _train_reference(c):
    jcfg, jp, jb = c["jcfg"], c["jp"], c["jb"]
    run = jbase.RunConfig(
        model=jcfg, shape=jbase.ShapeConfig("t", "train", S, B),
        sharding=jbase.ShardingConfig(policy="fsdp"),
        optim=jbase.OptimConfig(), microbatches=MICRO)
    js = jmake_opt_state(run, jp)
    _, js, jm = jax.jit(jmake_train_step(run))(jp, js, jb)
    return dict(loss=float(jloss_fn(jcfg, jp, jb)[0]),
                metrics={k: float(v) for k, v in jm.items()},
                m=_flat(js["m"]), v=_flat(js["v"]))


def _decode_reference(cfg, params, prompt, ticks):
    lg, cache = jprefill(cfg, params, prompt, MAX_LEN)
    step = jax.jit(lambda p, t, ca: jdecode_step(cfg, p, t, ca))
    logits, tokens, caches = [np.asarray(lg)], [], []
    prefill_cache = {k: np.asarray(v) for k, v in cache.items()}
    for _ in range(ticks):
        tok = np.asarray(lg)[:, -1].argmax(-1)[:, None].astype(np.int32)
        tokens.append(tok)
        lg, cache = step(params, jax.numpy.asarray(tok), cache)
        logits.append(np.asarray(lg))
        caches.append({k: np.asarray(v) for k, v in cache.items()})
    return dict(logits=logits, tokens=tokens, prefill_cache=prefill_cache,
                tick_caches=caches, cache=caches[-1])


@pytest.fixture(scope="module")
def references(cases):
    out = {"uneven": _train_reference(cases["uneven"])}
    for name in ARCHS:
        c = cases[name]
        out[name] = dict(
            _train_reference(c),
            decode=_decode_reference(c["jcfg"], c["jp"], c["prompt"][0],
                                     TICKS),
            seq=_decode_reference(c["jcfg"], c["jp"], c["seq_prompt"][0],
                                  SEQ_TICKS))
    return out


@pytest.fixture(scope="module")
def ranks(started, references):
    return D.join_ranks(started)


def _block(full, axes, coord, mesh_names=("data", "model"), rules=None):
    """The block of ``full`` at mesh ``coord`` for the logical ``axes``
    under ``rules`` (logical name -> mesh axis): each dim cut by the mesh
    axis it maps to, where that axis divides it."""
    sl = []
    for dim, name in enumerate(axes):
        axis = rules.get(name) if name else None
        if axis is None or full.shape[dim] % MESH[mesh_names.index(axis)]:
            sl.append(slice(None))
            continue
        n = MESH[mesh_names.index(axis)]
        size = full.shape[dim] // n
        c = coord[mesh_names.index(axis)]
        sl.append(slice(c * size, (c + 1) * size))
    return full[tuple(sl)]


RULES = {"batch": "data", "kv_act": "model", "heads_act": "model",
         "inner_act": "model", "embed_act": None, "kv_seq": None}
SEQ_RULES = dict(RULES, batch=None, kv_seq="data")


@pytest.mark.parametrize("family,policy", [
    (f, p) for f in ARCHS for p in POLICIES] + [("uneven", "fsdp")])
def test_sharded_loss_and_train_step_match_reference(ranks, references,
                                                     cases, family, policy):
    ref, tcfg = references[family], cases[family]["tcfg"]
    for r in ranks:
        got = r[f"{family}/{policy}/train"]
        np.testing.assert_allclose(float(got["loss"]), ref["loss"],
                                   rtol=1e-5)
        for k in ("loss", "grad_norm", "ce", "z", "aux"):
            np.testing.assert_allclose(float(got["metrics"][k]),
                                       ref["metrics"][k], rtol=1e-5,
                                       atol=1e-8, err_msg=k)
        assert got["in_place"] and got["kept"] and got["state_on_dtensors"]
        for mom in ("m", "v"):
            flat = _flat(params_to_numpy(tcfg, got[mom]))
            assert sorted(flat) == sorted(ref[mom])
            for leaf, want in ref[mom].items():
                assert _scaled(flat[leaf], want) <= 1e-4, (mom, leaf)


def _check_decode(got, ref, ticks):
    assert got["kept"]
    assert len(got["logits"]) == len(ref["logits"]) == ticks + 1
    for g, want in zip(got["logits"], ref["logits"]):
        assert _scaled(g, want) <= 1e-5
    for g, want in zip(got["tokens"], ref["tokens"]):
        np.testing.assert_array_equal(g.numpy(), want)


def _check_blocks(got, ref, cfg, rules, shard_seq):
    """Each rank's blocks after the prefill and after every tick."""
    axes = cache_logical_axes(cfg, shard_seq=shard_seq)
    pairs = [(got["prefill_blocks"], ref["prefill_cache"])] + list(
        zip(got["tick_blocks"], ref["tick_caches"]))
    assert len(pairs) == len(ref["tick_caches"]) + 1
    for blocks, cache in pairs:
        assert sorted(blocks) == sorted(cache) == sorted(axes)
        for k, ax in axes.items():
            want = _block(cache[k], ax, got["coord"], rules=rules)
            assert tuple(blocks[k].shape) == want.shape, k
            if k == "index":
                np.testing.assert_array_equal(blocks[k].numpy(), want)
            else:
                assert _scaled(blocks[k], want) <= 1e-5, k


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", list(ARCHS))
def test_sharded_prefill_decode_and_cache_blocks_match_reference(
        ranks, references, cases, family, policy):
    """Logits and tokens as the reference's; each rank holds the reference
    cache's block at its coordinate: batch rows by data, kv columns, the
    WKV state's heads and the Mamba states' channels by model."""
    ref, cfg = references[family]["decode"], cases[family]["tcfg"]
    for r in ranks:
        got = r[f"{family}/{policy}/decode"]
        _check_decode(got, ref, TICKS)
        _check_blocks(got, ref, cfg, RULES, False)


@pytest.mark.parametrize("family", list(ARCHS))
def test_shard_seq_decode_crosses_the_blocks_and_matches_reference(
        ranks, references, cases, family):
    """Under the ``shard_seq`` decode rules the batch is whole and the
    hybrid's K/V rows split over data (8 of 16 a rank): the ticks write
    rows 6 to 9, so each data rank's block takes writes only from the rank
    that holds the row, and the attention merges the blocks by log-sum-exp;
    RWKV6 (no rows) keeps its state by heads."""
    ref, cfg = references[family]["seq"], cases[family]["tcfg"]
    assert SEQ_PROMPT < MAX_LEN // MESH[0] < SEQ_PROMPT + SEQ_TICKS
    for r in ranks:
        got = r[f"{family}/seq"]
        _check_decode(got, ref, SEQ_TICKS)
        _check_blocks(got, ref, cfg, SEQ_RULES, True)
        if family == "hybrid":
            assert got["blocks"]["k"].shape[2] == MAX_LEN // MESH[0]
