"""The enc-dec and VLM families sharded on a (data 2, model 2) ``gloo``
mesh, held to the single-device JAX reference on the same numpy weights,
in f32 on the tiny configs (seamless-m4t-medium: 2 + 2 layers, 4 heads of
16; qwen2-vl-72b: M-RoPE positions [3, B, S]), under ``fsdp`` and
``baseline``:

- the loss, within 1e-5;
- one train step with 2 microbatches (the enc-dec frontend and the VLM
  positions split as the reference splits them): every metric within
  1e-5, the moments within 1e-4 of each leaf's scale;
- prefill (enc-dec: the frames through the encoder, then 8 text tokens,
  cross-attention with Sq != Skv; VLM: 4 patches before the text) and 3
  greedy decode ticks: logits within 1e-5 of their scale, the same tokens;
- each rank's block of every cache entry (enc-dec ``k``/``v``/``xk``/
  ``xv``, VLM ``k``/``v``, and ``index``) after the prefill and after the
  ticks equal to the reference cache's slice at its mesh coordinate,
  the cache laid out by ``cache_logical_axes`` throughout.

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
from _torch_parity import batches, configs, port_params

ARCHS = {"encdec": "seamless-m4t-medium", "vlm": "qwen2-vl-72b"}
POLICIES = ("fsdp", "baseline")
B, S, MICRO = 4, 16, 2
PROMPT, MAX_LEN, TICKS = 8, 16, 3
MESH = (2, 2)


def _targets(cfg, jb, tb):
    tg = np.random.default_rng(1).integers(
        0, cfg.vocab_size, tb["tokens"].shape).astype(np.int32)
    tg[0, 1:] = -1
    tg[2:, ::5] = -1
    return (dict(jb, targets=jax.numpy.asarray(tg)),
            dict(tb, targets=torch.from_numpy(tg).long()))


def _prompt(name, cfg):
    """Enc-dec: S frames and the first PROMPT text tokens; VLM: PROMPT
    positions, the first 4 of them patches."""
    jb, tb = batches(cfg, B, S if name == "encdec" else PROMPT, seed=2)
    if name == "encdec":
        cut = lambda b: dict(b, tokens=b["tokens"][:, :PROMPT],
                             positions=b["positions"][:, :PROMPT])
        jb, tb = cut(jb), cut(tb)
    return jb, tb


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
                         prompt=_prompt(name, tcfg))
    return out


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    """Every family's step and decode under both policies, in one spawn
    of the 4 ranks."""
    jobs = {}
    for name, c in cases.items():
        for policy in POLICIES:
            jobs[f"{name}/{policy}/train"] = (R.train_step_rank, (
                "cpu", c["tcfg"], MESH, c["tp"], c["tb"], MICRO, "float32",
                policy))
            jobs[f"{name}/{policy}/decode"] = (R.decode_rank, (
                "cpu", c["tcfg"], MESH, c["tp"], c["prompt"][1], MAX_LEN,
                TICKS, policy))
    return D.run_ranks(R.jobs_rank, 4, tmp_path_factory.mktemp("encvlm"),
                       jobs)


@pytest.fixture(scope="module")
def references(cases):
    out = {}
    for name, c in cases.items():
        jcfg, jp, jb = c["jcfg"], c["jp"], c["jb"]
        run = jbase.RunConfig(
            model=jcfg, shape=jbase.ShapeConfig("t", "train", S, B),
            sharding=jbase.ShardingConfig(policy="fsdp"),
            optim=jbase.OptimConfig(), microbatches=MICRO)
        js = jmake_opt_state(run, jp)
        _, js, jm = jax.jit(jmake_train_step(run))(jp, js, jb)
        lg, cache = jprefill(jcfg, jp, c["prompt"][0], MAX_LEN)
        step = jax.jit(lambda p, t, ca, cfg=jcfg: jdecode_step(cfg, p, t, ca))
        logits, tokens = [np.asarray(lg)], []
        prefill_cache = {k: np.asarray(v) for k, v in cache.items()}
        for _ in range(TICKS):
            tok = np.asarray(lg)[:, -1].argmax(-1)[:, None].astype(np.int32)
            tokens.append(tok)
            lg, cache = step(jp, jax.numpy.asarray(tok), cache)
            logits.append(np.asarray(lg))
        out[name] = dict(
            loss=float(jloss_fn(jcfg, jp, jb)[0]),
            metrics={k: float(v) for k, v in jm.items()},
            m=_flat(js["m"]), v=_flat(js["v"]), logits=logits,
            tokens=tokens, prefill_cache=prefill_cache,
            cache={k: np.asarray(v) for k, v in cache.items()})
    return out


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", list(ARCHS))
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


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", list(ARCHS))
def test_sharded_prefill_and_decode_match_reference(ranks, references,
                                                    family, policy):
    ref = references[family]
    for r in ranks:
        got = r[f"{family}/{policy}/decode"]
        assert got["kept"]
        assert len(got["logits"]) == len(ref["logits"]) == TICKS + 1
        for g, want in zip(got["logits"], ref["logits"]):
            assert _scaled(g, want) <= 1e-5
        for g, want in zip(got["tokens"], ref["tokens"]):
            np.testing.assert_array_equal(g.numpy(), want)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", list(ARCHS))
def test_sharded_cache_blocks_are_reference_slices(ranks, references, cases,
                                                   family, policy):
    """Each rank holds the reference cache's block at its coordinate:
    batch rows by data, kv columns by model; the enc-dec ``xk``/``xv``
    keep the encoder's S rows."""
    ref, tcfg = references[family], cases[family]["tcfg"]
    want_keys = ["index", "k", "v"] + (["xk", "xv"] if family == "encdec"
                                       else [])
    rows, cols = B // MESH[0], tcfg.kv_dim // MESH[1]
    for r in ranks:
        got = r[f"{family}/{policy}/decode"]
        data, model = r[f"{family}/{policy}/decode"]["coord"]
        b0, c0 = data * rows, model * cols
        for blocks, cache in ((got["prefill_blocks"], ref["prefill_cache"]),
                              (got["blocks"], ref["cache"])):
            assert sorted(blocks) == sorted(cache) == want_keys
            np.testing.assert_array_equal(blocks["index"].numpy(),
                                          cache["index"][b0:b0 + rows])
            for k in want_keys[1:]:
                want = cache[k][:, b0:b0 + rows, :, c0:c0 + cols]
                assert tuple(blocks[k].shape) == want.shape, k
                assert _scaled(blocks[k], want) <= 1e-5, k
        if family == "encdec":
            assert got["blocks"]["xk"].shape[2] == S
