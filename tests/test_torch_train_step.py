"""The port's training slice against the JAX package on the CPU: ``loss_fn``
grads against ``jax.grad`` for every ported family, remat, one
``make_train_step`` step (fp32 and int8 moments, int8 gradient
compression, microbatches), the eval step, batches and the run configs.

Parity runs in f32 activations on the ``xla`` paths, with params made by
the port and carried to the reference as numpy (``_torch_parity``); the
mirrors of the reference's own tests keep the tiny configs' bf16.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode

from repro.config import base as jbase
from repro.data.batches import batch_shapes as jbatch_shapes
from repro.models import loss_fn as jloss_fn
from repro.optim import q8_decode as jq8_decode
from repro.train.step import make_eval_step as jmake_eval_step
from repro.train.step import make_opt_state as jmake_opt_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import config as tbase
from repro_torch.bridge import params_to_numpy
from repro_torch.data import batch_shapes, make_batch
from repro_torch.models import loss_fn
from repro_torch.optim import q8_encode
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.train import make_eval_step, make_opt_state, make_train_step
from _torch_parity import batches, configs, port_params

HYBRID = "jamba-1.5-large-398b"
# (arch, config overrides): dense, MoE, RWKV6, hybrid without and with experts
FAMILIES = {"dense": ("qwen3-4b", {}),
            "moe": ("qwen3-moe-30b-a3b", {}),
            "rwkv6": ("rwkv6-3b", {}),
            "hybrid": (HYBRID, {"moe": None}),
            "hybrid_moe": (HYBRID, {})}
B, S = 2, 16


def _with_targets(cfg, jb, tb, seed=1):
    """The same targets in both batches, a few masked (-1)."""
    tg = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, tb["tokens"].shape).astype(np.int32)
    tg[:, ::5] = -1
    return (dict(jb, targets=jnp.asarray(tg)),
            dict(tb, targets=torch.from_numpy(tg).long()))


def _flat(tree, prefix=""):
    """A nested dict of arrays -> {"a/b": np.float32 array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _port_grads(cfg, params, batch):
    """``loss_fn``'s grads in the reference's layout, as numpy."""
    for p in tree_leaves(params):
        p.requires_grad_(True)
        p.grad = None
    loss, _ = loss_fn(cfg, params, batch)
    loss.backward()
    grads = tree_map(lambda p: p.grad, params)
    for p in tree_leaves(params):
        p.requires_grad_(False)
        p.grad = None
    return float(loss.detach()), _flat(params_to_numpy(cfg, grads))


@functools.lru_cache(maxsize=None)
def _reference(family):
    """(configs, params, batches, reference loss and grads), made once."""
    arch, kw = FAMILIES[family]
    jcfg, tcfg = configs(arch, dtype="float32", **kw)
    jp, tp = port_params(tcfg)
    jb, tb = _with_targets(tcfg, *batches(tcfg, B, S))
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(jcfg, p, b), has_aux=True))(jp, jb)
    return tcfg, tp, tb, float(jl), _flat(jg)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_grads_match_jax_grad(family, remat):
    """Every leaf's grad within 1e-4 of its largest reference value."""
    tcfg, tp, tb, jl, jg = _reference(family)
    loss, tg = _port_grads(tcfg.replace(remat=remat), tp, tb)
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    assert sorted(tg) == sorted(jg)
    for name, want in jg.items():
        scale = float(np.abs(want).max())
        assert scale > 0, name
        np.testing.assert_allclose(tg[name], want, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                    torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("family,group", [("dense", 2), ("rwkv6", 2),
                                          ("moe", 2), ("hybrid_moe", 1)])
def test_remat_modes_give_equal_grads(family, group):
    """``none``, ``full`` and ``dots``, and blocks in groups, give the same
    grads (1e-6).  ``dots`` saves every matmul output, so its backward
    runs as many matmuls as ``none``'s, and ``full``'s more."""
    tcfg, tp, tb, _, _ = _reference(family)
    want = None
    mm_in_backward = {}
    for remat, lps in (("none", 1), ("full", 1), ("dots", 1),
                       ("full", group), ("dots", group)):
        cfg = tcfg.replace(remat=remat, layers_per_step=lps)
        for p in tree_leaves(tp):
            p.requires_grad_(True)
            p.grad = None
        loss, _ = loss_fn(cfg, tp, tb)
        with _CountMM() as count:
            loss.backward()
        mm_in_backward[remat, lps] = count.n
        got = [p.grad.clone() for p in tree_leaves(tp)]
        for p in tree_leaves(tp):
            p.requires_grad_(False)
            p.grad = None
        if want is None:
            want = got
            continue
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-9)
    assert (mm_in_backward["none", 1] == mm_in_backward["dots", 1]
            == mm_in_backward["dots", group] < mm_in_backward["full", 1]
            <= mm_in_backward["full", group]), mm_in_backward


def test_layers_per_step_must_divide_blocks():
    tcfg, tp, tb, _, _ = _reference("dense")
    with pytest.raises(ValueError, match="layers_per_step"):
        loss_fn(tcfg.replace(layers_per_step=3), tp, tb)


def _runs(optim_kw, microbatches):
    jcfg, tcfg = configs("qwen3-4b", dtype="float32")
    shape = dict(name="t", kind="train", seq_len=S, global_batch=4)
    jrun = jbase.RunConfig(model=jcfg, shape=jbase.ShapeConfig(**shape),
                           optim=jbase.OptimConfig(**optim_kw),
                           microbatches=microbatches)
    trun = tbase.RunConfig(model=tcfg, shape=tbase.ShapeConfig(**shape),
                           optim=tbase.OptimConfig(**optim_kw),
                           microbatches=microbatches)
    return jrun, trun


def _code_step(x, block, b=1.0):
    """The int8 code step of each element of ``x`` / ``b`` in blocks of
    ``block`` along the last dim, times ``b``."""
    s = q8_encode(torch.from_numpy(np.asarray(x, np.float32) / b), block)[1]
    return np.repeat(s.numpy(), block, axis=-1)[..., :x.shape[-1]] * b


def _decode(q, s, cfg):
    return np.asarray(jq8_decode(jnp.asarray(q), jnp.asarray(s),
                                 cfg.int8_block))


def _ref_moment(tree, cfg):
    """The reference's moment tree as {name: f32}; int8 codes decoded (v's
    to sqrt(v), the domain they are coded in)."""
    if cfg.state_dtype != "int8":
        return _flat(tree)
    is_q = lambda x: isinstance(x, dict) and set(x) == {"q", "s"}
    return _flat(jax.tree.map(lambda d: _decode(d["q"], d["s"], cfg), tree,
                              is_leaf=is_q))


def _port_moment(mcfg, params, tree, cfg):
    """The port's moment tree in the reference's layout as {name: f32}."""
    if cfg.state_dtype != "int8":
        return _flat(params_to_numpy(mcfg, tree))
    q, s = ({k: np.asarray(v) for k, v in _flat(params_to_numpy(
        mcfg, tree_map(lambda p, d: d[part], params, tree))).items()}
        for part in ("q", "s"))
    return {k: _decode(q[k].astype(np.int8), s[k], cfg) for k in q}


STEP_CASES = {"fp32": ({}, 1), "int8_moments": ({"state_dtype": "int8"}, 1),
              "int8_grads": ({"grad_compress": "int8"}, 1),
              "microbatches": ({}, 2)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_reference(case):
    """One step from the same params and batch: loss, grad norm, lr and the
    last microbatch's ce/aux/z at 1e-5; the params (the first step's lr
    is 0) and the moments, which carry every grad, within 1e-4 of each
    leaf's scale.  An int8 code (moments, or the compressed grads) may
    land one step from the reference's, where the two grads straddle a
    rounding tie: there the moment may differ by that code step."""
    optim_kw, n = STEP_CASES[case]
    optim_kw = dict(optim_kw, warmup_steps=1, lr=1e-2)
    jrun, trun = _runs(optim_kw, n)
    tcfg, ocfg = trun.model, trun.optim
    jp, tp = port_params(tcfg)
    p0 = _flat(params_to_numpy(tcfg, tp))
    jb, tb = _with_targets(tcfg, *batches(tcfg, 4, S))
    js = jmake_opt_state(jrun, jp)
    ts = make_opt_state(trun, tp)
    jp, js, jm = jax.jit(jmake_train_step(jrun))(jp, js, jb)
    tp2, ts2, tm = make_train_step(trun)(tp, ts, tb)
    assert tp2 is tp and ts2 is ts                      # in place
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(tm["lr"]) == 0.0 and int(ts["count"]) == 1
    assert all(not p.requires_grad and p.grad is None
               for p in tree_leaves(tp))
    got = _flat(params_to_numpy(tcfg, tp))
    for name, want in _flat(jp).items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)
        np.testing.assert_array_equal(got[name], p0[name], err_msg=name)
    b1, b2 = ocfg.b1, ocfg.b2
    q8 = ocfg.state_dtype == "int8"
    moments = {k: (_port_moment(tcfg, tp, ts[k], ocfg),
                   _ref_moment(js[k], ocfg)) for k in ("m", "v")}
    for mom, (tgot, jwant) in moments.items():
        for name, want in jwant.items():
            tol = 1e-4 * float(np.abs(want).max())
            if q8:      # decoded codes of m, or of sqrt(v): one step away
                step = _code_step(want, ocfg.int8_block)
            elif ocfg.grad_compress == "int8":   # a grad code one step away
                g = want / (1 - b1) if mom == "m" else np.sqrt(want / (1 - b2))
                step = _code_step(g, 256)
                step = ((1 - b1) * step if mom == "m"
                        else (1 - b2) * (2 * g * step + step ** 2))
            else:
                step = 0.0
            err = np.abs(tgot[name] - want)
            assert np.all(err <= tol + step * 1.001), (mom, name,
                                                       float(err.max()))
    if ocfg.grad_compress == "int8":
        jerr = _flat(js["ef_error"])
        terr = _flat(params_to_numpy(tcfg, ts["ef_error"]))
        for name, want in jerr.items():
            g = np.sqrt(moments["v"][1][name] / (1 - b2))
            step = _code_step(g, 256)
            err = np.abs(terr[name] - want)
            assert np.all(err <= 1e-4 * float(np.abs(g).max())
                          + step * 1.001), (name, float(err.max()))


def test_eval_step_matches_reference():
    jrun, trun = _runs({}, 1)
    tcfg = trun.model
    jp, tp = port_params(tcfg)
    jb, tb = _with_targets(tcfg, *batches(tcfg, 2, S))
    jm = jmake_eval_step(jrun)(jp, jb)
    tm = make_eval_step(trun)(tp, tb)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        assert not tm[k].requires_grad
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("family", ["dense", "moe", "rwkv6", "hybrid_moe"])
def test_train_step_no_nans(family):
    """The reference's ``test_train_step_no_nans`` in the port: remat
    ``full`` at the tiny configs' bf16, finite grads; then a train step
    leaves finite params and metrics."""
    arch, kw = FAMILIES[family]
    _, tcfg = configs(arch, remat="full", **kw)
    _, tp = port_params(tcfg)
    batch = make_batch(tcfg, B, S, device="cpu")
    _, grads = _port_grads(tcfg, tp, batch)
    for name, g in grads.items():
        assert np.isfinite(g).all(), name
    _, trun = _runs({"warmup_steps": 1}, 1)
    trun = trun.replace(model=tcfg)
    opt = make_opt_state(trun, tp)
    step = make_train_step(trun)
    for _ in range(2):
        tp, opt, metrics = step(tp, opt, batch)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert all(bool(torch.isfinite(p.float()).all()) for p in tree_leaves(tp))


def test_microbatching_matches_full_batch_loss():
    """The reference's test in the port (bf16, 5e-2), and in f32 the mean
    of 4 microbatches' grads equals the full batch's (the moments)."""
    _, tcfg = configs("qwen3-8b")
    batch = make_batch(tcfg, 4, 16, device="cpu")
    for dtype, tol in (("bfloat16", 5e-2), ("float32", 1e-5)):
        cfg = tcfg.replace(dtype=dtype)
        out = {}
        for n in (1, 4):
            _, run = _runs({"lr": 0.0, "grad_clip": 1e9}, n)
            run = run.replace(model=cfg)
            _, tp = port_params(cfg)
            opt = make_opt_state(run, tp)
            _, opt, metrics = make_train_step(run)(tp, opt, batch)
            out[n] = (float(metrics["loss"]), tree_leaves(opt["m"]))
        assert abs(out[1][0] - out[4][0]) < tol
        if dtype == "float32":
            for a, b in zip(out[1][1], out[4][1]):
                torch.testing.assert_close(
                    a, b, rtol=0, atol=1e-4 * float(b.abs().max()) + 1e-12)


def test_make_batch_shapes_and_determinism():
    for arch in ("qwen3-4b", "rwkv6-3b", HYBRID):
        jcfg, tcfg = configs(arch)
        want = jbatch_shapes(jcfg, 3, 20)
        got = batch_shapes(tcfg, 3, 20)
        assert {k: s for k, (s, _) in got.items()} == \
            {k: s for k, (s, _) in want.items()}
        assert all(dt == torch.int32 for _, dt in got.values())
        gen = torch.Generator().manual_seed(7)
        b1 = make_batch(tcfg, 3, 20, gen, device="cpu")
        b2 = make_batch(tcfg, 3, 20, torch.Generator().manual_seed(7),
                        device="cpu")
        for k in b1:
            torch.testing.assert_close(b1[k], b2[k])
        assert int(b1["tokens"].min()) >= 0
        assert int(b1["tokens"].max()) < tcfg.vocab_size
        assert (b1["positions"] == torch.arange(20)).all()


def test_run_configs_match_reference():
    """The config copies' fields, defaults and ``SHAPES`` equal the
    reference's; ``RunConfig.replace`` works as there."""
    for name in ("ShapeConfig", "MeshConfig", "OptimConfig",
                 "ShardingConfig", "RunConfig"):
        jf = {f.name: (f.default, str(f.type)) for f in
              dataclasses.fields(getattr(jbase, name))}
        tf = {f.name: (f.default, str(f.type)) for f in
              dataclasses.fields(getattr(tbase, name))}
        assert list(tf) == list(jf), name
        for k in jf:
            if k not in ("mesh", "optim", "sharding", "model", "shape"):
                assert tf[k] == jf[k], (name, k)
    for name in ("MeshConfig", "OptimConfig", "ShardingConfig"):
        assert dataclasses.asdict(getattr(tbase, name)()) == \
            dataclasses.asdict(getattr(jbase, name)())
    assert (tbase.TRAIN, tbase.PREFILL, tbase.DECODE) == \
        (jbase.TRAIN, jbase.PREFILL, jbase.DECODE)
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert tbase.MeshConfig(data=2, model=4, pods=2).num_devices == 16
    jrun, trun = _runs({}, 2)
    assert dataclasses.asdict(trun.replace(seed=3).optim) == \
        dataclasses.asdict(jrun.replace(seed=3).optim)
    assert trun.replace(seed=3).seed == 3 and trun.microbatches == 2
