"""The port's enc-dec family (``seamless-m4t-medium``, tiny: 2 + 2
layers, d = 64, head dim 16) against the JAX package on the CPU.

Both packages run the same JAX-made parameters (bridged through numpy) on
the same numpy batches, in f32 at 1e-4: ``forward``, ``loss_fn``,
``prefill`` (every cache entry), three ``decode_step``s, the plain flash
path (``attention_impl="pallas"``) against the reference's Pallas kernel
in interpret mode, grads against ``jax.grad`` and one train step.  Then
the enc-dec init, bridge and batches, the training launcher, and the
engine's refusal beside the reference's ``KeyError``.  The mirror of the
reference's ``test_decode_matches_forward`` keeps the tiny config's bf16
and its 1e-2.
"""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.config import base as jbase
from repro.data.batches import batch_shapes as jbatch_shapes
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models import prefill as jprefill
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train.step import make_opt_state as jmake_opt_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import config as tbase
from repro_torch.bridge import leaf_names, params_from_numpy, params_to_numpy
from repro_torch.data import batch_shapes, make_batch
from repro_torch.models import (
    cache_batch_axes, decode_step, forward, init_cache, init_params, loss_fn,
    prefill,
)
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.serve import ServeEngine
from repro_torch.train import make_opt_state, make_train_step
from _torch_parity import (
    assert_pipelines_agree, batches, configs, f32, params, port_params,
)

ARCH = "seamless-m4t-medium"
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _with_targets(cfg, jb, tb, seed=1):
    """The same next-token targets in both batches, a few masked (-1)."""
    tg = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, tb["tokens"].shape).astype(np.int32)
    tg[:, ::5] = -1
    return (dict(jb, targets=jnp.asarray(tg)),
            dict(tb, targets=torch.from_numpy(tg).long()))


def _text(jb, tb, n):
    """Both batches with their first ``n`` text tokens (all frames kept)."""
    jb = dict(jb, tokens=jb["tokens"][:, :n], positions=jb["positions"][:, :n])
    tb = dict(tb, tokens=tb["tokens"][:, :n], positions=tb["positions"][:, :n])
    return jb, tb


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


# ---- forward / loss / prefill / decode ---------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_and_loss_match_jax(impl):
    jcfg, tcfg = configs(ARCH, dtype="float32", attention_impl=impl)
    jp, tp = params(jcfg, tcfg)
    jb, tb = _with_targets(tcfg, *batches(tcfg, B, S))
    assert tb["frontend"].shape == (B, S, tcfg.frontend_embed_dim)
    jl, _ = jax.jit(lambda p, b: jforward(jcfg, p, b))(jp, jb)
    tl, aux = forward(tcfg, tp, tb)
    assert tl.shape == (B, S, tcfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    _, jm = jax.jit(lambda p, b: jloss_fn(jcfg, p, b))(jp, jb)
    _, tm = loss_fn(tcfg, tp, tb)
    for k in ("loss", "ce", "z", "tokens"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_and_decode_match_jax(impl):
    """24 encoder frames against 12 text tokens (cross-attention with
    Sq != Skv), then three decode steps (cross-attention with one query
    row against the cached encoder K/V); every cache entry each time."""
    jcfg, tcfg = configs(ARCH, dtype="float32", attention_impl=impl)
    jp, tp = params(jcfg, tcfg, seed=1)
    jb, tb = _text(*batches(tcfg, B, 24, seed=1), 12)
    jl, jc = jax.jit(lambda p, b: jprefill(jcfg, p, b, max_len=20))(jp, jb)
    tl, tc = prefill(tcfg, tp, tb, max_len=20)
    assert sorted(tc) == sorted(jc) == ["index", "k", "v", "xk", "xv"]
    assert tc["xk"].shape == (tcfg.decoder_layers, B, 24, tcfg.kv_dim)
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)

    def same_cache():
        for name in ("k", "v", "xk", "xv"):
            assert tc[name].shape == jc[name].shape, name
            np.testing.assert_allclose(f32(tc[name]), f32(jc[name]), **TOL,
                                       err_msg=name)
        np.testing.assert_array_equal(tc["index"].numpy(),
                                      np.asarray(jc["index"]))

    same_cache()
    np.testing.assert_array_equal(tc["index"].numpy(), [12, 12])
    jstep = jax.jit(lambda p, t, c: jdecode(jcfg, p, t, c))
    toks = np.array([[3], [7]], np.int32)
    for _ in range(3):
        jl, jc = jstep(jp, jnp.asarray(toks), jc)
        tl, tc = decode_step(tcfg, tp, torch.from_numpy(toks).long(), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
        toks = np.array(jnp.argmax(jl[:, 0], -1), np.int32)[:, None]
    same_cache()


def test_decode_matches_forward():
    """prefill(S-1 tokens) + decode(last) == forward(S tokens)[-1], the
    reference's ``test_decode_matches_forward`` on the port (bf16)."""
    _, cfg = configs(ARCH)
    _, p = params(*configs(ARCH))
    _, batch = batches(cfg, B, S)
    logits, _ = forward(cfg, p, batch)
    _, cache = prefill(cfg, p, _text(batch, batch, S - 1)[1], max_len=S + 8)
    dec, cache2 = decode_step(cfg, p, batch["tokens"][:, -1:], cache)
    err = float((dec[:, 0].float() - logits[:, -1].float()).abs().max())
    assert err < 1e-2, err
    assert int(cache2["index"][0]) == S


def test_init_cache_matches_reference_layout():
    jcfg, tcfg = configs(ARCH)
    jc = jinit_cache(jcfg, 3, 40)
    tc = init_cache(tcfg, 3, 40, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()} == \
        {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in tc.items()}
    assert cache_batch_axes(tcfg) == {"k": 1, "v": 1, "xk": 1, "xv": 1,
                                      "index": 0}


# ---- grads and the train step -------------------------------------------------

def _grads(cfg, tp, tb):
    for p in tree_leaves(tp):
        p.requires_grad_(True)
        p.grad = None
    loss, _ = loss_fn(cfg, tp, tb)
    loss.backward()
    grads = tree_map(lambda p: p.grad, tp)
    for p in tree_leaves(tp):
        p.requires_grad_(False)
        p.grad = None
    return float(loss.detach()), grads


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_grads_match_jax_grad(remat):
    """Every leaf's grad within 1e-4 of its largest reference value."""
    jcfg, tcfg = configs(ARCH, dtype="float32")
    jp, tp = port_params(tcfg)
    jb, tb = _with_targets(tcfg, *batches(tcfg, B, S))
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(jcfg, p, b), has_aux=True))(jp, jb)
    loss, tg = _grads(tcfg.replace(remat=remat), tp, tb)
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    got, want = _flat(params_to_numpy(tcfg, tg)), _flat(jg)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0, name
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def test_remat_modes_give_equal_grads():
    """``none``, ``full`` and ``dots``, one block or both blocks of each
    stack a group, give the same grads (1e-6)."""
    _, tcfg = configs(ARCH, dtype="float32")
    _, tp = port_params(tcfg)
    _, tb = _with_targets(tcfg, *batches(tcfg, B, S))
    _, want = _grads(tcfg, tp, tb)
    for remat in ("full", "dots"):
        for lps in (1, 2):
            _, got = _grads(tcfg.replace(remat=remat, layers_per_step=lps),
                            tp, tb)
            for g, w in zip(tree_leaves(got), tree_leaves(want)):
                torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_moments_match_reference(microbatches):
    """One step of ``make_train_step`` from the same params and batch (the
    frontend split along axis 0 into microbatches): the metrics at 1e-5,
    the params unmoved (lr_at(0) = 0) and the fp32 moments within 1e-4 of
    each leaf's scale."""
    jcfg, tcfg = configs(ARCH, dtype="float32")
    optim = dict(warmup_steps=1, lr=1e-2)
    shape = dict(name="t", kind="train", seq_len=S, global_batch=4)
    jrun = jbase.RunConfig(model=jcfg, shape=jbase.ShapeConfig(**shape),
                           optim=jbase.OptimConfig(**optim),
                           microbatches=microbatches)
    trun = tbase.RunConfig(model=tcfg, shape=tbase.ShapeConfig(**shape),
                           optim=tbase.OptimConfig(**optim),
                           microbatches=microbatches)
    jp, tp = port_params(tcfg)
    jb, tb = _with_targets(tcfg, *batches(tcfg, 4, S))
    js, ts = jmake_opt_state(jrun, jp), make_opt_state(trun, tp)
    jp, js, jm = jax.jit(jmake_train_step(jrun))(jp, js, jb)
    _, ts, tm = make_train_step(trun)(tp, ts, tb)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    got = _flat(params_to_numpy(tcfg, tp))
    for name, want in _flat(jp).items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    for mom in ("m", "v"):
        got = _flat(params_to_numpy(tcfg, ts[mom]))
        for name, want in _flat(js[mom]).items():
            tol = 1e-4 * float(np.abs(want).max())
            np.testing.assert_allclose(got[name], want, rtol=0, atol=tol,
                                       err_msg=f"{mom} {name}")


# ---- init and bridge ----------------------------------------------------------

def test_init_matches_reference_shapes_and_dtypes():
    jcfg, tcfg = configs(ARCH, param_dtype="bfloat16")
    jp = jax.eval_shape(lambda: jinit_params(jcfg, jax.random.PRNGKey(0)))
    tp = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert len(tp["enc_blocks"]) == tcfg.encoder_layers
    assert len(tp["dec_blocks"]) == tcfg.decoder_layers
    got = {k: (v.shape, str(v.dtype)) for k, v in
           _flat_shapes(params_to_numpy(tcfg, tp)).items()}
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            _flat_shapes(jp).items()}
    assert got == want


def _flat_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_every_jax_leaf_consumed_exactly_once():
    from repro.checkpoint.ckpt import _leaf_paths, _path_str
    jcfg, tcfg = configs(ARCH)
    jp, tp = params(jcfg, tcfg)
    names = [_path_str(p) for p, _ in _leaf_paths(jp)]
    assert sorted(names) == sorted(leaf_names(tcfg))
    assert {"embed/frontend_proj", "enc_norm", "enc_blocks/attn/bq",
            "dec_blocks/cross_attn/wk", "dec_blocks/ln_x"} <= set(names)
    n_elems = sum(np.asarray(x).size for x in jax.tree.leaves(jp))
    assert sum(t.numel() for t in tree_leaves(tp)) == n_elems
    np.testing.assert_array_equal(
        tp["dec_blocks"][1]["cross_attn"]["wq"].numpy(),
        np.asarray(jp["dec_blocks"]["cross_attn"]["wq"][1]))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_exact(param_dtype):
    jcfg, tcfg = configs(ARCH, param_dtype=param_dtype)
    jp, tp = params(jcfg, tcfg)
    want = jax.tree.map(np.asarray, jp)
    for got in (params_to_numpy(tcfg, tp),
                params_to_numpy(tcfg, params_from_numpy(tcfg, want, "cpu"))):
        fg, fw = _flat_shapes(got), _flat_shapes(want)
        assert sorted(fg) == sorted(fw)
        for name in fw:
            assert fg[name].dtype == fw[name].dtype, name
            np.testing.assert_array_equal(fg[name].view(np.uint8),
                                          fw[name].view(np.uint8),
                                          err_msg=name)


def test_stack_depth_is_checked():
    jcfg, tcfg = configs(ARCH)
    tree = jax.tree.map(np.asarray, params(jcfg, tcfg)[0])
    with pytest.raises(ValueError, match="encoder_layers=3"):
        params_from_numpy(tcfg.replace(encoder_layers=3), tree, "cpu")


# ---- the launcher and the engine ------------------------------------------------

def test_train_launcher_trains_crashes_and_restores(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--tiny",
         "--device", "cpu", "--arch", ARCH, "--steps", "8", "--ckpt-every",
         "3", "--inject-crash-at", "5", "--workdir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "family=encdec device=cpu" in out.stdout
    m = re.search(r"restarts=(\d+) loss ([-\d.na]+) -> ([-\d.na]+)",
                  out.stdout)
    assert m and m.group(1) == "1", out.stdout
    assert np.isfinite(float(m.group(2))) and np.isfinite(float(m.group(3)))


def test_engine_refuses_encdec():
    _, tcfg = configs(ARCH)
    with pytest.raises(NotImplementedError, match="frontend"):
        ServeEngine(tcfg, None, device="cpu")


def test_reference_caveat_engine_raises_key_error_for_encdec():
    """Recorded, not a port fault: the reference's engine admits a batch
    without the encoder's ``frontend`` (ROADMAP Queue 3)."""
    jcfg, _ = configs(ARCH)
    jp = params(*configs(ARCH))[0]
    eng = JServeEngine(jcfg, jp, slots=1, max_len=32)
    eng.add_request(JRequest(rid=0, prompt=[1, 2, 3], max_new_tokens=2))
    with pytest.raises(KeyError, match="frontend"):
        eng.step()


# ---- batches ------------------------------------------------------------------

def test_batch_shapes_match_reference():
    jcfg, tcfg = configs(ARCH)
    want = {k: (s, np.dtype(d).name)
            for k, (s, d) in jbatch_shapes(jcfg, 3, 40).items()}
    got = {k: (s, str(d).replace("torch.", ""))
           for k, (s, d) in batch_shapes(tcfg, 3, 40).items()}
    assert got == want
    b = make_batch(tcfg, 3, 40, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in b.items()} == \
        {k: (s, d) for k, (s, d) in batch_shapes(tcfg, 3, 40).items()}
    assert b["frontend"].dtype == torch.bfloat16


def test_pipeline_batches_equal_the_references(tmp_path):
    assert_pipelines_agree(str(tmp_path), ARCH)
