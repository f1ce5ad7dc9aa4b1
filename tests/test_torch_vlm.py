"""The port's VLM family (``qwen2-vl-72b``, tiny: 2 layers, d = 64, head
dim 16, M-RoPE sections (4, 2, 2)) against the JAX package on the CPU.

``apply_mrope`` on random [3, B, S] positions (f32 at 1e-6, bf16 at the
reference's 1e-2); then, with the same JAX-made parameters and numpy
batches (frontend patches prepended to the text, [3, B, S] positions),
in f32 at 1e-4: ``forward`` and ``loss_fn`` (the text tail scored),
``prefill`` (its index counting the patches) and three ``decode_step``s,
grads against ``jax.grad``, one train step; the VLM batches, bridge and
launcher; and the engine's refusal beside the reference's NaN logits.
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
from repro.data.batches import vlm_patch_count as jvlm_patch_count
from repro.models import decode_step as jdecode
from repro.models import forward as jforward
from repro.models import layers as JL
from repro.models import loss_fn as jloss_fn
from repro.models import prefill as jprefill
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train.step import make_opt_state as jmake_opt_state
from repro.train.step import make_train_step as jmake_train_step
from repro_torch import config as tbase
from repro_torch.bridge import leaf_names, params_from_numpy, params_to_numpy
from repro_torch.data import batch_shapes, make_batch, vlm_patch_count
from repro_torch.launch import serve as tserve
from repro_torch.models import decode_step, forward, loss_fn, prefill
from repro_torch.models import layers as TL
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.serve import ServeEngine
from repro_torch.train import make_opt_state, make_train_step
from _torch_parity import (
    assert_pipelines_agree, batches, configs, f32, params, port_params,
)

ARCH = "qwen2-vl-72b"
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 16          # 4 frontend patches + 12 text tokens
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _with_targets(cfg, jb, tb, seed=1):
    """The same next-token targets for the text in both batches, a few
    masked (-1)."""
    tg = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, tb["tokens"].shape).astype(np.int32)
    tg[:, ::5] = -1
    return (dict(jb, targets=jnp.asarray(tg)),
            dict(tb, targets=torch.from_numpy(tg).long()))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


# ---- M-RoPE ------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 1e-2)])
def test_apply_mrope_matches_jax(dtype, tol):
    """Random [3, B, S] positions (t, h and w apart) at the full config's
    head dim and sections, and at the tiny config's."""
    rng = np.random.default_rng(0)
    for D, sections, theta in ((128, (16, 24, 24), 1e6),
                               (16, (4, 2, 2), 1e6)):
        x = rng.standard_normal((2, 9, 4, D)).astype(np.float32)
        pos = rng.integers(0, 2048, (3, 2, 9)).astype(np.int32)
        jx = jnp.asarray(x).astype(dtype)
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        got = TL.apply_mrope(tx, torch.from_numpy(pos), theta, sections)
        want = JL.apply_mrope(jx, jnp.asarray(pos), theta, sections)
        assert got.dtype == tx.dtype
        np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def test_apply_mrope_equals_rope_when_sections_agree():
    """With t = h = w the sections rotate as plain RoPE does."""
    x = torch.randn(2, 9, 4, 16, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(9).expand(2, 9)
    torch.testing.assert_close(
        TL.apply_mrope(x, pos.expand(3, 2, 9), 1e6, (4, 2, 2)),
        TL.apply_rope(x, pos, 1e6), rtol=0, atol=0)


def test_apply_mrope_refuses_positions_without_sections():
    """[1, S] or [B, S] positions raise; the reference fills NaN there."""
    x = torch.randn(1, 5, 4, 16)
    for pos in (torch.arange(5)[None], torch.zeros(3, 5, dtype=torch.long)):
        with pytest.raises(ValueError, match=r"positions \[3, \.\.\., S\]"):
            TL.apply_mrope(x, pos, 1e6, (4, 2, 2))
    with pytest.raises(ValueError, match="sum"):
        TL.apply_mrope(x, torch.zeros(3, 1, 5), 1e6, (4, 2, 1))
    want = JL.apply_mrope(jnp.asarray(x.numpy()), jnp.arange(5)[None], 1e6,
                          (4, 2, 2))
    assert bool(jnp.isnan(want).any())


def test_vlm_mrope_positions_change_output():
    """The reference's ``test_vlm_mrope_positions_change_output`` on the
    port: scaling the h and w position ids changes the logits."""
    _, cfg = configs(ARCH)
    _, p = params(*configs(ARCH))
    _, batch = batches(cfg, B, S)
    lo1, _ = forward(cfg, p, batch)
    b2 = dict(batch, positions=batch["positions"]
              * torch.tensor([1, 2, 3])[:, None, None])
    lo2, _ = forward(cfg, p, b2)
    assert float((lo1.float() - lo2.float()).abs().max()) > 1e-6


# ---- forward / loss / prefill / decode ---------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_and_loss_match_jax(impl):
    jcfg, tcfg = configs(ARCH, dtype="float32", attention_impl=impl)
    jp, tp = params(jcfg, tcfg)
    jb, tb = _with_targets(tcfg, *batches(tcfg, B, S))
    npat = vlm_patch_count(S)
    assert tb["frontend"].shape == (B, npat, tcfg.frontend_embed_dim)
    assert tb["positions"].shape == (3, B, S)
    jl, _ = jax.jit(lambda p, b: jforward(jcfg, p, b))(jp, jb)
    tl, _ = forward(tcfg, tp, tb)
    assert tl.shape == (B, S, tcfg.vocab_size)
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    _, jm = jax.jit(lambda p, b: jloss_fn(jcfg, p, b))(jp, jb)
    _, tm = loss_fn(tcfg, tp, tb)
    for k in ("loss", "ce", "z", "tokens"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_and_decode_match_jax(impl):
    """The index reads patches + text; the decode steps take [3, B, 1]
    positions at the index; every cache entry each time."""
    jcfg, tcfg = configs(ARCH, dtype="float32", attention_impl=impl)
    jp, tp = params(jcfg, tcfg, seed=1)
    jb, tb = batches(tcfg, B, 20, seed=1)
    jl, jc = jax.jit(lambda p, b: jprefill(jcfg, p, b, max_len=32))(jp, jb)
    tl, tc = prefill(tcfg, tp, tb, max_len=32)
    np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
    np.testing.assert_array_equal(tc["index"].numpy(), [20, 20])

    def same_cache():
        assert sorted(tc) == sorted(jc)
        for name in ("k", "v"):
            np.testing.assert_allclose(f32(tc[name]), f32(jc[name]), **TOL,
                                       err_msg=name)
        np.testing.assert_array_equal(tc["index"].numpy(),
                                      np.asarray(jc["index"]))

    same_cache()
    jstep = jax.jit(lambda p, t, c: jdecode(jcfg, p, t, c))
    toks = np.array([[3], [7]], np.int32)
    for _ in range(3):
        jl, jc = jstep(jp, jnp.asarray(toks), jc)
        tl, tc = decode_step(tcfg, tp, torch.from_numpy(toks).long(), tc)
        np.testing.assert_allclose(f32(tl), f32(jl), **TOL)
        toks = np.array(jnp.argmax(jl[:, 0], -1), np.int32)[:, None]
    same_cache()


def test_decode_matches_forward():
    """prefill(S-1 positions) + decode(last) == forward(S)[-1], the
    reference's ``test_decode_matches_forward`` on the port (bf16)."""
    _, cfg = configs(ARCH)
    _, p = params(*configs(ARCH))
    _, batch = batches(cfg, B, S)
    logits, _ = forward(cfg, p, batch)
    prefix = dict(batch, tokens=batch["tokens"][:, :-1],
                  positions=batch["positions"][:, :, :-1])
    _, cache = prefill(cfg, p, prefix, max_len=S + 8)
    dec, cache2 = decode_step(cfg, p, batch["tokens"][:, -1:], cache)
    err = float((dec[:, 0].float() - logits[:, -1].float()).abs().max())
    assert err < 1e-2, err
    assert int(cache2["index"][0]) == S


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


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_loss_grads_match_jax_grad(remat):
    """Every leaf's grad (``frontend_proj`` too) within 1e-4 of its
    largest reference value."""
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
    """One step from the same params and batch (frontend split on axis 0,
    positions [3, B, S] on axis 1): metrics at 1e-5, params unmoved
    (lr_at(0) = 0), fp32 moments within 1e-4 of each leaf's scale."""
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


# ---- batches, bridge, launcher, engine ----------------------------------------

@pytest.mark.parametrize("seq", [8, 16, 100, 2048, 8192])
def test_batch_shapes_and_patch_count_match_reference(seq):
    jcfg, tcfg = configs(ARCH)
    assert vlm_patch_count(seq) == jvlm_patch_count(seq)
    want = {k: (s, np.dtype(d).name)
            for k, (s, d) in jbatch_shapes(jcfg, 2, seq).items()}
    got = {k: (s, str(d).replace("torch.", ""))
           for k, (s, d) in batch_shapes(tcfg, 2, seq).items()}
    assert got == want


def test_make_batch_has_the_shapes_and_mrope_positions():
    _, tcfg = configs(ARCH)
    b = make_batch(tcfg, 2, 40, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in b.items()} == \
        dict(batch_shapes(tcfg, 2, 40))
    assert torch.equal(b["positions"],
                       torch.arange(40, dtype=torch.int32).expand(3, 2, 40))
    loss, _ = loss_fn(tcfg, params(*configs(ARCH))[1], b)
    assert bool(torch.isfinite(loss))


def test_pipeline_batches_equal_the_references(tmp_path):
    assert_pipelines_agree(str(tmp_path), ARCH)


def test_every_jax_leaf_consumed_exactly_once():
    from repro.checkpoint.ckpt import _leaf_paths, _path_str
    jcfg, tcfg = configs(ARCH)
    jp, tp = params(jcfg, tcfg)
    names = [_path_str(p) for p, _ in _leaf_paths(jp)]
    assert sorted(names) == sorted(leaf_names(tcfg))
    assert "embed/frontend_proj" in names
    n_elems = sum(np.asarray(x).size for x in jax.tree.leaves(jp))
    assert sum(t.numel() for t in tree_leaves(tp)) == n_elems


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_exact(param_dtype):
    jcfg, tcfg = configs(ARCH, param_dtype=param_dtype)
    jp, tp = params(jcfg, tcfg)
    want = _flat_raw(jax.tree.map(np.asarray, jp))
    for got in (params_to_numpy(tcfg, tp), params_to_numpy(
            tcfg, params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                                    "cpu"))):
        got = _flat_raw(got)
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name].view(np.uint8),
                                          want[name].view(np.uint8),
                                          err_msg=name)


def _flat_raw(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_raw(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_train_launcher_trains_crashes_and_restores(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--tiny",
         "--device", "cpu", "--arch", ARCH, "--steps", "8", "--ckpt-every",
         "3", "--inject-crash-at", "5", "--workdir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "family=vlm device=cpu" in out.stdout
    m = re.search(r"restarts=(\d+) loss ([-\d.na]+) -> ([-\d.na]+)",
                  out.stdout)
    assert m and m.group(1) == "1", out.stdout
    assert np.isfinite(float(m.group(2))) and np.isfinite(float(m.group(3)))


def test_engine_and_serve_launcher_refuse_vlm(monkeypatch):
    _, tcfg = configs(ARCH)
    with pytest.raises(NotImplementedError, match="M-RoPE"):
        ServeEngine(tcfg, None, device="cpu")
    monkeypatch.setattr(sys, "argv", ["serve", "--tiny", "--arch", ARCH,
                                      "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="NaN"):
        tserve.main()


def test_reference_caveat_engine_emits_nan_logits_for_vlm():
    """Recorded, not a port fault: the reference's engine prefills with
    [1, S] positions, which M-RoPE's gather fills with NaN, so the
    admission logits are NaN and its argmax token 0 (ROADMAP Queue 3)."""
    jcfg, _ = configs(ARCH)
    jp = params(*configs(ARCH))[0]
    eng = JServeEngine(jcfg, jp, slots=1, max_len=32)
    seen = []
    real = eng._sample
    eng._sample = lambda logits, t: (seen.append(np.asarray(logits)),
                                     real(logits, t))[1]
    eng.add_request(JRequest(rid=0, prompt=[5, 6, 7, 8], max_new_tokens=3))
    eng.run_until_done(max_ticks=8)
    assert np.isnan(seen[0]).all()
    assert eng.requests[0].output == [0, 0, 0]
