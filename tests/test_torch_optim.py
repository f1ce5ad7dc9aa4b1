"""The port's optimizer stack (``repro_torch.optim``) against the JAX
package's functions on the same numpy inputs: the int8 codec, AdamW with
fp32 and int8 moments, the decay mask on the port's per-layer params,
global-norm clipping, error-feedback compression and the schedule.  The
first seven tests mirror ``tests/test_optim.py`` one for one."""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax
import jax.numpy as jnp
import numpy as np
from _propcheck import given, settings, strategies as st

from repro.config.base import OptimConfig as JOptimConfig
from repro.optim import adamw_update as jadamw
from repro.optim import clip_by_global_norm as jclip
from repro.optim import compress_decompress as jcompress
from repro.optim import init_error as jinit_error
from repro.optim import init_state as jinit_state
from repro.optim import lr_at as jlr_at
from repro.optim import q8_decode as jq8_decode
from repro.optim import q8_encode as jq8_encode
from repro_torch.bridge import params_to_numpy
from repro_torch.config import OptimConfig
from repro_torch.optim import (
    adamw_update, clip_by_global_norm, compress_decompress, init_error,
    init_state, lr_at, q8_decode, q8_encode,
)
from repro_torch.optim.adamw import tree_map
from _torch_parity import configs, port_params


def _t(tree):
    """numpy/JAX tree -> the same tree of torch tensors (copies)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _leaf_scale(x):
    return float(np.abs(x).max()) + 1e-30


def _grid_gap(x, scale):
    """Each element's distance from a rounding tie of x / scale."""
    y = np.asarray(x, np.float64) / np.asarray(scale, np.float64)
    return np.abs(np.abs(y - np.floor(y)) - 0.5)


def test_adamw_matches_manual_reference():
    cfg = OptimConfig(lr=0.1, weight_decay=0.0, b1=0.9, b2=0.99, eps=1e-8)
    w = np.array([[1.0, -2.0], [0.5, 3.0]], np.float32)
    g = np.array([[0.1, 0.2], [-0.3, 0.4]], np.float32)
    p, grads = {"w": torch.from_numpy(w.copy())}, {"w": torch.from_numpy(g)}
    state = init_state(p, cfg)
    out, st2 = adamw_update(grads, state, p, torch.tensor(0.1), cfg)
    assert out is p and st2 is state                    # in place
    expect = w - 0.1 * (g / (np.abs(g) + 1e-8))
    np.testing.assert_allclose(p["w"].numpy(), expect, rtol=1e-5)
    jp, _ = jadamw({"w": jnp.asarray(g)}, jinit_state({"w": jnp.asarray(w)},
                                                      _jcfg(cfg)),
                   {"w": jnp.asarray(w)}, jnp.asarray(0.1), _jcfg(cfg))
    np.testing.assert_allclose(p["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6)
    assert int(st2["count"]) == 1


def _jcfg(cfg):
    return JOptimConfig(**{k: getattr(cfg, k)
                           for k in JOptimConfig.__dataclass_fields__})


def test_weight_decay_applies_to_matrices_only():
    cfg = OptimConfig(lr=0.1, weight_decay=0.5)
    p = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
    g = {"w": torch.zeros((2, 2)), "b": torch.zeros((2,))}
    adamw_update(g, init_state(p, cfg), p, torch.tensor(0.1), cfg)
    jp = {"w": jnp.ones((2, 2)), "b": jnp.ones((2,))}
    jg = tree_map(lambda x: jnp.zeros(x.shape), p)
    jnew, _ = jadamw(jg, jinit_state(jp, _jcfg(cfg)), jp, jnp.asarray(0.1),
                     _jcfg(cfg))
    assert float(p["w"][0, 0]) < 1.0                    # decayed
    assert float(p["b"][0]) == 1.0                      # not decayed
    for k in p:
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(jnew[k]))


@given(st.integers(min_value=1, max_value=300),
       st.integers(min_value=8, max_value=128))
@settings(max_examples=12, deadline=None)
def test_q8_codes_match_reference_and_error_bound(n, block):
    """Codes bit for bit away from rounding ties, scales within 1 ulp, and
    the round trip within half a code step, as the reference's test."""
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    x *= 3.0
    q, s = q8_encode(torch.from_numpy(x), block)
    jq, js = jax.jit(jq8_encode, static_argnums=1)(jnp.asarray(x), block)
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)
    nb = s.shape[-1]
    blk_scale = np.repeat(np.asarray(js), block, axis=-1)[:, :n]
    away = _grid_gap(x, np.where(blk_scale == 0, 1, blk_scale)) > 1e-3
    assert away.mean() > 0.9
    np.testing.assert_array_equal(q.numpy()[away], np.asarray(jq)[away])
    out = q8_decode(q, s, block)
    np.testing.assert_allclose(out.numpy()[away],
                               np.asarray(jq8_decode(jq, js, block))[away],
                               rtol=1e-6, atol=0)
    assert out.shape == x.shape and nb == -(-n // block)
    err = np.abs(out.numpy() - x)
    assert np.all(err <= blk_scale * 0.5 + 1e-6)


def _moment_step(state, cfg):
    """A moment leaf as f32 (int8 codes decoded), with its code step."""
    if cfg.state_dtype != "int8":
        return np.asarray(state), 0.0
    q, s = state["q"], state["s"]
    if isinstance(q, torch.Tensor):
        dec = q8_decode(q, s, cfg.int8_block).numpy()
        s = s.numpy()
    else:
        dec = np.asarray(jq8_decode(q, s, cfg.int8_block))
        s = np.asarray(s)
    return dec, np.repeat(s, cfg.int8_block, axis=-1)[..., :dec.shape[-1]]


@pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
def test_int8_adamw_tracks_reference_over_steps(state_dtype):
    """Three steps on the same grads in both packages: fp32 moments agree
    at 1e-6 relative; int8 moments decode within one code step of the
    reference's (a fused multiply-add in XLA can move a code by one) and
    the params within 1e-5 of each leaf's scale."""
    cfg = OptimConfig(lr=1e-2, weight_decay=0.1, state_dtype=state_dtype,
                      int8_block=32)
    rng = np.random.default_rng(0)
    shapes = {"w": (64, 64), "u": (3, 40), "b": (40,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    tp, jp = _t(p0), {k: jnp.asarray(v) for k, v in p0.items()}
    ts, js = init_state(tp, cfg), jinit_state(jp, _jcfg(cfg))
    for i in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        lr = np.float32(1e-2 * (i + 1))
        adamw_update(_t(g), ts, tp, torch.tensor(lr), cfg)
        jp, js = jadamw({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                        jnp.asarray(lr), _jcfg(cfg))
    assert int(ts["count"]) == int(js["count"]) == 3
    for k in shapes:
        want = np.asarray(jp[k])
        if state_dtype == "fp32":
            np.testing.assert_allclose(tp[k].numpy(), want, rtol=1e-6,
                                       atol=1e-7)
        else:
            np.testing.assert_allclose(tp[k].numpy(), want, rtol=0,
                                       atol=1e-5 * _leaf_scale(want))
        for mom in ("m", "v"):
            got, _ = _moment_step(ts[mom][k], cfg)
            ref, step = _moment_step(js[mom][k], cfg)
            if state_dtype == "fp32":
                np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-9)
            else:
                assert np.all(np.abs(got - ref) <= step * 1.0001 + 1e-9), \
                    (k, mom, float(np.abs(got - ref).max()))


def test_decay_mask_follows_reference_stacked_layout():
    """One step with zero grads, lr > 0 and weight decay: every leaf moves
    as the reference's stacked leaf does, including a dense layer's norm
    scale ([L, d] there, [d] here), RWKV's ``u`` and a hybrid Mamba
    layer's ``dt_norm`` ([nb, n_mamba, r] there)."""
    cfg = OptimConfig(lr=0.5, weight_decay=0.5)
    lr = np.float32(0.5)
    checked = {"qwen3-4b": "blocks/ln1", "rwkv6-3b": "blocks/u",
               "jamba-1.5-large-398b": "blocks/mamba/dt_norm"}
    for arch, name in checked.items():
        _, tcfg = configs(arch, dtype="float32")
        jp, tp = port_params(tcfg)
        before = params_to_numpy(tcfg, tp)
        zeros = tree_map(torch.zeros_like, tp)
        adamw_update(zeros, init_state(tp, cfg), tp, torch.tensor(lr), cfg)
        jnew, _ = jax.jit(jadamw, static_argnums=4)(
                         jax.tree.map(jnp.zeros_like, jp),
                         jinit_state(jp, _jcfg(cfg)), jp, jnp.asarray(lr),
                         _jcfg(cfg))
        got = params_to_numpy(tcfg, tp)
        for path, leaf in jax.tree_util.tree_flatten_with_path(jnew)[0]:
            key = "/".join(k.key for k in path)
            g, b = got, before
            for part in key.split("/"):
                g, b = g[part], b[part]
            np.testing.assert_allclose(g, np.asarray(leaf), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{arch} {key}")
            if key == name:
                assert not np.array_equal(g, b), f"{arch} {key} not decayed"


def test_grad_clip_global_norm():
    g = {"a": np.full((10,), 3.0, np.float32),
         "b": np.full((5,), 4.0, np.float32)}
    tg = _t(g)
    clipped, gn = clip_by_global_norm(tg, 1.0)
    assert clipped is tg                                # in place
    jclipped, jgn = jclip({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    total = float(torch.sqrt(sum(x.square().sum()
                                 for x in clipped.values())))
    assert abs(total - 1.0) < 1e-5
    assert float(gn) > 1.0
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-7)
    for k in g:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jclipped[k]),
                                   rtol=1e-7)


def test_error_feedback_preserves_signal():
    """EF compression: accumulated compressed updates converge to the
    accumulated true gradient, and every round's decoded grads and error
    match the reference's."""
    x = (np.random.default_rng(1).standard_normal((256,)) * 1.0
         ).astype(np.float32)
    err, jerr = init_error({"w": torch.zeros(256)}), \
        jinit_error({"w": jnp.zeros(256)})
    acc = np.zeros(256, np.float32)
    for _ in range(50):
        g = {"w": torch.from_numpy(x.copy())}
        deq, err2 = compress_decompress(g, err)
        assert deq is g and err2 is err                 # in place
        jdeq, jerr = jcompress({"w": jnp.asarray(x)}, jerr)
        np.testing.assert_allclose(deq["w"].numpy(), np.asarray(jdeq["w"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(err["w"].numpy(), np.asarray(jerr["w"]),
                                   rtol=1e-6, atol=1e-6)
        acc += deq["w"].numpy()
    rel = np.linalg.norm(acc - x * 50) / np.linalg.norm(x * 50)
    assert rel < 0.01, rel


def test_lr_schedule_shape():
    cfg = OptimConfig(lr=1.0, warmup_steps=10, total_steps=110)
    assert float(lr_at(0, cfg)) == 0.0
    assert abs(float(lr_at(10, cfg)) - 1.0) < 1e-6
    assert float(lr_at(60, cfg)) < 1.0
    assert float(lr_at(110, cfg)) <= 0.2
    for s in (0, 3, 10, 35, 60, 109, 110, 500):
        got = lr_at(torch.tensor(s, dtype=torch.int32), cfg)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jlr_at(s, _jcfg(cfg))),
                                   rtol=1e-6, atol=0)
