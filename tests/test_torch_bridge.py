"""repro_torch.bridge: the JAX package's parameter tree <-> the port's."""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax
import numpy as np

from repro.checkpoint.ckpt import _leaf_paths, _path_str
from repro_torch.bridge import leaf_names, params_from_numpy, params_to_numpy
from _torch_parity import configs, params


def _numpy_tree(jp):
    return jax.tree.map(np.asarray, jp)


def _assert_trees_equal(a, b):
    fa = {_path_str(p): x for p, x in _leaf_paths(a)}
    fb = {_path_str(p): x for p, x in _leaf_paths(b)}
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name].dtype == fb[name].dtype, name
        assert fa[name].shape == fb[name].shape, name
        np.testing.assert_array_equal(fa[name].view(np.uint8),
                                      fb[name].view(np.uint8), err_msg=name)


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen2.5-32b"])
def test_every_jax_leaf_consumed_exactly_once(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg, tcfg)
    names = [_path_str(p) for p, _ in _leaf_paths(jp)]
    assert sorted(names) == sorted(leaf_names(tcfg))
    n_elems = sum(np.asarray(x).size for x in jax.tree.leaves(jp))
    per_layer = [t for blk in tp["blocks"] for t in jax.tree.leaves(blk)]
    top = [tp["final_norm"], *tp["embed"].values()]
    assert sum(t.numel() for t in per_layer + top) == n_elems
    assert len(tp["blocks"]) == tcfg.num_layers


def test_flat_tree_by_checkpoint_names_is_accepted():
    jcfg, tcfg = configs("qwen3-4b")
    jp = params(jcfg, tcfg)[0]
    flat = {_path_str(p): np.asarray(x) for p, x in _leaf_paths(jp)}
    tp = params_from_numpy(tcfg, flat, "cpu")
    np.testing.assert_array_equal(tp["blocks"][1]["attn"]["wq"].numpy(),
                                  flat["blocks/attn/wq"][1])


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_round_trip_is_exact(param_dtype):
    jcfg, tcfg = configs("qwen3-8b", param_dtype=param_dtype)
    jp, tp = params(jcfg, tcfg)
    want = _numpy_tree(jp)
    assert tp["final_norm"].dtype == getattr(torch, param_dtype)
    _assert_trees_equal(params_to_numpy(tcfg, tp), want)
    _assert_trees_equal(
        params_to_numpy(tcfg, params_from_numpy(tcfg, want, "cpu")), want)


def test_mismatched_tree_raises():
    jcfg, tcfg = configs("qwen3-8b")
    tree = _numpy_tree(params(jcfg, tcfg)[0])
    tree["blocks"]["attn"]["extra"] = np.zeros(3)
    with pytest.raises(KeyError, match="extra"):
        params_from_numpy(tcfg, tree, "cpu")
    del tree["blocks"]["attn"]["extra"], tree["embed"]["unembed"]
    with pytest.raises(KeyError, match="unembed"):
        params_from_numpy(tcfg, tree, "cpu")
    with pytest.raises(ValueError, match="num_layers"):
        params_from_numpy(tcfg.replace(num_layers=3, tie_embeddings=True),
                          tree, "cpu")


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "dbrx-132b"])
def test_moe_leaves_round_trip(arch, param_dtype):
    """MoE blocks: ``blocks/moe/*`` stacked [L, ...] in place of
    ``blocks/mlp/*``, each layer a view, the router f32 under bf16."""
    jcfg, tcfg = configs(arch, param_dtype=param_dtype)
    jp, tp = params(jcfg, tcfg)
    want = _numpy_tree(jp)
    names = [_path_str(p) for p, _ in _leaf_paths(jp)]
    assert sorted(names) == sorted(leaf_names(tcfg))
    assert "blocks/moe/router" in names and "blocks/mlp/wo" not in names
    m = tcfg.moe
    assert want["blocks"]["moe"]["wi_up"].shape == \
        (tcfg.num_layers, m.num_experts, tcfg.d_model, m.d_ff_expert)
    moe1 = tp["blocks"][1]["moe"]
    assert moe1["router"].dtype == torch.float32
    assert moe1["wo"].dtype == getattr(torch, param_dtype)
    assert moe1["wi_gate"].is_contiguous()
    np.testing.assert_array_equal(moe1["router"].numpy(),
                                  want["blocks"]["moe"]["router"][1])
    _assert_trees_equal(params_to_numpy(tcfg, tp), want)
