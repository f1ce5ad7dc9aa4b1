"""The logical-axes trees, the sharding rules and the single-process parts
of the sharding context against the reference; ``make_specs``,
``make_decode_tokens`` and ``ops.gmm_padded``.

The reference stacks a stack's layers on a leading ``"layers"`` axis (and
a hybrid superblock's layers on ``"sublayer"``); the port keeps them as
lists, so each of its leaves is the reference's tuple without those axes,
found through the bridge's naming (``bridge.leaf_names``, ``_stacks``,
``_sublayers``).  Every leaf's length is its tensor's rank.
"""
import types

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax
import jax.numpy as jnp
import numpy as np

import repro.config as jconf
import repro.data.batches as jbatches
import repro.kernels.ops as jops
import repro.models as jmodels
import repro.optim as joptim
import repro.parallel.context as jctx
import repro.parallel.sharding as jsharding
import repro_torch.config as tconf
import repro_torch.data as tbatches
import repro_torch.models as tmodels
import repro_torch.optim as toptim
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import ops as tops
from repro_torch.optim.adamw import tree_map
from repro_torch.parallel import context as tctx
from repro_torch.parallel import sharding as tsharding
from _torch_dist import port_leaves
from _torch_parity import configs


def _flat(tree, prefix=""):
    """{path: leaf} of a reference tree (nested dicts, tuple leaves)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _get(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _count(tree):
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_count(v) for v in tree)
    return 1


def _assert_matches_reference(cfg, port, ref):
    """Every reference leaf, its stacked axes dropped, at every port leaf
    it stands for; and no other port leaf."""
    seen = 0
    for name, want in _flat(ref).items():
        leaves, n_stack = port_leaves(bridge._stacks(cfg),
                                      bridge._sublayers(cfg), port, name)
        stacked = ("layers", "sublayer")[:n_stack]
        assert tuple(want[:n_stack]) == stacked, name
        for got in leaves:
            assert got == want[n_stack:], name
        seen += len(leaves)
    assert seen == _count(port)


def _assert_ranks(axes, tensors):
    tree_map(lambda ax, t: _check_rank(ax, t), axes, tensors)


def _check_rank(ax, t):
    assert isinstance(ax, tuple) and len(ax) == t.dim(), (ax, t.shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_match_reference(arch):
    jcfg, tcfg = configs(arch)
    axes = tmodels.param_axes(tcfg)
    _assert_matches_reference(tcfg, axes, jmodels.param_axes(jcfg))
    gen = torch.Generator().manual_seed(0)
    _assert_ranks(axes, tmodels.init_params(tcfg, gen, "cpu"))


@pytest.mark.parametrize("shard_seq", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_axes_match_reference(arch, shard_seq):
    jcfg, tcfg = configs(arch)
    axes = tmodels.cache_logical_axes(tcfg, shard_seq=shard_seq)
    assert axes == jmodels.cache_logical_axes(jcfg, shard_seq=shard_seq)
    _assert_ranks(axes, tmodels.init_cache(tcfg, 2, 8, "cpu"))
    assert tmodels.cache_batch_axes(tcfg) == {
        k: ax.index("batch") for k, ax in axes.items()}


def _part(tree, part):
    """An int8 moment's ``"q"`` or ``"s"`` axes, from every leaf."""
    if isinstance(tree, dict) and "q" in tree:
        return tree[part]
    if isinstance(tree, dict):
        return {k: _part(v, part) for k, v in tree.items()}
    return [_part(v, part) for v in tree]


@pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_axes_match_reference(arch, state_dtype):
    jcfg, tcfg = configs(arch)
    jo = jconf.OptimConfig(state_dtype=state_dtype, int8_block=32)
    to = tconf.OptimConfig(state_dtype=state_dtype, int8_block=32)
    axes = toptim.state_axes(tmodels.param_axes(tcfg), to)
    ref = joptim.state_axes(jmodels.param_axes(jcfg), jo)
    assert axes["count"] == ref["count"] == ()
    for key in ("m", "v"):
        if state_dtype == "int8":
            for part in ("q", "s"):
                _assert_matches_reference(tcfg, _part(axes[key], part),
                                          _part(ref[key], part))
        else:
            _assert_matches_reference(tcfg, axes[key], ref[key])
    gen = torch.Generator().manual_seed(0)
    state = toptim.init_state(tmodels.init_params(tcfg, gen, "cpu"), to)
    for key in ("m", "v"):
        _assert_ranks(axes[key], state[key])
    # the stacked layout a checkpoint holds: the reference's axes, leaf
    # for leaf, in rank
    stacked = bridge.state_to_reference(tcfg, {"opt": state})["opt"]
    for key in ("m", "v"):
        flat_ref, flat_t = _flat(ref[key]), _flat(stacked[key])
        assert sorted(flat_ref) == sorted(flat_t)
        for name, ax in flat_ref.items():
            assert len(ax) == flat_t[name].dim(), name


@pytest.mark.parametrize("shard_seq", [False, True])
@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("policy", ["baseline", "fsdp"])
def test_make_rules_match_reference(policy, multi_pod, decode, shard_seq):
    kw = dict(policy=policy, shard_seq=shard_seq)
    got = tsharding.make_rules(tconf.ShardingConfig(**kw),
                               multi_pod=multi_pod, decode=decode)
    want = jsharding.make_rules(jconf.ShardingConfig(**kw),
                                multi_pod=multi_pod, decode=decode)
    assert got == want


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "rwkv6-3b",
                                  "seamless-m4t-medium"])
def test_ctx_spec_matches_reference(arch):
    """``ShardingCtx.spec`` of every param and cache leaf is the
    reference's ``PartitionSpec``, entry for entry."""
    jcfg, tcfg = configs(arch)
    rules = tsharding.make_rules(tconf.ShardingConfig(policy="fsdp"),
                                 multi_pod=True)
    tc = tctx.ShardingCtx(mesh=None, rules=rules)
    jc = jctx.ShardingCtx(mesh=None, rules=rules)
    trees = [jmodels.param_axes(jcfg), jmodels.cache_logical_axes(jcfg)]
    for tree in trees:
        for ax in _flat(tree).values():
            assert tc.spec(ax) == tuple(jc.spec(ax)), ax


def _mesh(**axes):
    """The mesh's names and sizes, all that placements and sanitize read."""
    names, sizes = tuple(axes), tuple(axes.values())
    return types.SimpleNamespace(mesh_dim_names=names,
                                 size=lambda i: sizes[i])


def test_placements_shard_each_named_mesh_dim_major_first():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh(pod=2, data=2, model=2)
    sh = tctx.NamedSharding(mesh, (("pod", "data"), None, "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert tctx.NamedSharding(mesh, (None, "data")).placements == (
        Replicate(), Shard(1), Replicate())
    assert tsharding.replicated(mesh).placements == (Replicate(),) * 3
    for bad in ((("data", "pod"),), ("data", "data"), ("expert",)):
        with pytest.raises(ValueError):
            tctx.NamedSharding(mesh, bad).placements


def test_sanitize_drops_undivided_axes_at_full_width():
    """seamless's vocab of 256,206 and rwkv6-3b's 40 heads on the
    production mesh's 16-way model axis fall back to replication; every
    other dim keeps its axes."""
    mesh = _mesh(data=16, model=16)
    ctx = tsharding.make_ctx(mesh, tconf.ShardingConfig(policy="fsdp"))
    for arch, tree, name, dim in (
            ("seamless-m4t-medium", "params", "embed/embedding", 0),
            ("rwkv6-3b", "cache", "wkv", 2)):
        cfg = get_config(arch)
        if tree == "params":
            axes = tmodels.param_axes(cfg)
            shapes = tmodels.init_params(cfg, torch.Generator(), "meta")
        else:
            axes = tmodels.cache_logical_axes(cfg)
            shapes = tmodels.init_cache(cfg, 16, 64, "meta")
        before = tsharding.tree_shardings(ctx, axes)
        after = tsharding.sanitize_shardings(before, shapes)
        for path, b in _walk(before):
            a = _get_path(after, path)
            shape = _get_path(shapes, path).shape
            for i, axes_i in enumerate(b.spec):
                n = tsharding.axis_size(mesh, axes_i)
                if n > 1 and shape[i] % n:
                    assert a.spec[i] is None, (arch, path, i)
                else:
                    assert a.spec[i] == axes_i, (arch, path, i)
        leaf = _get(after, name)
        assert leaf.spec[dim] is None and _get(before, name).spec[dim] == \
            "model", (arch, name)


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _get_path(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("arch", ["qwen3-8b", "seamless-m4t-medium",
                                  "qwen2-vl-72b"])
def test_make_specs_match_reference(arch):
    jcfg, tcfg = configs(arch)
    got = tbatches.make_specs(tcfg, 3, 64)
    want = jbatches.make_specs(jcfg, 3, 64)
    assert sorted(got) == sorted(want)
    for name, spec in want.items():
        assert got[name].device.type == "meta", name
        assert tuple(got[name].shape) == tuple(spec.shape), name
        assert str(got[name].dtype).split(".")[-1] == \
            jnp.dtype(spec.dtype).name, name


def test_make_decode_tokens_shape_dtype_and_range():
    jcfg, tcfg = configs("qwen3-8b")
    assert tbatches.decode_token_shapes(tcfg, 5)[0] == \
        jbatches.decode_token_shapes(jcfg, 5)[0]
    gen = torch.Generator().manual_seed(3)
    toks = tbatches.make_decode_tokens(tcfg, 5, gen, device="cpu")
    assert toks.shape == (5, 1) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < tcfg.vocab_size
    again = tbatches.make_decode_tokens(
        tcfg, 5, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(toks, again)
    ref = np.asarray(jbatches.make_decode_tokens(jcfg, 5))
    assert ref.shape == tuple(toks.shape) and ref.dtype == np.int32


@pytest.mark.parametrize("block_m", [128, 64])
@pytest.mark.parametrize("tile_ids", [[0, 0, 1, 3], [2, 0, 3, 0], [1, 1, 1, 1]])
def test_gmm_padded_matches_reference(tile_ids, block_m):
    rng = np.random.default_rng(len(tile_ids) + block_m + tile_ids[0])
    M, K, N, G = len(tile_ids) * block_m, 64, 96, 4
    lhs = rng.standard_normal((M, K), dtype=np.float32)
    rhs = rng.standard_normal((G, K, N), dtype=np.float32)
    ids = np.asarray(tile_ids, np.int32)
    want = np.asarray(jops.gmm_padded(jnp.asarray(lhs), jnp.asarray(rhs),
                                      jnp.asarray(ids), block_m=block_m))
    got = tops.gmm_padded(torch.from_numpy(lhs), torch.from_numpy(rhs),
                          torch.from_numpy(ids), block_m=block_m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_gmm_padded_refuses_a_table_that_does_not_fit():
    lhs, rhs = torch.zeros(256, 8), torch.zeros(2, 8, 8)
    with pytest.raises(ValueError):
        tops.gmm_padded(lhs, rhs, torch.tensor([0, 1, 1]))       # 3 tiles
    with pytest.raises(ValueError):
        tops.gmm_padded(lhs, rhs, torch.tensor([0, 2]))          # G = 2
    with pytest.raises(ValueError):
        tops.gmm_padded(torch.zeros(200, 8), rhs, torch.tensor([0, 1]))


@pytest.mark.parametrize("arch", ["qwen3-8b", "seamless-m4t-medium",
                                  "qwen2-vl-72b"])
def test_batch_shardings_match_reference(arch):
    """The batch dim sharded (dim 1 of a VLM's [3, B, S] positions), spec
    for spec with the reference's on a one-device mesh of the same axes."""
    from jax.sharding import Mesh
    jcfg, tcfg = configs(arch)
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                 ("pod", "data", "model"))
    jc = jsharding.make_ctx(jmesh, jconf.ShardingConfig())
    tc = tsharding.make_ctx(_mesh(pod=2, data=2, model=2),
                            tconf.ShardingConfig())
    want = jsharding.batch_shardings(jc, jbatches.make_specs(jcfg, 4, 64))
    got = tsharding.batch_shardings(tc, tbatches.make_specs(tcfg, 4, 64))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].spec == tuple(want[name].spec), name
