"""The dry-run's RWKV6 and hybrid cells on tiny configs over 4- and 8-rank
fake meshes: ``dryrun.lower_cell`` traces rwkv6-3b's and
jamba-1.5-large-398b's four cells each (train_4k and prefill_32k cut to
16 rows of 8 tokens, decode_32k and long_500k at their own sizes), 16
cells in all, with a rank's argument bytes equal to the sum of its
sanitized blocks (long_500k's cache with its rows split over data, the
``shard_seq`` decode rules).  The hybrid's Mamba layers trade in_proj's
column blocks by one all-to-all a layer: in a prefill cell a rank's
all-to-all bytes are its block of xz [B, S, 2·di] a Mamba layer, and in
a train cell (no remat in the tiny configs) the batch's block, for the
microbatch split, and twice xz's blocks (each layer's xz out, its grad
back).
A long_500k hybrid cell merges its row blocks by all-reduces.  The fake
process group is process-global, so the cells run in a subprocess.
"""
import json

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from test_torch_dryrun import MESHES, _Mesh, _python

ARCHS = ("rwkv6-3b", "jamba-1.5-large-398b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SHORT = {"train_4k": (8, 16), "prefill_32k": (8, 16)}   # (seq, batch)


@pytest.fixture(scope="module")
def lowered():
    return _python("""
        import json, sys
        from repro_torch.config import ShapeConfig
        from repro_torch.configs import get_shape, get_tiny_config
        from repro_torch.launch import dryrun

        short = json.loads(sys.argv[3])
        out = {}
        for arch in json.loads(sys.argv[1]):
            for shape in json.loads(sys.argv[4]):
                cell = None
                if shape in short:
                    cell = ShapeConfig(shape, get_shape(shape).kind,
                                       *short[shape])
                for ms in json.loads(sys.argv[2]):
                    art = dryrun.lower_cell(arch, shape, "single",
                                            model=get_tiny_config(arch),
                                            mesh_shape=ms, shape=cell)
                    oa = art.pop("op_analysis")
                    art["coll"] = {k: oa[k] for k in oa
                                   if k.startswith("coll_")}
                    out[f"{arch}/{shape}/{len(ms)}"] = art
        print(json.dumps(out))
    """, json.dumps(ARCHS), json.dumps(MESHES), json.dumps(SHORT),
        json.dumps(SHAPES), limit=240)


def _cell(arch, shape):
    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_shape, get_tiny_config
    from repro_torch.launch import dryrun
    cell = None
    if shape in SHORT:
        cell = ShapeConfig(shape, get_shape(shape).kind, *SHORT[shape])
    return dryrun._cell_run_config(arch, shape, policy="auto", micro=1,
                                   model=get_tiny_config(arch), shape=cell)


def _ctx(run, ms):
    from repro_torch.config.base import DECODE
    from repro_torch.parallel.context import ShardingCtx
    from repro_torch.parallel.sharding import make_rules
    return ShardingCtx(_Mesh(ms), make_rules(
        run.sharding, multi_pod=len(ms) == 3,
        decode=run.shape.kind == DECODE))


def _nbytes(mesh, tree, shardings):
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel.context import axis_size
    from repro_torch.parallel.sharding import sanitize_shardings
    total = 0
    for t, sh in zip(tree_leaves(tree),
                     tree_leaves(sanitize_shardings(shardings, tree))):
        n = t.numel()
        for axes in sh.spec:
            n //= axis_size(mesh, axes)
        total += n * t.element_size()
    return total


def _expected_argument_bytes(arch, shape, ms):
    """A rank's blocks of the cell's arguments: each leaf's numel over the
    shards of its sanitized spec, times its element size (no DTensor);
    the cache laid out with ``shard_seq`` where the cell sets it."""
    from repro_torch.config.base import DECODE, TRAIN
    from repro_torch.data.batches import make_specs
    from repro_torch.models import (
        cache_logical_axes, init_cache, init_params, param_axes,
    )
    from repro_torch.optim import state_axes
    from repro_torch.parallel.sharding import batch_shardings, tree_shardings
    from repro_torch.train.step import make_opt_state

    run = _cell(arch, shape)
    cfg, shp, ctx = run.model, run.shape, _ctx(run, ms)
    mesh = ctx.mesh
    params = init_params(cfg, torch.Generator(), "meta")
    p_axes = param_axes(cfg)
    total = _nbytes(mesh, params, tree_shardings(ctx, p_axes))
    if shp.kind == TRAIN:
        total += _nbytes(mesh, make_opt_state(run, params),
                         tree_shardings(ctx, state_axes(p_axes, run.optim)))
    if shp.kind == DECODE:
        cache = init_cache(cfg, shp.global_batch, shp.seq_len, "meta")
        axes = cache_logical_axes(cfg, shard_seq=run.sharding.shard_seq)
        total += _nbytes(mesh, cache, tree_shardings(ctx, axes))
        tok = {"t": torch.empty(shp.global_batch, 1, dtype=torch.int32,
                                device="meta")}
        total += _nbytes(mesh, tok, {"t": ctx.sharding(("batch", None))})
    else:
        batch = make_specs(cfg, shp.global_batch, shp.seq_len)
        if shp.kind != TRAIN:
            batch.pop("targets")
        total += _nbytes(mesh, batch, batch_shardings(ctx, batch))
    return total


def _batch_block_bytes(arch, shape, ms):
    """A rank's block of the cell's batch (``make_specs`` laid out by
    ``batch_shardings``): what the train step's microbatch split moves."""
    from repro_torch.data.batches import make_specs
    from repro_torch.parallel.sharding import batch_shardings
    run = _cell(arch, shape)
    ctx = _ctx(run, ms)
    batch = make_specs(run.model, run.shape.global_batch, run.shape.seq_len)
    return _nbytes(ctx.mesh, batch, batch_shardings(ctx, batch))


def _xz_block_bytes(arch, shape, ms):
    """A rank's blocks of xz [B, S, 2·di] in the cell's dtype, over the
    Mamba layers: B over the batch axes, the columns over ``model``."""
    from repro_torch.models.hybrid import n_mamba
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.mamba import _dims
    from repro_torch.parallel.context import axis_size
    run = _cell(arch, shape)
    cfg, shp, ctx = run.model, run.shape, _ctx(run, ms)
    di = _dims(cfg)[0]
    rows = shp.global_batch // axis_size(ctx.mesh, ctx.rules["batch"])
    cols = 2 * di // axis_size(ctx.mesh, ctx.rules["inner"])
    elt = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    layers = n_mamba(cfg) * (cfg.num_layers // cfg.hybrid_period)
    return layers * rows * shp.seq_len * cols * elt


@pytest.mark.parametrize("ms", MESHES, ids=["2x2", "2x2x2"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_rwkv6_and_hybrid_cells_lower_with_sanitized_argument_bytes(
        lowered, arch, shape, ms):
    art = lowered[f"{arch}/{shape}/{len(ms)}"]
    n = 1
    for k in ms:
        n *= k
    assert art["devices"] == n and art["mesh_shape"] == list(ms)
    want = _expected_argument_bytes(arch, shape, ms)
    assert art["memory"]["argument_bytes"] == want
    assert art["memory"]["peak_bytes"] >= want
    assert art["flops_per_device"] > 0
    a2a = art["coll"]["coll_all-to-all"]
    hybrid = arch.startswith("jamba")
    if shape == "train_4k":
        assert art["microbatches"] == 4
        assert art["coll"]["coll_reduce-scatter"] > 0      # fsdp grads
    if hybrid and shape == "prefill_32k":
        assert a2a == _xz_block_bytes(arch, shape, ms)
    elif hybrid and shape == "train_4k":
        # the microbatch split, then each layer's xz out and its grad back
        assert a2a == _batch_block_bytes(arch, shape, ms) + \
            2 * _xz_block_bytes(arch, shape, ms)
    elif not hybrid and shape != "train_4k":
        assert a2a == 0
    if hybrid and shape == "long_500k":
        assert art["coll"]["coll_all-reduce"] > 0
