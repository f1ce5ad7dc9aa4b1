"""The port's dry-run tools against the reference's and against hand counts:
the registry's shape cells, the H100 roofline terms, ``op_analysis``'s
FLOPs, bytes and collectives on a 2x2 fake mesh, ``lower_cell`` on tiny
dense and MoE cells over 4- and 8-rank fake meshes (argument bytes a rank
equal to the sum of its sanitized blocks; the dense prefill's FLOPs a
rank within 5% of ``model_flops / n_dev``).

The fake process group (``torch.testing._internal``) is process-global,
so everything that starts one runs in a subprocess.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro import configs as jconfigs
from repro.config import SHAPES as JSHAPES
from repro_torch import configs as tconfigs
from repro_torch.launch import roofline as R

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LIMIT = 120


def _python(code, *args, limit=LIMIT):
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code), *args],
                       capture_output=True, text=True, timeout=limit, env=env)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_cells_match_reference(arch):
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.cells(arch) == jconfigs.cells(arch)
    assert tconfigs.skipped_cells(arch) == jconfigs.skipped_cells(arch)
    for name in JSHAPES:
        t, j = tconfigs.get_shape(name), jconfigs.get_shape(name)
        assert (t.name, t.kind, t.seq_len, t.global_batch) == \
            (j.name, j.kind, j.seq_len, j.global_batch)


def test_roofline_terms_use_h100_datasheet_constants():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 450e9)
    t = R.roofline_terms(2 * 989e12, 3.35e12, 0.5 * 450e9)
    assert t["compute_s"] == pytest.approx(2.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(0.5)
    assert t["dominant"] == "compute"
    assert t["step_lower_bound_s"] == pytest.approx(2.0)
    assert t["roofline_fraction_compute"] == pytest.approx(1.0)
    t = R.roofline_terms(989e12, 3.35e12, 4 * 450e9)
    assert t["dominant"] == "collective"
    assert t["roofline_fraction_compute"] == pytest.approx(0.25)
    assert R.model_flops(10, 3, train=True) == 180.0
    assert R.model_flops(10, 3, train=False) == 60.0


def test_collective_bytes_sums_records_by_kind():
    out = R.collective_bytes([("all-gather", 100), ("all-reduce", 8),
                              ("all-gather", 28), ("all-to-all", 4)])
    assert out["all-gather"] == 128 and out["all-reduce"] == 8
    assert out["all-to-all"] == 4 and out["reduce-scatter"] == 0
    assert out["count"] == 4 and out["total"] == 140
    with pytest.raises(ValueError):
        R.collective_bytes([("send", 1)])


def test_op_analysis_counts_a_hand_count_on_a_2x2_mesh():
    """x [8,16] rows on data, w1 [16,12] columns on model, w2 [12,16] rows
    on model, all f32 on meta: a rank multiplies [4,16]x[16,6] and
    [4,6]x[6,16] (768 FLOPs and 736 bytes each), then all-reduces its
    [4,16] partial sums over model and all-gathers them over data (256
    bytes in each).  DTensor's propagation on global stand-ins counts
    nothing."""
    r = _python("""
        import json, torch, torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=4)
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.launch.op_analysis import OpAnalysis
        from repro_torch.models.layers import matmul
        from repro_torch.parallel.context import to_dtensor
        mesh = make_test_mesh(2, 2, device_type="cpu")
        def d(shape, *pl):
            return to_dtensor(torch.empty(*shape, device="meta"), mesh, pl)
        x = d((8, 16), Shard(0), Replicate())
        w1 = d((16, 12), Replicate(), Shard(1))
        w2 = d((12, 16), Replicate(), Shard(0))
        oa = OpAnalysis()
        args = oa.track([x, w1, w2])
        with oa:
            y = matmul(matmul(x, w1), w2)
            z = y.redistribute(mesh, (Shard(0), Replicate()))
            z = z.redistribute(mesh, (Replicate(), Replicate()))
        out = oa.result()
        out["args"] = args
        out["records"] = oa.collectives
        out["placements"] = [str(p) for p in y.placements]
        print(json.dumps(out))
    """)
    assert r["flops"] == 2 * (2 * 4 * 16 * 6)
    assert r["ops"]["mm"] == {"count": 2, "flops": 1536, "bytes": 2 * 736}
    assert r["records"] == [["all-reduce", 256], ["all-gather", 256]]
    assert r["collective_total"] == 512 and r["collective_count"] == 2
    assert r["traffic_bytes"] == 2 * 736 + 512
    assert r["args"] == 4 * (4 * 16 + 16 * 6 + 6 * 16)
    assert r["peak_bytes"] >= r["args"] + 4 * (4 * 6 + 4 * 16 + 8 * 16)
    assert r["placements"][1].startswith("P")


CELLS = [("qwen3-8b", "train_4k"), ("qwen3-8b", "prefill"),
         ("qwen3-8b", "decode_32k"), ("qwen3-moe-30b-a3b", "train_4k")]
MESHES = [(2, 2), (2, 2, 2)]
# the dense prefill: a short prompt (seq 16, batch 8) on wider layers, where
# the products dominate (at 32k tokens a tiny model's FLOPs are attention's)
# and model_flops' count of the embedding and of the unembedding at every
# position (the prefill unembeds the last only) stays ~3% of the total
WIDE = dict(d_model=256, num_heads=4, head_dim=64, d_ff=4096)
SHORT = (16, 8)


@pytest.fixture(scope="module")
def lowered():
    """Every tiny cell on both meshes, in one subprocess; beside each
    artifact, the bytes of a rank's blocks of the arguments summed from
    the sanitized shardings' specs and the leaves' shapes."""
    return _python("""
        import json, sys
        from repro_torch.config import ShapeConfig
        from repro_torch.configs import get_tiny_config
        from repro_torch.launch import dryrun

        cells, meshes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
        wide, short = json.loads(sys.argv[3]), json.loads(sys.argv[4])
        out = {}
        for arch, shape in cells:
            tiny = get_tiny_config(arch)
            name, cell_shape = shape, None
            if shape == "prefill":
                tiny = tiny.replace(**wide)
                name = "prefill_32k"
                cell_shape = ShapeConfig(name, "prefill", *short)
            for ms in meshes:
                art = dryrun.lower_cell(arch, name, "single", model=tiny,
                                        mesh_shape=ms, shape=cell_shape)
                art.pop("op_analysis")
                out[f"{arch}/{shape}/{len(ms)}"] = art
        print(json.dumps(out))
    """, json.dumps(CELLS), json.dumps(MESHES), json.dumps(WIDE),
        json.dumps(SHORT), limit=240)


class _Mesh:
    """The sizes and axis names a mesh answers, with no process group."""

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.mesh_dim_names = (("pod",) if len(shape) == 3 else ()) + (
            "data", "model")

    def size(self, i):
        return self.shape[i]


def _expected_argument_bytes(arch, shape, ms):
    """A rank's blocks of the cell's arguments: each leaf's numel over the
    shards of its sanitized spec, times its element size (no DTensor)."""
    from repro_torch.config import ShapeConfig
    from repro_torch.config.base import DECODE, TRAIN
    from repro_torch.configs import get_tiny_config
    from repro_torch.data.batches import make_specs
    from repro_torch.launch import dryrun
    from repro_torch.models import (
        cache_logical_axes, init_cache, init_params, param_axes,
    )
    from repro_torch.optim import state_axes
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel.context import ShardingCtx, axis_size
    from repro_torch.parallel.sharding import (
        batch_shardings, make_rules, sanitize_shardings, tree_shardings,
    )
    from repro_torch.train.step import make_opt_state

    tiny, name, cell = get_tiny_config(arch), shape, None
    if shape == "prefill":
        tiny, name = tiny.replace(**WIDE), "prefill_32k"
        cell = ShapeConfig("prefill_32k", "prefill", *SHORT)
    run = dryrun._cell_run_config(arch, name, policy="auto", micro=1,
                                  model=tiny, shape=cell)
    cfg, shp = run.model, run.shape
    mesh = _Mesh(ms)
    ctx = ShardingCtx(mesh, make_rules(run.sharding, multi_pod=len(ms) == 3,
                                       decode=shp.kind == DECODE))

    def nbytes(tree, shardings):
        total = 0
        for t, sh in zip(tree_leaves(tree),
                         tree_leaves(sanitize_shardings(shardings, tree))):
            n = t.numel()
            for axes in sh.spec:
                n //= axis_size(mesh, axes)
            total += n * t.element_size()
        return total

    params = init_params(cfg, torch.Generator(), "meta")
    p_axes = param_axes(cfg)
    total = nbytes(params, tree_shardings(ctx, p_axes))
    if shp.kind == TRAIN:
        total += nbytes(make_opt_state(run, params),
                        tree_shardings(ctx, state_axes(p_axes, run.optim)))
    if shp.kind == DECODE:
        cache = init_cache(cfg, shp.global_batch, shp.seq_len, "meta")
        total += nbytes(cache, tree_shardings(ctx, cache_logical_axes(cfg)))
        tok = {"t": torch.empty(shp.global_batch, 1, dtype=torch.int32,
                                device="meta")}
        total += nbytes(tok, {"t": ctx.sharding(("batch", None))})
    else:
        batch = make_specs(cfg, shp.global_batch, shp.seq_len)
        if shp.kind != TRAIN:
            batch.pop("targets")
        total += nbytes(batch, batch_shardings(ctx, batch))
    return total


@pytest.mark.parametrize("ms", MESHES, ids=["2x2", "2x2x2"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_lower_cell_argument_bytes_are_the_sanitized_blocks(lowered, arch,
                                                            shape, ms):
    art = lowered[f"{arch}/{shape}/{len(ms)}"]
    n = 1
    for k in ms:
        n *= k
    assert art["devices"] == n and art["mesh_shape"] == list(ms)
    want = _expected_argument_bytes(arch, shape, ms)
    assert art["memory"]["argument_bytes"] == want
    assert art["memory"]["peak_bytes"] >= want
    assert art["flops_per_device"] > 0
    assert art["roofline"]["dominant"] in ("compute", "memory", "collective")
    if shape == "train_4k":
        assert art["collective_bytes_per_device"] > 0


@pytest.mark.parametrize("ms", MESHES, ids=["2x2", "2x2x2"])
def test_dense_prefill_flops_a_rank_match_model_flops(lowered, ms):
    art = lowered[f"qwen3-8b/prefill/{len(ms)}"]
    assert art["useful_flops_ratio"] == pytest.approx(1.0, abs=0.05)
    assert art["model_flops_per_device"] == pytest.approx(
        art["model_flops_total"] / art["devices"])
