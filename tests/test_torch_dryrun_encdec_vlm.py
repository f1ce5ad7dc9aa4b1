"""The dry-run's enc-dec and VLM cells on tiny configs over 4- and 8-rank
fake meshes: ``dryrun.lower_cell`` traces seamless-m4t-medium's train and
decode cells and qwen2-vl-72b's train and prefill cells, with a rank's
argument bytes equal to the sum of its sanitized blocks (the enc-dec
``frontend`` and the decode cache's ``xk``/``xv``, the VLM's patches and
[3, B, S] positions among them), and a train cell's all-to-all bytes
equal to a rank's block of the batch: the 4-microbatch step moves the
batch once to take the reference's global microbatches.  The fake process
group is process-global, so the cells run in a subprocess.
"""
import json

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from test_torch_dryrun import (
    MESHES, _Mesh, _expected_argument_bytes, _python,
)

CELLS = [("seamless-m4t-medium", "train_4k"),
         ("seamless-m4t-medium", "decode_32k"),
         ("qwen2-vl-72b", "train_4k"), ("qwen2-vl-72b", "prefill_32k")]


@pytest.fixture(scope="module")
def lowered():
    return _python("""
        import json, sys
        from repro_torch.configs import get_tiny_config
        from repro_torch.launch import dryrun

        out = {}
        for arch, shape in json.loads(sys.argv[1]):
            for ms in json.loads(sys.argv[2]):
                art = dryrun.lower_cell(arch, shape, "single",
                                        model=get_tiny_config(arch),
                                        mesh_shape=ms)
                art["all_to_all"] = art.pop("op_analysis")["coll_all-to-all"]
                out[f"{arch}/{shape}/{len(ms)}"] = art
        print(json.dumps(out))
    """, json.dumps(CELLS), json.dumps(MESHES), limit=180)


def _batch_block_bytes(arch, shape, ms):
    """A rank's block of the cell's batch (``make_specs`` laid out by
    ``batch_shardings``)."""
    from repro_torch.configs import get_shape, get_tiny_config
    from repro_torch.data.batches import make_specs
    from repro_torch.launch import dryrun
    from repro_torch.parallel.context import ShardingCtx, axis_size, fit
    from repro_torch.parallel.sharding import batch_shardings, make_rules
    run = dryrun._cell_run_config(arch, shape, policy="auto", micro=4,
                                  model=get_tiny_config(arch))
    mesh = _Mesh(ms)
    ctx = ShardingCtx(mesh, make_rules(run.sharding,
                                       multi_pod=len(ms) == 3))
    shp = get_shape(shape)
    batch = make_specs(run.model, shp.global_batch, shp.seq_len)
    total = 0
    for name, sh in batch_shardings(ctx, batch).items():
        t = batch[name]
        n = t.numel()
        for axes in fit(sh, tuple(t.shape)).spec:
            n //= axis_size(mesh, axes)
        total += n * t.element_size()
    return total


@pytest.mark.parametrize("ms", MESHES, ids=["2x2", "2x2x2"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_encdec_and_vlm_cells_lower_with_sanitized_argument_bytes(
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
    if shape == "train_4k":
        assert art["microbatches"] == 4
        assert art["all_to_all"] == _batch_block_bytes(arch, shape, ms)
    else:
        assert art["all_to_all"] == 0
