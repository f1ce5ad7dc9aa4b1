"""The dry-run's trace of the Mamba scan on ``meta`` (``models/mamba.py``
``_MetaChunk``) against the eager token loop it stands in for: tiny jamba
cells on a 2x2 fake mesh, traced once through ``_MetaChunk`` and once
with the loop stepped token by token (``_chunk`` replaced by
``_eager_chunk``), with ``CHUNK`` cut to 36 so that a train cell's 80
tokens run as chunks of 36, 36 and 8 (the first two extrapolated from
probes, the last probed as it is) and a prefill's as one run of 80.  A
rank's FLOPs, bytes, every collective and every op's count and bytes
are equal; the peak of live bytes within 1%.  The train cell runs with
remat "none" (the chunk's checkpoint alone) and "full" (nested in a
layer's); the fake process group is process-global, so the cells run in
a subprocess, and the first cell, traced again in the same process,
counts the same (DTensor's sharding propagation through an op's
decomposition, which runs once a process, is not counted).

Also ``op_analysis.extrapolate`` on a record that is no polynomial, and
the scan on CPU tensors, which never takes the ``meta`` path."""
import json

import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from test_torch_dryrun import _python

CASES = [("train_4k", "none"), ("train_4k", "full"), ("prefill_32k", "none")]


@pytest.fixture(scope="module")
def traced():
    return _python("""
        import json, sys
        from repro_torch.config import ShapeConfig
        from repro_torch.configs import get_shape, get_tiny_config
        from repro_torch.launch import dryrun
        from repro_torch.models import mamba

        mamba.CHUNK = 36
        meta_chunk = mamba._chunk
        arch = "jamba-1.5-large-398b"
        out = {}
        cases = json.loads(sys.argv[1])
        for i, (shape, remat) in enumerate(cases + cases[:1]):
            cfg = get_tiny_config(arch).replace(remat=remat)
            cell = ShapeConfig(shape, get_shape(shape).kind, 80, 8)
            ways = (("meta", meta_chunk), ("eager", mamba._eager_chunk))
            for way, chunk in ways if i < len(cases) else \
                    (("again", meta_chunk),):
                mamba._chunk = chunk
                art = dryrun.lower_cell(arch, shape, "single", model=cfg,
                                        mesh_shape=(2, 2), shape=cell,
                                        micro=1)
                oa = art["op_analysis"]
                out[f"{shape}/{remat}/{way}"] = dict(
                    flops=art["flops_per_device"],
                    bytes=art["bytes_per_device"],
                    peak=art["memory"]["peak_bytes"],
                    coll={k: v for k, v in oa.items()
                          if k.startswith("coll")},
                    ops=oa["ops"])
        print(json.dumps(out))
    """, json.dumps(CASES), limit=300)


@pytest.mark.parametrize("shape,remat", CASES)
def test_meta_scan_counts_what_the_token_loop_dispatches(traced, shape,
                                                         remat):
    got = traced[f"{shape}/{remat}/meta"]
    want = traced[f"{shape}/{remat}/eager"]
    assert want["flops"] > 0 and want["bytes"] > 0
    assert got["flops"] == want["flops"]
    assert got["bytes"] == want["bytes"]
    assert got["coll"] == want["coll"]
    assert want["coll"]["coll_all-to-all"] > 0          # in_proj's trade
    assert got["ops"] == want["ops"]
    assert abs(got["peak"] - want["peak"]) <= 0.01 * want["peak"], \
        (got["peak"], want["peak"])


def test_a_cell_traced_twice_in_one_process_counts_the_same(traced):
    shape, remat = CASES[0]
    got = traced[f"{shape}/{remat}/again"]
    want = traced[f"{shape}/{remat}/meta"]
    assert got == want


def test_extrapolate_refuses_a_record_that_is_no_polynomial():
    from repro_torch.launch.op_analysis import extrapolate

    def probe(k, cubic=False):
        n = k ** 3 if cubic else 3 * k * k + 2 * k + 7
        return {"ops": {"mul": {"count": k, "flops": 0, "bytes": n}},
                "flops": 2 * k, "traffic": n, "collectives": [],
                "peak": 10 * k}

    rec = extrapolate(probe, 256)
    assert rec["traffic"] == rec["ops"]["mul"]["bytes"] == \
        3 * 256 * 256 + 2 * 256 + 7
    assert rec["ops"]["mul"]["count"] == 256 and rec["flops"] == 512
    assert rec["peak"] == 2560
    assert extrapolate(probe, 7) == probe(7)         # short: probed as is
    with pytest.raises(ValueError, match="polynomial"):
        extrapolate(lambda k: probe(k, cubic=True), 256)


def test_cpu_scan_never_takes_the_meta_path(monkeypatch):
    from repro_torch.models import mamba

    def refuse(*args):
        raise AssertionError("the meta path ran on CPU tensors")

    monkeypatch.setattr(mamba._MetaChunk, "apply", refuse)
    g = torch.Generator().manual_seed(0)
    B, S, di, N = 2, 40, 8, 4
    A = -torch.rand(di, N, generator=g) - 0.5
    dt = torch.rand(B, S, di, generator=g) * 0.1
    b, c = (torch.randn(B, S, N, generator=g) for _ in range(2))
    x = torch.randn(B, S, di, generator=g)
    y, h = mamba._scan("xla", True, dt, A, b, c, x)
    y0, h0 = mamba._scan_chunk(A, dt, b, c, x, torch.zeros(B, di, N))
    assert torch.equal(y, y0) and torch.equal(h, h0)
