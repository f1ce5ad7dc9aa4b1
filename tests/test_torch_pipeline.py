"""repro_torch.data.pipeline against repro.data.pipeline: the reference's
pipeline tests on the port, the same shard files at home, the same
batches bit for bit (across shard wraps, cache evictions and a resume),
and the same modeled WAN costs for the same reads."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import repro.core as jcore
import repro_torch.core as tcore
from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe
from _torch_parity import configs


def _session(core, root, site="site"):
    return core.Fabric(core.FabricSpec.star(os.path.join(root, "h"),
                                            os.path.join(root, site))
                       ).login("sci")


@pytest.fixture()
def session(tmp_path):
    return _session(tcore, str(tmp_path))


def _pipe(s, cfg, **kw):
    return tpipe.DataPipeline(s.client, "home/data", cfg, batch=2, seq=16,
                              n_shards=2, device="cpu", **kw)


def _tiny():
    return configs("qwen3-4b")[1]


def _np(x):
    return np.asarray(x)


# ---- the reference's three tests (tests/test_data_and_analysis.py) on the port

def test_pipeline_deterministic_and_resumable(session):
    s = session
    cfg = _tiny()
    tpipe.SyntheticCorpus(s.client, "home/data", seed=0,
                          vocab=cfg.vocab_size, shard_tokens=512
                          ).materialize(2)
    p1 = _pipe(s, cfg)
    batches1 = [p1.next_batch() for _ in range(4)]
    state = p1.state()
    nxt = p1.next_batch()
    # a fresh pipeline restored from state produces the same next batch
    p2 = _pipe(s, cfg)
    p2.restore(state)
    nxt2 = p2.next_batch()
    assert torch.equal(nxt["tokens"], nxt2["tokens"])
    # and a replay from scratch matches batch-for-batch
    p3 = _pipe(s, cfg)
    for b in batches1:
        b3 = p3.next_batch()
        assert torch.equal(b["tokens"], b3["tokens"])


def test_pipeline_targets_are_shifted_tokens(session):
    s = session
    cfg = _tiny()
    tpipe.SyntheticCorpus(s.client, "home/data", seed=0,
                          vocab=cfg.vocab_size, shard_tokens=512
                          ).materialize(2)
    b = _pipe(s, cfg).next_batch()
    toks = b["tokens"].reshape(-1)
    tgts = b["targets"].reshape(-1)
    assert torch.equal(toks[1:], tgts[:-1])


def test_pipeline_reads_through_cache(session):
    s = session
    cfg = _tiny()
    tpipe.SyntheticCorpus(s.client, "home/data", seed=0,
                          vocab=cfg.vocab_size, shard_tokens=512
                          ).materialize(2)
    p = _pipe(s, cfg)
    p.next_batch()
    clock0 = s.client.network.clock
    for _ in range(6):
        p.next_batch()    # all shards cached: zero WAN time
    assert s.client.network.clock == clock0


# ---- against the reference ------------------------------------------------------

# B * S + 1 = 33 tokens a batch; 500-token shards are not a multiple of it,
# so batches straddle shards; 4 shards with read_ahead=1 keep at most 3 in
# the cache, so it evicts; 130 batches wrap the 2,000 tokens twice.
B, S, SHARD_TOKENS, N_SHARDS, N_BATCHES = 2, 16, 500, 4, 130


def _home_files(root):
    data = os.path.join(root, "h", "sci", "data")
    out = {}
    for dirpath, _, files in os.walk(data):
        for fn in files:
            with open(os.path.join(dirpath, fn), "rb") as f:
                out[os.path.relpath(os.path.join(dirpath, fn), data)] = \
                    f.read()
    return out


@pytest.fixture()
def two_pipelines(tmp_path):
    """(reference session and pipeline, port session and pipeline), each
    over its own fabric with the same corpus materialized."""
    jcfg, tcfg = configs("qwen3-4b")
    out = []
    for core, pipe, cfg, name, kw in (
            (jcore, jpipe, jcfg, "jax", {}),
            (tcore, tpipe, tcfg, "torch", {"device": "cpu"})):
        s = _session(core, str(tmp_path / name))
        pipe.SyntheticCorpus(s.client, "home/data", seed=3,
                             vocab=cfg.vocab_size,
                             shard_tokens=SHARD_TOKENS).materialize(N_SHARDS)
        out.append((s, pipe.DataPipeline(s.client, "home/data", cfg,
                                         batch=B, seq=S, n_shards=N_SHARDS,
                                         read_ahead=1, **kw)))
    return out


def _assert_batch_equal(tb, jb):
    assert sorted(tb) == sorted(jb)
    for k, v in jb.items():
        want = _np(v)
        got = tb[k].numpy()
        assert got.dtype == want.dtype == np.int32, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_shard_files_are_the_references(tmp_path, two_pipelines):
    jfiles = _home_files(str(tmp_path / "jax"))
    assert len(jfiles) == N_SHARDS
    assert _home_files(str(tmp_path / "torch")) == jfiles
    want = jpipe.synth_tokens(3, 1, SHARD_TOKENS, 512)
    np.testing.assert_array_equal(
        tpipe.synth_tokens(3, 1, SHARD_TOKENS, 512), want)


def test_batches_equal_the_references_over_two_wraps(two_pipelines):
    (js, jp), (ts, tp) = two_pipelines
    evicted = False
    for _ in range(N_BATCHES):
        _assert_batch_equal(tp.next_batch(), jp.next_batch())
        assert sorted(tp._shard_cache) == sorted(jp._shard_cache)
        evicted |= len(tp._shard_cache) < N_SHARDS
        assert tp.state() == jp.state()
    assert tp.state()["cursor"] > 2 * N_SHARDS * SHARD_TOKENS
    assert evicted
    # the same reads cost the same on both fabrics' modeled WANs
    assert ts.network.clock == js.network.clock
    assert ts.network.per_endpoint_rpcs == js.network.per_endpoint_rpcs
    assert ts.network.trace == js.network.trace


def test_batches_equal_the_references_after_a_restore(two_pipelines):
    (js, jp), (ts, tp) = two_pipelines
    for _ in range(37):
        jp.next_batch()
    state = jp.state()
    fresh = tpipe.DataPipeline(ts.client, "home/data", tp.cfg, batch=B,
                               seq=S, n_shards=N_SHARDS, read_ahead=1,
                               device="cpu")
    fresh.restore(state)
    for _ in range(40):
        _assert_batch_equal(fresh.next_batch(), jp.next_batch())
    assert fresh.state() == jp.state()


def test_cuda_default_raises_without_a_card(session):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default takes it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.DataPipeline(session.client, "home/data", _tiny(), batch=2,
                           seq=16)

