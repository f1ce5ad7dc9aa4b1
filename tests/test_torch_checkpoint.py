"""repro_torch.checkpoint on the port's fabric: the reference's own
checkpoint tests mirrored, cross-restore both ways between the packages
(each through its own fabric over one shared home root), identical files
and wire traces for the same state, a save that a later in-place train
step cannot reach, and the serve launcher's modeled WAN restore time."""
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import contextlib
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

import repro.checkpoint as jckpt
import repro.core as jcore
import repro.launch.serve as jserve
import repro_torch.checkpoint as tckpt
import repro_torch.core as tcore
from repro.config import base as jbase
from repro.train.step import make_opt_state as jmake_opt_state
from repro_torch import config as tbase
from repro_torch.bridge import (
    state_from_numpy, state_from_reference, state_to_numpy,
    state_to_reference,
)
from repro_torch.core.namespace import XufsClient
from repro_torch.data import make_batch
from repro_torch.launch import serve as tserve
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.train import make_opt_state, make_train_step
from _torch_parity import configs, port_params

HYBRID = "jamba-1.5-large-398b"


def _fabric(core, root, site="site"):
    return core.Fabric(core.FabricSpec.star(os.path.join(root, "h"),
                                            os.path.join(root, site)))


@pytest.fixture()
def session(tmp_path):
    return _fabric(tcore, str(tmp_path)).login("sci")


# ---- the reference's five tests, on the port's fabric -----------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((32, 16), generator=g),
                   "b": torch.zeros((16,))},
        "opt": {"m": torch.ones((32, 16)) * 0.5,
                "count": torch.tensor(7, dtype=torch.int32)},
    }


def _zeros(tree):
    return tree_map(torch.zeros_like, tree)


def test_save_restore_roundtrip(session):
    s = session
    mgr = tckpt.CheckpointManager(s.client, "home/ckpt")
    tree = _tree()
    mgr.save(10, tree, extra={"data": {"cursor": 1234}})
    s.client.sync()
    restored, manifest = mgr.restore(_zeros(tree))
    assert manifest["step"] == 10
    assert manifest["extra"]["data"]["cursor"] == 1234
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert restored["opt"]["count"].shape == ()


def test_wal_fifo_commit_ordering(session):
    """LATEST reaches home only after every leaf it names."""
    s = session
    mgr = tckpt.CheckpointManager(s.client, "home/ckpt")
    mgr.save(5, _tree())
    saw_latest = False
    while s.client.oplog.pending():
        s.client.pump(max_ops=1)
        try:
            data, _ = s.server.store.get(s.token, "home/ckpt/LATEST")
            saw_latest = True
        except FileNotFoundError:
            continue
        base = f"home/ckpt/step_{int(data.decode()):08d}"
        mdata, _ = s.server.store.get(s.token, base + "/MANIFEST.json")
        for leaf in json.loads(mdata.decode())["leaves"]:
            s.server.store.get(s.token, leaf["path"])   # must not raise
    assert saw_latest


def test_crash_before_sync_recovers_via_wal(session):
    """A fresh client over the same WAL replays a save never pumped."""
    s = session
    mgr = tckpt.CheckpointManager(s.client, "home/ckpt")
    tree = _tree()
    mgr.save(3, tree)
    c2 = XufsClient("site", s.network, cache_root=s.client.cache.root,
                    oplog_root=s.client.oplog.root, owner="sci")
    c2.mount("home/", "home", s.server.store, s.token)
    assert len(c2.oplog.pending()) > 0
    c2.sync()
    restored, manifest = tckpt.CheckpointManager(c2, "home/ckpt").restore(
        _zeros(tree))
    assert manifest["step"] == 3
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])


def test_latest_points_to_newest(session):
    s = session
    mgr = tckpt.CheckpointManager(s.client, "home/ckpt")
    mgr.save(1, _tree(1))
    mgr.save(2, _tree(2))
    s.client.sync()
    assert mgr.latest_step() == 2
    restored, manifest = mgr.restore(_zeros(_tree()))
    assert manifest["step"] == 2
    assert torch.equal(restored["params"]["w"], _tree(2)["params"]["w"])


def test_gc_keeps_recent(session):
    s = session
    mgr = tckpt.CheckpointManager(s.client, "home/ckpt", keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, _tree(step))
    s.client.sync()
    mgr.gc()
    s.client.sync()
    steps = mgr.list_steps()
    assert 3 in steps and 4 in steps and 1 not in steps


# ---- trees of the model: params alone, and a trainer tree -------------------

def _randomize(state, seed=0):
    """Seeded values in every leaf of a port state, in place (int8 codes
    across their range)."""
    g = torch.Generator().manual_seed(seed)
    for t in tree_leaves(state):
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g))
        elif t.dtype == torch.int32:
            t.fill_(int(torch.randint(1, 1000, (), generator=g)))
        else:
            t.copy_(torch.randn(t.shape, generator=g))
    return state


def _runs(jcfg, tcfg):
    optim = dict(state_dtype="int8", grad_compress="int8")
    shape = dict(name="t", kind="train", seq_len=8, global_batch=2)
    return (jbase.RunConfig(model=jcfg, shape=jbase.ShapeConfig(**shape),
                            optim=jbase.OptimConfig(**optim)),
            tbase.RunConfig(model=tcfg, shape=tbase.ShapeConfig(**shape),
                            optim=tbase.OptimConfig(**optim)))


def _state(arch, param_dtype, trainer, **kw):
    """(port config, port state: params alone or the trainer's tree, the
    reference's tree of the same shapes as JAX arrays)."""
    jcfg, tcfg = configs(arch, param_dtype=param_dtype, **kw)
    jp, tp = port_params(tcfg)
    if not trainer:
        return tcfg, {"params": tp}, {"params": jp}
    jrun, trun = _runs(jcfg, tcfg)
    state = _randomize({"params": tp, "opt": make_opt_state(trun, tp)})
    return tcfg, state, {"params": jp, "opt": jmake_opt_state(jrun, jp)}


def _named(tree):
    """{leaf name: numpy array} through the reference's own path names."""
    from repro.checkpoint.ckpt import _leaf_paths, _path_str
    return {_path_str(p): np.asarray(x) for p, x in _leaf_paths(tree)}


def _assert_bits_equal(got, want):
    got, want = _named(got), _named(want)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name].reshape(-1).view(np.uint8),
                                      want[name].reshape(-1).view(np.uint8),
                                      err_msg=name)


CASES = [("qwen3-8b", "float32", False, {}),
         ("qwen3-8b", "bfloat16", False, {}),
         (HYBRID, "float32", False, {}),
         (HYBRID, "bfloat16", False, {}),
         ("qwen3-4b", "float32", True, {}),
         (HYBRID, "bfloat16", True, {})]
IDS = [f"{a.split('-')[0]}-{d}-{'trainer' if t else 'params'}"
       for a, d, t, _ in CASES]


@pytest.mark.parametrize("arch,param_dtype,trainer,kw", CASES, ids=IDS)
def test_port_tree_has_the_reference_leaves(arch, param_dtype, trainer, kw):
    """The port's tree in the reference's layout has the reference's leaf
    names, shapes and dtypes: int8 moments' block scales stack along the
    leading axes, ``count`` stays 0-d."""
    tcfg, state, jtree = _state(arch, param_dtype, trainer, **kw)
    got = {k: (v.shape, v.dtype)
           for k, v in _named(state_to_numpy(tcfg, state)).items()}
    want = {k: (v.shape, v.dtype) for k, v in _named(jtree).items()}
    assert got == want


@pytest.mark.parametrize("arch,param_dtype,trainer,kw", CASES, ids=IDS)
def test_jax_save_restores_in_torch(tmp_path, arch, param_dtype, trainer,
                                    kw):
    tcfg, state, _ = _state(arch, param_dtype, trainer, **kw)
    want = state_to_numpy(tcfg, state)
    js = _fabric(jcore, str(tmp_path), "site_jax").login("sci")
    jckpt.CheckpointManager(js.client, "home/ckpt").save(
        4, jax.tree.map(jnp.asarray, want))
    js.client.sync()

    ts = _fabric(tcore, str(tmp_path), "site_torch").login("sci")
    template = state_to_reference(tcfg, tree_map(torch.zeros_like, state))
    restored, manifest = tckpt.CheckpointManager(
        ts.client, "home/ckpt").restore(template)
    assert manifest["step"] == 4
    port = state_from_reference(tcfg, restored)
    _assert_bits_equal(state_to_numpy(tcfg, port), want)
    if trainer:
        assert port["opt"]["count"].shape == ()


@pytest.mark.parametrize("arch,param_dtype,trainer,kw", CASES, ids=IDS)
def test_torch_save_restores_in_jax(tmp_path, arch, param_dtype, trainer,
                                    kw):
    tcfg, state, _ = _state(arch, param_dtype, trainer, **kw)
    ts = _fabric(tcore, str(tmp_path), "site_torch").login("sci")
    tckpt.CheckpointManager(ts.client, "home/ckpt").save(
        4, state_to_reference(tcfg, state))
    ts.client.sync()

    js = _fabric(jcore, str(tmp_path), "site_jax").login("sci")
    want = state_to_numpy(tcfg, state)
    restored, manifest = jckpt.CheckpointManager(
        js.client, "home/ckpt").restore(jax.tree.map(jnp.zeros_like, want))
    assert manifest["step"] == 4
    _assert_bits_equal(restored, want)


def _home_files(home):
    data = os.path.join(home, "data")
    out = {}
    for dirpath, _, files in os.walk(data):
        for fn in files:
            with open(os.path.join(dirpath, fn), "rb") as f:
                out[os.path.relpath(os.path.join(dirpath, fn), data)] = \
                    f.read()
    return out


@pytest.mark.parametrize("arch,param_dtype,trainer,kw",
                         [CASES[1], CASES[5]], ids=[IDS[1], IDS[5]])
def test_same_state_same_files_and_trace(tmp_path, arch, param_dtype,
                                         trainer, kw):
    """One state saved, synced and restored through each package on its
    own fabric: the same ``.npy`` leaves, manifest and LATEST at home, and
    the same wire trace and clock after the save and after the restore."""
    tcfg, state, _ = _state(arch, param_dtype, trainer, **kw)
    tree = state_to_reference(tcfg, state)
    ref, port = str(tmp_path / "jax"), str(tmp_path / "torch")
    js = _fabric(jcore, ref).login("sci")
    ts = _fabric(tcore, port).login("sci")
    jmgr = jckpt.CheckpointManager(js.client, "home/ckpt")
    tmgr = tckpt.CheckpointManager(ts.client, "home/ckpt")
    jtree = jax.tree.map(jnp.asarray, state_to_numpy(tcfg, state))
    jmgr.save(7, jtree, extra={"data": {"cursor": 3}})
    tmgr.save(7, tree, extra={"data": {"cursor": 3}})
    js.client.sync()
    ts.client.sync()
    files = _home_files(os.path.join(ref, "h", "sci"))
    assert {"home/ckpt/LATEST", "home/ckpt/step_00000007/MANIFEST.json"} \
        <= set(files)
    assert _home_files(os.path.join(port, "h", "sci")) == files
    assert ts.network.trace == js.network.trace
    assert ts.network.clock == js.network.clock
    n_saved = len(js.network.trace)

    jmgr.restore(jax.tree.map(jnp.zeros_like, jtree))
    tmgr.restore(tree_map(torch.zeros_like, tree))
    assert len(js.network.trace) > n_saved
    assert ts.network.trace == js.network.trace
    assert ts.network.clock == js.network.clock
    assert ts.network.per_endpoint_rpcs == js.network.per_endpoint_rpcs
    assert ts.client.cache.fills_from == js.client.cache.fills_from


def test_save_is_not_a_live_view(session):
    """The train step updates params and moments in place: a step taken
    after ``save`` must not reach the saved leaves."""
    jcfg, tcfg = configs("qwen3-4b", param_dtype="float32", dtype="float32")
    tp = port_params(tcfg)[1]
    run = _runs(jcfg, tcfg)[1].replace(
        optim=tbase.OptimConfig(state_dtype="int8", warmup_steps=1))
    opt = make_opt_state(run, tp)
    step = make_train_step(run)
    batch = make_batch(tcfg, 2, 8, torch.Generator().manual_seed(0), "cpu")
    tp, opt, _ = step(tp, opt, batch)          # count 0 -> 1; lr 0
    state = {"params": tp, "opt": opt}
    snapshot = tree_map(torch.clone, state)
    mgr = tckpt.CheckpointManager(session.client, "home/ckpt")
    mgr.save(1, state_to_reference(tcfg, state))
    step(tp, opt, batch)                       # lr > 0: params move too
    assert not torch.equal(tp["final_norm"], snapshot["params"]["final_norm"])
    assert not torch.equal(opt["m"]["embed"]["embedding"]["s"],
                           snapshot["opt"]["m"]["embed"]["embedding"]["s"])
    session.client.sync()
    restored, _ = mgr.restore(state_to_reference(tcfg, state))
    _assert_bits_equal(
        state_to_numpy(tcfg, state_from_reference(tcfg, restored)),
        state_to_numpy(tcfg, snapshot))


class _NoEngine:
    """The reference launcher's engine, left out: only its restore is
    compared (the reference's eager serving would dominate the test)."""

    def __init__(self, *a, **kw):
        self.queue, self.slot_states, self.tokens_generated = [], [], 0

    def add_request(self, req):
        pass


def _wan_line(main, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main()
    lines = [ln for ln in out.getvalue().splitlines() if "XUFS" in ln]
    assert len(lines) == 1, out.getvalue()
    return lines[0]


def test_launcher_restore_time_matches_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(jserve, "ServeEngine", _NoEngine)
    want = _wan_line(jserve.main, ["--tiny", "--requests", "0",
                                   "--workdir", str(tmp_path / "jax")],
                     monkeypatch)
    got = _wan_line(tserve.main, ["--tiny", "--device", "cpu", "--requests",
                                  "2", "--max-new", "2", "--workdir",
                                  str(tmp_path / "torch")], monkeypatch)
    assert got == want
    assert want.startswith("weights restored through XUFS in ")
    files = _home_files(str(tmp_path / "jax" / "home" / "server"))
    assert "home/models/qwen3-8b-tiny/step_00000000/MANIFEST.json" in files
    assert _home_files(str(tmp_path / "torch" / "home" / "server")).keys() \
        == files.keys()


def test_state_from_numpy_is_state_from_reference():
    tcfg, state, _ = _state("qwen3-4b", "float32", True)
    tree = state_to_numpy(tcfg, state)
    _assert_bits_equal(state_to_numpy(tcfg, state_from_numpy(tcfg, tree,
                                                             "cpu")), tree)


def test_numpy_leaves_save_and_restore_as_numpy(tmp_path):
    """A tree of numpy arrays (bf16 as numpy's ``ml_dtypes`` bfloat16, as
    JAX hands them out) saves to the same files as the same tree of torch
    tensors, and restores into a numpy template as numpy arrays."""
    tcfg, state, _ = _state("qwen3-8b", "bfloat16", False)
    want = state_to_numpy(tcfg, state)
    roots = [str(tmp_path / "np"), str(tmp_path / "torch")]
    for root, tree in zip(roots, (want, state_to_reference(tcfg, state))):
        s = _fabric(tcore, root).login("sci")
        tckpt.CheckpointManager(s.client, "home/ckpt").save(2, tree)
        s.client.sync()
    files = _home_files(os.path.join(roots[0], "h", "sci"))
    assert _home_files(os.path.join(roots[1], "h", "sci")) == files
    restored, _ = tckpt.CheckpointManager(s.client, "home/ckpt").restore(
        jax.tree.map(np.zeros_like, want))
    assert all(isinstance(x, np.ndarray) for x in _named(restored).values())
    _assert_bits_equal(restored, want)
