"""repro_torch.train.loop (``Trainer``), train/fault.py and the training
launcher against the reference: the reference's trainer and workflow
tests on the port, the loop step for step beside the reference's under a
straggle and a crash (same restarts, checkpoints and fabric costs, losses
within 1e-4), checkpoints written by either package's ``Trainer``
restored by the other's, and a restore that rebinds the state the step
updates in place."""
import os
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax

import repro.checkpoint as jckpt
import repro.core as jcore
import repro.train as jtrain
import repro_torch.checkpoint as tckpt
import repro_torch.core as tcore
import repro_torch.train as ttrain
from repro.config import base as jbase
from repro.data import pipeline as jpipe
from repro_torch import config as tbase
from repro_torch.bridge import params_from_numpy, state_to_numpy, \
    state_to_reference
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as tlaunch
from repro_torch.optim import compress_decompress, init_error
from _torch_parity import configs

ROOT = Path(__file__).resolve().parent.parent
PKGS = {"jax": (jcore, jpipe, jckpt, jtrain, jbase, {}),
        "torch": (tcore, tpipe, tckpt, ttrain, tbase, {"device": "cpu"})}


def _session(core, root, site="site"):
    return core.Fabric(core.FabricSpec.star(
        os.path.join(root, "h"), os.path.join(root, site))).login(
        "sci", mounts=[core.MountSpec("home/", ("home/scratch/",))])


def _stack(pkg, root, cfg, *, site="site", monitor=None, lr=1e-3, micro=1,
           steps_total=60, grad_compress="none", materialize=True):
    """``tests/test_train_serve.py`` ``_mk_trainer`` in either package:
    (trainer, session); ``materialize=False`` reads a corpus already at
    home."""
    core, pipe, ckpt, train, base, dev = PKGS[pkg]
    s = _session(core, root, site)
    run = base.RunConfig(model=cfg,
                         shape=base.ShapeConfig("t", "train", 32, 4),
                         optim=base.OptimConfig(lr=lr, warmup_steps=5,
                                                total_steps=steps_total,
                                                grad_compress=grad_compress),
                         microbatches=micro)
    if materialize:
        pipe.SyntheticCorpus(s.client, "home/data", seed=0,
                             vocab=cfg.vocab_size, shard_tokens=4096
                             ).materialize(2)
    data = pipe.DataPipeline(s.client, "home/data", cfg, batch=4, seq=32,
                             n_shards=2, **dev)
    mgr = ckpt.CheckpointManager(s.client, "home/ckpt")
    return train.Trainer(run, data, mgr, monitor=monitor, ckpt_every=4,
                         **dev), s


def _by_path(tree, path=()):
    """{path: tensor} of a tree of dicts, lists and tensors."""
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items()
                for p, t in _by_path(v, path + (k,)).items()}
    if isinstance(tree, list):
        return {p: t for i, v in enumerate(tree)
                for p, t in _by_path(v, path + (i,)).items()}
    return {path: tree}


def _mk_trainer(tmp_path, **kw):
    return _stack("torch", str(tmp_path), configs("qwen3-4b")[1], **kw)


def test_fault_is_the_references_text():
    ref = ROOT / "src" / "repro" / "train" / "fault.py"
    port = ROOT / "src" / "repro_torch" / "train" / "fault.py"
    assert port.read_bytes() == ref.read_bytes()


# ---- the reference's trainer tests (tests/test_train_serve.py) on the port ----

def test_loss_decreases(tmp_path):
    tr, _ = _mk_trainer(tmp_path)
    res = tr.train(12)
    assert res.losses[-1] < res.losses[0]


def test_crash_restart_resumes_from_checkpoint(tmp_path):
    mon = ttrain.FaultMonitor(n_workers=4, schedule=[
        ttrain.FaultEvent(step=6, worker=2, kind="crash")])
    tr, s = _mk_trainer(tmp_path, monitor=mon)
    res = tr.train(10)
    assert res.restarts == 1
    assert tr.step == 10
    assert res.checkpoints   # checkpoints were published


def test_straggler_dropped_then_rejoins(tmp_path):
    mon = ttrain.FaultMonitor(n_workers=4, schedule=[
        ttrain.FaultEvent(step=3, worker=1, kind="straggle", duration=2)])
    tr, _ = _mk_trainer(tmp_path, monitor=mon)
    res = tr.train(8)
    assert mon.dropped_syncs == 2      # bounded staleness, no restart
    assert res.restarts == 0


def test_too_stale_straggler_forces_remesh(tmp_path):
    mon = ttrain.FaultMonitor(n_workers=2, max_staleness=1, schedule=[
        ttrain.FaultEvent(step=5, worker=0, kind="straggle", duration=10)])
    tr, _ = _mk_trainer(tmp_path, monitor=mon)
    res = tr.train(8)
    assert res.restarts >= 1


def test_cold_restore_reproduces_params(tmp_path):
    tr, s = _mk_trainer(tmp_path)
    tr.train(8)
    tr2 = ttrain.Trainer(tr.run, tr.pipeline, tr.ckpt, device="cpu")
    tr2.initialize()
    assert tr2.restore_latest()
    assert tr2.step == 8
    want, got = _by_path(tr._state_tree()), _by_path(tr2._state_tree())
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert a.dtype == got[k].dtype and torch.equal(a, got[k]), k


def test_grad_compression_trains(tmp_path):
    """EF-int8 compression runs end to end, and the compressed update stays
    aligned with the true gradient."""
    tr, _ = _mk_trainer(tmp_path, grad_compress="int8")
    res = tr.train(10)
    assert all(np.isfinite(res.losses))
    assert "ef_error" in tr.opt_state
    g = {"w": torch.randn(512, generator=torch.Generator().manual_seed(3))}
    want = g["w"].clone()
    deq, _ = compress_decompress(g, init_error(g))
    cos = float((want * deq["w"]).sum()
                / (want.norm() * deq["w"].norm()))
    assert cos > 0.999, cos


def test_full_workflow(tmp_path):
    """``tests/test_system.py`` on the port: input cached at the pod, a
    WAN partition mid-run with checkpoints queued, heal, sync, the newest
    checkpoint at home, raw output never crossing."""
    fab = tcore.Fabric(tcore.FabricSpec.star(str(tmp_path / "laptop"),
                                             str(tmp_path / "pod")))
    net = fab.network
    s = fab.login("sci", mounts=[tcore.MountSpec("home/",
                                                 ("home/scratch/raw/",))])
    cfg = configs("qwen3-4b")[1]

    for i in range(8):
        s.server.store.put(s.token, f"home/src/mod{i}.py", b"# sim\n" * 100)
    assert s.client.chdir("home/src") == 8        # parallel prefetch
    tpipe.SyntheticCorpus(s.client, "home/input", seed=1,
                          vocab=cfg.vocab_size, shard_tokens=4096
                          ).materialize(2)

    pipe = tpipe.DataPipeline(s.client, "home/input", cfg, batch=4, seq=32,
                              n_shards=2, device="cpu")
    run = tbase.RunConfig(model=cfg,
                          shape=tbase.ShapeConfig("sys", "train", 32, 4),
                          optim=tbase.OptimConfig(lr=1e-3, warmup_steps=3,
                                                  total_steps=50))
    ckpt = tckpt.CheckpointManager(s.client, "home/ckpt")
    tr = ttrain.Trainer(run, pipe, ckpt, ckpt_every=4, device="cpu")
    res1 = tr.train(6)
    with s.client.open("home/scratch/raw/activations.bin", "w") as f:
        f.write(b"\x00" * 1_000_000)

    net.partition("pod", "laptop")
    res2 = tr.train(6)
    assert len(res2.losses) == 6                  # no stall
    assert len(s.client.oplog.pending()) > 0      # checkpoints queued

    net.heal("pod", "laptop")
    s.client.sync()
    assert ckpt.latest_step() == 12
    restored, manifest = ckpt.restore(state_to_reference(cfg,
                                                         tr._state_tree()))
    assert torch.equal(restored["params"]["final_norm"],
                       tr.params["final_norm"])

    with pytest.raises(FileNotFoundError):
        s.server.store.get(s.token, "home/scratch/raw/activations.bin")
    assert np.isfinite(res1.losses + res2.losses).all()


# ---- the port's own rules -------------------------------------------------------

def test_restore_rebinds_the_state_the_step_updates_in_place(tmp_path):
    """A save at step 2, an in-place step, a crash at step 3: right after
    the restore, the trainer's params and moments are the checkpoint's
    values, not the pre-crash ones."""
    mon = ttrain.FaultMonitor(n_workers=2, schedule=[
        ttrain.FaultEvent(step=3, worker=0, kind="crash")])
    tr, _ = _mk_trainer(tmp_path, monitor=mon)
    tr.ckpt_every = 2
    seen = {}
    save, restore = tr.save_checkpoint, tr.restore_latest

    def snapshot():
        return {k: t.clone() for k, t in _by_path(tr._state_tree()).items()}

    def saving():
        seen.setdefault("saved", snapshot())
        save()

    def restoring():
        seen["pre_crash"] = snapshot()
        ok = restore()
        seen["restored"] = snapshot()
        return ok

    tr.save_checkpoint, tr.restore_latest = saving, restoring
    res = tr.train(4)
    assert res.restarts == 1 and res.checkpoints == [2, 4] and tr.step == 4
    saved = seen["saved"]
    assert sorted(seen["restored"]) == sorted(saved)
    moved = [not torch.equal(seen["pre_crash"][k], v)
             for k, v in saved.items()]
    assert sum(moved) > len(moved) // 2     # the step moved most leaves
    for k, want in saved.items():
        assert torch.equal(seen["restored"][k], want), k


def test_trainer_takes_the_pipelines_device(tmp_path):
    tr, _ = _mk_trainer(tmp_path)
    with pytest.raises(ValueError, match="pipeline"):
        ttrain.Trainer(tr.run, tr.pipeline, tr.ckpt, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttrain.Trainer(tr.run, tr.pipeline, tr.ckpt)


def test_launcher_trains_crashes_and_restores(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "train", "--tiny", "--device", "cpu", "--steps", "12",
        "--ckpt-every", "4", "--inject-crash-at", "6",
        "--workdir", str(tmp_path)])
    tlaunch.main()
    out = capsys.readouterr().out
    assert "device=cpu" in out
    assert "steps=12 restarts=1 " in out
    assert "checkpoints [4, 8, 12]" in out


def test_example_trains_and_cold_restores(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "train_lm_torch.py", "--preset", "smoke", "--device", "cpu",
        "--steps", "6"])
    runpy.run_path(str(ROOT / "examples" / "train_lm_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "steps=6 restarts=1 " in out
    assert "cold restore OK at step 5" in out


# ---- parity with the reference's Trainer ----------------------------------------

def _f32_configs():
    return configs("qwen3-4b", dtype="float32")


@pytest.fixture(scope="module")
def jit_steps():
    """One compiled reference step per learning rate, shared by the
    reference trainers of this module (each ``Trainer`` jits its own)."""
    return {}


def _jax_trainer(jit_steps, root, cfg, **kw):
    tr, s = _stack("jax", root, cfg, site="site_jax", **kw)
    lr = tr.run.optim.lr
    tr.step_fn = jit_steps.setdefault(lr, tr.step_fn)
    return tr, s


def _port_from_reference(tr, jtr, tcfg):
    """The port trainer's state set to the reference trainer's params and
    fresh moments (``jax.random`` bits cannot be drawn in torch)."""
    tr.params = params_from_numpy(tcfg, jax.tree.map(np.asarray, jtr.params),
                                  "cpu")
    tr.opt_state = ttrain.make_opt_state(tr.run, tr.params)


def _observed(tr, s, res):
    net = s.network
    return dict(restarts=res.restarts, step=tr.step,
                checkpoints=res.checkpoints,
                dropped_syncs=tr.monitor.dropped_syncs, clock=net.clock,
                bytes_sent=net.bytes_sent,
                rpcs=dict(net.per_endpoint_rpcs),
                cursor=tr.pipeline.state(), n_losses=len(res.losses))


def _schedule(train):
    return train.FaultMonitor(n_workers=4, schedule=[
        train.FaultEvent(step=3, worker=1, kind="straggle", duration=2),
        train.FaultEvent(step=6, worker=2, kind="crash")])


def test_loop_matches_reference_under_straggle_and_crash(tmp_path,
                                                          jit_steps):
    """lr = 0, so Adam cannot amplify last-bit grad differences: every
    loss within 1e-4 of the reference's, and the same restarts, steps,
    checkpoints, dropped syncs and fabric costs, which depend only on
    sizes and the order of operations."""
    jcfg, tcfg = _f32_configs()
    jtr, js = _jax_trainer(jit_steps, str(tmp_path / "jax"), jcfg,
                           monitor=_schedule(jtrain), lr=0.0)
    jtr.initialize()
    ttr, ts = _stack("torch", str(tmp_path / "torch"), tcfg,
                     monitor=_schedule(ttrain), lr=0.0)
    _port_from_reference(ttr, jtr, tcfg)
    jres, tres = jtr.train(10), ttr.train(10)
    want = _observed(jtr, js, jres)
    assert want["restarts"] == 1 and want["dropped_syncs"] == 2
    assert want["checkpoints"] == [4, 8]
    assert _observed(ttr, ts, tres) == want
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=0, atol=1e-4)


def _assert_state_bits_equal(tcfg, ttr, jtr):
    got = state_to_numpy(tcfg, ttr._state_tree())
    want = jax.tree.map(np.asarray, jtr._state_tree())
    from repro.checkpoint.ckpt import _leaf_paths, _path_str
    got = {_path_str(p): x for p, x in _leaf_paths(got)}
    want = {_path_str(p): x for p, x in _leaf_paths(want)}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and got[name].shape == w.shape
        np.testing.assert_array_equal(got[name].reshape(-1).view(np.uint8),
                                      w.reshape(-1).view(np.uint8),
                                      err_msg=name)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_trainer_checkpoint_restores_in_the_other_package(tmp_path,
                                                          jit_steps, writer):
    """One package's Trainer trains 8 steps at lr 1e-3 and saves; the
    other's ``restore_latest`` gives the same step, data cursor and state
    bit for bit, and the next step's loss of both within 1e-4."""
    jcfg, tcfg = _f32_configs()
    root = str(tmp_path)
    template, _ = _jax_trainer(jit_steps, str(tmp_path / "template"), jcfg)
    template.initialize()
    if writer == "jax":
        jtr, _ = _jax_trainer(jit_steps, root, jcfg)
        jtr.params, jtr.opt_state = template.params, template.opt_state
        jtr.train(8)
        jtr.ckpt.client.sync()
        ttr, _ = _stack("torch", root, tcfg, site="site_torch",
                        materialize=False)
        ttr.initialize()
        assert ttr.restore_latest()
    else:
        ttr, _ = _stack("torch", root, tcfg, site="site_torch")
        ttr.train(8)
        ttr.ckpt.client.sync()
        jtr, _ = _jax_trainer(jit_steps, root, jcfg, materialize=False)
        jtr.params, jtr.opt_state = template.params, template.opt_state
        assert jtr.restore_latest()
    assert ttr.step == jtr.step == 8
    assert ttr.pipeline.state() == jtr.pipeline.state() == {
        "cursor": 8 * (4 * 32 + 1)}
    _assert_state_bits_equal(tcfg, ttr, jtr)
    jnext, tnext = jtr.train(1), ttr.train(1)
    np.testing.assert_allclose(tnext.losses, jnext.losses, rtol=0, atol=1e-4)
