"""The port's examples against the reference's:
``examples/quickstart_torch.py`` beside ``examples/quickstart.py`` and
``examples/disconnected_ops_torch.py`` beside
``examples/disconnected_ops.py``.

The quickstarts run at lr 0 in f32, the way
``tests/test_torch_trainer.py::test_loop_matches_reference_under_straggle_and_crash``
holds the loop: ``OptimConfig`` (lr 0), ``get_tiny_config`` (f32) and the
port's ``Trainer`` (started from the reference's initial params, carried
over by ``repro_torch.bridge``) are replaced in each script module's
globals, and nothing of either script is edited.  Restarts, checkpoint
steps, the WAN clock, the bytes shipped and both requests' greedy tokens
are equal; every loss within 1e-4.  The port's quickstart as written (lr
1e-3, bf16, ``--device cpu``) lowers its loss and prints the reference's
lines.  The fabric is a copy, so disconnected_ops prints the reference's
output line for line, its clock and bytes included."""
import importlib.util
import re
import runpy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

import jax

from repro_torch.bridge import params_from_numpy
from repro_torch.train import make_opt_state

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"


def _module(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _at_lr0_in_f32(mod, monkeypatch, seen):
    """Patch ``mod``'s globals: lr 0, the tiny config in f32, and record
    the fabric and the trainer with its train result."""
    optim, tiny = mod.OptimConfig, mod.get_tiny_config
    fabric_cls, trainer_cls = mod.Fabric, mod.Trainer
    monkeypatch.setattr(mod, "OptimConfig",
                        lambda **kw: optim(**{**kw, "lr": 0.0}))
    monkeypatch.setattr(mod, "get_tiny_config",
                        lambda arch: tiny(arch).replace(dtype="float32"))

    class Fabric(fabric_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["fabric"] = self

    class Trainer(trainer_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["trainer"] = self

        def train(self, n):
            seen["result"] = super().train(n)
            return seen["result"]

    monkeypatch.setattr(mod, "Fabric", Fabric)
    monkeypatch.setattr(mod, "Trainer", Trainer)
    return Trainer


def _observed(seen, out):
    res, net = seen["result"], seen["fabric"].network
    tokens = re.findall(r"^request (\d): (\[.*\])$", out, re.M)
    return dict(restarts=res.restarts, checkpoints=res.checkpoints,
                steps=seen["trainer"].step, clock=net.clock,
                bytes_sent=net.bytes_sent, tokens=tokens)


def test_quickstart_matches_reference_at_lr0(monkeypatch, capsys):
    ref, port = _module("quickstart"), _module("quickstart_torch")
    jseen, tseen = {}, {}
    jtrainer = _at_lr0_in_f32(ref, monkeypatch, jseen)

    class RefTrainer(jtrainer):
        def initialize(self):
            super().initialize()
            jseen["init"] = jax.tree.map(np.asarray, self.params)

    monkeypatch.setattr(ref, "Trainer", RefTrainer)
    ref.main()
    jout = capsys.readouterr().out

    ttrainer = _at_lr0_in_f32(port, monkeypatch, tseen)

    class PortTrainer(ttrainer):
        def initialize(self):
            super().initialize()
            self.params = params_from_numpy(self.run.model, jseen["init"],
                                            self.device)
            self.opt_state = make_opt_state(self.run, self.params)

    monkeypatch.setattr(port, "Trainer", PortTrainer)
    got = port.main(["--device", "cpu"])
    tout = capsys.readouterr().out

    want = _observed(jseen, jout)
    assert want["restarts"] == 0 and want["checkpoints"] == [10, 20]
    assert len(want["tokens"]) == 2
    assert _observed(tseen, tout) == want
    assert got.result is tseen["result"]
    np.testing.assert_allclose(tseen["result"].losses,
                               jseen["result"].losses, rtol=0, atol=1e-4)
    assert len(tseen["result"].losses) == 20


LINES = [r"loss: \d+\.\d{3} -> \d+\.\d{3}  checkpoints at \[10, 20\]",
         r"virtual WAN time: \d+\.\d{2}s, bytes shipped: \d{1,3}(,\d{3})*",
         r"request 0: \[(\d+(, \d+)*)\]",
         r"request 1: \[(\d+(, \d+)*)\]"]


def test_quickstart_as_written_trains_and_prints_the_references_lines(
        capsys):
    got = _module("quickstart_torch").main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(LINES)
    for line, pattern in zip(lines, LINES):
        assert re.fullmatch(pattern, line), line
    losses = got.result.losses
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert got.trainer.step == 20 and got.result.restarts == 0
    for rid, prompt in enumerate(([1, 2, 3], [9, 8, 7, 6])):
        req = got.engine.requests[rid]
        assert req.prompt == prompt and req.done
        assert len(req.output) == 8
        assert all(0 <= t < got.cfg.vocab_size for t in req.output)
    assert lines[1] == (f"virtual WAN time: {got.network.clock:.2f}s, "
                        f"bytes shipped: {got.network.bytes_sent:,}")


def test_quickstart_takes_the_card_unless_told(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _module("quickstart_torch").main([])


def test_disconnected_ops_prints_the_references_output(capsys):
    runpy.run_path(str(EXAMPLES / "disconnected_ops.py"), run_name="__main__")
    want = capsys.readouterr().out.splitlines()
    runpy.run_path(str(EXAMPLES / "disconnected_ops_torch.py"),
                   run_name="__main__")
    got = capsys.readouterr().out.splitlines()
    assert len(want) == 8 and "final WAN clock" in want[-1]
    assert got == want
