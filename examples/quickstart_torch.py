"""Quickstart on the PyTorch port: the whole system in ~60 lines.

The port's counterpart of ``examples/quickstart.py``, step for step:
mount a home namespace over the simulated WAN, materialize a dataset,
train a tiny Qwen3-family model with write-behind checkpointing, then
serve a few requests from the trained weights.

    PYTHONPATH=src python examples/quickstart_torch.py                 # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import os
import sys
import tempfile
from types import SimpleNamespace

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import Fabric, FabricSpec, MountSpec, SiteSpec
from repro_torch.config import RunConfig, ShapeConfig, OptimConfig
from repro_torch.configs import get_tiny_config
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import SyntheticCorpus, DataPipeline
from repro_torch.device import resolve_device
from repro_torch.serve.engine import ServeEngine, Request
from repro_torch.train import Trainer


def main(argv=None) -> SimpleNamespace:
    """Runs the quickstart; returns its config, trainer, train result,
    serving engine and network (for callers that go on from it)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    with tempfile.TemporaryDirectory() as td:
        # 1. declare the topology, then USSH login: personal file server
        #    at "home", pod site mounts it (scratch/ stays pod-local)
        fabric = Fabric(FabricSpec(sites=(
            SiteSpec("home", root=td + "/home"),
            SiteSpec("site", root=td + "/site"),
        )))
        net = fabric.network
        s = fabric.login("scientist",
                         mounts=[MountSpec("home/", ("home/scratch/",))])

        # 2. input data lives in the home space; the pod reads it through
        #    the whole-object cache + prefetcher
        cfg = get_tiny_config("qwen3-4b")
        SyntheticCorpus(s.client, "home/data", seed=0,
                        vocab=cfg.vocab_size,
                        shard_tokens=8192).materialize(2)
        pipe = DataPipeline(s.client, "home/data", cfg, batch=4, seq=32,
                            n_shards=2, device=dev)

        # 3. train with write-behind checkpoints (WAL -> striped -> home)
        run = RunConfig(model=cfg,
                        shape=ShapeConfig("quick", "train", 32, 4),
                        optim=OptimConfig(lr=1e-3, warmup_steps=5,
                                          total_steps=100))
        ckpt = CheckpointManager(s.client, "home/ckpt")
        trainer = Trainer(run, pipe, ckpt, ckpt_every=10, device=dev)
        result = trainer.train(20)
        print(f"loss: {result.losses[0]:.3f} -> {result.losses[-1]:.3f}  "
              f"checkpoints at {result.checkpoints}")
        print(f"virtual WAN time: {net.clock:.2f}s, "
              f"bytes shipped: {net.bytes_sent:,}")

        # 4. serve from the trained weights (continuous batching)
        engine = ServeEngine(cfg, trainer.params, slots=2, max_len=64,
                             device=dev)
        for rid, prompt in enumerate(([1, 2, 3], [9, 8, 7, 6])):
            engine.add_request(Request(rid=rid, prompt=prompt,
                                       max_new_tokens=8))
        engine.run_until_done()
        for rid in (0, 1):
            print(f"request {rid}: {engine.requests[rid].output}")
    return SimpleNamespace(cfg=cfg, trainer=trainer, result=result,
                           engine=engine, network=net)


if __name__ == "__main__":
    main()
