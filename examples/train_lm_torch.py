"""End-to-end training example on the PyTorch port: a ~100M-param
Qwen3-family LM trained through the full stack (XUFS data fabric,
write-behind checkpointing, fault injection mid-run, crash recovery).
The port's counterpart of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/train_lm_torch.py --preset full    # ~100M, 300 steps, on the card
    PYTHONPATH=src python examples/train_lm_torch.py --preset smoke --device cpu
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import (
    DENSE, ModelConfig, OptimConfig, RunConfig, ShapeConfig,
)
from repro_torch.core import Fabric, FabricSpec, MountSpec, SiteSpec
from repro_torch.data.pipeline import DataPipeline, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.train import FaultEvent, FaultMonitor, Trainer

PRESETS = {
    # ~100M params: 12L x 640d x 10H, vocab 32k
    "full": dict(layers=12, d_model=640, heads=10, kv_heads=5, d_ff=2560,
                 vocab=32768, seq=1024, batch=8, steps=300, micro=2),
    "smoke": dict(layers=2, d_model=128, heads=4, kv_heads=2, d_ff=512,
                  vocab=2048, seq=64, batch=4, steps=30, micro=1),
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="smoke")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    p = PRESETS[args.preset]
    steps = args.steps or p["steps"]

    cfg = ModelConfig(
        name=f"lm-{args.preset}", family=DENSE, num_layers=p["layers"],
        d_model=p["d_model"], num_heads=p["heads"],
        num_kv_heads=p["kv_heads"], head_dim=p["d_model"] // p["heads"],
        d_ff=p["d_ff"], vocab_size=p["vocab"], qk_norm=True,
        remat="full")
    print(f"model: {cfg.param_count() / 1e6:.1f}M params on {dev}")

    with tempfile.TemporaryDirectory() as td:
        fabric = Fabric(FabricSpec(sites=(
            SiteSpec("home", root=td + "/home"),
            SiteSpec("site", root=td + "/site"),
        )))
        net = fabric.network
        s = fabric.login("trainer",
                         mounts=[MountSpec("home/", ("home/scratch/",))])
        SyntheticCorpus(s.client, "home/data", seed=0,
                        vocab=cfg.vocab_size,
                        shard_tokens=max(p["seq"] * p["batch"] * 4, 8192)
                        ).materialize(4)
        pipe = DataPipeline(s.client, "home/data", cfg, batch=p["batch"],
                            seq=p["seq"], n_shards=4, device=dev)
        run = RunConfig(model=cfg,
                        shape=ShapeConfig("train", "train", p["seq"],
                                          p["batch"]),
                        optim=OptimConfig(lr=3e-4, warmup_steps=20,
                                          total_steps=steps),
                        microbatches=p["micro"])
        ckpt = CheckpointManager(s.client, "home/ckpt")
        # inject a node failure a third of the way through
        monitor = FaultMonitor(n_workers=8, schedule=[
            FaultEvent(step=max(steps // 3, 2), worker=3, kind="crash")])
        trainer = Trainer(run, pipe, ckpt, monitor=monitor,
                          ckpt_every=max(steps // 10, 5), device=dev)
        res = trainer.train(steps)
        print(f"steps={res.steps_run} restarts={res.restarts} "
              f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}")
        print(f"WAN clock {net.clock:.1f}s; checkpoints {res.checkpoints}")

        # cold-restart proof: a fresh trainer restores the newest manifest
        t2 = Trainer(run, pipe, ckpt, device=dev)
        t2.initialize()
        if not t2.restore_latest():
            raise SystemExit("no restorable checkpoint!")
        print(f"cold restore OK at step {t2.step}")


if __name__ == "__main__":
    main()
