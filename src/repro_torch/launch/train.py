"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Counterpart of ``repro/launch/train.py``.  Wires an architecture config
into the full stack: USSH session -> synthetic corpus in the home store
-> XUFS-cached data pipeline -> fault-monitored trainer with write-behind
checkpoints, on ``--device`` (the card by default; ``--device cpu`` runs
on the CPU).  The fabric lives under ``--workdir``, by default a new temp
dir that is left in place and printed, as the reference does.

``--tiny`` takes the reduced config (same code path).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import OptimConfig, RunConfig, ShapeConfig
from repro_torch.configs import ARCH_IDS, get_config, get_tiny_config
from repro_torch.core import Fabric, FabricSpec, MountSpec, SiteSpec
from repro_torch.data.pipeline import DataPipeline, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.launch.serve import device_name
from repro_torch.train import FaultEvent, FaultMonitor, Trainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-4b")
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--inject-crash-at", type=int, default=0)
    ap.add_argument("--workdir", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"family={cfg.family} device={device_name(dev)}")

    workdir = args.workdir or tempfile.mkdtemp(prefix="xufs_train_")
    fabric = Fabric(FabricSpec(sites=(
        SiteSpec("home", root=os.path.join(workdir, "home")),
        SiteSpec("site", root=os.path.join(workdir, "site")),
    )))
    net = fabric.network
    s = fabric.login("trainer",
                     mounts=[MountSpec("home/", ("home/scratch/",))])
    SyntheticCorpus(s.client, "home/data", seed=0, vocab=cfg.vocab_size,
                    shard_tokens=max(args.batch * args.seq * 4, 8192)
                    ).materialize(4)
    pipe = DataPipeline(s.client, "home/data", cfg, batch=args.batch,
                        seq=args.seq, n_shards=4, device=dev)
    run = RunConfig(
        model=cfg,
        shape=ShapeConfig("cli", "train", args.seq, args.batch),
        optim=OptimConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps),
        microbatches=args.micro)
    schedule = []
    if args.inject_crash_at:
        schedule.append(FaultEvent(step=args.inject_crash_at, worker=0,
                                   kind="crash"))
    trainer = Trainer(run, pipe, CheckpointManager(s.client, "home/ckpt"),
                      monitor=FaultMonitor(n_workers=4, schedule=schedule),
                      ckpt_every=args.ckpt_every, device=dev)
    res = trainer.train(args.steps)
    print(f"steps={res.steps_run} restarts={res.restarts} "
          f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}")
    print(f"WAN clock {net.clock:.1f}s bytes {net.bytes_sent:,} "
          f"checkpoints {res.checkpoints}")
    print(f"workdir: {workdir}")


if __name__ == "__main__":
    main()
