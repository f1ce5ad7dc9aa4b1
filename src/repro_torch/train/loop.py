"""Trainer: the end-to-end loop wiring every substrate together
(``repro/train/loop.py``).

Per step: data batch (XUFS-cached shards) -> train_step -> write-behind
checkpoint pump (the WAL drains toward home on the virtual WAN while
compute proceeds) -> callback pump (invalidations) -> fault monitor
protocol (heartbeats / stragglers / restarts).

Crash recovery = exactly the paper's story: restart, ``client.sync()``
replays the meta-op queue, restore from the newest *complete* manifest.

Checkpoints are the reference's files: the state goes through
``bridge.state_to_reference`` before a save and comes back through
``state_from_reference`` after a restore, so either package's ``Trainer``
restores the other's.  The train step updates params and moments in
place, so a restore rebinds ``params`` and ``opt_state`` to the restored
tensors; a save encodes every leaf before it returns, so a later step
cannot reach a checkpoint still queued in the WAL.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from repro_torch.bridge import state_from_reference, state_to_reference
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.config.base import RunConfig
from repro_torch.data.pipeline import DataPipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import init_params
from repro_torch.optim.adamw import tree_map
from repro_torch.train.fault import FaultMonitor
from repro_torch.train.step import make_opt_state, make_train_step


@dataclass
class TrainResult:
    steps_run: int
    restarts: int
    final_loss: float
    losses: List[float] = field(default_factory=list)
    checkpoints: List[int] = field(default_factory=list)


def _same_device(a: torch.device, b: torch.device) -> bool:
    def index(d):
        if d.type == "cuda" and d.index is None:
            return torch.cuda.current_device()
        return d.index
    return a.type == b.type and index(a) == index(b)


class Trainer:
    def __init__(self, run: RunConfig, pipeline: DataPipeline,
                 ckpt: CheckpointManager, *,
                 monitor: Optional[FaultMonitor] = None,
                 ckpt_every: int = 10, pump_ops_per_step: int = 2,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        if not _same_device(pipeline.device, self.device):
            raise ValueError(f"the pipeline's batches land on "
                             f"{pipeline.device}, the trainer runs on "
                             f"{self.device}")
        self.run = run
        self.pipeline = pipeline
        self.ckpt = ckpt
        self.monitor = monitor or FaultMonitor(n_workers=1)
        self.ckpt_every = ckpt_every
        self.pump_ops_per_step = pump_ops_per_step
        self.step_fn = make_train_step(run)
        self.params: Any = None
        self.opt_state: Any = None
        self.step = 0

    # ---- state ------------------------------------------------------------
    def initialize(self) -> None:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.run.seed)
        self.params = init_params(self.run.model, gen, self.device)
        self.opt_state = make_opt_state(self.run, self.params)
        self.step = 0

    def _state_tree(self) -> Dict[str, Any]:
        return {"params": self.params, "opt": self.opt_state}

    def save_checkpoint(self) -> None:
        self.ckpt.save(self.step,
                       state_to_reference(self.run.model, self._state_tree()),
                       extra={"data": self.pipeline.state()})

    def restore_latest(self) -> bool:
        """Post-crash: replay the WAL, then restore the newest manifest."""
        self.ckpt.client.sync()
        # the reference's layout with empty leaves: ``restore`` reads only
        # a template leaf's device and dtype, so no state is copied
        template = state_to_reference(
            self.run.model, tree_map(lambda t: t.new_empty(0),
                                     self._state_tree()))
        try:
            tree, manifest = self.ckpt.restore(template)
        except FileNotFoundError:
            return False
        state = state_from_reference(self.run.model, tree)
        self.params = state["params"]
        self.opt_state = state["opt"]
        self.step = int(manifest["step"])
        if "data" in manifest.get("extra", {}):
            self.pipeline.restore(manifest["extra"]["data"])
        return True

    # ---- loop ------------------------------------------------------------
    def train(self, num_steps: int) -> TrainResult:
        if self.params is None:
            self.initialize()
        losses: List[float] = []
        saved: List[int] = []
        target = self.step + num_steps
        while self.step < target:
            participating, must_restart = self.monitor.begin_step(self.step)
            if must_restart:
                # node failure: elastic re-mesh + restore from checkpoint
                self.monitor.replace_dead()
                restored = self.restore_latest()
                if not restored:
                    self.initialize()
                continue
            batch = self.pipeline.next_batch()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            losses.append(float(metrics["loss"]))
            self.step += 1
            # write-behind: drain a few WAL ops toward home per step
            self.ckpt.client.pump(max_ops=self.pump_ops_per_step)
            self.ckpt.client.pump_callbacks()
            if self.step % self.ckpt_every == 0:
                self.save_checkpoint()
                saved.append(self.step)
        return TrainResult(steps_run=num_steps,
                           restarts=self.monitor.restarts,
                           final_loss=losses[-1] if losses else float("nan"),
                           losses=losses, checkpoints=saved)
