"""Fault tolerance harness: heartbeats, failure detection, straggler policy.

Single-process simulation of the multi-host control plane: workers (pods)
report heartbeats against a virtual clock; the monitor classifies them as
healthy / straggling / dead and the training loop reacts:

  * dead worker      -> restart from the last published checkpoint
                        (possibly with a different worker count — elastic);
  * straggler        -> "disconnected DP": drop it from this step's gradient
                        sync (bounded staleness, like an XUFS disconnect),
                        reconcile when it catches back up.

Fault *injection* is a schedule of (step, worker, kind) events so tests are
deterministic.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

HEALTHY = "healthy"
STRAGGLER = "straggler"
DEAD = "dead"


@dataclass
class FaultEvent:
    step: int
    worker: int
    kind: str            # "crash" | "straggle" | "recover"
    duration: int = 1    # steps (for straggle)


@dataclass
class WorkerState:
    index: int
    status: str = HEALTHY
    last_heartbeat: float = 0.0
    missed_syncs: int = 0
    straggle_until: int = -1


@dataclass
class FaultMonitor:
    n_workers: int
    heartbeat_timeout: float = 10.0
    max_staleness: int = 3          # straggler steps before forced restart
    schedule: List[FaultEvent] = field(default_factory=list)
    workers: Dict[int, WorkerState] = field(default_factory=dict)
    restarts: int = 0
    dropped_syncs: int = 0

    def __post_init__(self) -> None:
        for i in range(self.n_workers):
            self.workers[i] = WorkerState(index=i)

    # ---- injection ------------------------------------------------------
    def inject(self, step: int) -> List[FaultEvent]:
        """Fire scheduled events for ``step``.  Events are ONE-SHOT: a
        restart rewinds the step counter past the event, and refiring it
        would crash-loop forever."""
        fired = [e for e in self.schedule if e.step == step]
        self.schedule = [e for e in self.schedule if e.step != step]
        for e in fired:
            w = self.workers[e.worker]
            if e.kind == "crash":
                w.status = DEAD
            elif e.kind == "straggle":
                w.status = STRAGGLER
                w.straggle_until = step + e.duration
            elif e.kind == "recover":
                w.status = HEALTHY
                w.missed_syncs = 0
        return fired

    # ---- per-step protocol ----------------------------------------------
    def begin_step(self, step: int) -> Tuple[Set[int], bool]:
        """Returns (workers participating in this step's sync, must_restart)."""
        self.inject(step)
        participating: Set[int] = set()
        must_restart = False
        for w in self.workers.values():
            if w.status == DEAD:
                must_restart = True
                continue
            if w.status == STRAGGLER:
                if step >= w.straggle_until:
                    w.status = HEALTHY
                    w.missed_syncs = 0
                    participating.add(w.index)
                else:
                    w.missed_syncs += 1
                    self.dropped_syncs += 1
                    if w.missed_syncs > self.max_staleness:
                        must_restart = True   # too stale: re-mesh without it
                    continue
            else:
                participating.add(w.index)
        return participating, must_restart

    def replace_dead(self) -> int:
        """Elastic re-mesh: dead workers are replaced (or dropped)."""
        n = 0
        for w in self.workers.values():
            if w.status in (DEAD, STRAGGLER):
                w.status = HEALTHY
                w.missed_syncs = 0
                n += 1
        self.restarts += 1
        return n
