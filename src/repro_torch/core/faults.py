"""Deterministic fault-injection harness for the simulated WAN.

Hand-rolled chaos — ``network.partition(...)`` / ``heal(...)`` calls
threaded through test and benchmark choreography — couples the fault
schedule to the code path that happens to run next.  This module makes
the schedule *declarative*: a :class:`FaultPlan` is a tuple of events
pinned to the virtual clock (:class:`PartitionEvent`,
:class:`HealEvent`, :class:`FlapEvent`, :class:`CrashEvent`), and a
:class:`FaultInjector` armed on a :class:`~repro_torch.core.transport.Network`
fires them lazily: every partition-sensitive operation (and
``Network.advance``) first releases all events whose time the clock has
reached.  Outage windows are anchored at the *event* time, not the pump
time, so auto-heal deadlines never depend on when a check happened to
run — same plan + same workload => bit-identical ``Network.trace``.

``FaultPlan.chaos(...)`` generates a seeded random plan (partitions of
bounded duration over a declared link set, optional site crashes) for
property tests: same seed => same plan => same trace.

An unarmed network never touches this module — the no-fault fast path
stays bit-identical to a build without it.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

__all__ = [
    "PartitionEvent", "HealEvent", "FlapEvent", "CrashEvent",
    "FaultPlan", "FaultInjector",
]

_INF = float("inf")


@dataclass(frozen=True)
class PartitionEvent:
    """Cut link ``a <-> b`` at ``at_s`` for ``duration_s`` virtual
    seconds (default: until an explicit :class:`HealEvent`)."""
    at_s: float
    a: str
    b: str
    duration_s: float = _INF

    def __post_init__(self) -> None:
        if self.at_s < 0.0:
            raise ValueError(f"PartitionEvent.at_s must be >= 0, got {self.at_s}")
        if self.duration_s <= 0.0:
            raise ValueError(
                f"PartitionEvent.duration_s must be > 0, got {self.duration_s}")


@dataclass(frozen=True)
class HealEvent:
    """Heal link ``a <-> b`` at ``at_s`` (no-op if not partitioned)."""
    at_s: float
    a: str
    b: str

    def __post_init__(self) -> None:
        if self.at_s < 0.0:
            raise ValueError(f"HealEvent.at_s must be >= 0, got {self.at_s}")


@dataclass(frozen=True)
class FlapEvent:
    """A flapping link: ``count`` outages of ``down_s`` each, the k-th
    starting at ``at_s + k * period_s``.  Expands to ``count``
    anchored :class:`PartitionEvent` windows."""
    at_s: float
    a: str
    b: str
    down_s: float
    period_s: float
    count: int = 1

    def __post_init__(self) -> None:
        if self.at_s < 0.0:
            raise ValueError(f"FlapEvent.at_s must be >= 0, got {self.at_s}")
        if self.down_s <= 0.0:
            raise ValueError(f"FlapEvent.down_s must be > 0, got {self.down_s}")
        if self.period_s <= 0.0:
            raise ValueError(
                f"FlapEvent.period_s must be > 0, got {self.period_s}")
        if self.count < 1:
            raise ValueError(f"FlapEvent.count must be >= 1, got {self.count}")


@dataclass(frozen=True)
class CrashEvent:
    """Crash the user file server(s) at ``site`` at ``at_s`` (volatile
    session state — auth tokens, subscriptions — is lost; the client
    recovers via ``reconnect()``/``remount()``)."""
    at_s: float
    site: str

    def __post_init__(self) -> None:
        if self.at_s < 0.0:
            raise ValueError(f"CrashEvent.at_s must be >= 0, got {self.at_s}")


_EVENT_TYPES = (PartitionEvent, HealEvent, FlapEvent, CrashEvent)


@dataclass(frozen=True)
class FaultPlan:
    """A declarative, virtual-clock fault schedule.

    ``events`` may arrive in any order; expansion sorts actions by
    ``(time, declaration index)`` so ties resolve deterministically in
    declaration order.
    """
    events: Tuple = ()

    def __post_init__(self) -> None:
        evs = tuple(self.events)
        for ev in evs:
            if not isinstance(ev, _EVENT_TYPES):
                raise TypeError(
                    f"FaultPlan events must be Partition/Heal/Flap/Crash "
                    f"events, got {type(ev).__name__}")
        object.__setattr__(self, "events", evs)

    def actions(self) -> List[Tuple[float, int, str, tuple]]:
        """Expand to a time-sorted action list
        ``(at_s, decl_index, kind, args)`` — flaps become their
        individual outage windows."""
        acts: List[Tuple[float, int, str, tuple]] = []
        for i, ev in enumerate(self.events):
            if isinstance(ev, PartitionEvent):
                acts.append((ev.at_s, i, "partition",
                             (ev.a, ev.b, ev.duration_s)))
            elif isinstance(ev, HealEvent):
                acts.append((ev.at_s, i, "heal", (ev.a, ev.b)))
            elif isinstance(ev, CrashEvent):
                acts.append((ev.at_s, i, "crash", (ev.site,)))
            else:  # FlapEvent
                for k in range(ev.count):
                    acts.append((ev.at_s + k * ev.period_s, i, "partition",
                                 (ev.a, ev.b, ev.down_s)))
        acts.sort(key=lambda t: (t[0], t[1]))
        return acts

    @classmethod
    def chaos(cls, pairs: Sequence[Tuple[str, str]], *, seed: int,
              horizon_s: float, events: int = 8, start_s: float = 0.0,
              min_down_s: float = 0.5, max_down_s: float = 5.0,
              crash_sites: Sequence[str] = ()) -> "FaultPlan":
        """Seeded random chaos: ``events`` finite outages spread over
        ``[start_s, start_s + horizon_s)`` across ``pairs``, plus an
        optional coin-flip crash per site in ``crash_sites``.  Pure
        function of its arguments — same seed => same plan."""
        if not pairs:
            raise ValueError("chaos() needs at least one link pair")
        if horizon_s <= 0.0:
            raise ValueError(f"horizon_s must be > 0, got {horizon_s}")
        if not 0.0 < min_down_s <= max_down_s:
            raise ValueError("need 0 < min_down_s <= max_down_s")
        rng = random.Random(seed)
        evs: List = []
        for _ in range(max(int(events), 0)):
            a, b = pairs[rng.randrange(len(pairs))]
            at = start_s + rng.random() * horizon_s
            down = min_down_s + rng.random() * (max_down_s - min_down_s)
            evs.append(PartitionEvent(at_s=round(at, 6), a=a, b=b,
                                      duration_s=round(down, 6)))
        for site in crash_sites:
            if rng.random() < 0.5:
                at = start_s + rng.random() * horizon_s
                evs.append(CrashEvent(at_s=round(at, 6), site=site))
        return cls(events=tuple(evs))


@dataclass
class FaultInjector:
    """Replays a :class:`FaultPlan` onto a network as the virtual clock
    passes each event.  Armed via ``Network.arm_faults`` (and, when a
    maintenance scheduler runs, mirrored on ``scheduler.faults`` so
    ``run_until`` walks the clock to fault times even with no task
    due).  ``crash_fn(site) -> int`` is supplied by the fabric; without
    one, :class:`CrashEvent` is a recorded no-op."""
    network: object
    plan: FaultPlan
    crash_fn: Optional[Callable[[str], int]] = None
    fired: int = 0
    crashes: int = 0

    def __post_init__(self) -> None:
        self._actions = self.plan.actions()
        self._idx = 0

    def next_at(self) -> Optional[float]:
        """Virtual time of the next unfired event (None when spent)."""
        if self._idx >= len(self._actions):
            return None
        return self._actions[self._idx][0]

    def done(self) -> bool:
        return self._idx >= len(self._actions)

    def advance_to(self, now: float) -> int:
        """Fire every event with ``at_s <= now``, in schedule order.
        Partition windows anchor at their event time (``start=at_s``),
        so a window the clock has fully passed is skipped rather than
        stretched.  Returns the number of events fired."""
        acts = self._actions
        n = 0
        while self._idx < len(acts) and acts[self._idx][0] <= now:
            at, _decl, kind, a = acts[self._idx]
            self._idx += 1
            if kind == "partition":
                self.network.partition(a[0], a[1], a[2], start=at)
            elif kind == "heal":
                self.network.heal(a[0], a[1])
            else:  # crash
                if self.crash_fn is not None:
                    self.crashes += int(self.crash_fn(a[0]))
            n += 1
        self.fired += n
        return n
