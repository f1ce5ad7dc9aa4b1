"""Background maintenance plane: scheduled fabric upkeep on the virtual
clock, with retry, backoff, per-path locks, and a dead-letter record.

XUFS's disconnection machinery — anti-entropy ``resync()``, read-repair
drain, lease ``renew_all()``, oplog ``reconcile()`` — used to run inline
from whatever client call happened to trigger it, so maintenance cost
rode reader latency and a partition mid-renewal silently corrupted lease
state.  This module makes that work a first-class subsystem, following
the GridFTP replica-management line (Allcock et al.) and the xDFS
transfer framework (Poshtkohi et al.): reliable retry-driven background
movement instead of a side effect of foreground I/O.

  * :class:`MaintenanceSpec` — the declarative knob on
    :class:`~repro_torch.core.fabric.FabricSpec`: task periods, the
    :class:`RetryPolicy`, and the per-path lock lease.  Unset ⇒ no
    scheduler exists and every wire event is bit-identical to the
    pre-maintenance fabric (the benchmark gate).
  * :class:`MaintenanceScheduler` — owned by one
    :class:`~repro_torch.core.fabric.Fabric` and shared by ALL its logins.
    Driven entirely by the transport's per-channel virtual clock
    (``Network.clock``): :meth:`tick` runs everything due *now*,
    :meth:`run_until` walks the clock from due-time to due-time.  No
    wall time, no jitter — same schedule ⇒ same trace.
  * :class:`RetryPolicy` — deterministic exponential backoff.  A task
    that raises is retried at ``base * multiplier^k`` delays (capped);
    after ``max_retries`` consecutive failures it is **dead-lettered**:
    removed from the schedule and recorded (attempts, backoff history,
    error strings, timestamps) for operators/benchmarks to inspect via
    :meth:`MaintenanceScheduler.report`.  :meth:`revive` puts a dead
    task back on the schedule once the fault is fixed.
  * :class:`LockTable` — per-path leases over the shared fabric so two
    sessions attached to one replica set never double-repair the same
    path.  Locks expire on the virtual clock (release is itself a WAN
    round-trip in a real deployment, so the conservative crash-safe
    default is to let the lease lapse); re-acquire by the same owner
    extends.  Conflicts are counted, not blocked on.

Counters (``tasks_run``, ``retries``, ``dead_lettered``,
``lock_conflicts``, ``repairs``, ``double_repairs``, ``evictions``)
plus per-task stats
snapshot into a :class:`MaintenanceReport` — what
``benchmarks/fig_maintenance.py`` gates on.  See ``docs/maintenance.md``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

from repro_torch.core.transport import Network

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.core.replication import PendingApply, ReplicaSet


@dataclass(frozen=True)
class RetryPolicy:
    """Deterministic exponential backoff — jitter-free on purpose: the
    virtual clock is the determinism witness, so retry ``k`` of a failing
    task always lands at ``base_delay_s * multiplier**(k-1)`` (capped at
    ``max_delay_s``) after the failure.  ``max_retries`` consecutive
    failures dead-letter the task."""

    max_retries: int = 3
    base_delay_s: float = 1.0
    multiplier: float = 2.0
    max_delay_s: float = 60.0

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0: {self.max_retries}")
        if self.base_delay_s <= 0:
            raise ValueError(
                f"base_delay_s must be > 0: {self.base_delay_s}")
        if self.multiplier < 1.0:
            raise ValueError(
                f"multiplier must be >= 1 (backoff never shrinks): "
                f"{self.multiplier}")
        if self.max_delay_s < self.base_delay_s:
            raise ValueError(
                f"max_delay_s ({self.max_delay_s}) < base_delay_s "
                f"({self.base_delay_s})")

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        return min(self.base_delay_s * self.multiplier ** (attempt - 1),
                   self.max_delay_s)


@dataclass(frozen=True)
class MaintenanceSpec:
    """Declarative maintenance plane: periods for the four scheduled
    task families, the retry policy, and the per-path repair-lock lease.
    Attach to :class:`~repro_torch.core.fabric.FabricSpec` (``maintenance=``);
    leaving it unset keeps the fabric scheduler-free and every trace
    bit-identical to the pre-maintenance code."""

    resync_period_s: float = 30.0
    repair_period_s: float = 5.0
    lease_period_s: float = 10.0
    reconcile_period_s: float = 15.0
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    lock_lease_s: float = 30.0

    def __post_init__(self) -> None:
        for name in ("resync_period_s", "repair_period_s",
                     "lease_period_s", "reconcile_period_s",
                     "lock_lease_s"):
            v = getattr(self, name)
            if v <= 0:
                raise ValueError(f"{name} must be > 0: {v}")


@dataclass(frozen=True)
class DeadLetter:
    """One task the scheduler gave up on: the inspectable record of a
    failure episode that outlived its retry budget."""

    task: str
    owner: str
    attempts: int                    # failed executions (initial + retries)
    backoff_s: Tuple[float, ...]     # the delays actually scheduled
    errors: Tuple[str, ...]          # one per failed execution
    first_failed_at: float
    dead_at: float


@dataclass
class ConflictRecord:
    """One detected concurrent-writer divergence (sibling of
    :class:`DeadLetter`): two vector-timestamp branches of the same path
    that neither dominates the other.  Reconciliation auto-picks a
    deterministic last-writer-wins ``winner`` and lands its bytes at
    home, but the losing branch is preserved here — a true conflict is
    never silently clobbered.  ``resolve()`` lets an operator override
    the automatic pick by re-applying either branch on top."""

    path: str
    seq: int                         # oplog seq of the detecting record
    owner: str                       # writer whose reconcile detected it
    ours_vts: Dict[str, int]         # the reconciling record's stamp
    theirs_vts: Dict[str, int]       # home's frontier at detection
    winner: str                      # "ours" | "theirs" (LWW auto-pick)
    ours_data: bytes
    theirs_data: bytes
    detected_at: float
    resolved: bool = False
    resolution: Optional[str] = None
    _apply: Optional[Callable[[bytes], None]] = field(
        default=None, repr=False, compare=False)

    def resolve(self, keep: str) -> None:
        """Operator override: re-apply the chosen branch (``"ours"`` or
        ``"theirs"``) on top at home.  One-shot."""
        if keep not in ("ours", "theirs"):
            raise ValueError(f'resolve() takes "ours" or "theirs": {keep!r}')
        if self.resolved:
            raise RuntimeError(
                f"conflict on {self.path!r} already resolved "
                f"({self.resolution})")
        if self._apply is not None:
            self._apply(self.ours_data if keep == "ours"
                        else self.theirs_data)
        self.resolved = True
        self.resolution = keep


@dataclass
class ScheduledTask:
    """One periodic schedule entry.  ``fn`` returning normally is
    success; raising is a failure that enters the retry/backoff ladder.
    State is per-failure-episode: success resets it."""

    name: str
    owner: str
    fn: Callable[[], object]
    period_s: float
    retry: RetryPolicy
    next_due: float
    runs: int = 0
    failures: int = 0
    attempt: int = 0                 # retries scheduled this episode
    backoff_s: List[float] = field(default_factory=list)
    errors: List[str] = field(default_factory=list)
    first_failed_at: Optional[float] = None
    dead: bool = False
    last_result: object = None


class LockTable:
    """Per-path lease locks over one fabric's shared state.

    ``acquire`` grants (or same-owner-extends) a lease until
    ``now + lease_s``; a different owner before expiry is a counted
    conflict.  There is no blocking: maintenance that loses the race
    simply skips the path this tick — the holder (or the next tick)
    covers it.  Expiry is judged on the caller-supplied virtual clock,
    so lock lifetime is deterministic.
    """

    def __init__(self, lease_s: float):
        if lease_s <= 0:
            raise ValueError(f"lock lease must be > 0: {lease_s}")
        self.lease_s = lease_s
        self._locks: Dict[str, Tuple[str, float]] = {}
        self.acquired = 0
        self.conflicts = 0

    def holder(self, key: str, now: float) -> Optional[str]:
        cur = self._locks.get(key)
        if cur is None or cur[1] <= now:
            return None
        return cur[0]

    def acquire(self, key: str, owner: str, now: float) -> bool:
        cur = self._locks.get(key)
        if cur is not None and cur[1] > now and cur[0] != owner:
            self.conflicts += 1
            return False
        self._locks[key] = (owner, now + self.lease_s)
        self.acquired += 1
        return True

    def release(self, key: str, owner: str) -> None:
        cur = self._locks.get(key)
        if cur is not None and cur[0] == owner:
            del self._locks[key]


@dataclass(frozen=True)
class MaintenanceReport:
    """Point-in-time snapshot the benchmarks gate on."""

    clock: float
    tasks_run: int
    retries: int
    dead_lettered: int
    lock_conflicts: int
    repairs: int
    double_repairs: int
    evictions: int
    conflicts: int
    #: replica-apply payload bytes by provenance (Network counters):
    #: third-party = storage->storage movement, client-mediated = pushed
    #: off a client session's NIC — the bulk plane's offload witness
    bytes_third_party: int
    bytes_client_mediated: int
    inflight: int
    #: task name -> {owner, runs, failures, attempt, next_due, dead}
    tasks: Dict[str, Dict[str, object]]
    dead_letters: Tuple[DeadLetter, ...]
    conflict_records: Tuple[ConflictRecord, ...]


class MaintenanceScheduler:
    """Periodic maintenance on the virtual clock, one per Fabric.

    All sessions logging into (or attaching to) a fabric register their
    task closures here, so the whole fabric's upkeep is schedulable,
    observable, and throttleable in one place.  The scheduler never
    advances the clock on its own except through :meth:`run_until`
    (walking due-time to due-time) and whatever waits the tasks
    themselves perform; :meth:`tick` at a fixed clock is side-effect-free
    when nothing is due.
    """

    #: hard ceiling on run_until iterations — a misconfigured period
    #: must fail loudly, not spin the simulator forever
    MAX_EVENTS = 1_000_000

    def __init__(self, network: Network, spec: MaintenanceSpec):
        self.network = network
        self.spec = spec
        self.tasks: Dict[str, ScheduledTask] = {}
        self.locks = LockTable(spec.lock_lease_s)
        self.dead_letters: List[DeadLetter] = []
        self.tasks_run = 0
        self.retries = 0
        self.dead_lettered = 0
        self.repairs = 0
        self.double_repairs = 0
        self.evictions = 0
        # concurrent-writer divergences surfaced by client reconciles
        self.conflicts: List[ConflictRecord] = []
        # armed FaultInjector (see Fabric.arm_faults): run_until walks
        # the clock to scheduled fault times even when no task is due
        self.faults: Optional[object] = None
        # repairs launched but not yet acked: (replica set, pending apply)
        self._inflight: List[Tuple["ReplicaSet", "PendingApply"]] = []
        self._tick_seq = 0
        # path -> (tick seq, owner) of the latest repair launch; a second
        # owner launching for the same path in the same tick IS the
        # double-repair the per-path locks exist to prevent
        self._repair_marks: Dict[str, Tuple[int, str]] = {}
        # stable per-process keys for replica sets ("rs0", "rs1", ...):
        # lock keys must be deterministic across sessions sharing a set
        self._rset_keys: Dict[int, str] = {}

    # ---- registration ----------------------------------------------------
    def register(self, name: str, fn: Callable[[], object], *,
                 period_s: float, owner: str = "fabric",
                 retry: Optional[RetryPolicy] = None,
                 first_due: Optional[float] = None) -> ScheduledTask:
        """Add one periodic task.  First run lands one period from now
        unless ``first_due`` pins it.  Registration touches no wire —
        a fabric with a scheduler but no ticks traces identically to a
        fabric without one."""
        if name in self.tasks:
            raise ValueError(f"task {name!r} already registered")
        if period_s <= 0:
            raise ValueError(f"task {name!r}: period must be > 0: "
                             f"{period_s}")
        t = ScheduledTask(
            name=name, owner=owner, fn=fn, period_s=period_s,
            retry=retry if retry is not None else self.spec.retry,
            next_due=(first_due if first_due is not None
                      else self.network.clock + period_s))
        self.tasks[name] = t
        return t

    def rset_key(self, rset: "ReplicaSet") -> str:
        """Stable lock-key prefix for a replica set shared by multiple
        sessions (first registration wins the name)."""
        key = self._rset_keys.get(id(rset))
        if key is None:
            key = f"rs{len(self._rset_keys)}"
            self._rset_keys[id(rset)] = key
        return key

    # ---- repair bookkeeping ----------------------------------------------
    def note_repair(self, path_key: str, owner: str) -> None:
        """Record a repair launch; flags a double repair when another
        owner launched for the same path in the same tick."""
        mark = self._repair_marks.get(path_key)
        if (mark is not None and mark[0] == self._tick_seq
                and mark[1] != owner):
            self.double_repairs += 1
        self._repair_marks[path_key] = (self._tick_seq, owner)
        self.repairs += 1

    def note_conflict(self, record: ConflictRecord) -> None:
        """Adopt a concurrent-writer conflict detected by a client's
        reconcile (wired up by the fabric) so it surfaces in
        :meth:`report` next to the dead letters."""
        self.conflicts.append(record)

    def track(self, rset: "ReplicaSet",
              pending: List["PendingApply"]) -> None:
        """Adopt launched-but-unacked repair applies; they land (bytes
        into the replica store, catalog updated, lag cleared) at the
        first tick whose clock has passed their ack."""
        for p in pending:
            self._inflight.append((rset, p))

    def _settle_inflight(self) -> int:
        now = self.network.clock
        landed = 0
        still: List[Tuple["ReplicaSet", "PendingApply"]] = []
        for rset, p in self._inflight:
            if p.ack.completion <= now:
                rset.complete_apply(p)
                landed += 1
            else:
                still.append((rset, p))
        self._inflight = still
        return landed

    def quiesce(self) -> int:
        """Wait out and land every in-flight repair (shutdown / report
        boundaries). Returns how many applies landed."""
        if not self._inflight:
            return 0
        self.network.wait_all([p.ack for _, p in self._inflight])
        return self._settle_inflight()

    # ---- the clock loop --------------------------------------------------
    @property
    def lock_conflicts(self) -> int:
        return self.locks.conflicts

    def next_event(self) -> Optional[float]:
        """Earliest virtual time anything needs attention: a task coming
        due or an in-flight repair ack landing."""
        times = [t.next_due for t in self.tasks.values() if not t.dead]
        times += [p.ack.completion for _, p in self._inflight]
        if self.faults is not None:
            nxt = self.faults.next_at()
            if nxt is not None:
                times.append(nxt)
        return min(times) if times else None

    def tick(self) -> int:
        """Run every task due at the current clock (registration order —
        deterministic), firing due fault-plan events and landing matured
        repair acks first.  Returns how many tasks ran."""
        self._tick_seq += 1
        if self.faults is not None:
            self.faults.advance_to(self.network.clock)
        self._settle_inflight()
        ran = 0
        now = self.network.clock
        for t in list(self.tasks.values()):
            if t.dead or t.next_due > now:
                continue
            self._run(t)
            ran += 1
        return ran

    def run_until(self, t_stop: float, *,
                  advance_to_stop: bool = True) -> float:
        """Walk the virtual clock forward to ``t_stop``, ticking at each
        due time.  This is how idle/think time hosts maintenance: the
        caller hands the scheduler a window and gets the clock back at
        ``t_stop`` with everything due inside it done (task-internal
        waits may push past a due time; later events catch up).
        """
        for _ in range(self.MAX_EVENTS):
            nxt = self.next_event()
            if nxt is None or nxt > t_stop:
                break
            if nxt > self.network.clock:
                self.network.advance(nxt - self.network.clock)
            self.tick()
        else:                                        # pragma: no cover
            raise RuntimeError("maintenance schedule did not converge "
                               f"within {self.MAX_EVENTS} events")
        if advance_to_stop and self.network.clock < t_stop:
            self.network.advance(t_stop - self.network.clock)
            self._settle_inflight()
        return self.network.clock

    # ---- execution / retry ladder ----------------------------------------
    def _run(self, t: ScheduledTask) -> None:
        self.tasks_run += 1
        t.runs += 1
        try:
            t.last_result = t.fn()
        except Exception as e:
            # scheduled upkeep must never crash the client: a failure
            # enters the retry ladder (or the dead-letter record), and
            # the session keeps serving reads/writes
            t.failures += 1
            if t.first_failed_at is None:
                t.first_failed_at = self.network.clock
            t.errors.append(f"{type(e).__name__}: {e}")
            if t.attempt >= t.retry.max_retries:
                self._dead_letter(t)
                return
            t.attempt += 1
            self.retries += 1
            delay = t.retry.delay_s(t.attempt)
            t.backoff_s.append(delay)
            t.next_due = self.network.clock + delay
            return
        # success closes the failure episode
        t.attempt = 0
        t.backoff_s.clear()
        t.errors.clear()
        t.first_failed_at = None
        t.next_due = self.network.clock + t.period_s

    def _dead_letter(self, t: ScheduledTask) -> None:
        t.dead = True
        self.dead_lettered += 1
        self.dead_letters.append(DeadLetter(
            task=t.name, owner=t.owner, attempts=t.attempt + 1,
            backoff_s=tuple(t.backoff_s), errors=tuple(t.errors),
            first_failed_at=t.first_failed_at if t.first_failed_at
            is not None else self.network.clock,
            dead_at=self.network.clock))

    def revive(self, name: str, *, delay_s: float = 0.0) -> ScheduledTask:
        """Dead-letter lifecycle, step 2: after the operator (or a heal)
        fixes the fault, put the task back on the schedule with a clean
        retry episode.  The dead-letter record itself is history — it
        stays in ``dead_letters``."""
        t = self.tasks[name]
        if t.dead:
            t.dead = False
            t.attempt = 0
            t.backoff_s = []
            t.errors = []
            t.first_failed_at = None
            t.next_due = self.network.clock + delay_s
        return t

    # ---- observability ---------------------------------------------------
    def report(self) -> MaintenanceReport:
        return MaintenanceReport(
            clock=self.network.clock,
            tasks_run=self.tasks_run,
            retries=self.retries,
            dead_lettered=self.dead_lettered,
            lock_conflicts=self.locks.conflicts,
            repairs=self.repairs,
            double_repairs=self.double_repairs,
            evictions=self.evictions,
            conflicts=len(self.conflicts),
            bytes_third_party=self.network.bytes_third_party,
            bytes_client_mediated=self.network.bytes_client_mediated,
            inflight=len(self._inflight),
            tasks={t.name: {
                "owner": t.owner, "runs": t.runs,
                "failures": t.failures, "attempt": t.attempt,
                "next_due": t.next_due, "dead": t.dead,
            } for t in self.tasks.values()},
            dead_letters=tuple(self.dead_letters),
            conflict_records=tuple(self.conflicts))
