"""Simulated WAN transport with a deterministic per-channel virtual clock.

The container is one CPU process, so the *wire* is modeled while every
protocol above it (striping, callbacks, leases, auth, WAL replay) is real
code moving real bytes between in-process endpoints.

Time is event-based: every ``(endpoint, endpoint)`` pair owns a pool of
*channels* (modeled parallel TCP connections, at most
``channels_per_pair``), each with a ``busy_until`` time.  ``transfer()``
*reserves* a channel — start = max(clock, channel busy, ``not_before``) —
and returns a :class:`Transfer` record carrying start/completion times
without touching the global clock.  Callers advance the clock explicitly:
``wait(t)`` to one completion, ``wait_all(ts)`` to the max of a group,
``drain()`` to the max of everything outstanding.  Overlapped elapsed time
is therefore the max over channels, not the sum — which is what lets
striped transfers, replica write fan-out, and pipelined prefetch actually
overlap on the virtual clock (see ``docs/transport.md``).  ``rpc()``
remains the synchronous reserve-then-wait wrapper for request/response
calls (stat, lock, callback probes).

The engine is a batched discrete-event core (``docs/transport.md`` —
"event engine"): reservations land in a heap-based event queue popped in
completion order, per-pair channel state lives in a preallocated numpy
array, and N same-epoch reservations can be priced in ONE vectorized
pass via :meth:`Network.transfer_batch` (with
:meth:`Network.estimate_batch` as the vectorized routing metric).  The
batch paths are bit-identical to issuing the same reservations one at a
time with :meth:`Network.transfer` — same trace, same channel/NIC state
— which is what keeps every gated benchmark topology valid.

Link model (paper context: TeraGrid 30 Gbps WAN, high RTT):
  * per-stream throughput is TCP-window/RTT limited (``per_stream_bw``) —
    the reason XUFS stripes transfers (§3.3);
  * the aggregate link caps at ``link_bw`` (``stream_time`` grants each of
    k concurrent streams a ``link_bw / k`` share at most);
  * every transfer pays one ``latency_s``.

NIC model: an endpoint may carry an optional aggregate bandwidth budget
(``set_nic_budget``) shared by its uplink and downlink across ALL pairs.
Each reservation additionally serializes its payload through both
endpoints' NICs at the budget rate; when concurrent reservations across
different pairs oversubscribe an endpoint, completion stretches to the
NIC backlog (``docs/transport.md`` has the math).  With no budget set
the reservation math is bit-for-bit the pure link formula.
``estimated_completion()`` exposes the same arithmetic — static latency
+ channel queue depth + NIC backlog — without reserving, which is what
queue-aware replica routing ranks candidates by.

Failures: ``partition(a, b[, duration])`` makes reservations raise
:class:`DisconnectedError` until ``heal`` (or until the virtual clock passes
the deadline) — this is how tests exercise XUFS disconnected operation.
"""
from __future__ import annotations

import hashlib
import heapq
import hmac as hmac_mod
import os
import secrets
from dataclasses import dataclass, field
from typing import (
    Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple,
)

import numpy as np

KB = 1024
MB = 1024 * 1024
GB = 1024 * 1024 * 1024


class DisconnectedError(ConnectionError):
    """The WAN link between two endpoints is down."""


class QuorumNotReachedError(DisconnectedError):
    """Fewer than W of the N write endpoints acknowledged an apply.

    Subclasses :class:`DisconnectedError` because a missed quorum is a
    connectivity-induced stall: the flusher stops draining and the op
    stays queued (with its partial acks persisted) until links heal.
    """


class AuthError(PermissionError):
    """HMAC challenge failed."""


@dataclass
class LinkModel:
    latency_s: float = 0.030          # one-way WAN latency (SDSC<->NCSA era)
    per_stream_bw: float = 80 * MB    # TCP window-limited single stream
    link_bw: float = 3.75 * GB        # 30 Gbps
    crypto_bw: float = 25 * MB        # single-stream *encrypted* (SCP-like)

    def transfer_time(self, nbytes: int, n_streams: int = 1,
                      encrypted: bool = False) -> float:
        """Aggregate time for ``nbytes`` over ``n_streams`` modeled as ONE
        reservation (the legacy ``rpc(n_streams=...)`` path)."""
        if nbytes <= 0:
            return self.latency_s
        if encrypted:
            eff = min(self.crypto_bw * max(n_streams, 1), self.link_bw)
        else:
            eff = min(self.per_stream_bw * max(n_streams, 1), self.link_bw)
        return self.latency_s + nbytes / eff

    def stream_time(self, nbytes: int, concurrency: int = 1,
                    encrypted: bool = False) -> float:
        """Time for ONE stream carrying ``nbytes`` while ``concurrency``
        streams share the pair: window-limited per-stream bandwidth, but
        never more than an even ``link_bw`` share."""
        if nbytes <= 0:
            return self.latency_s
        bw = self.crypto_bw if encrypted else self.per_stream_bw
        eff = min(bw, self.link_bw / max(concurrency, 1))
        return self.latency_s + nbytes / eff


@dataclass(eq=False)
class Transfer:
    """One reserved channel occupancy: the unit of overlapped time.

    ``start``/``completion`` are virtual-clock times fixed at reservation;
    the global clock advances only when a caller waits on the record.
    Identity (not value) equality: two byte-identical transfers are still
    distinct wire events.
    """

    src: str
    dst: str
    method: str
    nbytes: int
    start: float
    completion: float
    channel: int          # index into the pair's channel pool
    settled: bool = False   # a caller waited on it (or it aged past clock)

    @property
    def elapsed(self) -> float:
        return self.completion - self.start

    @property
    def pair(self) -> Tuple[str, str]:
        return (min(self.src, self.dst), max(self.src, self.dst))

    def settle(self) -> None:
        self.settled = True


class TransferRequest(NamedTuple):
    """One row of a :meth:`Network.transfer_batch` call.  Plain tuples
    of ``(src, dst, method[, nbytes[, concurrency[, encrypted[,
    not_before]]]])`` are accepted too."""

    src: str
    dst: str
    method: str
    nbytes: int = 0
    concurrency: int = 1
    encrypted: bool = False
    not_before: float = 0.0


class TransferBatch:
    """N same-epoch reservations priced in one vectorized pass.

    Carries the reservation results as numpy arrays; the event queue
    holds the whole batch as ONE entry keyed by its max completion, so
    draining a 100k-reservation wave costs one heap pop.  ``transfers``
    materializes per-reservation :class:`Transfer` records lazily (the
    scalar-compatibility view — most batch callers never need it).
    """

    __slots__ = ("srcs", "dsts", "methods", "nbytes", "starts",
                 "completions", "channels", "completion", "settled",
                 "_transfers")

    def __init__(self, srcs: List[str], dsts: List[str],
                 methods: List[str], nbytes: List[int],
                 starts: np.ndarray, completions: np.ndarray,
                 channels: np.ndarray,
                 transfers: Optional[List[Transfer]] = None):
        self.srcs = srcs
        self.dsts = dsts
        self.methods = methods
        self.nbytes = nbytes
        self.starts = starts
        self.completions = completions
        self.channels = channels
        self.completion = float(completions.max()) if len(srcs) else 0.0
        self.settled = False
        self._transfers = transfers

    def __len__(self) -> int:
        return len(self.srcs)

    @property
    def transfers(self) -> List[Transfer]:
        """Per-reservation records (materialized on first access)."""
        if self._transfers is None:
            st = self.starts.tolist()
            co = self.completions.tolist()
            ch = self.channels.tolist()
            self._transfers = [
                Transfer(src=self.srcs[i], dst=self.dsts[i],
                         method=self.methods[i], nbytes=self.nbytes[i],
                         start=st[i], completion=co[i], channel=ch[i],
                         settled=self.settled)
                for i in range(len(self.srcs))
            ]
        return self._transfers

    def settle(self) -> None:
        self.settled = True
        if self._transfers is not None:
            for t in self._transfers:
                t.settled = True


_GROW = 64      # initial/minimum id-table array capacity


@dataclass
class Network:
    """Endpoint registry + per-channel virtual clock + partition schedule.

    The default ``link`` models every pair; ``set_link`` overrides a single
    pair (e.g. a nearby replica site with a fraction of the home RTT).
    Per-endpoint RPC/byte counters let tests and benchmarks assert *where*
    traffic went, not just how much.  ``trace`` records reservations
    ``(src, dst, method, nbytes, channel, start, completion)`` in issue
    order — the determinism witness (same ops => identical trace) — and
    keeps the first ``trace_limit`` so a long-lived network stays
    bounded (truncation is itself deterministic).

    Internally endpoints and pairs are interned to dense integer ids:
    channel ``busy_until`` state is one preallocated ``(n_pairs,
    channels_per_pair)`` float array (an untouched slot at 0.0 is
    indistinguishable from the old create-on-demand channel list), link
    parameters are cached per pair id for the vectorized paths, and
    completions queue in a heap popped in time order.
    """

    link: LinkModel = field(default_factory=LinkModel)
    clock: float = 0.0
    bytes_sent: int = 0
    rpc_count: int = 0
    # byte provenance for replica-apply payloads (wire-free accounting):
    # third-party = moved storage->storage (home->replica or
    # replica->replica); client-mediated = pushed from a client session's
    # endpoint.  The bulk plane's offload witness (docs/maintenance.md).
    bytes_third_party: int = 0
    bytes_client_mediated: int = 0
    channels_per_pair: int = 12       # parallel TCP connections per pair
    trace_limit: int = 100_000        # reservations recorded (first N)
    _partitions: Dict[Tuple[str, str], float] = field(default_factory=dict)
    _endpoints: Dict[str, "Endpoint"] = field(default_factory=dict)
    _links: Dict[Tuple[str, str], LinkModel] = field(default_factory=dict)
    nic_budgets: Dict[str, float] = field(default_factory=dict)
    _nic_free: Dict[str, float] = field(default_factory=dict)
    trace: List[Tuple] = field(default_factory=list)
    # armed FaultInjector (repro_torch.core.faults), pumped lazily before any
    # partition-sensitive operation; None => zero-cost no-op
    _faults: Optional[Any] = None

    def __post_init__(self) -> None:
        w = max(int(self.channels_per_pair), 1)
        # interned ids: endpoint name -> eid, ordered pair -> pid
        self._ep_ids: Dict[str, int] = {}
        self._ep_names: List[str] = []
        self._pair_ids: Dict[Tuple[str, str], int] = {}
        self._pair_keys: List[Tuple[str, str]] = []
        # per-pair channel state + cached link parameters (pid-indexed)
        self._chan_busy = np.zeros((0, w))
        self._pair_lat = np.zeros(0)
        self._pair_psbw = np.zeros(0)
        self._pair_lbw = np.zeros(0)
        self._pair_cbw = np.zeros(0)
        # heap-based event queue: (completion, seq, Transfer|TransferBatch)
        self._event_heap: List[Tuple[float, int, Any]] = []
        self._event_seq = 0
        # accounting: the dicts are the source of truth; batch paths
        # accumulate into id-indexed scratch arrays flushed on read
        self._pe_rpcs: Dict[str, int] = {}
        self._pe_bytes: Dict[str, int] = {}
        self._pe_busy: Dict[str, float] = {}
        self._pp_rpcs: Dict[Tuple[str, str], int] = {}
        self._pp_bytes: Dict[Tuple[str, str], int] = {}
        self._acct_ep_rpcs = np.zeros(0, np.int64)
        self._acct_ep_bytes = np.zeros(0, np.int64)
        self._acct_ep_busy = np.zeros(0)
        self._acct_pair_rpcs = np.zeros(0, np.int64)
        self._acct_pair_bytes = np.zeros(0, np.int64)
        self._acct_dirty = False

    # ---- endpoints ----------------------------------------------------
    def register(self, ep: "Endpoint") -> None:
        self._endpoints[ep.name] = ep
        self._ep_id(ep.name)

    def endpoint(self, name: str) -> "Endpoint":
        return self._endpoints[name]

    def prealloc(self, names: Sequence[str]) -> None:
        """Intern a declared site set up front: endpoint ids plus every
        site-to-site pair, so a fabric's steady-state traffic never pays
        id registration or array growth mid-run."""
        names = list(names)
        for nm in names:
            self._ep_id(nm)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                self.pair_id(a, b)

    def _ep_id(self, name: str) -> int:
        eid = self._ep_ids.get(name)
        if eid is None:
            eid = len(self._ep_names)
            self._ep_ids[name] = eid
            self._ep_names.append(name)
            if eid >= self._acct_ep_rpcs.shape[0]:
                grow = max(_GROW, self._acct_ep_rpcs.shape[0])
                self._acct_ep_rpcs = np.concatenate(
                    [self._acct_ep_rpcs, np.zeros(grow, np.int64)])
                self._acct_ep_bytes = np.concatenate(
                    [self._acct_ep_bytes, np.zeros(grow, np.int64)])
                self._acct_ep_busy = np.concatenate(
                    [self._acct_ep_busy, np.zeros(grow)])
        return eid

    def pair_id(self, a: str, b: str) -> int:
        """Dense id of the unordered ``(a, b)`` pair (interned on first
        use).  Hot drivers may precompute these and hand them to
        :meth:`estimate_batch` to skip per-call name lookups."""
        key = (a, b) if a <= b else (b, a)
        pid = self._pair_ids.get(key)
        if pid is None:
            pid = self._register_pair(key)
        return pid

    def intern_pairs(self, srcs: Sequence[str],
                     dsts: Sequence[str]) -> np.ndarray:
        """Bulk :meth:`pair_id`: intern N ``(src, dst)`` pairs in one
        pass and return their dense ids.  Capacity growth and
        link-parameter caching are amortized over the whole call — the
        setup path for drivers that price the same candidate set every
        wave (precompute once, hand the ids to
        :meth:`estimate_batch`)."""
        pair_ids = self._pair_ids
        pair_keys = self._pair_keys
        first_new = len(pair_keys)
        new_keys: List[Tuple[str, str]] = []
        out: List[int] = []
        append = out.append
        setdefault = pair_ids.setdefault
        nxt = first_new
        for a, b in zip(srcs, dsts):
            key = (a, b) if a <= b else (b, a)
            pid = setdefault(key, nxt)
            if pid == nxt:
                pair_keys.append(key)
                new_keys.append(key)
                nxt += 1
            append(pid)
        if new_keys:
            need = len(pair_keys)
            self._ensure_pair_capacity(need)
            # every new pair rides the network default; the (rare)
            # set_link overrides are fixed up after the bulk fill
            lk = self.link
            sl = slice(first_new, need)
            self._pair_lat[sl] = lk.latency_s
            self._pair_psbw[sl] = lk.per_stream_bw
            self._pair_lbw[sl] = lk.link_bw
            self._pair_cbw[sl] = lk.crypto_bw
            if self._links:
                links = self._links
                for j, key in enumerate(new_keys):
                    ov = links.get(key)
                    if ov is not None:
                        self._cache_pair_link(first_new + j, ov)
        return np.array(out, dtype=np.intp)

    def _ensure_pair_capacity(self, need: int) -> None:
        cap = self._chan_busy.shape[0]
        if need <= cap:
            return
        grow = max(need - cap, _GROW, cap)
        self._chan_busy = np.vstack(
            [self._chan_busy,
             np.zeros((grow, self._chan_busy.shape[1]))])
        z = np.zeros(grow)
        self._pair_lat = np.concatenate([self._pair_lat, z])
        self._pair_psbw = np.concatenate([self._pair_psbw, z.copy()])
        self._pair_lbw = np.concatenate([self._pair_lbw, z.copy()])
        self._pair_cbw = np.concatenate([self._pair_cbw, z.copy()])
        self._acct_pair_rpcs = np.concatenate(
            [self._acct_pair_rpcs, np.zeros(grow, np.int64)])
        self._acct_pair_bytes = np.concatenate(
            [self._acct_pair_bytes, np.zeros(grow, np.int64)])

    def _register_pair(self, key: Tuple[str, str]) -> int:
        pid = len(self._pair_keys)
        self._pair_ids[key] = pid
        self._pair_keys.append(key)
        self._ensure_pair_capacity(pid + 1)
        self._cache_pair_link(pid, self._links.get(key, self.link))
        return pid

    def _cache_pair_link(self, pid: int, lk: LinkModel) -> None:
        self._pair_lat[pid] = lk.latency_s
        self._pair_psbw[pid] = lk.per_stream_bw
        self._pair_lbw[pid] = lk.link_bw
        self._pair_cbw[pid] = lk.crypto_bw

    def _ensure_chan_width(self) -> None:
        # channels_per_pair raised after construction: pad idle columns
        # (a 0.0 column behaves exactly like a newly creatable channel).
        # Lowering it mid-run is unsupported.
        w = self._chan_busy.shape[1]
        cpp = int(self.channels_per_pair)
        if cpp > w:
            self._chan_busy = np.hstack(
                [self._chan_busy,
                 np.zeros((self._chan_busy.shape[0], cpp - w))])

    # ---- per-pair links -------------------------------------------------
    def set_link(self, a: str, b: str, link: LinkModel) -> None:
        key = (min(a, b), max(a, b))
        self._links[key] = link
        pid = self._pair_ids.get(key)
        if pid is not None:
            self._cache_pair_link(pid, link)

    def link_between(self, a: str, b: str) -> LinkModel:
        return self._links.get((min(a, b), max(a, b)), self.link)

    def has_link(self, a: str, b: str) -> bool:
        """Whether the pair carries a specific link (set_link) rather
        than riding the network default."""
        return (min(a, b), max(a, b)) in self._links

    def latency_between(self, a: str, b: str) -> float:
        return self.link_between(a, b).latency_s

    # ---- per-endpoint NIC budgets ---------------------------------------
    def set_nic_budget(self, endpoint: str,
                       bytes_per_s: Optional[float]) -> None:
        """Cap ``endpoint``'s aggregate NIC bandwidth (uplink + downlink
        share it, across ALL pairs).  ``None`` removes the cap — the
        default, under which reservations reproduce the pure link
        formula bit-for-bit."""
        if bytes_per_s is None:
            self.nic_budgets.pop(endpoint, None)
            # drop the serializer backlog too: an uncapped interval
            # drains the queue, so a later re-applied budget must not
            # inherit phantom queueing from before the cap was lifted
            self._nic_free.pop(endpoint, None)
            return
        if bytes_per_s <= 0:
            raise ValueError(f"NIC budget must be > 0: {bytes_per_s}")
        self.nic_budgets[endpoint] = bytes_per_s

    def nic_budget(self, endpoint: str) -> Optional[float]:
        return self.nic_budgets.get(endpoint)

    # ---- byte provenance ------------------------------------------------
    def note_provenance(self, kind: str, nbytes: int) -> None:
        """Attribute ``nbytes`` of replica-apply payload to its source
        class: ``"third_party"`` (storage->storage movement) or
        ``"client_mediated"`` (pushed off a client session's NIC).
        Pure accounting — touches no wire, no clock, no trace."""
        if kind == "third_party":
            self.bytes_third_party += int(nbytes)
        elif kind == "client_mediated":
            self.bytes_client_mediated += int(nbytes)
        else:
            raise ValueError(f"unknown provenance kind: {kind!r}")

    def _charge_nic(self, endpoint: str, start: float, nbytes: int,
                    completion: float) -> float:
        """Serialize ``nbytes`` through ``endpoint``'s NIC at the budget
        rate (FIFO in reservation order — deterministic): the payload's
        NIC service occupies ``[max(backlog, start), +nbytes/budget)``,
        so aggregate bytes through the endpoint can never exceed
        budget x busy-span.  Returns the (possibly stretched)
        completion."""
        bw = self.nic_budgets.get(endpoint)
        if bw is None or nbytes <= 0:
            return completion
        free = max(self._nic_free.get(endpoint, 0.0), start) + nbytes / bw
        self._nic_free[endpoint] = free
        return completion if free <= completion else free

    # ---- time ----------------------------------------------------------
    def advance(self, seconds: float) -> None:
        """Push the clock forward unconditionally (lease-expiry tests and
        workload idle time; data movement should reserve channels)."""
        self.clock += max(seconds, 0.0)
        if self._faults is not None:
            self._faults.advance_to(self.clock)

    def wait(self, t: Transfer) -> float:
        """Block on one transfer: clock lands at its completion (no-op if
        the clock already passed it).  Returns the completion time."""
        t.settled = True
        if t.completion > self.clock:
            self.clock = t.completion
        return t.completion

    def wait_all(self, transfers: Optional[List[Transfer]] = None) -> float:
        """Block on a group (default: everything outstanding): the clock
        advances to the max completion — the overlapped elapsed time."""
        if transfers is None:
            return self._drain_events()
        clock = self.clock
        for t in transfers:
            t.settled = True
            if t.completion > clock:
                clock = t.completion
        self.clock = clock
        return clock

    def wait_batch(self, batch: TransferBatch) -> float:
        """Block on a whole reservation batch: one clock advance to its
        max completion (``wait_all(batch.transfers)`` without ever
        materializing the per-reservation records)."""
        batch.settle()
        if batch.completion > self.clock:
            self.clock = batch.completion
        return batch.completion

    def drain(self) -> float:
        """Settle every outstanding transfer (fire-and-forget fan-out,
        pipelined fills) and return the clock."""
        return self._drain_events()

    def _drain_events(self) -> float:
        """Pop the event queue dry in completion order; the clock lands
        on the last (= max) completion popped."""
        h = self._event_heap
        clock = self.clock
        while h:
            completion, _seq, item = heapq.heappop(h)
            item.settle()
            if completion > clock:
                clock = completion
        self.clock = clock
        return clock

    def _push_event(self, completion: float, item: Any) -> None:
        """Queue a completion event; entries the clock already passed
        are pruned from the top on the way in (amortized O(1)), so
        fire-and-forget traffic never grows the queue."""
        h = self._event_heap
        clock = self.clock
        while h and h[0][0] <= clock:
            heapq.heappop(h)[2].settle()
        self._event_seq += 1
        heapq.heappush(h, (completion, self._event_seq, item))

    def outstanding(self) -> List[Transfer]:
        """Transfers still in flight at the current clock (issue order).
        Diagnostic view — materializes batched reservations."""
        h = self._event_heap
        clock = self.clock
        while h and h[0][0] <= clock:
            heapq.heappop(h)[2].settle()
        live: List[Tuple[int, int, Transfer]] = []
        for completion, seq, item in h:
            if item.settled:
                continue
            if isinstance(item, TransferBatch):
                live.extend((seq, i, t)
                            for i, t in enumerate(item.transfers)
                            if t.completion > clock and not t.settled)
            elif completion > clock:
                live.append((seq, 0, item))
        live.sort(key=lambda e: (e[0], e[1]))
        return [t for _seq, _i, t in live]

    # ---- failures --------------------------------------------------------
    def arm_faults(self, injector: Any) -> None:
        """Attach a :class:`repro_torch.core.faults.FaultInjector`.  Scheduled
        events fire lazily: any partition-sensitive operation (and
        :meth:`advance`) first releases every event whose time the clock
        has reached.  Pass ``None`` to disarm."""
        self._faults = injector

    def _pump_faults(self) -> None:
        f = self._faults
        if f is not None:
            f.advance_to(self.clock)

    def partition(self, a: str, b: str, duration: float = float("inf"),
                  *, start: Optional[float] = None):
        """Cut the ``a <-> b`` link.  ``start`` anchors the outage window
        at an earlier virtual time (fault plans fire lazily, so the
        window must not depend on when the pump happened to run); a
        window already fully in the past is a no-op."""
        t0 = self.clock if start is None else start
        until = t0 + duration
        if until <= self.clock:
            return
        self._partitions[(min(a, b), max(a, b))] = until

    def heal(self, a: str, b: str) -> None:
        self._partitions.pop((min(a, b), max(a, b)), None)

    def is_partitioned(self, a: str, b: str) -> bool:
        if self._faults is not None:
            self._faults.advance_to(self.clock)
        key = (min(a, b), max(a, b))
        until = self._partitions.get(key)
        if until is None:
            return False
        if self.clock >= until:
            del self._partitions[key]
            return False
        return True

    # ---- data plane ------------------------------------------------------
    def _peek_reserve(self, pair: Tuple[str, str],
                      not_before: float = 0.0) -> Tuple[int, float, bool]:
        """The channel :meth:`_reserve` would pick, without reserving:
        the lowest-index idle one (an untouched array slot at 0.0 IS the
        old "new channel"), else the earliest-free channel by argmin.
        Returns (index, start time, whether the pair is untouched)."""
        t0 = self.clock if self.clock >= not_before else not_before
        pid = self._pair_ids.get(pair)
        if pid is None:
            return 0, t0, True
        self._ensure_chan_width()
        row = self._chan_busy[pid]
        busy = row.tolist()
        for i, b in enumerate(busy):
            if b <= t0:
                return i, t0, False
        i = int(row.argmin())
        b = busy[i]
        return i, (b if b > t0 else t0), False

    def _reserve(self, pair: Tuple[str, str],
                 not_before: float = 0.0) -> Tuple[int, float]:
        """Pick a channel deterministically and claim it."""
        i, start, new = self._peek_reserve(pair, not_before)
        if new:
            self._register_pair(pair)
        return i, start

    def estimated_completion(self, src: str, dst: str, nbytes: int = 0,
                             *, not_before: float = 0.0) -> float:
        """Completion time a single-stream transfer reserved *now* would
        get — static link time + channel queue depth + NIC backlog at
        both endpoints — WITHOUT reserving anything.  A partitioned pair
        estimates to ``inf``.  This is the queue-aware routing metric:
        for an idle network it reduces to ``clock + latency +
        nbytes/eff``, so ranking by it degenerates to the static
        nearest-by-latency order."""
        if self.is_partitioned(src, dst):
            return float("inf")
        pair = (min(src, dst), max(src, dst))
        _i, start, _new = self._peek_reserve(pair, not_before)
        completion = start + self.link_between(src, dst).stream_time(nbytes)
        if nbytes > 0:
            for ep in (src, dst):
                bw = self.nic_budgets.get(ep)
                if bw is not None:
                    backlog = max(self._nic_free.get(ep, 0.0), start)
                    completion = max(completion, backlog + nbytes / bw)
        return completion

    def estimate_batch(self, srcs, dsts, nbytes=0, *,
                       not_before: float = 0.0,
                       pair_ids: Optional[np.ndarray] = None) -> np.ndarray:
        """Vectorized :meth:`estimated_completion` over N candidate
        routes in one pass — the queue-aware routing metric for a whole
        wave.  ``srcs``/``dsts`` are name sequences (either may be a
        single string, broadcast against the other); ``nbytes`` and
        ``not_before`` are scalars or per-candidate arrays.  Read-only:
        nothing is reserved, so duplicate pairs are fine.  Element i is
        float-identical to ``estimated_completion(srcs[i], dsts[i],
        ...)`` called in isolation.  ``pair_ids`` (from
        :meth:`pair_id`) skips the per-call name interning for hot
        drivers."""
        if isinstance(srcs, str):
            srcs = [srcs] * (1 if isinstance(dsts, str) else len(dsts))
        if isinstance(dsts, str):
            dsts = [dsts] * len(srcs)
        n = len(srcs)
        if n == 0:
            return np.zeros(0)
        if pair_ids is None:
            pair_ids = np.array(
                [self.pair_id(s, d) for s, d in zip(srcs, dsts)],
                dtype=np.intp)
        self._ensure_chan_width()
        rows = self._chan_busy[pair_ids]
        nb = np.asarray(nbytes, dtype=np.float64)
        if nb.ndim == 0:
            nb = np.full(n, float(nb))
        t0 = np.maximum(
            np.broadcast_to(np.asarray(not_before, dtype=np.float64), (n,)),
            self.clock)
        has_idle = (rows <= t0[:, None]).any(axis=1)
        start = np.where(has_idle, t0, rows.min(axis=1))
        lat = self._pair_lat[pair_ids]
        eff = np.minimum(self._pair_psbw[pair_ids], self._pair_lbw[pair_ids])
        est = start + np.where(nb > 0, lat + nb / eff, lat)
        if self.nic_budgets:
            budgets = self.nic_budgets
            nic_free = self._nic_free
            st_l = start.tolist()
            est_l = est.tolist()
            nb_l = nb.tolist()
            touched = False
            for i in range(n):
                nbi = nb_l[i]
                if nbi <= 0:
                    continue
                c = est_l[i]
                for ep in (srcs[i], dsts[i]):
                    bw = budgets.get(ep)
                    if bw is not None:
                        backlog = max(nic_free.get(ep, 0.0), st_l[i])
                        v = backlog + nbi / bw
                        if v > c:
                            c = v
                if c != est_l[i]:
                    est_l[i] = c
                    touched = True
            if touched:
                est = np.array(est_l)
        if self._faults is not None:
            self._faults.advance_to(self.clock)
        if self._partitions:
            for i in range(n):
                if self.is_partitioned(srcs[i], dsts[i]):
                    est[i] = np.inf
        return est

    def transfer(self, src: str, dst: str, method: str,
                 payload_bytes: int = 0, *, n_streams: int = 1,
                 concurrency: int = 1, encrypted: bool = False,
                 not_before: float = 0.0) -> Transfer:
        """Reserve a channel for one transfer; the clock does NOT move.

        ``concurrency`` declares how many sibling streams share the pair
        right now (per-stripe bandwidth share); ``n_streams > 1`` instead
        models an n-stream aggregate as one reservation (legacy RPC
        surface).  ``not_before`` chains causally-dependent transfers
        (an ack cannot start before its data lands).  The caller later
        advances the clock via ``wait``/``wait_all``/``drain``.
        """
        if self._faults is not None:
            self._faults.advance_to(self.clock)
        if self._partitions and self.is_partitioned(src, dst):
            raise DisconnectedError(f"{src} <-> {dst} partitioned")
        key = (src, dst) if src <= dst else (dst, src)
        link = self._links.get(key)
        if link is None:
            link = self.link
        if n_streams > 1:
            dt = link.transfer_time(payload_bytes, n_streams, encrypted)
        else:
            dt = link.stream_time(payload_bytes, concurrency, encrypted)
        pid = self._pair_ids.get(key)
        if pid is None:
            pid = self._register_pair(key)
        self._ensure_chan_width()
        row = self._chan_busy[pid]
        t0 = self.clock if self.clock >= not_before else not_before
        busy = row.tolist()
        channel = -1
        start = t0
        for i, b in enumerate(busy):
            if b <= t0:
                channel = i
                break
        if channel < 0:
            channel = int(row.argmin())
            b = busy[channel]
            if b > t0:
                start = b
        completion = start + dt
        # both NICs serialize the payload at their budget rate; an
        # oversubscribed endpoint stretches completion to its backlog
        if self.nic_budgets:
            completion = self._charge_nic(src, start, payload_bytes,
                                          completion)
            completion = self._charge_nic(dst, start, payload_bytes,
                                          completion)
        self._chan_busy[pid, channel] = completion
        t = Transfer(src=src, dst=dst, method=method, nbytes=payload_bytes,
                     start=start, completion=completion, channel=channel)
        self._push_event(completion, t)
        if len(self.trace) < self.trace_limit:
            self.trace.append((src, dst, method, payload_bytes, channel,
                               round(start, 9), round(completion, 9)))
        self.bytes_sent += payload_bytes
        self.rpc_count += 1
        pe = self._pe_rpcs
        pe[src] = pe.get(src, 0) + 1
        pe[dst] = pe.get(dst, 0) + 1
        pb = self._pe_bytes
        pb[src] = pb.get(src, 0) + payload_bytes
        pb[dst] = pb.get(dst, 0) + payload_bytes
        dur = completion - start
        bz = self._pe_busy
        bz[src] = bz.get(src, 0.0) + dur
        bz[dst] = bz.get(dst, 0.0) + dur
        self._pp_rpcs[key] = self._pp_rpcs.get(key, 0) + 1
        self._pp_bytes[key] = self._pp_bytes.get(key, 0) + payload_bytes
        return t

    def transfer_batch(self, reqs: Sequence, *,
                       pair_ids: Optional[np.ndarray] = None
                       ) -> TransferBatch:
        """Reserve N transfers in one same-epoch pass; the clock does
        NOT move.  ``reqs`` rows are :class:`TransferRequest` (or plain
        ``(src, dst, method[, nbytes[, concurrency[, encrypted[,
        not_before]]]])`` tuples).  ``pair_ids`` (from :meth:`pair_id` /
        :meth:`intern_pairs`, one id per row) skips the per-row pair
        interning for hot drivers — it must describe exactly these rows.

        Contract: the resulting channel/NIC state, accounting, and trace
        are identical to issuing the rows one at a time with
        :meth:`transfer` in order.  Batches whose pairs are all distinct
        take a fully vectorized path (same-epoch rows on distinct pairs
        cannot interact, so pricing them simultaneously IS sequential
        pricing); duplicate-pair batches fall back to the sequential
        scalar path, as does any batch touching a partitioned pair
        (which must raise mid-application exactly where a sequential
        caller would)."""
        reqs = reqs if isinstance(reqs, list) else list(reqs)
        n = len(reqs)
        if n == 0:
            empty = np.zeros(0)
            b = TransferBatch([], [], [], [], empty, empty,
                              np.zeros(0, np.intp), transfers=[])
            b.completion = self.clock
            b.settled = True
            return b
        lens = set(map(len, reqs))
        if len(lens) == 1:
            # uniform-arity rows: transpose at C speed
            lr = lens.pop()
            cols = list(zip(*reqs))
            srcs = list(cols[0])
            dsts = list(cols[1])
            methods = list(cols[2])
            nbs = list(cols[3]) if lr > 3 else [0] * n
            concs = list(cols[4]) if lr > 4 else [1] * n
            encs = list(cols[5]) if lr > 5 else [False] * n
            nbefs = list(cols[6]) if lr > 6 else [0.0] * n
        else:
            srcs, dsts, methods = [], [], []
            nbs, concs, encs, nbefs = [], [], [], []
            for r in reqs:
                lr = len(r)
                srcs.append(r[0])
                dsts.append(r[1])
                methods.append(r[2])
                nbs.append(r[3] if lr > 3 else 0)
                concs.append(r[4] if lr > 4 else 1)
                encs.append(r[5] if lr > 5 else False)
                nbefs.append(r[6] if lr > 6 else 0.0)
        sequential = False
        if self._faults is not None:
            self._faults.advance_to(self.clock)
        if self._partitions:
            for src, dst in zip(srcs, dsts):
                if self.is_partitioned(src, dst):
                    sequential = True
                    break
        if pair_ids is not None:
            pid_arr = np.asarray(pair_ids, dtype=np.intp)
            if not sequential and np.unique(pid_arr).size != n:
                sequential = True
        else:
            table = self._pair_ids
            pids: List[int] = []
            seen: set = set()
            for src, dst in zip(srcs, dsts):
                key = (src, dst) if src <= dst else (dst, src)
                pid = table.get(key)
                if pid is None:
                    pid = self._register_pair(key)
                if pid in seen:
                    sequential = True
                else:
                    seen.add(pid)
                pids.append(pid)
            pid_arr = np.array(pids, dtype=np.intp)
        if sequential:
            # duplicate pairs interact through channel state (and a
            # partitioned pair must raise after the partial prefix
            # applied), so replay through the scalar path — exactly what
            # the contract promises anyway
            ts = [self.transfer(srcs[i], dsts[i], methods[i], nbs[i],
                                concurrency=concs[i], encrypted=encs[i],
                                not_before=nbefs[i])
                  for i in range(n)]
            return TransferBatch(
                srcs, dsts, methods, nbs,
                np.array([t.start for t in ts]),
                np.array([t.completion for t in ts]),
                np.array([t.channel for t in ts], dtype=np.intp),
                transfers=ts)
        self._ensure_chan_width()
        nb_arr = np.array(nbs, dtype=np.float64)
        t0 = np.maximum(np.array(nbefs, dtype=np.float64), self.clock)
        rows = self._chan_busy[pid_arr]
        le = rows <= t0[:, None]
        has_idle = le.any(axis=1)
        # np.argmax/argmin return the FIRST hit — the scalar tie-breaks
        chan = np.where(has_idle, le.argmax(axis=1), rows.argmin(axis=1))
        start = np.maximum(rows[np.arange(n), chan], t0)
        lat = self._pair_lat[pid_arr]
        bw = np.where(np.array(encs, dtype=bool),
                      self._pair_cbw[pid_arr], self._pair_psbw[pid_arr])
        eff = np.minimum(
            bw, self._pair_lbw[pid_arr] /
            np.maximum(np.array(concs, dtype=np.int64), 1))
        completion = start + np.where(nb_arr > 0, lat + nb_arr / eff, lat)
        if self.nic_budgets:
            budgets = self.nic_budgets
            if any(s in budgets or d in budgets
                   for s, d in zip(srcs, dsts)):
                # the NIC backlog is a serial max/add chain — replaying
                # it per budgeted endpoint in request order (src before
                # dst, as the scalar path charges) is the only
                # bit-exact evaluation
                nic_free = self._nic_free
                st_l = start.tolist()
                co_l = completion.tolist()
                for i in range(n):
                    nb = nbs[i]
                    if nb <= 0:
                        continue
                    c = co_l[i]
                    s = st_l[i]
                    for ep in (srcs[i], dsts[i]):
                        bwd = budgets.get(ep)
                        if bwd is not None:
                            free = max(nic_free.get(ep, 0.0), s) + nb / bwd
                            nic_free[ep] = free
                            if free > c:
                                c = free
                    co_l[i] = c
                completion = np.array(co_l)
        self._chan_busy[pid_arr, chan] = completion
        batch = TransferBatch(srcs, dsts, methods, nbs, start, completion,
                              chan)
        self._push_event(batch.completion, batch)
        if len(self.trace) < self.trace_limit:
            room = self.trace_limit - len(self.trace)
            st_l = start.tolist()
            co_l = completion.tolist()
            ch_l = chan.tolist()
            trace = self.trace
            for i in range(n if n < room else room):
                # Python round, not np.round: the trace is the
                # bit-identity witness against the scalar path
                trace.append((srcs[i], dsts[i], methods[i], nbs[i],
                              ch_l[i], round(st_l[i], 9),
                              round(co_l[i], 9)))
        self.bytes_sent += int(sum(nbs))
        self.rpc_count += n
        # fast path when every endpoint is already interned (steady
        # state); first contact falls back to the registering loop
        d = self._ep_ids
        try:
            sid = np.fromiter(map(d.__getitem__, srcs), np.intp, n)
            did = np.fromiter(map(d.__getitem__, dsts), np.intp, n)
        except KeyError:
            sid = np.array([self._ep_id(s) for s in srcs], dtype=np.intp)
            did = np.array([self._ep_id(d) for d in dsts], dtype=np.intp)
        nb_i = np.array(nbs, dtype=np.int64)
        dur = completion - start
        np.add.at(self._acct_ep_rpcs, sid, 1)
        np.add.at(self._acct_ep_rpcs, did, 1)
        np.add.at(self._acct_ep_bytes, sid, nb_i)
        np.add.at(self._acct_ep_bytes, did, nb_i)
        np.add.at(self._acct_ep_busy, sid, dur)
        np.add.at(self._acct_ep_busy, did, dur)
        np.add.at(self._acct_pair_rpcs, pid_arr, 1)
        np.add.at(self._acct_pair_bytes, pid_arr, nb_i)
        self._acct_dirty = True
        return batch

    def rpc(self, src: str, dst: str, method: str, payload_bytes: int = 0,
            n_streams: int = 1, encrypted: bool = False) -> float:
        """Synchronous request/response: reserve a channel and wait on it.
        Returns the elapsed seconds the caller observed (queueing
        included) — identical to the pre-channel-clock behavior whenever
        the pair has an idle channel."""
        t0 = self.clock
        self.wait(self.transfer(src, dst, method, payload_bytes,
                                n_streams=n_streams, encrypted=encrypted))
        return self.clock - t0

    # ---- accounting ------------------------------------------------------
    def _flush_accounting(self) -> None:
        """Fold the batch scratch arrays into the counter dicts.  All
        counters are commutative sums, so interleaved scalar updates and
        deferred batch flushes land on the same totals."""
        self._acct_dirty = False
        er = self._acct_ep_rpcs
        idx = np.nonzero(er)[0]
        if idx.size:
            eb = self._acct_ep_bytes
            ez = self._acct_ep_busy
            for i in idx.tolist():
                name = self._ep_names[i]
                self._pe_rpcs[name] = self._pe_rpcs.get(name, 0) + int(er[i])
                self._pe_bytes[name] = \
                    self._pe_bytes.get(name, 0) + int(eb[i])
                self._pe_busy[name] = \
                    self._pe_busy.get(name, 0.0) + float(ez[i])
            er[idx] = 0
            eb[idx] = 0
            ez[idx] = 0.0
        pr = self._acct_pair_rpcs
        idx = np.nonzero(pr)[0]
        if idx.size:
            pb = self._acct_pair_bytes
            for i in idx.tolist():
                key = self._pair_keys[i]
                self._pp_rpcs[key] = self._pp_rpcs.get(key, 0) + int(pr[i])
                self._pp_bytes[key] = \
                    self._pp_bytes.get(key, 0) + int(pb[i])
            pr[idx] = 0
            pb[idx] = 0

    @property
    def per_endpoint_rpcs(self) -> Dict[str, int]:
        if self._acct_dirty:
            self._flush_accounting()
        return self._pe_rpcs

    @property
    def per_endpoint_bytes(self) -> Dict[str, int]:
        if self._acct_dirty:
            self._flush_accounting()
        return self._pe_bytes

    @property
    def per_endpoint_busy_s(self) -> Dict[str, float]:
        if self._acct_dirty:
            self._flush_accounting()
        return self._pe_busy

    @property
    def per_pair_rpcs(self) -> Dict[Tuple[str, str], int]:
        if self._acct_dirty:
            self._flush_accounting()
        return self._pp_rpcs

    @property
    def per_pair_bytes(self) -> Dict[Tuple[str, str], int]:
        if self._acct_dirty:
            self._flush_accounting()
        return self._pp_bytes

    def pair_rpcs(self, a: str, b: str) -> int:
        """RPCs that crossed the ``a <-> b`` link (ack accounting reads
        this to assert quorum round-trips went over the right pairs)."""
        if self._acct_dirty:
            self._flush_accounting()
        return self._pp_rpcs.get((min(a, b), max(a, b)), 0)

    def account(self, endpoint: str, payload_bytes: int = 0,
                rpcs: int = 1) -> None:
        """Attribute traffic to one end of a link (rpc charges both ends,
        so ``per_endpoint_rpcs[name]`` reads as 'traffic touching name')."""
        self._pe_rpcs[endpoint] = self._pe_rpcs.get(endpoint, 0) + rpcs
        self._pe_bytes[endpoint] = \
            self._pe_bytes.get(endpoint, 0) + payload_bytes


@dataclass
class Endpoint:
    """A named party on the network (home workstation, pod host, ...)."""

    name: str
    network: Network

    def __post_init__(self) -> None:
        self.network.register(self)

    def call(self, dst: str, method: str, payload_bytes: int = 0,
             n_streams: int = 1, encrypted: bool = False) -> float:
        return self.network.rpc(self.name, dst, method, payload_bytes,
                                n_streams, encrypted)


# ---------------------------------------------------------------------------
# USSH-style <key, phrase> challenge authentication (paper §3.2)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KeyPhrase:
    key: str
    phrase: str

    @classmethod
    def generate(cls) -> "KeyPhrase":
        return cls(key=secrets.token_hex(16), phrase=secrets.token_hex(16))


def make_challenge() -> str:
    return secrets.token_hex(16)


def respond(kp: KeyPhrase, challenge: str) -> str:
    return hmac_mod.new(kp.key.encode(), (challenge + kp.phrase).encode(),
                        hashlib.sha256).hexdigest()


def verify(kp: KeyPhrase, challenge: str, response: str) -> bool:
    return hmac_mod.compare_digest(respond(kp, challenge), response)
