"""Multi-site replica fabric: catalog, nearest-replica reads, fan-out.

XUFS as published assumes a single authoritative home store; this module
adds SCISPACE-style per-site read replicas on top of the same
``Network``/``HomeStore`` fabric, following the GridFTP replica-management
recipe (replica catalog + striped transfer):

  * :class:`ReplicaCatalog` maps ``path -> {endpoint: version}`` plus the
    home's latest version per path.  A holder is *fresh* iff its version is
    at least the home version the catalog has seen — callback notifications
    from the home store keep the catalog current, so a stale replica drops
    out of the read path the moment home changes (the replica-side
    equivalent of ``cache.INVALID``).
  * :class:`ReplicaSet` places the replicas, routes reads to the fresh
    holder with the lowest *estimated completion* — static latency plus
    channel queue depth plus NIC backlog, so a hammered replica sheds
    reads to the next-nearest fresh holder (home is always the terminal
    fallback, whatever its queue) —
    fans writes out home-first-then-replicas under a W-of-N ack policy
    (``write_quorum``; see ``docs/consistency.md``) so a lagging or
    partitioned replica never blocks the client below W — and a
    partitioned *home* no longer stalls writes when W > 1 — and repairs
    divergence via ``resync()`` (anti-entropy over the home version
    vector).

The catalog is metadata colocated with the home service and mirrored to
clients over the callback channel; lookups are therefore modeled as free —
only data movement and per-operation RPCs charge the virtual clock.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple, Union

from repro_torch.core.bulk import BulkSpec
from repro_torch.core.oplog import vts_merge
from repro_torch.core.store import HomeStore, ObjectStat
from repro_torch.core.striping import StripedTransfer, TransferGroup
from repro_torch.core.transport import (
    AuthError, DisconnectedError, Network, Transfer, respond,
)


class WriteLeaseContended(DisconnectedError):
    """Another writer holds the per-path write lease on a common
    replica.  Subclasses :class:`DisconnectedError` on purpose: the
    flusher treats it like a WAN fault — the drain stops, the op stays
    queued, and the next pump retries (by which time the holder has
    reconciled or its short TTL lapsed)."""

#: A read source the client can try: (endpoint name, store, auth token).
ReadSource = Tuple[str, HomeStore, str]

#: Write-ack policy: an explicit W, or "majority" / "all" of the N
#: endpoints (home + replicas).  W=1 degenerates to the legacy policy —
#: the home apply alone is the ack and replica fan-out stays best-effort.
WritePolicy = Union[int, str]

#: Nominal payload the router prices a candidate with when the caller
#: does not know the object size yet (a cold ``open`` learns the size
#: only after choosing a source).  Large enough that NIC backlog and
#: queue depth dominate latency on a loaded endpoint, small enough that
#: an idle network still ranks by pure latency.
ROUTE_PROBE_BYTES = 1024 * 1024


#: Shared empty result for directories the catalog knows nothing under.
_NO_PATHS: Set[str] = frozenset()   # type: ignore[assignment]


@dataclass(frozen=True)
class WriteLeaseSpec:
    """Per-path write leases over the replica set for quorum writes
    around a dead home.

    Before assigning a client-side version, the flusher must hold a
    short-TTL lease on **every** replica it can reach (owner
    ``write:<user>``, the PR 6 owner-prefix pattern) — so two sessions
    writing one path during the same outage serialize whenever any
    common replica is reachable: the second writer's drain defers
    (:class:`WriteLeaseContended`) and retries after the first
    reconciles or the TTL lapses, by which point it observes the first
    write's vector timestamp and lands causally *after* it instead of
    concurrently.  Under a full partition (no replica reachable) writes
    fall back to vector-timestamp tagging and conflict detection at
    reconcile.  Unset (``ReplicaPolicy.write_lease=None``) keeps the
    write path lease-free and every trace bit-identical.
    """

    ttl_s: float = 10.0

    def __post_init__(self) -> None:
        if self.ttl_s <= 0:
            raise ValueError(
                f"WriteLeaseSpec.ttl_s must be > 0: {self.ttl_s}")


@dataclass(frozen=True)
class EvictionSpec:
    """Capacity-aware placement/eviction policy for one home space's
    replicas (GridFTP replica-management line: placement under finite
    replica storage is *the* wide-area problem).

    ``capacity`` bounds each replica's resident bytes; the scheduled
    ``evict:`` task scans every ``scan_period_s`` and, once resident
    bytes cross ``high_watermark * capacity``, evicts candidates ranked
    by ``policy`` — ``"lru"`` (coldest last-touch first) or
    ``"fill_cost"`` (fewest fills served first, LRU tie-break, i.e.
    least projected refill traffic) — down to
    ``low_watermark * capacity``.  A capacity-bounded replica also stops
    mirroring the home space: resync refreshes only what is already
    resident, and placement happens on demand via read repair
    (``docs/maintenance.md``).  Unset (``ReplicaPolicy.eviction=None``)
    keeps replicas unbounded and every trace bit-identical.
    """

    capacity: int
    high_watermark: float = 0.9
    low_watermark: float = 0.6
    policy: str = "lru"
    scan_period_s: float = 10.0

    def __post_init__(self) -> None:
        if self.capacity <= 0:
            raise ValueError(
                f"EvictionSpec.capacity must be > 0 bytes: {self.capacity}")
        if not (0.0 < self.low_watermark <= self.high_watermark <= 1.0):
            raise ValueError(
                "watermarks must satisfy 0 < low <= high <= 1: "
                f"low={self.low_watermark}, high={self.high_watermark}")
        if self.policy not in ("lru", "fill_cost"):
            raise ValueError(
                f"eviction policy must be 'lru' or 'fill_cost': "
                f"{self.policy!r}")
        if self.scan_period_s <= 0:
            raise ValueError(
                f"scan_period_s must be > 0: {self.scan_period_s}")

    @property
    def high_bytes(self) -> int:
        """Resident bytes beyond which a scan starts evicting."""
        return int(self.high_watermark * self.capacity)

    @property
    def low_bytes(self) -> int:
        """The scan's target: evict until resident bytes <= this."""
        return int(self.low_watermark * self.capacity)


class ReplicaCatalog:
    """``path -> {endpoint: version}`` plus the home version per path.

    ``quorum_versions`` additionally tracks versions that reached a write
    quorum while home was partitioned: freshness is judged against the
    newest version known on *either* channel, so a read may be served
    fresh from an acked replica even when home has never seen the write.
    """

    def __init__(self) -> None:
        self.home_versions: Dict[str, int] = {}
        self.quorum_versions: Dict[str, int] = {}
        self._holders: Dict[str, Dict[str, int]] = {}
        #: True once the FULL home version vector has been learned
        #: (resync/reattach).  Until then the catalog only knows changes
        #: it witnessed, so it cannot prove a listing complete — objects
        #: that predate the subscription may exist at home unseen.
        self.vector_learned = False
        #: Bumped on every state change — memoized routes key on it.
        self.gen = 0
        # per-directory index: "a/b/" -> every known path under it (any
        # depth), so route_meta never scans the whole catalog per call.
        # Paths are never unindexed: a deletion keeps its (negative-
        # version) catalog entry, and consumers filter by freshness floor.
        self._by_dir: Dict[str, Set[str]] = {}
        self._indexed: Set[str] = set()

    def _index(self, path: str) -> None:
        if path in self._indexed:
            return
        self._indexed.add(path)
        parts = path.split("/")
        for i in range(1, len(parts)):
            d = "/".join(parts[:i]) + "/"
            self._by_dir.setdefault(d, set()).add(path)

    def paths_under(self, dir_prefix: str) -> Set[str]:
        """Known paths under the directory (``dir_prefix`` ends with
        "/"); directory-boundary match, same as the old linear scan.

        Returns a live READ-ONLY view of the index (an empty frozenset
        for unknown directories) — callers must copy before mutating,
        or they corrupt the index behind the catalog's back."""
        return self._by_dir.get(dir_prefix, _NO_PATHS)

    # ---- home side -------------------------------------------------------
    def note_home(self, path: str, version: int) -> None:
        changed = self.home_versions.get(path) != version
        self.home_versions[path] = version
        self._index(path)
        qv = self.quorum_versions.get(path)
        if qv is not None and version >= qv:
            # home caught up with the quorum write: single authority again
            del self.quorum_versions[path]
            changed = True
        if changed:
            self.gen += 1

    def home_version(self, path: str) -> Optional[int]:
        return self.home_versions.get(path)

    # ---- quorum side -----------------------------------------------------
    def note_quorum(self, path: str, version: int) -> None:
        """A W-of-N quorum acked ``version`` with home unreachable."""
        if version > self.quorum_versions.get(path, 0):
            self.quorum_versions[path] = version
            self._index(path)
            self.gen += 1

    def forget_quorum(self, path: str) -> None:
        """Drop the quorum-side floor (the path was deleted or home
        re-learned it through another channel)."""
        if self.quorum_versions.pop(path, None) is not None:
            self.gen += 1

    def freshness_floor(self, path: str) -> Optional[int]:
        """Newest version known home-side or via a quorum ack."""
        hv = self.home_versions.get(path)
        qv = self.quorum_versions.get(path)
        if qv is not None and (hv is None or qv > hv):
            return qv
        return hv

    # ---- holders ---------------------------------------------------------
    def record(self, path: str, endpoint: str, version: int) -> None:
        holders = self._holders.setdefault(path, {})
        if holders.get(endpoint) != version:
            holders[endpoint] = version
            self.gen += 1

    def drop(self, path: str, endpoint: Optional[str] = None) -> None:
        if endpoint is None:
            if self._holders.pop(path, None) is not None:
                self.gen += 1
            return
        holders = self._holders.get(path)
        if holders is not None and holders.pop(endpoint, None) is not None:
            self.gen += 1

    def version_at(self, path: str, endpoint: str) -> Optional[int]:
        return self._holders.get(path, {}).get(endpoint)

    def paths_at(self, endpoint: str) -> List[str]:
        return [p for p, h in self._holders.items() if endpoint in h]

    def fresh_holders(self, path: str) -> List[str]:
        """Endpoints holding a version at least as new as the floor.

        The floor is the newest version seen from home *or* acked by a
        write quorum — a replica that acked a quorum write serves it fresh
        even while home is partitioned.  An unknown floor means the
        catalog never saw the object — only home can be trusted.  A
        negative floor is a deletion: nothing is fresh.
        """
        hv = self.freshness_floor(path)
        if hv is None or hv < 0:
            return []
        return [ep for ep, v in self._holders.get(path, {}).items()
                if v >= hv]


@dataclass
class Replica:
    """One per-site read replica: a HomeStore at its own endpoint.

    Byte accounting (``resident``/``resident_bytes``/``peak``) and the
    touch/fill clocks are maintained for every replica — they are free
    metadata — but only a capacity-bounded replica (an
    :class:`EvictionSpec` on the set) acts on them.
    """

    name: str
    store: HomeStore
    token: str
    lagging: Set[str] = field(default_factory=set)   # paths needing repair
    #: path -> bytes held here (the resident set the eviction scan ranks)
    resident: Dict[str, int] = field(default_factory=dict)
    resident_bytes: int = 0
    #: high-water mark of resident_bytes — the capacity gate's witness
    peak_resident_bytes: int = 0
    #: path -> virtual clock of the last fill this replica served or
    #: received (the LRU clock)
    last_touch: Dict[str, float] = field(default_factory=dict)
    #: path -> cache fills this replica served (the fill-cost signal)
    fills: Dict[str, int] = field(default_factory=dict)
    evictions: int = 0


@dataclass
class PendingApply:
    """One in-flight replica apply: stripes on the wire plus the chained
    ack round-trip.  ``ack.completion`` is when the endpoint counts
    toward the write quorum."""

    name: str
    path: str
    data: bytes
    version: int
    src: str
    group: TransferGroup
    ack: Transfer
    #: vector timestamp riding the apply (None on legacy/untagged paths)
    vts: Optional[Dict[str, int]] = None


class ReplicaSet:
    """Places, routes to, and repairs the read replicas of one home space."""

    def __init__(self, network: Network, home_name: str,
                 home_store: HomeStore, token: str,
                 write_quorum: WritePolicy = 1,
                 queue_aware: bool = True,
                 capacity_bytes: Optional[int] = None,
                 eviction: Optional[EvictionSpec] = None,
                 write_lease: Optional[WriteLeaseSpec] = None,
                 bulk: Optional[BulkSpec] = None):
        if capacity_bytes is not None:
            # deprecated alias (the PR 5 seam): assembles the structured
            # spec — ReplicaPolicy warns; this low-level path stays quiet
            if capacity_bytes <= 0:
                raise ValueError(
                    f"capacity_bytes must be > 0 (or None = unbounded): "
                    f"{capacity_bytes}")
            if eviction is not None and eviction.capacity != capacity_bytes:
                raise ValueError(
                    f"conflicting capacity_bytes={capacity_bytes} and "
                    f"eviction.capacity={eviction.capacity}; drop the "
                    "deprecated alias")
            if eviction is None:
                eviction = EvictionSpec(capacity=capacity_bytes)
        self.network = network
        self.home_name = home_name
        self.home_store = home_store
        self.token = token
        self.write_quorum = write_quorum
        #: Per-replica placement/eviction policy.  None = unbounded:
        #: replicas mirror the whole home space and no accounting is
        #: acted on (traces bit-identical to the pre-eviction fabric).
        self.eviction = eviction
        #: Rank read sources / fan-out targets by estimated completion
        #: (latency + channel queue + NIC backlog).  False restores the
        #: static nearest-by-latency ranking — on an idle network the
        #: two produce identical orders, so this is a load-shedding
        #: feature flag, not a semantics change.
        self.queue_aware = queue_aware
        self.replicas: Dict[str, Replica] = {}
        self.catalog = ReplicaCatalog()
        #: Bulk-transfer policy (repro_torch.core.bulk).  None = legacy
        #: fixed-width striping and home/client-driven repair sources —
        #: traces bit-identical to the pre-bulk fabric.  Set, it widens
        #: apply stripes to the granted stream budget and (with
        #: ``third_party=True``) lets maintenance pull from the
        #: cheapest fresh *replica* instead of home/client.
        self.bulk = bulk
        self.transfer = StripedTransfer(network, spec=bulk)
        #: Per-path write leases for quorum writes (None = lease-free,
        #: vector timestamps alone catch divergence at reconcile).
        self.write_lease = write_lease
        self.fanout_ok = 0
        self.fanout_deferred = 0
        #: applies whose payload moved replica->replica (a third-party
        #: pull from a non-home source), and the ones that fell back to
        #: the mediated path after the chosen source partitioned mid-pull
        self.third_party_pulls = 0
        self.third_party_fallbacks = 0
        self.read_repairs = 0
        self.lease_acquired = 0
        self.lease_contended = 0
        self.lease_unavailable = 0
        #: applies refused because they would overflow a bounded replica
        self.admission_refused = 0
        #: evictions across every replica (per-replica count on Replica)
        self.evictions = 0
        # memoized per-(client, path) fresh-source candidates, valid for
        # one catalog generation; the O(1) lagging membership check and
        # the ranking by current queue state stay per-call (they are
        # O(candidates) — the rebuild of the fresh-holder set was the
        # per-read cost), so lagging mutations and congestion changes
        # take effect immediately without an invalidation hook.
        self._route_cache: Dict[Tuple[str, str], List[str]] = {}
        self._route_cache_gen = -1
        self.route_hits = 0
        self.route_misses = 0
        home_store.subscribe(self._on_home_change)

    @property
    def capacity_bytes(self) -> Optional[int]:
        """Deprecated alias for ``eviction.capacity``; None = unbounded."""
        return self.eviction.capacity if self.eviction is not None else None

    # ---- capacity accounting --------------------------------------------
    # Accounting is unconditional (wire-free dict updates: unbounded-set
    # traces stay bit-identical); only *behavior* — admission, hot-set
    # resync, demand placement, the evict task — gates on ``eviction``.
    def _account_put(self, name: str, path: str, nbytes: int) -> None:
        rep = self.replicas[name]
        old = rep.resident.get(path, 0)
        rep.resident[path] = nbytes
        rep.resident_bytes += nbytes - old
        if rep.resident_bytes > rep.peak_resident_bytes:
            rep.peak_resident_bytes = rep.resident_bytes
        rep.last_touch[path] = self.network.clock
        rep.fills[path] = rep.fills.get(path, 0) + 1

    def _account_drop(self, name: str, path: str) -> int:
        rep = self.replicas[name]
        freed = rep.resident.pop(path, 0)
        rep.resident_bytes -= freed
        rep.last_touch.pop(path, None)
        rep.fills.pop(path, None)
        return freed

    def note_read(self, name: str, path: str) -> None:
        """Touch a path's LRU clock: the client read (or prefetch) was
        served from this replica.  Wire-free; feeds eviction ranking."""
        rep = self.replicas.get(name)
        if rep is not None and path in rep.resident:
            rep.last_touch[path] = self.network.clock

    def admits(self, name: str, path: str, nbytes: int) -> bool:
        """Would landing ``nbytes`` for ``path`` keep the replica within
        its capacity?  Unbounded sets admit everything."""
        if self.eviction is None:
            return True
        rep = self.replicas[name]
        old = rep.resident.get(path, 0)
        return rep.resident_bytes - old + nbytes <= self.eviction.capacity

    # ---- eviction (policy decisions; the fabric schedules them) ----------
    def eviction_protected(self, name: str, path: str) -> bool:
        """Paths eviction must never touch: a quorum-parked write whose
        replica copies are the only durable ones, and a path whose held
        version IS the freshness floor (newer than — or absent from —
        home, so evicting would lose the newest bytes)."""
        if path in self.catalog.quorum_versions:
            return True
        held = self.catalog.version_at(path, name)
        if held is None:
            # physically resident but catalog-dropped (deferred fan-out):
            # repair owns this path, eviction stays away
            return True
        hv = self.catalog.home_version(path)
        return hv is None or held > hv

    def eviction_candidates(self, name: str) -> List[str]:
        """Resident, unprotected paths cheapest-to-evict first under the
        spec's policy: ``"lru"`` = coldest last-touch; ``"fill_cost"`` =
        fewest re-fills (cheap to re-place on demand), LRU tiebreak.
        Path-name tiebreak keeps the order deterministic."""
        rep = self.replicas[name]
        paths = [p for p in rep.resident
                 if not self.eviction_protected(name, p)]
        if self.eviction is not None and self.eviction.policy == "fill_cost":
            paths.sort(key=lambda p: (rep.fills.get(p, 0),
                                      rep.last_touch.get(p, 0.0), p))
        else:
            paths.sort(key=lambda p: (rep.last_touch.get(p, 0.0), p))
        return paths

    def evict_path(self, name: str, path: str) -> int:
        """Drop one replica copy and return the bytes freed.  The path is
        NOT marked lagging: re-placement is read repair on the next hot
        access, not a scheduled repair obligation."""
        rep = self.replicas[name]
        try:
            rep.store.delete(rep.token, path)
        except FileNotFoundError:
            pass
        self.catalog.drop(path, name)
        rep.lagging.discard(path)
        freed = self._account_drop(name, path)
        rep.evictions += 1
        self.evictions += 1
        return freed

    # ---- write-ack policy ------------------------------------------------
    @property
    def n_endpoints(self) -> int:
        """Size of the write group: home + every placed replica."""
        return 1 + len(self.replicas)

    def resolve_w(self) -> int:
        """Acks required before the flusher may retire a write."""
        n = self.n_endpoints
        if self.write_quorum == "majority":
            return n // 2 + 1
        if self.write_quorum == "all":
            return n
        return max(1, min(int(self.write_quorum), n))

    def next_version(self, path: str) -> int:
        """Client-assigned version for a quorum write around a dead home:
        one past the newest version any endpoint is known to hold."""
        best = 0
        hv = self.catalog.home_version(path)
        if hv is not None and hv > best:
            best = hv
        qv = self.catalog.quorum_versions.get(path)
        if qv is not None and qv > best:
            best = qv
        for ep in self.replicas:
            v = self.catalog.version_at(path, ep)
            if v is not None and v > best:
                best = v
        return best + 1

    # ---- concurrent-writer safety ---------------------------------------
    def vts_frontier(self, client_name: str, path: str) -> Dict[str, int]:
        """Merged vector-timestamp frontier of every replica reachable
        from ``client_name``.  The frontier piggy-backs on the fan-out
        messages the flusher sends anyway, so reading it is wire-free;
        merging it into a new write's stamp is what orders that write
        *after* everything a common replica has already acked."""
        out: Dict[str, int] = {}
        for name, rep in self.replicas.items():
            if self.network.is_partitioned(client_name, name):
                continue
            out = vts_merge(out, rep.store.vts_of(path))
        return out

    def acquire_write_lease(self, client_name: str, path: str,
                            owner: str) -> Optional[bool]:
        """Take the per-path write lease on every reachable replica.

        Returns ``True`` when all reachable replicas granted (same-owner
        re-acquire extends — a resumed flush attempt keeps its lease),
        ``False`` when another writer holds it somewhere (partial grants
        are rolled back; the caller defers), and ``None`` when no
        replica is reachable at all — a full partition, where the lease
        cannot serialize anything and vector timestamps are the safety
        net.  Each grant and rollback is a real lease RPC on the clock.
        """
        spec = self.write_lease
        if spec is None:
            return None
        reachable = [n for n in self.replicas
                     if not self.network.is_partitioned(client_name, n)]
        if not reachable:
            self.lease_unavailable += 1
            return None
        granted: List[str] = []
        for name in reachable:
            rep = self.replicas[name]
            try:
                self.network.rpc(client_name, name, "write_lease")
            except DisconnectedError:
                continue          # flapped mid-acquire: treat as absent
            if rep.store.acquire_lock(rep.token, path, owner,
                                      spec.ttl_s, self.network.clock):
                granted.append(name)
                continue
            # contended: another writer got there first on a common
            # replica — roll back partial grants and defer
            for g in granted:
                grep = self.replicas[g]
                try:
                    self.network.rpc(client_name, g, "write_lease_release")
                except DisconnectedError:
                    pass          # its short TTL is the fallback
                grep.store.release_lock(grep.token, path, owner)
            self.lease_contended += 1
            return False
        if not granted:
            self.lease_unavailable += 1
            return None
        self.lease_acquired += 1
        return True

    def release_write_lease(self, client_name: str, path: str,
                            owner: str) -> int:
        """Best-effort release of a held write lease (called once the
        write lands at home).  A replica that cannot be reached keeps
        the lock until its TTL lapses — crash-safe by construction."""
        released = 0
        now = self.network.clock
        for name, rep in self.replicas.items():
            if rep.store.lock_owner(path, now) != owner:
                continue
            try:
                self.network.rpc(client_name, name, "write_lease_release")
            except DisconnectedError:
                continue          # TTL expiry is the fallback
            rep.store.release_lock(rep.token, path, owner)
            released += 1
        return released

    def _route_cost(self, src: str, dst: str, nbytes: int) -> float:
        """What one routing candidate costs right now: estimated
        completion (latency + channel queue + NIC backlog) when
        queue-aware, static link latency otherwise."""
        if self.queue_aware:
            return self.network.estimated_completion(src, dst, nbytes)
        return self.network.latency_between(src, dst)

    def _route_costs(self, src: str, dsts: List[str],
                     nbytes: int) -> List[float]:
        """Costs of many candidates in one pass: one vectorized
        ``estimate_batch`` call when queue-aware (element-identical to
        per-candidate ``estimated_completion``), static latencies
        otherwise."""
        if not dsts:
            return []
        if self.queue_aware:
            return self.network.estimate_batch(src, dsts, nbytes).tolist()
        return [self.network.latency_between(src, d) for d in dsts]

    def replicas_by_cost(self, src: str, nbytes: int = 0) -> List[str]:
        """Replica names cheapest-first from ``src`` under the current
        queue/NIC state — the flusher launches fan-out in this order so
        the W-th ack lands as early as possible.  Partitioned pairs
        estimate to ``inf`` and sort last (they defer anyway)."""
        names = list(self.replicas)
        costs = self._route_costs(src, names, nbytes)
        # stable sort on cost == sorted(key=cost): ties keep replica order
        return [n for _c, n in sorted(zip(costs, names),
                                      key=lambda cn: cn[0])]

    # ---- catalog feed (rides the home callback channel) ------------------
    def _on_home_change(self, path: str, st: ObjectStat) -> None:
        self.catalog.note_home(path, st.version)

    def reattach(self, token: Optional[str] = None,
                 via: Optional[str] = None,
                 skip: Optional[Set[str]] = None) -> bool:
        """Recover the fabric view after a home-server crash.

        Re-subscribes the catalog feed (the crash dropped it) and
        re-learns the home version vector, which the catalog may have
        missed changes to while the channel was down.  ``token`` replaces
        an auth token the crash invalidated; ``via`` names the endpoint
        whose link to home gates the refresh — when that link is still
        partitioned the quorum-side view simply survives untouched;
        ``skip`` marks quorum-parked paths whose freshness floor must not
        be evicted before reconciliation lands them at home.
        Returns True when the home vector was re-learned.
        """
        if token is not None:
            self.token = token
        self.home_store.unsubscribe(self._on_home_change)
        self.home_store.subscribe(self._on_home_change)
        if via is not None and self.network.is_partitioned(via,
                                                           self.home_name):
            return False
        try:
            vv = self.home_store.version_vector(self.token)
        except (AuthError, DisconnectedError):
            return False   # still crashed / token stale: survive, and let
            #                Session.remount re-authenticate
        for path, hv in vv.items():
            if skip is None or path not in skip:
                self.catalog.note_home(path, hv)
        self.catalog.vector_learned = True
        return True

    # ---- placement -------------------------------------------------------
    def add_replica(self, name: str, store: HomeStore) -> Replica:
        token = store.authenticate(
            lambda ch: respond(store.keyphrase, ch))
        rep = Replica(name=name, store=store, token=token)
        self.replicas[name] = rep
        return rep

    # ---- read routing ----------------------------------------------------
    def _fresh_sources(self, client_name: str, path: str) -> List[str]:
        """Memoized replica candidates (fresh holders placed in this
        set) for one (client, path); valid for exactly one catalog
        generation — any note/record/drop clears the cache wholesale.
        Lagging is deliberately NOT baked in: it is an O(1) membership
        test the caller applies per-call, so every mutation spelling on
        a plain ``lagging`` set takes effect immediately."""
        if self.catalog.gen != self._route_cache_gen:
            self._route_cache.clear()
            self._route_cache_gen = self.catalog.gen
        key = (client_name, path)
        names = self._route_cache.get(key)
        if names is not None:
            self.route_hits += 1
            return names
        self.route_misses += 1
        names = [ep for ep in self.catalog.fresh_holders(path)
                 if ep in self.replicas]
        self._route_cache[key] = names
        return names

    def route(self, client_name: str, path: str,
              nbytes: Optional[int] = None) -> List[ReadSource]:
        """Read sources cheapest-first by estimated completion (static
        latency when ``queue_aware`` is off); home always present.

        ``nbytes`` prices the candidates with the object size when the
        caller knows it (prefetch does); otherwise a nominal probe size
        stands in.  Cost ties go to home (authoritative).  The client
        walks the list, falling back on :class:`DisconnectedError`.
        """
        probe = ROUTE_PROBE_BYTES if nbytes is None else nbytes
        cands: List[Tuple[int, ReadSource]] = [
            (0, (self.home_name, self.home_store, self.token))]
        for ep in self._fresh_sources(client_name, path):
            rep = self.replicas[ep]
            if path in rep.lagging:
                continue
            cands.append((1, (ep, rep.store, rep.token)))
        # every candidate priced in one vectorized pass
        costs = self._route_costs(client_name, [s[0] for _t, s in cands],
                                  probe)
        ranked = [(c, t, s) for c, (t, s) in zip(costs, cands)]
        ranked.sort(key=lambda t: (t[0], t[1]))
        return [src for _, _, src in ranked]

    # ---- metadata routing ------------------------------------------------
    def route_meta(self, client_name: str, prefix: str) -> List[ReadSource]:
        """Metadata read sources (``stat`` via listing / ``opendir``)
        cheapest-first by the same estimated-completion rule as data
        reads; home always present as the authoritative fallback
        regardless of its queue depth.

        A replica may serve a *listing* only when the catalog can prove it
        complete and fresh for the prefix: the full home version vector
        has been learned at least once (``vector_learned`` — an
        incremental change feed alone cannot rule out objects that
        predate the subscription), every known path under the prefix with
        a live freshness floor is held at >= that floor, and no deferred
        fan-out (``lagging``) touches the prefix.  A catalog that knows
        nothing under the prefix proves nothing — metadata then routes
        home (``resync()``/``reattach()`` teach it the home vector).
        """
        cands: List[Tuple[int, ReadSource]] = [
            (0, (self.home_name, self.home_store, self.token))]
        # directory match, not raw string prefix: "home/meta2/x" must not
        # count against a listing of "home/meta" — served by the
        # catalog's per-directory index, not a scan of every known path
        dirp = prefix if prefix.endswith("/") else prefix + "/"
        need = [(p, self.catalog.freshness_floor(p))
                for p in sorted(self.catalog.paths_under(dirp))]
        need = [(p, fl) for p, fl in need if fl is not None and fl >= 0]
        if need and self.catalog.vector_learned:
            for name, rep in self.replicas.items():
                if any(p.startswith(dirp) for p in rep.lagging):
                    continue
                if all((self.catalog.version_at(p, name) or 0) >= fl
                       for p, fl in need):
                    cands.append((1, (name, rep.store, rep.token)))
        costs = self._route_costs(client_name, [s[0] for _t, s in cands], 0)
        ranked = [(c, t, s) for c, (t, s) in zip(costs, cands)]
        ranked.sort(key=lambda t: (t[0], t[1]))
        return [src for _, _, src in ranked]

    # ---- third-party source selection (repro_torch.core.bulk) ------------------
    def third_party_source(self, target: str, path: str, version: int,
                           nbytes: int) -> Optional[str]:
        """Cheapest endpoint already holding exactly ``version`` of
        ``path`` to drive a repair of ``target`` from — a replica or
        home, ranked by the same queue-aware cost the read router uses
        (``estimate_batch``: latency + channel queue + NIC backlog), so
        a maintenance drain spreads across source NICs instead of
        serializing through home.  GridFTP's third-party transfer: the
        orchestrating session stays off the data path entirely.

        Returns ``None`` when the bulk plane is off (``bulk`` unset or
        ``third_party=False``) or no reachable holder exists — callers
        then keep their legacy source (home for resync/repair, the
        reading client for read repair).  Ties prefer a replica over
        home (the offload is the point), then name order.
        """
        spec = self.bulk
        if spec is None or not spec.third_party:
            return None
        cands: List[str] = []
        for ep, rep in self.replicas.items():
            if ep == target or path in rep.lagging:
                continue
            if self.catalog.version_at(path, ep) == version:
                cands.append(ep)
        if self.catalog.home_version(path) == version:
            cands.append(self.home_name)
        if not cands:
            return None
        costs = self._route_costs(target, cands, nbytes)
        ranked = sorted(zip(costs, cands),
                        key=lambda ce: (ce[0], ce[1] == self.home_name,
                                        ce[1]))
        for cost, ep in ranked:
            if cost != float("inf"):      # partitioned pairs price to inf
                return ep
        return None

    # ---- write-back fan-out ---------------------------------------------
    def begin_apply(self, name: str, path: str, data: bytes,
                    version: int, src: Optional[str] = None,
                    vts: Optional[Dict[str, int]] = None,
                    fallback_src: Optional[str] = None
                    ) -> Optional[PendingApply]:
        """Launch one replica apply as overlapped channel reservations.

        ``src`` is the endpoint driving the apply: home during ordinary
        fan-out and resync (third-party transfer, GridFTP-style), a
        fresh replica when :meth:`third_party_source` found a cheaper
        holder, or the client site when the flusher assembles a quorum
        around a partitioned home.  The data stripes and the chained ack
        ride the same pair (the ack reserves ``not_before`` the data
        lands), so per-pair accounting shows where quorum round-trips
        went.  A partitioned replica is recorded as lagging and yields
        ``None`` — fan-out never blocks or fails the flusher on a WAN
        fault; when a *third-party source* is what partitioned,
        ``fallback_src`` retries once through the mediated path instead
        (a repair must not stall on a second fault domain).  The clock
        does not move; pair :meth:`complete_apply` with a
        ``network.wait`` when the caller needs the ack on the clock.
        """
        rep = self.replicas[name]
        if not self.admits(name, path, len(data)):
            # bounded replica full: refuse, don't reserve wire.  The old
            # resident version (if any) stays valid — no catalog drop —
            # and the path must NOT stay lagging or the scheduled repair
            # would spin on a refusal forever; the evict task frees room
            # and the next hot read re-places via read repair.
            rep.lagging.discard(path)
            self.admission_refused += 1
            return None
        src = src or self.home_name
        try:
            group = self.transfer.begin(src, name, data)
            ack = self.network.transfer(name, src, "write_ack",
                                        not_before=group.completion)
        except DisconnectedError:
            if fallback_src is not None and fallback_src != src:
                self.third_party_fallbacks += 1
                return self.begin_apply(name, path, data, version,
                                        src=fallback_src, vts=vts)
            rep.lagging.add(path)
            self.catalog.drop(path, name)
            self.fanout_deferred += 1
            return None
        if src != self.home_name and src in self.replicas:
            self.third_party_pulls += 1
        self.network.note_provenance(
            "third_party" if (src == self.home_name
                              or src in self.replicas)
            else "client_mediated", len(data))
        return PendingApply(name=name, path=path, data=data,
                            version=version, src=src, group=group, ack=ack,
                            vts=vts)

    def complete_apply(self, p: PendingApply) -> None:
        """Land one in-flight apply: real bytes into the replica store,
        catalog updated, lag cleared.  Does not touch the clock — the
        caller decides whether this ack is on the critical path."""
        rep = self.replicas[p.name]
        rep.store.put(rep.token, p.path, p.data, version=p.version)
        if p.vts is not None:
            rep.store.set_vts(p.path, p.vts)
        self.catalog.record(p.path, p.name, p.version)
        rep.lagging.discard(p.path)
        self._account_put(p.name, p.path, len(p.data))
        self.fanout_ok += 1

    def apply_to_replica(self, name: str, path: str, data: bytes,
                         version: int, src: Optional[str] = None,
                         vts: Optional[Dict[str, int]] = None,
                         fallback_src: Optional[str] = None) -> bool:
        """Blocking apply (anti-entropy repair path): launch, wait the
        ack onto the clock, land the bytes."""
        p = self.begin_apply(name, path, data, version, src=src, vts=vts,
                             fallback_src=fallback_src)
        if p is None:
            return False
        self.network.wait(p.ack)
        self.complete_apply(p)
        return True

    # ---- read repair -----------------------------------------------------
    def read_repair(self, client_name: str, path: str, data: bytes,
                    version: int,
                    vts: Optional[Dict[str, int]] = None) -> int:
        """Push freshly-read bytes to replicas observed stale, off the
        reader's critical path.

        A quorum read that routed past a stale or lagging replica already
        has the fresh bytes in hand — pushing them back over the same
        striped-transfer fabric repairs the replica *now* instead of
        waiting for the next anti-entropy ``resync()``.  The pushes are
        overlapped channel reservations that are never waited on, so the
        read's observed latency is untouched.  Guards: never push bytes
        older than the freshness floor (a stale read must not propagate),
        and never touch a replica already at or past ``version``.
        """
        floor = self.catalog.freshness_floor(path)
        if floor is not None and version < floor:
            return 0
        repaired = 0
        for name, rep in self.replicas.items():
            held = self.catalog.version_at(path, name)
            if held is not None and held >= version:
                continue
            if held is None and path not in rep.lagging \
                    and self.eviction is None:
                continue          # never placed here: placement, not repair
            # on a capacity-bounded replica the read reaching this point
            # IS the placement signal: the path is hot, so read repair
            # doubles as demand placement (admission still gates it)
            tp = self.third_party_source(name, path, version, len(data))
            src = tp if tp is not None else client_name
            p = self.begin_apply(
                name, path, data, version, src=src, vts=vts,
                fallback_src=client_name if tp is not None else None)
            if p is None:
                continue          # still partitioned: stays lagging
            self.complete_apply(p)
            repaired += 1
        self.read_repairs += repaired
        return repaired

    def propagate_delete(self, path: str) -> int:
        ok = 0
        for rep in self.replicas.values():
            try:
                self.network.rpc(self.home_name, rep.name, "replica_delete")
            except DisconnectedError:
                rep.lagging.add(path)
                self.catalog.drop(path, rep.name)
                self.fanout_deferred += 1
                continue
            try:
                rep.store.delete(rep.token, path)
            except FileNotFoundError:
                pass
            self.catalog.drop(path, rep.name)
            rep.lagging.discard(path)
            self._account_drop(rep.name, path)
            ok += 1
        return ok

    # ---- anti-entropy ----------------------------------------------------
    def resync(self, skip: Optional[Set[str]] = None) -> int:
        """Converge every replica onto the home version vector.

        Pushes missing/stale objects, removes deleted ones, and refreshes
        the catalog's home-version view (which also recovers from a home
        crash that dropped the notification subscription).  ``skip`` names
        paths with a quorum-parked write still awaiting home
        reconciliation: home's numerically-higher-but-older version must
        not overwrite the acked replica bytes or evict the quorum
        freshness floor.  Returns the number of repair transfers.
        """
        skip = skip or set()
        vv = self.home_store.version_vector(self.token)
        for path, hv in vv.items():
            if path not in skip:
                self.catalog.note_home(path, hv)
        self.catalog.vector_learned = True
        repaired = 0
        for path, hv in vv.items():
            if path in skip:
                continue
            blob = None       # home disk read shared across replicas
            target = hv
            for rep in self.replicas.values():
                if self.eviction is not None \
                        and path not in rep.resident \
                        and path not in rep.lagging:
                    # hot-set-only fill: a capacity-bounded replica never
                    # mirrors at resync — bytes arrive on demand (read
                    # repair) and anti-entropy only refreshes what is
                    # already resident or owed (lagging)
                    continue
                held = self.catalog.version_at(path, rep.name)
                if held is not None and held >= target:
                    rep.lagging.discard(path)
                    continue
                if blob is None:
                    try:
                        blob = self.home_store.get(self.token, path)
                    except FileNotFoundError:
                        break   # deleted since the vector snapshot
                    data, st = blob
                    if st.version != target:
                        # a home write landed between the vector snapshot
                        # and this fetch: the fetched bytes are what every
                        # replica receives, so the fetched version is what
                        # the catalog must pin — judging staleness by the
                        # snapshot while applying the newer version left
                        # the catalog's home view and the replica holdings
                        # permanently divergent (visible whenever the
                        # change-feed subscription is down, i.e. exactly
                        # the post-crash recovery resync() serves)
                        target = st.version
                        self.catalog.note_home(path, target)
                        if held is not None and held >= target:
                            rep.lagging.discard(path)
                            continue
                data, st = blob
                # a replica already converged this pass is a third-party
                # source for the next one — the catalog records it at
                # complete_apply, so selection sees it immediately
                tp = self.third_party_source(rep.name, path, st.version,
                                             len(data))
                if self.apply_to_replica(
                        rep.name, path, data, st.version, src=tp,
                        vts=self.home_store.vts_of(path) or None,
                        fallback_src=self.home_name
                        if tp not in (None, self.home_name) else None):
                    repaired += 1
        for rep in self.replicas.values():
            # drop objects deleted at home (a parked quorum write that home
            # has never seen is NOT deleted-at-home — its replica copies
            # are the only durable ones)
            for path in self.catalog.paths_at(rep.name):
                if path in vv or path in skip:
                    continue
                try:
                    self.network.rpc(self.home_name, rep.name,
                                     "replica_delete")
                except DisconnectedError:
                    rep.lagging.add(path)
                    continue
                try:
                    rep.store.delete(rep.token, path)
                except FileNotFoundError:
                    pass
                self.catalog.drop(path, rep.name)
                # mirror propagate_delete: a successfully deleted path is
                # repaired — leaving it in ``lagging`` kept a dead path on
                # the read-repair candidate list forever
                rep.lagging.discard(path)
                self._account_drop(rep.name, path)
                repaired += 1
        return repaired

    # ---- schedulable maintenance units -----------------------------------
    def repair_targets(self) -> List[str]:
        """Paths some replica still needs repaired (deferred fan-out and
        partition leftovers), sorted so the scheduled drain walks them in
        a deterministic order."""
        out: Set[str] = set()
        for rep in self.replicas.values():
            out |= rep.lagging
        return sorted(out)

    def begin_repair_path(self, path: str) -> List[PendingApply]:
        """Launch — without waiting — the repair of ONE path onto every
        replica that lags or trails it: the schedulable read-repair
        drain unit.

        Storage-driven pushes (home, or the cheapest fresh replica when
        the bulk plane's third-party selection is armed — see
        :meth:`third_party_source`), overlapped channel reservations;
        the caller (the maintenance scheduler) completes each apply via
        :meth:`complete_apply` when its ack matures, so repair wire time
        never rides a reader's clock.  A path deleted at home while the
        repair was queued drains the tombstone instead
        (:meth:`propagate_delete`).  A still-partitioned replica stays
        lagging — the next drain tick retries.
        """
        try:
            data, st = self.home_store.get(self.token, path)
        except FileNotFoundError:
            self.propagate_delete(path)
            return []
        # same pin rule as resync(): the fetched version is the target
        self.catalog.note_home(path, st.version)
        pending: List[PendingApply] = []
        for name, rep in self.replicas.items():
            held = self.catalog.version_at(path, name)
            if held is not None and held >= st.version:
                rep.lagging.discard(path)
                continue
            if path not in rep.lagging and held is None:
                continue      # never placed here: placement, not repair
            tp = self.third_party_source(name, path, st.version, len(data))
            p = self.begin_apply(
                name, path, data, st.version, src=tp,
                vts=self.home_store.vts_of(path) or None,
                fallback_src=self.home_name
                if tp not in (None, self.home_name) else None)
            if p is not None:
                pending.append(p)
        return pending
