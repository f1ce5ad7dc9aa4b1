"""XufsClient: the interposition seam (the paper's libxufs.so equivalent).

Applications (the trainer, the serving engine, the data pipeline) perform
all file access through this client.  Semantics per the paper:

  * ``opendir`` materializes the remote listing into cache space (hidden
    attribute files) and redirects directory ops locally;
  * first ``open`` of a file fetches the WHOLE object (striped);
  * mutating ops update the cache copy, append to the persisted meta-op
    queue, and return — nothing blocks on the WAN;
  * ``write`` accumulates in a shadow buffer; ``close`` enqueues one
    aggregated store op (**last-close-wins**);
  * callback invalidations mark entries stale; next access re-fetches;
  * *localized directories*: new data never ships back to home;
  * disconnected operation: reads serve from cache, writes queue.
"""
from __future__ import annotations

import heapq
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.cache import (
    CacheSpace, CacheEntry, EMPTY, VALID, DIRTY, INVALID,
)
from repro_torch.core.callbacks import NotificationManager
from repro_torch.core.lease import LeaseManager
from repro_torch.core.oplog import (
    MetaOpQueue, OpRecord, vts_dominates, vts_lww_key, vts_merge,
)
from repro_torch.core.replication import (
    ReadSource, ReplicaSet, WriteLeaseContended,
)
from repro_torch.core.store import HomeStore, ObjectStat
from repro_torch.core.striping import StripedTransfer
from repro_torch.core.tasks import ConflictRecord
from repro_torch.core.transport import (
    DisconnectedError, Network, QuorumNotReachedError,
)


@dataclass
class Mount:
    prefix: str                      # namespace prefix, e.g. "home/"
    server_name: str
    store: HomeStore
    token: str
    localized: List[str] = field(default_factory=list)
    replicas: Optional[ReplicaSet] = None

    def is_localized(self, path: str) -> bool:
        return any(path.startswith(ld) for ld in self.localized)


class XufsFile:
    """An open file handle over the cache copy + shadow write buffer."""

    def __init__(self, client: "XufsClient", path: str, mode: str):
        assert mode in ("r", "w", "a", "rw")
        self.client = client
        self.path = path
        self.mode = mode
        self.closed = False
        if "r" in mode or mode == "a":
            base = client._ensure_cached(path, create_ok="w" in mode or
                                         mode == "a")
        else:
            base = b""
        self._buf = bytearray(base if mode != "w" else b"")
        self._dirty = mode in ("w", "a")
        self._pos = len(self._buf) if mode == "a" else 0

    # ---- POSIX-ish surface -------------------------------------------------
    def read(self, n: int = -1) -> bytes:
        end = len(self._buf) if n < 0 else min(self._pos + n, len(self._buf))
        out = bytes(self._buf[self._pos:end])
        self._pos = end
        return out

    def write(self, data: bytes) -> int:
        end = self._pos + len(data)
        if end > len(self._buf):
            self._buf.extend(b"\x00" * (end - len(self._buf)))
        self._buf[self._pos:end] = data
        self._pos = end
        self._dirty = True
        return len(data)

    def seek(self, pos: int) -> None:
        self._pos = pos

    def close(self) -> None:
        """Update the cache copy; enqueue ONE aggregated store op."""
        if self.closed:
            return
        self.closed = True
        if self._dirty:
            self.client._close_write(self.path, bytes(self._buf))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class XufsClient:
    def __init__(self, name: str, network: Network, cache_root: str,
                 oplog_root: str, owner: str = "user"):
        self.name = name
        self.network = network
        self.cache = CacheSpace(cache_root)
        self.oplog = MetaOpQueue(oplog_root)
        self.transfer = StripedTransfer(network)
        self.mounts: Dict[str, Mount] = {}
        self.notifiers: Dict[str, NotificationManager] = {}
        self.leases: Dict[str, LeaseManager] = {}
        self.owner = owner
        self.cwd = ""
        #: op seq -> modeled WAN seconds from apply start to the W-th ack
        #: (most recent ACK_WINDOW ops; insertion order = seq order)
        self.ack_wan_s: Dict[int, float] = {}
        #: path -> causal frontier of this client's own stamped writes
        #: (covers successive disconnected writes whose fan-out never
        #: landed anywhere we can read the frontier back from)
        self._vts_frontier: Dict[str, Dict[str, int]] = {}
        #: concurrent-writer divergences this client's reconciles
        #: detected (every one also forwarded to ``_conflict_sink``)
        self.conflicts: List[ConflictRecord] = []
        #: fabric wiring: scheduler.note_conflict when maintenance is on
        self._conflict_sink: Optional[
            Callable[[ConflictRecord], None]] = None

    ACK_WINDOW = 1024

    def _note_ack(self, seq: int, wan_s: float) -> None:
        self.ack_wan_s[seq] = wan_s
        while len(self.ack_wan_s) > self.ACK_WINDOW:
            self.ack_wan_s.pop(next(iter(self.ack_wan_s)))

    # ---- mounts -----------------------------------------------------------
    def mount(self, prefix: str, server_name: str, store: HomeStore,
              token: str, localized: Optional[List[str]] = None,
              replicas: Optional[ReplicaSet] = None) -> Mount:
        m = Mount(prefix=prefix, server_name=server_name, store=store,
                  token=token, localized=localized or [],
                  replicas=replicas)
        if replicas is not None and replicas.bulk is not None \
                and self.transfer.spec is None:
            # bulk-plane opt-in rides the mount: the client's own striped
            # transfers (cache fills, flusher fan-out of large payloads)
            # size their stripe width from the granted stream budget
            self.transfer.spec = replicas.bulk
        self.mounts[prefix] = m
        old_nm = self.notifiers.get(prefix)
        if old_nm is not None:
            # re-mount (remount/recovery): drop the old channel's store
            # subscription, or every put() keeps feeding an orphaned
            # pending list nobody drains
            old_nm.teardown()
        nm = NotificationManager(self.network, self.name, server_name,
                                 store, self.cache, prefix=prefix)
        nm.register(token)
        self.notifiers[prefix] = nm
        lm = LeaseManager(
            self.network, self.name, server_name, store, owner=self.owner,
            token=token)
        old_lm = self.leases.get(prefix)
        if old_lm is not None and old_lm.store is store:
            # a re-mount rotates the token but must not forget which
            # locks this client believes it holds: carry them over AT
            # RISK — the server may have expired them while we were away
            # (crash/partition is why remounts happen) — and let
            # reverify_at_risk() settle them on reconnect
            lm.local_locks = old_lm.local_locks
            lm.held = old_lm.held
            lm.at_risk = old_lm.at_risk | set(old_lm.held)
            lm.pending_release = set(old_lm.pending_release)
        self.leases[prefix] = lm
        return m

    def _mount_for(self, path: str) -> Mount:
        for prefix in sorted(self.mounts, key=len, reverse=True):
            if path.startswith(prefix):
                return self.mounts[prefix]
        raise FileNotFoundError(f"{path}: not under any XUFS mount")

    # ---- cache fill ------------------------------------------------------
    def _read_sources(self, m: Mount, path: str,
                      nbytes: Optional[int] = None) -> List[ReadSource]:
        """Candidate servers for a cache fill, cheapest estimated
        completion first, home always last-resort.  ``nbytes`` prices
        the route with the object size when known."""
        if m.replicas is not None:
            return m.replicas.route(self.name, path, nbytes=nbytes)
        return [(m.server_name, m.store, m.token)]

    def _fetch(self, m: Mount, path: str) -> CacheEntry:
        """Whole-object striped fetch into cache space.

        With a replica fabric mounted, sources are tried nearest-first;
        a partitioned replica falls through to the next candidate (home is
        always the terminal authority).
        """
        last_exc: Optional[Exception] = None
        prev = self.cache.lookup(path)   # attr-only entries carry the size
        hint = prev.stat.size if prev is not None else None
        for server_name, store, token in self._read_sources(m, path,
                                                            nbytes=hint):
            try:
                data, st = store.get(token, path)
                self.transfer.send(server_name, self.name, data)
            except DisconnectedError as e:
                last_exc = e
                continue
            except FileNotFoundError:
                if server_name == m.server_name:
                    raise       # authoritative miss
                continue        # replica catalog raced a delete; try next
            self.cache.misses += 1
            self.cache.record_fill(server_name)
            if m.replicas is not None:
                # the serving replica's LRU clock ticks (wire-free) —
                # feeds capacity-eviction ranking
                m.replicas.note_read(server_name, path)
                # read repair: push the bytes we just pulled to any
                # replica this read observed stale — overlapped, so the
                # read's own latency is untouched.  On a capacity-bounded
                # set this doubles as demand placement: the hot path is
                # (re-)placed at replicas that never held it.
                m.replicas.read_repair(self.name, path, data, st.version,
                                       vts=store.vts_of(path) or None)
            return self.cache.store_data(path, data, st, state=VALID)
        if last_exc is not None:
            raise last_exc
        raise FileNotFoundError(path)

    def _ensure_cached(self, path: str, create_ok: bool = False) -> bytes:
        m = self._mount_for(path)
        entry = self.cache.lookup(path)
        if entry is not None and entry.state in (VALID, DIRTY):
            self.cache.hits += 1
            return self.cache.read_data(path)
        try:
            entry = self._fetch(m, path)
            return self.cache.read_data(path)
        except FileNotFoundError:
            if create_ok:
                return b""
            raise
        except DisconnectedError:
            # disconnected operation: serve stale cache if we have bytes
            if entry is not None and os.path.exists(
                    self.cache.data_path(path)):
                self.cache.hits += 1
                return self.cache.read_data(path)
            raise

    # ---- file API ----------------------------------------------------------
    def open(self, path: str, mode: str = "r") -> XufsFile:
        return XufsFile(self, path, mode)

    def _close_write(self, path: str, data: bytes) -> None:
        m = self._mount_for(path)
        st = ObjectStat(path=path, size=len(data), version=-2,
                        mtime=self.network.clock)
        prev = self.cache.lookup(path)
        if prev is not None:
            st.version = prev.stat.version
        self.cache.store_data(path, data, st, state=DIRTY)
        if not m.is_localized(path):
            self.oplog.append("store", path, data)

    def unlink(self, path: str) -> None:
        m = self._mount_for(path)
        self.cache.evict(path)
        if not m.is_localized(path):
            self.oplog.append("delete", path)

    def stat(self, path: str) -> Optional[ObjectStat]:
        """Metadata read: cached attrs first, then the nearest fresh
        replica, with home as the authoritative fallback."""
        entry = self.cache.lookup(path)
        if entry is not None and entry.state != INVALID:
            return entry.stat     # served from the hidden attr file
        m = self._mount_for(path)
        last_exc: Optional[DisconnectedError] = None
        # a stat is a 0-byte RPC: price the route with nbytes=0 so NIC
        # backlog (which cannot delay it) does not steer it off the
        # nearest replica — same rule route_meta applies to listings
        for server_name, store, token in self._read_sources(m, path,
                                                            nbytes=0):
            try:
                self.network.rpc(self.name, server_name, "stat")
            except DisconnectedError as e:
                last_exc = e
                continue
            st = store.stat(token, path)
            if st is None and server_name != m.server_name:
                continue          # replica raced a delete; try the next
            if st is not None:
                self.cache.write_entry(CacheEntry(path=path, state=EMPTY,
                                                  stat=st))
            return st             # home's answer is authoritative (even None)
        assert last_exc is not None   # home is always a candidate
        raise last_exc

    def _meta_sources(self, m: Mount, prefix: str) -> List[ReadSource]:
        """Candidate servers for a listing: replicas the catalog can prove
        complete+fresh for the prefix, nearest first, home last."""
        if m.replicas is not None:
            return m.replicas.route_meta(self.name, prefix)
        return [(m.server_name, m.store, m.token)]

    def opendir(self, path: str) -> List[ObjectStat]:
        """Download the directory listing into cache space (paper §3.1).

        Routed like data reads: the nearest replica whose holdings
        provably cover the prefix serves the (cheap, low-latency) listing;
        a partitioned source falls through to the next, ending at home.
        """
        m = self._mount_for(path)
        last_exc: Optional[DisconnectedError] = None
        for server_name, store, token in self._meta_sources(m, path):
            if self.network.is_partitioned(self.name, server_name):
                last_exc = DisconnectedError(
                    f"{self.name} <-> {server_name} partitioned")
                continue
            stats = store.listdir(token, path)
            meta_bytes = sum(64 + len(s.path) for s in stats)
            self.network.rpc(self.name, server_name, "opendir", meta_bytes)
            self.cache.populate_listing(stats)
            return stats
        assert last_exc is not None   # home is always a candidate
        raise last_exc

    def listdir_cached(self, path: str) -> List[CacheEntry]:
        return self.cache.entries(path)

    def chdir(self, path: str) -> int:
        """cd into a mounted dir: triggers the parallel small-file prefetch."""
        self.cwd = path
        from repro_torch.core.prefetch import Prefetcher
        stats = self.opendir(path)
        pf = Prefetcher(self)
        return pf.prefetch_small(path, stats)

    # ---- write-behind sync ---------------------------------------------------
    def _apply_record(self, rec: OpRecord, data: Optional[bytes]) -> bool:
        """Apply one queued op across the write group (W-of-N ack policy).

        Returns True when the authoritative home acknowledged (the record
        may retire to ``done``) and False when a quorum acked around a
        partitioned home (the record parks at ``quorum`` until
        ``reconcile()``).  Raises :class:`QuorumNotReachedError` when
        fewer than W endpoints confirmed — the drain stops with the
        partial acks persisted.
        """
        m = self._mount_for(rec.path)
        if rec.op == "store":
            assert data is not None
            return self._apply_store(m, rec, data)
        if rec.op == "delete":
            return self._apply_delete(m, rec)
        return True

    def _apply_store(self, m: Mount, rec: OpRecord, data: bytes) -> bool:
        """One store across home + replicas, resuming from persisted acks.

        Home is always attempted first (authoritative, and it assigns the
        version); every surviving endpoint's ack is persisted in the oplog
        *before* the next endpoint is tried, so a flusher crash after W-1
        acks resumes with those acks in hand.  When home is unreachable
        the flusher takes the per-path write lease (when configured),
        pins a client-assigned version, stamps the record with a vector
        timestamp, and pushes directly to replicas nearest-first until W
        acks are in.  Reconciling a pinned record back at home is
        vts-aware: a causally-newer branch lands on top, a superseded one
        retires quietly, and concurrent branches resolve by deterministic
        last-writer-wins with the loser preserved in a
        :class:`~repro_torch.core.tasks.ConflictRecord` — never a silent
        clobber.
        """
        reps = m.replicas
        home = m.server_name
        acked = set(rec.acked)
        home_acked = home in acked
        version = rec.version
        t0 = self.network.clock
        lease_owner = f"write:{self.owner}"
        if not home_acked:
            try:
                self.transfer.send(self.name, home, data)
                if version is None:
                    st = m.store.put(m.token, rec.path, data)
                    # stamp the connected write's causal history: it
                    # builds on whatever home held when it applied, so a
                    # parked quorum branch that never saw it reconciles
                    # as a detected conflict, not a blind overwrite
                    vts = vts_merge(m.store.vts_of(rec.path),
                                    self._vts_frontier.get(rec.path))
                    vts[self.owner] = vts.get(self.owner, 0) + 1
                    m.store.set_vts(rec.path, vts)
                    rec.vts = dict(vts)
                    self._vts_frontier[rec.path] = dict(vts)
                else:                # replay/reconcile: idempotent re-apply
                    st, outcome = self._reconcile_pinned(m, rec, data,
                                                         version)
                    if outcome in ("superseded", "conflict-lost"):
                        # home's causal history already covers (or beat)
                        # this branch: retire the record WITHOUT fanning
                        # its stale bytes out; replicas converge from
                        # home via resync/repair
                        self.oplog.mark_acked(rec, home,
                                              version=st.version, home=True)
                        if reps is not None \
                                and reps.write_lease is not None:
                            reps.release_write_lease(self.name, rec.path,
                                                     lease_owner)
                        cur = self.cache.lookup(rec.path)
                        if cur is not None:
                            self.cache.write_entry(CacheEntry(
                                path=rec.path, state=INVALID, stat=st))
                        self._note_ack(rec.seq,
                                       self.network.clock - t0)
                        return True
                version = st.version
                self.oplog.mark_acked(rec, home, version=version, home=True)
                acked.add(home)
                home_acked = True
                cur = self.cache.lookup(rec.path)
                if cur is not None and cur.state == DIRTY:
                    self.cache.write_entry(CacheEntry(
                        path=rec.path, state=VALID, stat=st))
                if reps is not None and reps.write_lease is not None:
                    # the lease's job — no competing client-assigned
                    # versions — ends once home holds the write
                    reps.release_write_lease(self.name, rec.path,
                                             lease_owner)
            except DisconnectedError:
                pass     # home partitioned: try to assemble a replica quorum
        if reps is None:
            if not home_acked:
                raise DisconnectedError(f"{home} unreachable (no replicas)")
            self._note_ack(rec.seq, self.network.clock - t0)
            return True
        w = reps.resolve_w()
        if w <= 1 and not home_acked:
            # W=1 is the legacy policy: the home apply IS the ack; replica
            # fan-out stays best-effort, so a home outage stalls the drain.
            raise DisconnectedError(f"{home} unreachable (W=1 acks at home)")
        if version is None:
            # first quorum attempt around a dead home: serialize via the
            # write lease when one is configured, then pin version + vts
            if reps.write_lease is not None:
                if reps.acquire_write_lease(self.name, rec.path,
                                            lease_owner) is False:
                    raise WriteLeaseContended(
                        f"{rec.path}: write lease held by another writer")
            version = reps.next_version(rec.path)
            vts = vts_merge(reps.vts_frontier(self.name, rec.path),
                            self._vts_frontier.get(rec.path))
            vts[self.owner] = vts.get(self.owner, 0) + 1
            rec.vts = vts           # persisted with the first replica ack
            self._vts_frontier[rec.path] = dict(vts)
        quorum_clock: Optional[float] = None
        if len(acked) >= w:
            quorum_clock = self.network.clock
        # home forwards when it has the bytes (third-party transfer);
        # otherwise the client pushes directly.  Every apply is launched
        # as overlapped channel reservations FIRST; acks are then
        # collected in completion order, and the clock advances only to
        # the W-th — acks beyond the quorum settle in the background,
        # which is exactly why a W<N drain beats W=all on elapsed time.
        # fan-out launches cheapest-estimated-completion first (queue
        # depth + NIC backlog included), so the W-th ack lands as early
        # as the current congestion state allows
        src = reps.home_name if home_acked else self.name
        # replicas receive the authoritative frontier once home acked
        # (reconcile may have merged branches there); otherwise the
        # record's own stamp rides the fan-out
        fan_vts = (m.store.vts_of(rec.path) or None) if home_acked \
            else rec.vts
        launched = []
        for name in reps.replicas_by_cost(src, len(data)):
            if name in acked:
                continue
            p = reps.begin_apply(name, rec.path, data, version, src=src,
                                 vts=fan_vts)
            if p is not None:
                launched.append(p)
        # acks pop in completion order (heap, launch order on ties) —
        # the event-engine analogue of sorting the pending list
        ack_heap = [(p.ack.completion, i, p)
                    for i, p in enumerate(launched)]
        heapq.heapify(ack_heap)
        pending = [p for _c, _i, p in
                   (heapq.heappop(ack_heap) for _ in range(len(ack_heap)))]
        for p in pending:
            reps.complete_apply(p)
            self.oplog.mark_acked(rec, p.name, version=version)
            acked.add(p.name)
            if len(acked) >= w and quorum_clock is None:
                self.network.wait(p.ack)
                quorum_clock = self.network.clock
        if len(acked) < w:
            # the flusher waited out every launched apply before giving up
            self.network.wait_all([p.ack for p in pending])
            raise QuorumNotReachedError(
                f"{rec.path}: {len(acked)}/{w} acks "
                f"(N={reps.n_endpoints})")
        self._note_ack(rec.seq, quorum_clock - t0)
        if not home_acked:
            reps.catalog.note_quorum(rec.path, version)
            return False
        return True

    def _reconcile_pinned(self, m: Mount, rec: OpRecord, data: bytes,
                          version: int) -> Tuple[ObjectStat, str]:
        """Land a version-pinned record back at home (replay/reconcile),
        vts-aware.  Returns ``(home stat, outcome)`` with outcome one of
        ``"apply"`` / ``"superseded"`` / ``"conflict-won"`` /
        ``"conflict-lost"``.

        Legacy records (no stamp — pre-vts WAL lines) keep the
        historical blind put-on-top.  Stamped records compare causal
        histories first: a branch home already includes retires quietly;
        a branch that includes home's state lands on top; two branches
        that know nothing of each other are a true conflict — resolved
        by the deterministic last-writer-wins order (``vts_lww_key``)
        and preserved, both sides, in a :class:`ConflictRecord`.
        """
        if rec.vts is None:
            st = m.store.apply_versioned(m.token, rec.path, data, version)
            if st.version > version:
                # Home is past our pinned version without having seen
                # these bytes (the catalog under-counted when the quorum
                # was assembled): the quorum ack promised durability of
                # THIS write, so it lands on top.
                st = m.store.put(m.token, rec.path, data,
                                 version=st.version + 1)
            return st, "apply"
        home_vts = m.store.vts_of(rec.path)
        rvts = dict(rec.vts)
        if vts_dominates(home_vts, rvts):
            # our write is already in home's causal past: a duplicate
            # reconcile, or a later writer built on our branch (it
            # merged our frontier from a common replica) and landed
            # first — either way, re-applying would roll home back
            st = m.store.stat(m.token, rec.path)
            if st is None:        # deleted at home after superseding us
                st = ObjectStat(path=rec.path, size=0, version=version,
                                mtime=self.network.clock)
            return st, "superseded"
        if vts_dominates(rvts, home_vts):
            st = m.store.apply_versioned(m.token, rec.path, data, version)
            if st.version > version:
                st = m.store.put(m.token, rec.path, data,
                                 version=st.version + 1)
            m.store.set_vts(rec.path, rvts)
            return st, "apply"
        # concurrent branches: neither knows about the other.  Land the
        # deterministic LWW winner's bytes at a version past BOTH
        # branches — even when home's current bytes win, the version
        # bump makes home the freshness floor again, so replicas still
        # holding the losing branch get repaired instead of serving it.
        theirs_data, cur = m.store.get(m.token, rec.path)
        merged = vts_merge(rvts, home_vts)
        ours_win = vts_lww_key(rvts) > vts_lww_key(home_vts)
        st = m.store.put(m.token, rec.path,
                         data if ours_win else theirs_data,
                         version=max(cur.version, version) + 1)
        m.store.set_vts(rec.path, merged)
        self._note_conflict(ConflictRecord(
            path=rec.path, seq=rec.seq, owner=self.owner,
            ours_vts=rvts, theirs_vts=dict(home_vts),
            winner="ours" if ours_win else "theirs",
            ours_data=data, theirs_data=theirs_data,
            detected_at=self.network.clock,
            _apply=self._conflict_override_fn(m, rec.path, merged)))
        return st, ("conflict-won" if ours_win else "conflict-lost")

    def _note_conflict(self, record: ConflictRecord) -> None:
        self.conflicts.append(record)
        if self._conflict_sink is not None:
            self._conflict_sink(record)

    def _conflict_override_fn(self, m: Mount, path: str,
                              merged: Dict[str, int]
                              ) -> Callable[[bytes], None]:
        """Bound apply for ``ConflictRecord.resolve()``: re-lands the
        operator's chosen branch on top at home (a real wire write)."""
        def apply_override(data: bytes) -> None:
            self.transfer.send(self.name, m.server_name, data)
            st = m.store.stat_unchecked(path)
            m.store.put(m.token, path, data,
                        version=(st.version + 1) if st is not None else 1)
            m.store.set_vts(path, dict(merged))
        return apply_override

    def _apply_delete(self, m: Mount, rec: OpRecord) -> bool:
        """Deletes stay home-first: the authoritative tombstone must land
        at home before replicas drop their copies (fan-out best-effort)."""
        self.network.rpc(self.name, m.server_name, "delete")
        try:
            m.store.delete(m.token, rec.path)
        except FileNotFoundError:
            pass
        self.oplog.retire_superseded(rec.path, rec.seq)
        if m.replicas is not None:
            m.replicas.propagate_delete(rec.path)
            m.replicas.catalog.forget_quorum(rec.path)
        return True

    def pump(self, max_ops: Optional[int] = None) -> int:
        """Drain the meta-op queue (the background flusher tick).

        Returns the number of ops that became client-complete: home-acked
        and retired, or quorum-acked around a partitioned home.
        """
        return self.oplog.flush(self._apply_record, max_ops=max_ops)

    def reconcile(self) -> int:
        """Land the home apply for quorum-parked ops once home heals."""
        return self.oplog.reconcile(self._apply_record)

    def replay(self) -> int:
        """Post-crash sync: re-drain pending ops, then repair replicas.

        Per-endpoint acks are persisted as they arrive, so a flusher
        crash mid-quorum resumes from the recorded ack set instead of
        re-earning it; ``reconcile()`` then retires quorum-parked ops
        whose home heal landed, and the trailing ``resync`` converges
        replicas that were partitioned during fan-out or missed
        notifications.
        """
        n = self.oplog.replay(self._apply_record)
        self.reconcile()
        # paths still awaiting home reconciliation are off-limits to
        # anti-entropy: home's copy is older than the acked quorum write
        parked = {r.path for r in self.oplog.unreconciled()}
        seen = set()      # mounts may share one ReplicaSet: resync it once
        for m in self.mounts.values():
            if m.replicas is not None and id(m.replicas) not in seen:
                seen.add(id(m.replicas))
                m.replicas.resync(skip=parked)
        return n

    def sync(self) -> int:
        """Blocking drain (the paper's post-crash sync tool)."""
        total = 0
        while True:
            n = self.pump()
            if not self.oplog.pending():
                return total + n
            if n == 0:
                return total
            total += n

    # ---- consistency / recovery ----------------------------------------------
    def pump_callbacks(self) -> int:
        return sum(nm.pump() for nm in self.notifiers.values())

    def reconnect(self) -> int:
        """After a server crash/partition heals: re-learn and re-register.

        Guarantees on return: every mount's replica fabric is reattached
        (catalog feed re-subscribed, home version vector re-learned when
        reachable), quorum-parked writes were offered to home for
        reconciliation, and the callback channel is re-registered with
        every cached entry revalidated by version.  A home that is
        *still* down does not fail the call — the client stays in
        disconnected operation against the surviving quorum and keeps
        flushing through ``pump()``.
        """
        stale = 0
        parked = {r.path for r in self.oplog.unreconciled()}
        seen = set()
        for prefix, nm in self.notifiers.items():
            m = self.mounts[prefix]
            if m.replicas is not None and id(m.replicas) not in seen:
                seen.add(id(m.replicas))
                m.replicas.reattach(token=m.token, via=self.name,
                                    skip=parked)
            try:
                stale += nm.reconnect(m.token)
            except DisconnectedError:
                continue             # home still down: stay disconnected
            lm = self.leases.get(prefix)
            if lm is not None and lm.at_risk:
                # leases a partition-interrupted renewal (or a token
                # rotation) left unconfirmed: re-verify with the server
                # now that the channel is back, dropping any it expired
                lm.reverify_at_risk()
        self.reconcile()
        return stale

    # ---- locks -------------------------------------------------------------
    def lock(self, path: str) -> bool:
        m = self._mount_for(path)
        return self.leases[m.prefix].acquire(path,
                                             localized=m.is_localized(path))

    def unlock(self, path: str) -> None:
        m = self._mount_for(path)
        self.leases[m.prefix].release(path)
