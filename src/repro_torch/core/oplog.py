"""Persisted meta-operation queue (paper §3.1): the write-behind WAL.

Every mutating operation appends a record and returns — nothing blocks on
the WAN.  A flusher drains the queue in order to the write group (home +
replicas); per-endpoint acknowledgements are persisted as they arrive, so
a flusher crash mid-quorum resumes exactly where it left off.  A record
moves through four states:

  ``pending``       appended, no endpoint has confirmed the apply;
  ``applied@home``  the authoritative home confirmed, but fewer than W of
                    the N write endpoints have — the flusher keeps pushing;
  ``quorum``        at least W endpoints confirmed but home is NOT among
                    them (home was partitioned): the op is client-complete
                    — the client's ``sync()`` no longer waits on it — yet
                    the record (and its shadow payload) is retained until
                    ``reconcile()`` lands the apply at home;
  ``done``          home confirmed and the quorum was met: the record is
                    retired and its shadow file dropped.  Replicas beyond
                    the quorum converge via anti-entropy, not the WAL.

``replay()`` is the paper's post-crash sync tool; ``reconcile()`` is the
quorum-era addition that re-drives home applies for quorum-acked ops once
the home partition heals.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.transport import DisconnectedError

PENDING = "pending"
APPLIED_HOME = "applied@home"
QUORUM = "quorum"
DONE = "done"

#: Statuses the flusher still has to push (the op is not client-complete).
FLUSHABLE = (PENDING, APPLIED_HOME)


# ---- vector-timestamp algebra ------------------------------------------
# A vts maps writer name -> logical clock.  It rides OpRecord and the
# stores' per-path frontier so concurrent branches written around a dead
# home are detectable at reconcile time instead of silently clobbering.

def vts_merge(a: Optional[Dict[str, int]],
              b: Optional[Dict[str, int]]) -> Dict[str, int]:
    """Pointwise max — the least upper bound of two causal histories."""
    out = dict(a) if a else {}
    if b:
        for k, v in b.items():
            if v > out.get(k, 0):
                out[k] = v
    return out


def vts_dominates(a: Optional[Dict[str, int]],
                  b: Optional[Dict[str, int]]) -> bool:
    """True when ``a``'s history includes all of ``b``'s (``a >= b``
    pointwise; equality dominates).  Everything dominates the empty
    (pre-vts / legacy) stamp."""
    if not b:
        return True
    if not a:
        return False
    return all(a.get(k, 0) >= v for k, v in b.items())


def vts_concurrent(a: Optional[Dict[str, int]],
                   b: Optional[Dict[str, int]]) -> bool:
    """Neither branch knows about the other — a true conflict."""
    return not vts_dominates(a, b) and not vts_dominates(b, a)


def vts_lww_key(vts: Optional[Dict[str, int]]) -> Tuple:
    """Deterministic total order for last-writer-wins tie-breaking of
    concurrent branches: more total causal events wins, then the
    lexicographically greatest sorted (writer, clock) sequence.  Two
    concurrent branches can never compare equal (equal sums + equal
    sorted items would be the same dict)."""
    v = vts or {}
    return (sum(v.values()), tuple(sorted(v.items())))


@dataclass
class OpRecord:
    seq: int
    op: str               # "store" | "delete" | "setattr"
    path: str
    payload_file: Optional[str] = None   # shadow-file holding the data
    status: str = PENDING
    acked: List[str] = field(default_factory=list)  # endpoints that confirmed
    version: Optional[int] = None        # version pinned at first apply
    #: vector timestamp stamped at first apply (None on legacy records:
    #: reconcile then keeps the historical blind put-on-top behavior)
    vts: Optional[Dict[str, int]] = None

    def to_json(self) -> Dict:
        return {"seq": self.seq, "op": self.op, "path": self.path,
                "payload_file": self.payload_file, "status": self.status,
                "acked": self.acked, "version": self.version,
                "vts": self.vts}

    @classmethod
    def from_json(cls, d: Dict) -> "OpRecord":
        return cls(**d)


class MetaOpQueue:
    """Append-only JSONL WAL + shadow-file directory."""

    def __init__(self, root: str, compact_threshold: int = 512):
        self.root = root
        os.makedirs(root, exist_ok=True)
        os.makedirs(os.path.join(root, "shadow"), exist_ok=True)
        self.wal_path = os.path.join(root, "oplog.jsonl")
        self.compact_threshold = compact_threshold
        self._lines_written = 0
        self._next_seq = self._recover_next_seq()

    def _recover_next_seq(self) -> int:
        last = 0
        for rec in self.scan():
            last = max(last, rec.seq)
        return last + 1

    # ---- append ----------------------------------------------------------
    def shadow_path(self, seq: int) -> str:
        return os.path.join(self.root, "shadow", f"{seq:012d}.bin")

    def append(self, op: str, path: str,
               data: Optional[bytes] = None) -> OpRecord:
        seq = self._next_seq
        self._next_seq += 1
        payload_file = None
        if data is not None:
            payload_file = self.shadow_path(seq)
            tmp = payload_file + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, payload_file)
        rec = OpRecord(seq=seq, op=op, path=path, payload_file=payload_file)
        with open(self.wal_path, "a") as f:
            f.write(json.dumps(rec.to_json()) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._lines_written += 1
        return rec

    def _persist(self, rec: OpRecord) -> None:
        with open(self.wal_path, "a") as f:
            f.write(json.dumps(rec.to_json()) + "\n")
            f.flush()
        self._lines_written += 1

    # ---- ack bookkeeping -------------------------------------------------
    def mark_acked(self, rec: OpRecord, endpoint: str,
                   version: Optional[int] = None,
                   home: bool = False) -> None:
        """Persist one endpoint's apply confirmation.

        Written to the WAL *before* the flusher moves to the next
        endpoint, so a crash after W-1 acks resumes with those acks in
        hand instead of re-earning them.
        """
        if endpoint not in rec.acked:
            rec.acked.append(endpoint)
        if version is not None:
            rec.version = version
        if home and rec.status == PENDING:
            rec.status = APPLIED_HOME
        self._persist(rec)

    def mark_quorum(self, rec: OpRecord) -> None:
        """W acks reached without home: client-complete, home outstanding."""
        rec.status = QUORUM
        self._persist(rec)

    def mark_done(self, rec: OpRecord) -> None:
        rec.status = DONE
        self._persist(rec)
        if rec.payload_file and os.path.exists(rec.payload_file):
            os.remove(rec.payload_file)
        if (self._lines_written >= self.compact_threshold
                and not getattr(self, "_compacting", False)):
            self.compact()

    # ---- scan / replay -----------------------------------------------------
    def scan(self) -> List[OpRecord]:
        """Latest state per seq, ascending (truncated/garbage lines skipped)."""
        state: Dict[int, OpRecord] = {}
        if not os.path.exists(self.wal_path):
            return []
        with open(self.wal_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = OpRecord.from_json(json.loads(line))
                except (json.JSONDecodeError, TypeError):
                    continue  # torn write at crash tail
                state[rec.seq] = rec
        return [state[s] for s in sorted(state)]

    def pending(self) -> List[OpRecord]:
        # last-close-wins: only the newest pending store per path is shipped
        recs = [r for r in self.scan() if r.status in FLUSHABLE]
        newest: Dict[str, int] = {}
        for r in recs:
            if r.op == "store":
                newest[r.path] = r.seq
        out = []
        for r in recs:
            if r.op == "store" and newest.get(r.path) != r.seq:
                # superseded by a later close; mark done without shipping
                self.mark_done(r)
                continue
            out.append(r)
        return out

    def unreconciled(self) -> List[OpRecord]:
        """Quorum-acked ops whose authoritative home apply is outstanding."""
        return [r for r in self.scan() if r.status == QUORUM]

    def retire_superseded(self, path: str, before_seq: int) -> int:
        """Retire quorum-parked stores of ``path`` older than an op that
        just completed — reconciling such a store later would resurrect
        deleted/overwritten data (last-close-wins applies to parked
        records too)."""
        n = 0
        for rec in self.unreconciled():
            if rec.path == path and rec.seq < before_seq:
                self.mark_done(rec)
                n += 1
        return n

    def _read_payload(self, rec: OpRecord) -> Optional[bytes]:
        if not rec.payload_file:
            return None
        if not os.path.exists(rec.payload_file):
            return None
        with open(rec.payload_file, "rb") as f:
            return f.read()

    def flush(self, apply_fn: Callable[[OpRecord, Optional[bytes]], Optional[bool]],
              max_ops: Optional[int] = None) -> int:
        """Drain flushable ops in order through ``apply_fn``.

        ``apply_fn`` returns truthy (or ``None``, the single-endpoint
        legacy contract) when the authoritative home acknowledged — the
        record retires to ``done`` — and ``False`` when a W-of-N quorum
        acked around a partitioned home: the record parks at ``quorum``
        for later :meth:`reconcile`.  :class:`DisconnectedError` (which a
        missed quorum subclasses) stops the drain; partial acks stay
        persisted.  Returns the number of client-complete ops.
        """
        done = 0
        parked_paths = {r.path for r in self.unreconciled()}
        for rec in self.pending():
            data = None
            if rec.payload_file:
                data = self._read_payload(rec)
                if data is None:
                    self.mark_done(rec)   # shadow lost after done-crash race
                    continue
            try:
                home_acked = apply_fn(rec, data)
            except DisconnectedError:
                break   # WAN down: keep queueing (disconnected operation)
            if home_acked is None or home_acked:
                self.mark_done(rec)
            else:
                self.mark_quorum(rec)
            if rec.op == "store" and rec.path in parked_paths:
                # a newer close completed: older parked stores of this
                # path must never reconcile over it
                self.retire_superseded(rec.path, rec.seq)
            done += 1
            if max_ops is not None and done >= max_ops:
                break
        return done

    def replay(self, apply_fn: Callable[[OpRecord, Optional[bytes]],
                                        Optional[bool]]) -> int:
        """Post-crash convergence: re-drain every record still flushable.

        A record is flushable until its quorum was met — a crash *between*
        two endpoint acks resumes from the persisted ack set, skipping
        endpoints that already confirmed.  Safe because versioned applies
        are idempotent (stores overwrite same-or-older versions only,
        deletes are tolerant).
        """
        return self.flush(apply_fn)

    def reconcile(self, apply_fn: Callable[[OpRecord, Optional[bytes]],
                                           Optional[bool]]) -> int:
        """Land the home apply for quorum-parked ops (home healed).

        Each record that ``apply_fn`` now reports home-acked retires to
        ``done``; records whose home is still unreachable stay parked.
        Returns the number of records retired.
        """
        retired = 0
        for rec in self.unreconciled():
            data = self._read_payload(rec)
            if rec.payload_file and data is None:
                self.mark_done(rec)       # shadow lost after done-crash race
                continue
            try:
                home_acked = apply_fn(rec, data)
            except DisconnectedError:
                continue                  # home still down: stay parked
            if home_acked is None or home_acked:
                self.mark_done(rec)
                retired += 1
        return retired

    def compact(self) -> None:
        """Rewrite the WAL keeping only live (flushable/quorum) records."""
        self._compacting = True
        try:
            recs = sorted(self.pending() + self.unreconciled(),
                          key=lambda r: r.seq)
            tmp = self.wal_path + ".tmp"
            with open(tmp, "w") as f:
                for rec in recs:
                    f.write(json.dumps(rec.to_json()) + "\n")
            os.replace(tmp, self.wal_path)
            self._lines_written = len(recs)
        finally:
            self._compacting = False
