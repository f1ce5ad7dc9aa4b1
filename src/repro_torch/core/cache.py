"""CacheSpace: whole-object disk cache with hidden attribute files.

Mirrors the paper's design: ``opendir()`` recreates the remote directory in
cache space as empty entries plus hidden per-entry attribute files; only a
first ``open()`` fetches content.  Entries carry a state machine:

    EMPTY    listed, attributes cached, no data
    VALID    whole object cached, callback promise held
    DIRTY    modified locally, flush pending in the meta-op queue
    INVALID  callback fired: home changed; re-fetch before next access
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

from repro_torch.core.store import ObjectStat

EMPTY = "empty"
VALID = "valid"
DIRTY = "dirty"
INVALID = "invalid"


@dataclass
class CacheEntry:
    path: str
    state: str
    stat: ObjectStat

    def to_json(self) -> Dict:
        return {"path": self.path, "state": self.state,
                "stat": self.stat.to_json()}

    @classmethod
    def from_json(cls, d: Dict) -> "CacheEntry":
        return cls(path=d["path"], state=d["state"],
                   stat=ObjectStat.from_json(d["stat"]))


@dataclass(frozen=True)
class CacheStats:
    """Typed counter snapshot — what reporting consumes instead of
    poking the cache's raw dicts (``benchmarks/common.py``, eviction
    accounting)."""

    hits: int
    misses: int
    invalidations: int
    fills: int                       # total cache fills, all sources
    fills_from: Dict[str, int]       # endpoint name -> fills it served
    bytes_resident: int              # live data bytes in cache space

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class CacheSpace:
    """On-disk whole-object cache (sited on the fast local/parallel FS)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        # endpoint name -> number of cache fills it served (replica routing)
        self.fills_from: Dict[str, int] = {}
        # live data bytes, tracked incrementally at store/evict time
        self.bytes_resident = 0

    def record_fill(self, source: str) -> None:
        self.fills_from[source] = self.fills_from.get(source, 0) + 1

    def stats(self) -> CacheStats:
        return CacheStats(hits=self.hits, misses=self.misses,
                          invalidations=self.invalidations,
                          fills=sum(self.fills_from.values()),
                          fills_from=dict(self.fills_from),
                          bytes_resident=self.bytes_resident)

    # ---- paths: data file + hidden attr file alongside -------------------
    def data_path(self, path: str) -> str:
        return os.path.join(self.root, "obj", path.lstrip("/"))

    def attr_path(self, path: str) -> str:
        p = path.lstrip("/")
        d, name = os.path.split(p)
        return os.path.join(self.root, "obj", d, f".xufs.{name}.meta")

    # ---- entry state ------------------------------------------------------
    def lookup(self, path: str) -> Optional[CacheEntry]:
        ap = self.attr_path(path)
        if not os.path.exists(ap):
            return None
        with open(ap) as f:
            return CacheEntry.from_json(json.load(f))

    def write_entry(self, entry: CacheEntry) -> None:
        ap = self.attr_path(entry.path)
        os.makedirs(os.path.dirname(ap), exist_ok=True)
        with open(ap + ".tmp", "w") as f:
            json.dump(entry.to_json(), f)
        os.replace(ap + ".tmp", ap)

    def store_data(self, path: str, data: bytes, stat: ObjectStat,
                   state: str = VALID) -> CacheEntry:
        dp = self.data_path(path)
        os.makedirs(os.path.dirname(dp), exist_ok=True)
        old = os.path.getsize(dp) if os.path.exists(dp) else 0
        with open(dp + ".tmp", "wb") as f:
            f.write(data)
        os.replace(dp + ".tmp", dp)
        self.bytes_resident += len(data) - old
        entry = CacheEntry(path=path, state=state, stat=stat)
        self.write_entry(entry)
        return entry

    def read_data(self, path: str) -> bytes:
        with open(self.data_path(path), "rb") as f:
            return f.read()

    def populate_listing(self, stats: Iterable[ObjectStat]) -> int:
        """opendir(): create EMPTY entries + attr files (no data fetched)."""
        n = 0
        for st in stats:
            cur = self.lookup(st.path)
            if cur is not None and cur.state in (VALID, DIRTY) \
                    and cur.stat.version >= st.version:
                continue
            self.write_entry(CacheEntry(path=st.path, state=EMPTY, stat=st))
            n += 1
        return n

    def evict(self, path: str) -> int:
        """Drop the cached copy entirely: data file + hidden attr file.
        The next access is a cold fill (unlike ``invalidate``, which
        keeps the entry and marks it stale).  Returns the data bytes
        freed, so eviction accounting composes without a re-stat."""
        freed = 0
        dp = self.data_path(path)
        if os.path.exists(dp):
            freed = os.path.getsize(dp)
            os.remove(dp)
            self.bytes_resident -= freed
        ap = self.attr_path(path)
        if os.path.exists(ap):
            os.remove(ap)
        return freed

    def invalidate(self, path: str, new_stat: Optional[ObjectStat] = None):
        entry = self.lookup(path)
        if entry is None:
            return
        if entry.state == DIRTY:
            # local modifications win locally; flush order decides at home
            return
        if (new_stat is not None and entry.state == VALID
                and new_stat.version >= 0
                and new_stat.version <= entry.stat.version):
            return  # notification for the version we already hold
        entry.state = INVALID
        if new_stat is not None:
            entry.stat = new_stat
        self.write_entry(entry)
        self.invalidations += 1

    def entries(self, prefix: str = "") -> List[CacheEntry]:
        base = os.path.join(self.root, "obj", prefix.lstrip("/"))
        out: List[CacheEntry] = []
        if not os.path.isdir(base):
            return out
        for dirpath, _, files in os.walk(base):
            for fn in files:
                if fn.startswith(".xufs.") and fn.endswith(".meta"):
                    with open(os.path.join(dirpath, fn)) as f:
                        out.append(CacheEntry.from_json(json.load(f)))
        return sorted(out, key=lambda e: e.path)
