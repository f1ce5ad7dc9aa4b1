"""HomeStore: the authoritative object store (the user's "home space").

Objects are versioned blobs persisted on local disk with atomic renames.
The store runs *at* an endpoint (the user's workstation in the paper; the
checkpoint authority in the training adaptation) and pushes change
notifications to registered callback channels (paper §3.1).
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.transport import (
    Endpoint, KeyPhrase, Network, make_challenge, respond, verify, AuthError,
)


@dataclass
class ObjectStat:
    path: str
    size: int
    version: int
    mtime: float
    is_dir: bool = False

    def to_json(self) -> Dict:
        return {"path": self.path, "size": self.size, "version": self.version,
                "mtime": self.mtime, "is_dir": self.is_dir}

    @classmethod
    def from_json(cls, d: Dict) -> "ObjectStat":
        return cls(**d)


class HomeStore:
    """Versioned blob store over a local directory.

    Layout: ``<root>/data/<path>`` plus ``<root>/meta/<path>.json``.
    """

    def __init__(self, root: str, endpoint: Optional[Endpoint] = None,
                 keyphrase: Optional[KeyPhrase] = None):
        self.root = root
        self.endpoint = endpoint
        self.keyphrase = keyphrase or KeyPhrase.generate()
        os.makedirs(os.path.join(root, "data"), exist_ok=True)
        os.makedirs(os.path.join(root, "meta"), exist_ok=True)
        # path -> list of notify callables (version, stat)
        self._subscribers: List[Callable[[str, ObjectStat], None]] = []
        self._authed_tokens: set = set()
        self._locks: Dict[str, Tuple[str, float]] = {}  # path -> (owner, expiry)
        # path -> vector timestamp (writer -> logical clock): the causal
        # frontier of the bytes this store holds.  Rides existing data
        # messages, so it never costs wire traffic of its own.
        self._vts: Dict[str, Dict[str, int]] = {}

    # ---- auth (USSH <key,phrase> challenge, paper §3.2) ----------------
    def authenticate(self, respond_fn: Callable[[str], str]) -> str:
        challenge = make_challenge()
        response = respond_fn(challenge)
        if not verify(self.keyphrase, challenge, response):
            raise AuthError("challenge failed")
        token = make_challenge()
        self._authed_tokens.add(token)
        return token

    def check(self, token: str) -> None:
        if token not in self._authed_tokens:
            raise AuthError("unauthenticated session")

    # ---- paths -----------------------------------------------------------
    def _dpath(self, path: str) -> str:
        return os.path.join(self.root, "data", path.lstrip("/"))

    def _mpath(self, path: str) -> str:
        return os.path.join(self.root, "meta", path.lstrip("/") + ".json")

    # ---- object API ------------------------------------------------------
    def put(self, token: str, path: str, data: bytes,
            version: Optional[int] = None) -> ObjectStat:
        """Store a blob.  ``version=None`` bumps the local counter (the
        authoritative home path); replicas pass the home version explicitly
        so version numbers mean the same thing fabric-wide."""
        self.check(token)
        dp, mp = self._dpath(path), self._mpath(path)
        os.makedirs(os.path.dirname(dp), exist_ok=True)
        os.makedirs(os.path.dirname(mp), exist_ok=True)
        prev = self.stat_unchecked(path)
        if version is None:
            version = (prev.version + 1) if prev else 1
        # atomic write: temp + rename (crash-safe)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(dp))
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, dp)
        st = ObjectStat(path=path, size=len(data), version=version,
                        mtime=time.time())
        with open(mp + ".tmp", "w") as f:
            json.dump(st.to_json(), f)
        os.replace(mp + ".tmp", mp)
        self._notify(path, st)
        return st

    def apply_versioned(self, token: str, path: str, data: bytes,
                        version: int) -> ObjectStat:
        """Idempotent versioned apply (the quorum-write primitive).

        Writes only if ``version`` is newer than what the store holds and
        returns the stat the store ends up with either way — a flusher
        retry after a crash, or a late home reconciliation of a
        quorum-acked op, must never roll an object back to an older
        version.
        """
        self.check(token)
        cur = self.stat_unchecked(path)
        if cur is not None and cur.version >= version:
            return cur
        return self.put(token, path, data, version=version)

    def get(self, token: str, path: str) -> Tuple[bytes, ObjectStat]:
        self.check(token)
        st = self.stat_unchecked(path)
        if st is None:
            raise FileNotFoundError(path)
        with open(self._dpath(path), "rb") as f:
            return f.read(), st

    def stat(self, token: str, path: str) -> Optional[ObjectStat]:
        self.check(token)
        return self.stat_unchecked(path)

    def stat_unchecked(self, path: str) -> Optional[ObjectStat]:
        mp = self._mpath(path)
        if not os.path.exists(mp):
            return None
        with open(mp) as f:
            return ObjectStat.from_json(json.load(f))

    def vts_of(self, path: str) -> Dict[str, int]:
        """Vector timestamp of the blob at ``path`` (empty for paths
        written before vts tracking or by direct legacy puts)."""
        v = self._vts.get(path)
        return dict(v) if v else {}

    def set_vts(self, path: str, vts: Dict[str, int]) -> None:
        self._vts[path] = dict(vts)

    def delete(self, token: str, path: str) -> None:
        self.check(token)
        self._vts.pop(path, None)
        for p in (self._dpath(path), self._mpath(path)):
            if os.path.exists(p):
                os.remove(p)
        st = ObjectStat(path=path, size=0, version=-1, mtime=time.time())
        self._notify(path, st)

    def listdir(self, token: str, prefix: str) -> List[ObjectStat]:
        self.check(token)
        base = os.path.join(self.root, "meta", prefix.lstrip("/"))
        out: List[ObjectStat] = []
        if not os.path.isdir(base):
            return out
        for dirpath, _, files in os.walk(base):
            for fn in files:
                if not fn.endswith(".json"):
                    continue
                with open(os.path.join(dirpath, fn)) as f:
                    out.append(ObjectStat.from_json(json.load(f)))
        return sorted(out, key=lambda s: s.path)

    def version_vector(self, token: str, prefix: str = "") -> Dict[str, int]:
        """``path -> version`` for everything under ``prefix``.

        This is the anti-entropy primitive: a replica (or the post-crash
        sync tool) diffs its holdings against the home vector to find what
        to pull, push, or drop.
        """
        self.check(token)
        return {st.path: st.version for st in self.listdir(token, prefix)}

    # ---- locks / leases (paper §3.1 lease manager) -----------------------
    def acquire_lock(self, token: str, path: str, owner: str,
                     ttl: float, now: float) -> bool:
        self.check(token)
        cur = self._locks.get(path)
        if cur is not None and cur[1] > now and cur[0] != owner:
            return False
        self._locks[path] = (owner, now + ttl)
        return True

    def renew_lock(self, token: str, path: str, owner: str,
                   ttl: float, now: float) -> bool:
        self.check(token)
        cur = self._locks.get(path)
        if cur is None or cur[0] != owner:
            return False
        self._locks[path] = (owner, now + ttl)
        return True

    def release_lock(self, token: str, path: str, owner: str) -> None:
        self.check(token)
        cur = self._locks.get(path)
        if cur is not None and cur[0] == owner:
            del self._locks[path]

    def lock_owner(self, path: str, now: float) -> Optional[str]:
        cur = self._locks.get(path)
        if cur is None or cur[1] <= now:
            return None
        return cur[0]

    # ---- notifications -----------------------------------------------------
    def subscribe(self, cb: Callable[[str, ObjectStat], None]) -> None:
        self._subscribers.append(cb)

    def unsubscribe(self, cb: Callable[[str, ObjectStat], None]) -> None:
        if cb in self._subscribers:
            self._subscribers.remove(cb)

    def _notify(self, path: str, st: ObjectStat) -> None:
        for cb in list(self._subscribers):
            cb(path, st)
