"""Notification callback manager (paper §3.1, AFS-2 style consistency).

The client registers a callback channel with the home server; any home-side
change pushes an invalidation.  Cached copies are assumed fresh unless
notified — no per-open version checks (unlike NFS/Jade).  If the channel
breaks (server crash / partition), the client enters disconnected mode and
on reconnect re-registers and revalidates every cached entry by version.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from repro_torch.core.cache import CacheSpace, VALID, EMPTY
from repro_torch.core.store import HomeStore, ObjectStat
from repro_torch.core.transport import DisconnectedError, Network


@dataclass
class NotificationManager:
    network: Network
    client_name: str
    server_name: str
    store: HomeStore
    cache: CacheSpace
    prefix: str = ""
    connected: bool = False
    pending: List[Tuple[str, ObjectStat]] = field(default_factory=list)
    breaks: int = 0
    _cb: Optional[Callable] = None

    # ---- channel lifecycle ------------------------------------------------
    def register(self, token: str) -> None:
        """Open the callback channel (one RPC) and subscribe server-side."""
        self.network.rpc(self.client_name, self.server_name,
                         "register_callbacks")
        self.store.check(token)

        def _cb(path: str, st: ObjectStat) -> None:
            # server pushes over the (modeled) channel; queue client-side
            if self.prefix and not path.startswith(self.prefix):
                return
            self.pending.append((path, st))

        self._cb = _cb
        self.store.subscribe(_cb)
        self.connected = True

    def teardown(self) -> None:
        if self._cb is not None:
            self.store.unsubscribe(self._cb)
            self._cb = None
        self.connected = False

    # ---- pump: deliver queued notifications --------------------------------
    def pump(self) -> int:
        """Apply queued invalidations.  Detects a broken channel."""
        if not self.connected:
            return 0
        try:
            # channel liveness probe rides the persistent TCP connection
            self.network.rpc(self.client_name, self.server_name,
                             "callback_keepalive")
        except DisconnectedError:
            self.connected = False
            self.breaks += 1
            return 0
        n = 0
        while self.pending:
            path, st = self.pending.pop(0)
            if st.version < 0:
                self.cache.invalidate(path)     # deletion
            else:
                self.cache.invalidate(path, st)
            n += 1
        return n

    # ---- recovery ------------------------------------------------------------
    def reconnect(self, token: str) -> int:
        """Re-register after a break and revalidate all cached entries.

        The per-entry ``revalidate_stat`` probes are pipelined over the
        channel pool (they are independent round-trips), so revalidating
        a big cache costs ~ceil(entries / channels) RTTs instead of one
        RTT per entry.  Returns the number of entries found stale (and
        invalidated).
        """
        self.pending.clear()
        if self._cb is not None:
            self.store.unsubscribe(self._cb)
        self.register(token)
        entries = self.cache.entries(self.prefix)
        probes = [self.network.transfer(self.client_name, self.server_name,
                                        "revalidate_stat")
                  for _ in entries]
        self.network.wait_all(probes)
        stale = 0
        for entry in entries:
            st = self.store.stat(token, entry.path)
            if st is None:
                self.cache.invalidate(entry.path)
                stale += 1
            elif st.version > entry.stat.version:
                self.cache.invalidate(entry.path, st)
                stale += 1
        return stale
