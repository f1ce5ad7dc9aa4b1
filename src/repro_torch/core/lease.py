"""Lease manager (paper §3.1): remote locks with TTL renewal.

Locks on XUFS-mounted paths are forwarded to the file server; the lease
manager renews them periodically so a crashed client's locks expire rather
than orphan.  Files in *localized directories* use cache-space-local locks
(the parallel FS's own locking in the paper).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Set, Tuple

from repro_torch.core.store import HomeStore
from repro_torch.core.transport import DisconnectedError, Network

DEFAULT_TTL = 30.0


@dataclass
class LeaseManager:
    network: Network
    client_name: str
    server_name: str
    store: HomeStore
    owner: str
    token: str = ""
    ttl: float = DEFAULT_TTL
    held: Set[str] = field(default_factory=set)
    local_locks: Set[str] = field(default_factory=set)
    #: Leases we hold but could not confirm with the server (a partition
    #: interrupted renewal, or a re-mount rotated the token): the
    #: server-side TTL keeps running, so these must be re-verified (or
    #: dropped) before the client may keep acting as lock holder.
    at_risk: Set[str] = field(default_factory=set)
    #: Releases a partition interrupted: we no longer act as holder, but
    #: the server still does — its TTL keeps other writers locked out
    #: until it lapses.  ``reverify_at_risk`` finishes these releases on
    #: heal instead of waiting out the TTL.
    pending_release: Set[str] = field(default_factory=set)
    renew_interruptions: int = 0

    def acquire(self, path: str, localized: bool = False) -> bool:
        if localized:
            if path in self.local_locks:
                return True
            self.local_locks.add(path)
            return True
        self.network.rpc(self.client_name, self.server_name, "lock_acquire")
        ok = self.store.acquire_lock(self.token, path, self.owner, self.ttl,
                                     self.network.clock)
        if ok:
            self.held.add(path)
        return ok

    def release(self, path: str) -> None:
        if path in self.local_locks:
            self.local_locks.discard(path)
            return
        if path in self.held:
            try:
                self.network.rpc(self.client_name, self.server_name,
                                 "lock_release")
                self.store.release_lock(self.token, path, self.owner)
                self.at_risk.discard(path)
            except DisconnectedError:
                # The server still holds the lock and its TTL keeps
                # running, blocking other writers until it lapses.
                # Remember the intent (mirror of the renew_all at-risk
                # fix) so the release completes on heal instead of the
                # lease silently vanishing from our books while the
                # server honors it.
                self.pending_release.add(path)
                self.at_risk.add(path)
            self.held.discard(path)

    def renew_all(self) -> int:
        """Periodic renewal; drops leases the server no longer honors.

        Renewals are independent round-trips, so they ride the channel
        pool concurrently — one RTT per ``channels_per_pair`` leases, not
        one per lease.

        A partition mid-renewal leaves every not-yet-probed lease
        **at risk**: the server-side TTL keeps running while we cannot
        reach it, so those paths move to ``at_risk`` instead of silently
        staying in ``held`` as if renewed (the old behavior — the client
        kept acting as lock holder after the server expired the lease).
        :meth:`reverify_at_risk` settles them once the link heals.
        """
        renewed = 0
        probes = []
        paths = sorted(self.held)        # deterministic probe order
        cut = len(paths)
        for i, path in enumerate(paths):
            try:
                probes.append((path, self.network.transfer(
                    self.client_name, self.server_name, "lock_renew")))
            except DisconnectedError:
                cut = i          # WAN down: the remainder was never probed
                self.renew_interruptions += 1
                break
        self.network.wait_all([t for _, t in probes])
        for path, _t in probes:
            if self.store.renew_lock(self.token, path, self.owner, self.ttl,
                                     self.network.clock):
                renewed += 1
                self.at_risk.discard(path)
            else:
                self.held.discard(path)
                self.at_risk.discard(path)
        for path in paths[cut:]:
            if path in self.held:
                self.at_risk.add(path)
        return renewed

    def reverify_at_risk(self) -> Tuple[int, int]:
        """Settle leases left at risk by an interrupted renewal.

        Re-probes the server for each at-risk path: a lease it still
        honors is renewed and kept; one it expired (or re-granted to
        another owner) is dropped from ``held`` — holding a lock on hope
        alone is exactly the corruption the at-risk set exists to stop.
        Called from ``XufsClient.reconnect()`` and the scheduled lease
        task.  Returns ``(kept, dropped)``; if the WAN is still down,
        everything left unprobed stays at risk.
        """
        kept = dropped = 0
        probes = []
        for path in sorted(self.at_risk):
            op = ("lock_release" if path in self.pending_release
                  else "lock_reverify")
            try:
                probes.append((path, self.network.transfer(
                    self.client_name, self.server_name, op)))
            except DisconnectedError:
                break            # still partitioned: the rest stay at risk
        self.network.wait_all([t for _, t in probes])
        for path, _t in probes:
            if path in self.pending_release:
                # finish the interrupted release: the server-side lock
                # goes away now instead of at TTL expiry
                self.store.release_lock(self.token, path, self.owner)
                self.pending_release.discard(path)
                self.at_risk.discard(path)
                dropped += 1
                continue
            if self.store.renew_lock(self.token, path, self.owner, self.ttl,
                                     self.network.clock):
                kept += 1
            else:
                self.held.discard(path)
                dropped += 1
            self.at_risk.discard(path)
        return kept, dropped
