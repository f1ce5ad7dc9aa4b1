"""USSH session objects + the deprecated ``ussh_login`` shim.

:class:`Session` is what :meth:`repro_torch.core.fabric.Fabric.login` returns:
the user's personal file server, the site-side client, the auth token,
and the replica fabric, plus the :class:`~repro_torch.core.fabric.MountSpec`
per mount so a bare :meth:`Session.remount` restores every mount exactly
as declared (localized sub-prefixes included).

``ussh_login`` mirrors the paper's §3.2 flow but is **deprecated**: it
accreted ten keyword arguments and hid link construction, latency
composition, and NIC wiring in its body.  It survives as a thin shim
that assembles a declarative :class:`~repro_torch.core.fabric.FabricSpec` and
delegates to ``Fabric.login`` — bit-identical wiring (held by
``tests/test_fabric_spec.py``), one :class:`DeprecationWarning` per
process.  New code declares a spec; see ``docs/fabric.md``.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional

from repro_torch.core.namespace import XufsClient
from repro_torch.core.replication import ReplicaSet, WritePolicy
from repro_torch.core.store import HomeStore
from repro_torch.core.transport import Endpoint, Network, respond

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.core.fabric import MountSpec
    from repro_torch.core.tasks import MaintenanceReport, MaintenanceScheduler


@dataclass
class UserFileServer:
    """Personal user-space file server bound to one user's home space."""

    user: str
    endpoint: Endpoint
    store: HomeStore
    restarts: int = 0

    def crash(self) -> None:
        """Simulate a server crash: drop auth state + subscriptions."""
        self.store._authed_tokens.clear()
        self.store._subscribers.clear()

    def restart(self) -> None:
        """The paper restarts the server from a crontab job on recovery."""
        self.restarts += 1


@dataclass
class Session:
    user: str
    network: Network
    server: UserFileServer
    client: XufsClient
    token: str
    replicas: Optional[ReplicaSet] = None
    #: prefix -> the MountSpec it was mounted with; remount()'s witness.
    mount_specs: Dict[str, "MountSpec"] = field(default_factory=dict)
    #: the Fabric's shared maintenance scheduler (None when the spec
    #: declared no MaintenanceSpec) — the session's handle for driving
    #: background upkeep (``scheduler.run_until``) and inspecting it.
    scheduler: Optional["MaintenanceScheduler"] = None

    def maintenance_report(self) -> Optional["MaintenanceReport"]:
        """Snapshot of the fabric's maintenance plane, or None when no
        ``MaintenanceSpec`` was declared."""
        return self.scheduler.report() if self.scheduler is not None \
            else None

    def remount(self, prefix: Optional[str] = None,
                localized: Optional[List[str]] = None) -> None:
        """Re-authenticate and re-mount this session's home mounts.

        With no arguments every mount backed by this session's home
        store is restored exactly as declared — stored
        :class:`MountSpec` first, mounts added directly via
        ``client.mount()`` field-for-field off the live Mount (localized
        sub-prefixes included either way; a bare remount used to
        silently drop them).  Mounts backed by a *foreign* home store
        are left untouched: our crash did not invalidate their tokens
        and this session cannot re-authenticate them.  ``prefix``
        restores one mount; ``localized`` additionally replaces that
        mount's localized set and updates the stored spec.  All
        argument validation happens before the token rotates, so a
        rejected call leaves the session exactly as it was.
        """
        from repro_torch.core.fabric import MountSpec   # session<->fabric cycle
        if prefix is None and localized is not None:
            raise ValueError("localized override requires a prefix")
        target: Optional["MountSpec"] = None
        if prefix is not None:
            live = self.client.mounts.get(prefix)
            if live is not None and live.store is not self.server.store:
                raise ValueError(
                    f"mount {prefix!r} is backed by another home store; "
                    "remount it from the session that owns it")
            if localized is not None:
                target = MountSpec(prefix, tuple(localized))
            elif prefix in self.mount_specs:
                target = self.mount_specs[prefix]
            else:
                try:
                    target = MountSpec(prefix, tuple(live.localized)
                                       if live is not None else ())
                except ValueError:
                    target = None     # legacy spelling client.mount()
                    #                   accepted: restore raw, unrecorded
        token = _authenticate(self.server)
        self.token = token
        if self.replicas is not None:
            self.replicas.reattach(token=token)
        if prefix is not None:
            if target is not None:
                self.mount_specs[prefix] = target
                loc = list(target.localized)
            else:
                loc = list(live.localized) if live is not None else []
            # a live mount keeps its own replica wiring (a side mount
            # created replicas=None must not gain the session's fabric)
            self.client.mount(prefix, self.server.endpoint.name,
                              self.server.store, token, localized=loc,
                              replicas=live.replicas if live is not None
                              else self.replicas)
            return
        for spec in self.mount_specs.values():
            live = self.client.mounts.get(spec.prefix)
            if live is not None and live.store is not self.server.store:
                continue          # prefix re-pointed at a foreign home
                #                   since login: the live mount wins
            self.client.mount(spec.prefix, self.server.endpoint.name,
                              self.server.store, token,
                              localized=list(spec.localized),
                              replicas=live.replicas if live is not None
                              else self.replicas)
        for p, m in list(self.client.mounts.items()):
            if p in self.mount_specs or m.store is not self.server.store:
                continue          # foreign home: not ours to rebind
            self.client.mount(p, m.server_name, m.store, token,
                              localized=list(m.localized),
                              replicas=m.replicas)


def _authenticate(server: UserFileServer) -> str:
    kp = server.store.keyphrase
    return server.store.authenticate(lambda ch: respond(kp, ch))


#: ``ussh_login`` warns once per process, not once per call — benchmark
#: sweeps and multi-user scripts log in dozens of times.
_DEPRECATION_WARNED = False


def ussh_login(user: str, network: Network, home_root: str,
               site_root: str, *, home_name: str = "home",
               site_name: str = "site",
               mounts: Optional[Dict[str, List[str]]] = None,
               replica_sites: Optional[Dict[str, float]] = None,
               write_quorum: "WritePolicy" = 1,
               nic_budgets: Optional[Dict[str, float]] = None,
               queue_aware: bool = True) -> Session:
    """Deprecated: assemble a :class:`FabricSpec` and ``Fabric.login``.

    Kept as a shim for existing callers; the wiring is bit-identical to
    the spec path (``tests/test_fabric_spec.py`` holds the trace
    equivalence).  The keyword arguments map onto the spec one-for-one —
    ``docs/fabric.md`` has the full migration table:

    ``home_name``/``site_name`` + roots -> :class:`SiteSpec`;
    ``replica_sites={r: lat}`` -> ``SiteSpec(r)`` + ``LinkSpec(site, r,
    latency_s=lat)`` + ``ReplicaPolicy(sites=(r, ...))``;
    ``write_quorum``/``queue_aware`` -> :class:`ReplicaPolicy` fields;
    ``nic_budgets`` -> ``SiteSpec(nic_budget=...)``;
    ``mounts={prefix: localized}`` -> :class:`MountSpec`.

    One deliberate tightening: mount prefixes not ending in ``/`` (or
    localized entries outside their prefix) now fail fast with
    ``ValueError`` via :class:`MountSpec` validation, where the old code
    silently accepted them and string-prefix matching could bleed a
    ``data`` mount onto ``database/...`` paths.
    """
    from repro_torch.core.fabric import (
        Fabric, FabricSpec, MountSpec, ReplicaPolicy,
    )
    global _DEPRECATION_WARNED
    if not _DEPRECATION_WARNED:
        _DEPRECATION_WARNED = True
        warnings.warn(
            "ussh_login() is deprecated: declare the topology once — "
            "Fabric(FabricSpec(sites=(SiteSpec('home', root=...), "
            "SiteSpec('site', root=...), ...), links=(LinkSpec('site', "
            "'r1', latency_s=...), ...))).login(user, "
            "mounts=[MountSpec('home/', localized=(...,))], "
            "replicas=ReplicaPolicy(sites=(...), write_quorum=..., "
            "queue_aware=...)) — see docs/fabric.md for the migration "
            "table", DeprecationWarning, stacklevel=2)
    spec = FabricSpec.star(home_root, site_root, home=home_name,
                           site=site_name, replica_latencies=replica_sites,
                           nic_budgets=nic_budgets, link=network.link)
    policy = None
    if replica_sites:
        policy = ReplicaPolicy(sites=tuple(replica_sites),
                               write_quorum=write_quorum,
                               queue_aware=queue_aware)
    # an empty mounts dict got the default home/ mount pre-refactor
    # (`mounts or {...}`) — only a non-empty dict overrides it
    mount_specs = [MountSpec(prefix, tuple(localized or ()))
                   for prefix, localized in mounts.items()] \
        if mounts else None
    return Fabric(spec, network=network).login(
        user, home=home_name, site=site_name, mounts=mount_specs,
        replicas=policy)
