"""Declarative fabric spec: one topology API for sites, links, replicas,
and multi-user sessions.

XUFS's value proposition (paper §3) is that a researcher declares *what*
their private distributed namespace looks like and the system handles the
wide-area plumbing.  This module is that declaration:

  * :class:`FabricSpec` — a frozen, shareable description of a topology:
    the sites (endpoints, optionally with filesystem roots and NIC
    budgets), the links between them (latency override or a full
    :class:`LinkModel`), and the default link every undeclared pair
    rides.  Specs validate at construction, so a typo'd replica name or
    a negative budget fails before any wire is modeled.
  * :class:`Fabric` — the runtime built from a spec.  It owns the
    :class:`Network`, registers every endpoint, applies links and NIC
    budgets exactly once, and hands out sessions via :meth:`Fabric.login`
    — so multiple users/sessions compose on one shared topology as
    first-class API instead of each call site hand-rolling endpoints and
    links (which is what ``ussh_login`` used to force on every caller).
  * :class:`ReplicaPolicy` / :class:`MountSpec` — per-session policy
    (which declared sites replicate a home space, the W-of-N write-ack
    rule, queue-aware routing, an optional :class:`EvictionSpec`
    capacity bound driving on-demand placement and scheduled
    eviction) and the
    namespace mounts, separated from the topology they run on — replica
    *policy* apart from transport *mechanism*, per the GridFTP replica
    management line.

Latency composition: a replica site is near the compute site but
WAN-far from home, so when a login places a replica whose ``home <->
replica`` link was never declared, the fabric resolves it to

    default link latency  +  declared site <-> replica latency

(the rule ``ussh_login`` used to hide in its body).  Declaring an
explicit :class:`LinkSpec` for the pair overrides the composition.

``ussh_login`` (``repro_torch.core.session``) survives as a thin deprecated
shim that assembles a :class:`FabricSpec` from its keyword arguments and
delegates here — bit-identical wiring, one ``DeprecationWarning``.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.bulk import BulkSpec
from repro_torch.core.faults import FaultInjector, FaultPlan
from repro_torch.core.namespace import XufsClient
from repro_torch.core.replication import (
    EvictionSpec, ReplicaSet, WriteLeaseSpec, WritePolicy,
)
from repro_torch.core.session import Session, UserFileServer, _authenticate
from repro_torch.core.store import HomeStore
from repro_torch.core.tasks import (
    MaintenanceReport, MaintenanceScheduler, MaintenanceSpec,
)
from repro_torch.core.transport import (
    DisconnectedError, Endpoint, KeyPhrase, LinkModel, Network,
)


def _pair(a: str, b: str) -> Tuple[str, str]:
    return (min(a, b), max(a, b))


_CAPACITY_DEPRECATION_WARNED = False


def _warn_capacity_bytes_once() -> None:
    """One DeprecationWarning per process, the ``ussh_login`` shim
    pattern: loud enough to migrate, quiet enough for a long session."""
    global _CAPACITY_DEPRECATION_WARNED
    if not _CAPACITY_DEPRECATION_WARNED:
        _CAPACITY_DEPRECATION_WARNED = True
        warnings.warn(
            "ReplicaPolicy(capacity_bytes=...) is deprecated; pass "
            "eviction=EvictionSpec(capacity=...) — the alias assembles "
            "the default spec (lru, 0.9/0.6 watermarks, 10s scans) and "
            "will be dropped in a major version; see docs/fabric.md "
            "migration table", DeprecationWarning, stacklevel=3)


@dataclass(frozen=True)
class SiteSpec:
    """One named endpoint of the fabric.

    ``root`` is the local filesystem directory backing stores/caches at
    the site (required on sites that host a home space or a client;
    replica sites store under the home site's root).  ``nic_budget``
    caps the endpoint's aggregate NIC bytes/s (``None`` = uncapped, the
    default — see ``docs/transport.md``).
    """

    name: str
    root: Optional[str] = None
    nic_budget: Optional[float] = None

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("SiteSpec needs a non-empty name")
        if self.nic_budget is not None and self.nic_budget <= 0:
            raise ValueError(
                f"site {self.name!r}: NIC budget must be > 0, "
                f"got {self.nic_budget}")


@dataclass(frozen=True)
class LinkSpec:
    """One declared pair link: a latency override of the fabric default,
    or a full :class:`LinkModel` replacement (exactly one of the two)."""

    a: str
    b: str
    latency_s: Optional[float] = None
    link: Optional[LinkModel] = None

    def __post_init__(self) -> None:
        if self.a == self.b:
            raise ValueError(f"link {self.a!r} <-> itself is meaningless")
        if (self.latency_s is None) == (self.link is None):
            raise ValueError(
                f"link {self.a!r}<->{self.b!r}: give exactly one of "
                "latency_s or link")
        if self.latency_s is not None and self.latency_s < 0:
            raise ValueError(
                f"link {self.a!r}<->{self.b!r}: latency must be >= 0")

    @property
    def pair(self) -> Tuple[str, str]:
        return _pair(self.a, self.b)


@dataclass(frozen=True)
class ReplicaPolicy:
    """Replica *policy* for one session's home space, apart from the
    topology mechanism it runs on.

    ``sites`` names declared fabric sites that hold read replicas;
    ``write_quorum`` is the W-of-N ack rule (explicit W, ``"majority"``,
    or ``"all"`` — see ``docs/consistency.md``); ``queue_aware`` toggles
    estimated-completion routing.  ``eviction`` is an optional
    :class:`EvictionSpec` bounding each replica's resident bytes: the
    set fills on demand (read repair IS placement), resync refreshes
    only the resident hot set, and — when the fabric's maintenance
    plane is armed — a scheduled ``evict:`` task trims back under the
    watermarks (``docs/maintenance.md``).  Unset ⇒ replicas mirror the
    whole home space, traces bit-identical to the pre-eviction fabric.

    ``write_lease`` is an optional :class:`WriteLeaseSpec`: when set,
    the flusher serializes concurrent writers of one path through
    short-TTL write leases on the replica set before quorum fan-out
    (``docs/consistency.md``).  Unset (default) ⇒ no lease traffic,
    traces bit-identical to the pre-lease fabric; concurrent branches
    written around a dead home are still caught at reconcile time by
    their vector timestamps.

    ``bulk`` is an optional :class:`BulkSpec` (``repro_torch.core.bulk``,
    ``docs/transport.md``): apply/fetch stripe widths follow the granted
    stream budget, and with ``third_party=True`` maintenance repairs
    pull from the cheapest fresh replica instead of home or the client.
    Unset ⇒ the session inherits ``FabricSpec.bulk``; both unset ⇒
    fixed-width striping, legacy sources, traces bit-identical.

    ``capacity_bytes`` survives as a deprecated alias that assembles
    ``EvictionSpec(capacity=...)`` and warns once per process (the
    ``ussh_login`` shim pattern).
    """

    sites: Tuple[str, ...] = ()
    write_quorum: WritePolicy = 1
    queue_aware: bool = True
    capacity_bytes: Optional[int] = None
    eviction: Optional[EvictionSpec] = None
    write_lease: Optional[WriteLeaseSpec] = None
    bulk: Optional[BulkSpec] = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "sites", tuple(self.sites))
        if len(set(self.sites)) != len(self.sites):
            raise ValueError(f"duplicate replica sites: {self.sites}")
        if isinstance(self.write_quorum, str):
            if self.write_quorum not in ("majority", "all"):
                raise ValueError(
                    f"write_quorum must be an int, 'majority' or 'all': "
                    f"{self.write_quorum!r}")
        elif int(self.write_quorum) < 1:
            raise ValueError(f"write_quorum must be >= 1: "
                             f"{self.write_quorum}")
        if self.capacity_bytes is not None:
            if self.capacity_bytes <= 0:
                raise ValueError(
                    f"capacity_bytes must be > 0 (or None = unbounded): "
                    f"{self.capacity_bytes}")
            if self.eviction is not None:
                if self.eviction.capacity != self.capacity_bytes:
                    raise ValueError(
                        f"conflicting capacity_bytes={self.capacity_bytes} "
                        f"and eviction.capacity={self.eviction.capacity}; "
                        "drop the deprecated alias")
            else:
                _warn_capacity_bytes_once()
                object.__setattr__(
                    self, "eviction",
                    EvictionSpec(capacity=self.capacity_bytes))


@dataclass(frozen=True)
class MountSpec:
    """One namespace mount: a prefix plus its *localized* sub-prefixes —
    directories whose new data never ships back to home (paper §3.1)."""

    prefix: str
    localized: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "localized", tuple(self.localized))
        if not self.prefix.endswith("/"):
            raise ValueError(
                f"mount prefix must end with '/': {self.prefix!r}")
        for sub in self.localized:
            if not sub.startswith(self.prefix):
                raise ValueError(
                    f"localized {sub!r} is not under mount {self.prefix!r}")


@dataclass(frozen=True)
class FabricSpec:
    """A declarative, shareable topology: sites, links, and the default
    :class:`LinkModel` every undeclared pair rides."""

    sites: Tuple[SiteSpec, ...] = ()
    links: Tuple[LinkSpec, ...] = ()
    link: LinkModel = field(default_factory=LinkModel)
    #: Background maintenance plane (``docs/maintenance.md``): when set,
    #: the Fabric owns ONE MaintenanceScheduler shared by all logins and
    #: every login/attach registers its resync / read-repair drain /
    #: lease-renewal / oplog-reconcile tasks on it.  Unset (default) ⇒
    #: no scheduler exists and every wire event is bit-identical to the
    #: pre-maintenance fabric.
    maintenance: Optional[MaintenanceSpec] = None
    #: Fabric-wide default bulk-transfer policy: a login whose
    #: ``ReplicaPolicy.bulk`` is unset inherits this.  Both unset
    #: (default) ⇒ no bulk plane, traces bit-identical.
    bulk: Optional[BulkSpec] = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "sites", tuple(self.sites))
        object.__setattr__(self, "links", tuple(self.links))
        names = [s.name for s in self.sites]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate site names: {dupes}")
        known = set(names)
        pairs = set()
        for ls in self.links:
            for end in (ls.a, ls.b):
                if end not in known:
                    raise ValueError(
                        f"link {ls.a!r}<->{ls.b!r} references undeclared "
                        f"site {end!r}")
            if ls.pair in pairs:
                raise ValueError(f"duplicate link {ls.a!r}<->{ls.b!r}")
            pairs.add(ls.pair)

    def site(self, name: str) -> SiteSpec:
        for s in self.sites:
            if s.name == name:
                return s
        raise KeyError(f"{name!r} is not a declared fabric site "
                       f"(have: {sorted(s.name for s in self.sites)})")

    @classmethod
    def star(cls, home_root: Optional[str], site_root: Optional[str], *,
             home: str = "home", site: str = "site",
             replica_latencies: Optional[Dict[str, float]] = None,
             nic_budgets: Optional[Dict[str, float]] = None,
             link: Optional[LinkModel] = None,
             extra_sites: Sequence[SiteSpec] = (),
             extra_links: Sequence[LinkSpec] = ()) -> "FabricSpec":
        """The canonical one-home/one-compute-site star.

        Replica sites hang off the compute ``site`` at their declared
        latencies (the ``home <-> replica`` path is left to the
        composition rule), NIC budgets land on their named sites (a
        budget naming an endpoint outside the star becomes a
        budget-only site), and ``extra_sites`` / ``extra_links`` graft
        incast clients and the like on.  The ``ussh_login`` shim and
        the benchmarks both build their topologies through here.
        """
        budgets = dict(nic_budgets or {})
        sites = [SiteSpec(home, root=home_root,
                          nic_budget=budgets.pop(home, None)),
                 SiteSpec(site, root=site_root,
                          nic_budget=budgets.pop(site, None))]
        links = []
        for rname, latency_s in (replica_latencies or {}).items():
            sites.append(SiteSpec(rname,
                                  nic_budget=budgets.pop(rname, None)))
            links.append(LinkSpec(site, rname, latency_s=latency_s))
        for es in extra_sites:
            if es.name in budgets:        # budget named a grafted site
                es = _dc_replace(es, nic_budget=budgets.pop(es.name))
            sites.append(es)
        sites.extend(SiteSpec(name, nic_budget=b)
                     for name, b in budgets.items())
        links.extend(extra_links)
        return cls(sites=tuple(sites), links=tuple(links),
                   link=link if link is not None else LinkModel())


class Fabric:
    """Runtime topology built from a :class:`FabricSpec`.

    Owns the :class:`Network` (or attaches to an existing one — the
    ``ussh_login`` shim path), registers every declared site exactly
    once, applies link overrides and NIC budgets, and mints sessions via
    :meth:`login` / extra readers via :meth:`attach`.  All sessions share
    the one network, so their traffic contends for the same channels and
    NIC budgets — multi-user composition is the default, not a
    copy-paste exercise.
    """

    def __init__(self, spec: FabricSpec,
                 network: Optional[Network] = None):
        self.spec = spec
        if network is not None and network.link != spec.link:
            # undeclared pairs ride network.link, not spec.link — a
            # silently-divergent default would skew every derived
            # timing number
            raise ValueError(
                "FabricSpec.link differs from the attached Network's "
                "default link; declare the same LinkModel (or omit "
                "network= and let the Fabric own one)")
        self.network = network if network is not None \
            else Network(link=_dc_replace(spec.link))
        self.sessions: List[Session] = []
        #: ONE scheduler per fabric, shared by every login/attach — the
        #: per-path lock table and the counters span all sessions, which
        #: is what makes "two sessions never double-repair a path" a
        #: fabric-level guarantee rather than a per-client hope.
        self.scheduler: Optional[MaintenanceScheduler] = None
        if spec.maintenance is not None:
            self.scheduler = MaintenanceScheduler(self.network,
                                                  spec.maintenance)
        #: armed FaultInjector (:meth:`arm_faults`); None ⇒ no fault
        #: plan, every wire event bit-identical to the unarmed fabric
        self.faults: Optional[FaultInjector] = None
        # intern every declared site (and all site pairs) up front so
        # the engine's id tables and channel arrays are sized before
        # the first reservation — steady-state traffic never grows them
        self.network.prealloc([site.name for site in spec.sites])
        for site in spec.sites:
            Endpoint(site.name, self.network)
            if site.nic_budget is not None:
                self.network.set_nic_budget(site.name, site.nic_budget)
        for ls in spec.links:
            if network is not None and self.network.has_link(ls.a, ls.b):
                # attached to a live shared network: a pair another
                # fabric (or an earlier login's composition) already
                # timed is never retimed — same first-wins rule the
                # login composition follows
                continue
            self.network.set_link(ls.a, ls.b, self._resolve_link(ls))

    def _resolve_link(self, ls: LinkSpec) -> LinkModel:
        if ls.link is not None:
            return ls.link
        return _dc_replace(self.network.link, latency_s=ls.latency_s)

    def _site_root(self, name: str, override: Optional[str],
                   what: str) -> str:
        site = self.spec.site(name)        # KeyError on a typo'd name,
        #                                    override or not
        root = override if override is not None else site.root
        if root is None:
            raise ValueError(
                f"site {name!r} declares no filesystem root; a {what} "
                "needs one (SiteSpec(root=...) or the login override)")
        return root

    # ---- fault injection -------------------------------------------------
    def arm_faults(self, plan: FaultPlan) -> FaultInjector:
        """Arm a declarative :class:`FaultPlan` on this fabric's clock.

        The network pumps the injector lazily before every partition-
        sensitive operation, and the maintenance scheduler (when one is
        declared) walks its clock through fault times — so partitions,
        heals, flaps, and crashes fire exactly at their declared
        instants with no hand-rolled ``network.partition(...)``
        choreography at the call sites.  Arming an empty plan changes
        no trace; re-arming replaces the prior plan.  Returns the
        injector for counter inspection (``fired`` / ``crashes``).
        """
        injector = FaultInjector(self.network, plan,
                                 crash_fn=self._crash_site)
        self.faults = injector
        self.network.arm_faults(injector)
        if self.scheduler is not None:
            self.scheduler.faults = injector
        return injector

    def _crash_site(self, site: str) -> int:
        """CrashEvent hook: crash every user file server hosted at
        ``site`` (auth state and subscriptions drop — the paper's
        crontab restart maps to ``Session.remount()`` afterwards)."""
        crashed = 0
        for s in self.sessions:
            if s.server.endpoint.name == site:
                s.server.crash()
                crashed += 1
        return crashed

    # ---- background maintenance ------------------------------------------
    def maintenance_report(self) -> Optional[MaintenanceReport]:
        """Snapshot of the maintenance plane (None when no
        :class:`MaintenanceSpec` was declared)."""
        return self.scheduler.report() if self.scheduler is not None \
            else None

    def _register_maintenance(self, owner: str, site: str, home: str,
                              client: XufsClient,
                              rset: Optional[ReplicaSet]) -> None:
        """Register one session's periodic upkeep on the shared scheduler.

        Task closures read the client's live mount/lease tables at run
        time, so a later ``remount()`` (which swaps LeaseManagers and
        tokens) is picked up without re-registration.  Registration
        itself touches no wire.
        """
        sched = self.scheduler
        if sched is None:
            return
        # conflicts this client detects at reconcile time surface on the
        # shared MaintenanceReport (sibling of the dead-letter record)
        client._conflict_sink = sched.note_conflict
        spec = self.spec.maintenance
        tag = f"{owner}@{site}"
        net = self.network

        def lease_tick() -> int:
            # renewal first; anything a partition leaves at risk is
            # re-verified on the next (retry) tick once the link heals.
            # Unresolved at-risk leases are a task FAILURE: the retry
            # ladder (and ultimately the dead-letter record) makes a
            # silently-expiring lock an observable event.
            renewed = 0
            at_risk = 0
            for lm in client.leases.values():
                if lm.at_risk:
                    lm.reverify_at_risk()
                renewed += lm.renew_all()
                at_risk += len(lm.at_risk)
            if at_risk:
                raise DisconnectedError(
                    f"{tag}: {at_risk} lease(s) at risk after renewal")
            return renewed

        sched.register(f"lease:{tag}", lease_tick,
                       period_s=spec.lease_period_s, owner=tag)

        def reconcile_tick() -> int:
            return client.reconcile()

        sched.register(f"reconcile:{tag}", reconcile_tick,
                       period_s=spec.reconcile_period_s, owner=tag)

        if rset is None:
            return
        key = sched.rset_key(rset)

        def resync_tick() -> int:
            # anti-entropy originates at the client site: a partition
            # between site and home fails the task into the retry /
            # backoff / dead-letter ladder instead of silently skipping
            # convergence
            net.rpc(site, home, "resync_vector")
            if not sched.locks.acquire(f"{key}/resync", tag,
                                       now=net.clock):
                return 0      # a peer session is already resyncing
            parked = {r.path for r in client.oplog.unreconciled()}
            return rset.resync(skip=parked)

        sched.register(f"resync:{tag}", resync_tick,
                       period_s=spec.resync_period_s, owner=tag)

        def repair_tick() -> int:
            launched = 0
            for path in rset.repair_targets():
                if not sched.locks.acquire(f"{key}/{path}", tag,
                                           now=net.clock):
                    continue  # a peer holds the repair lease: skip, never
                    #           double-repair (the conflict is counted)
                pending = rset.begin_repair_path(path)
                if pending:
                    sched.note_repair(f"{key}/{path}", tag)
                    sched.track(rset, pending)
                    launched += 1
            return launched

        sched.register(f"repair:{tag}", repair_tick,
                       period_s=spec.repair_period_s, owner=tag)

        ev = rset.eviction
        if ev is None:
            return
        for rname in rset.replicas:
            # one evict task per capacity-bounded replica, fabric-wide:
            # sessions sharing the ReplicaSet (attach) must not scan the
            # same replica twice per period — first registration wins
            task_name = f"evict:{key}/{rname}"
            if task_name in sched.tasks:
                continue

            # the lease holder is the EVICTOR, not the session: repair
            # ticks registered under the session tag must contend (and
            # lose) against a live eviction lease on the same path —
            # sharing the session tag would let same-owner renewal
            # silently bypass the eviction/repair mutual exclusion
            evict_owner = f"evict:{tag}"

            def evict_tick(rname: str = rname) -> int:
                rep = rset.replicas[rname]
                if rep.resident_bytes <= ev.high_bytes:
                    return 0          # under the watermark: wire-free scan
                # over the high watermark: the scan probes the replica so
                # a partition fails the task into the retry / backoff /
                # dead-letter ladder instead of silently skipping the trim
                net.rpc(site, rname, "evict_scan")
                evicted = 0
                for path in rset.eviction_candidates(rname):
                    if rep.resident_bytes <= ev.low_bytes:
                        break         # trimmed down to the low watermark
                    if not sched.locks.acquire(f"{key}/{path}",
                                               evict_owner,
                                               now=net.clock):
                        continue      # repair (or a peer evictor) holds
                        #               the path lease: never race it
                    rset.evict_path(rname, path)
                    sched.evictions += 1
                    evicted += 1
                return evicted

            sched.register(task_name, evict_tick,
                           period_s=ev.scan_period_s, owner=tag)

    # ---- sessions --------------------------------------------------------
    def login(self, user: str, *, home: str = "home", site: str = "site",
              mounts: Optional[Sequence[MountSpec]] = None,
              replicas: Optional[ReplicaPolicy] = None,
              home_root: Optional[str] = None,
              site_root: Optional[str] = None) -> Session:
        """USSH login onto the declared topology (paper §3.2).

        Starts ``user``'s personal file server at the ``home`` site,
        authenticates the ``site``-side client over the HMAC challenge,
        places read replicas per ``replicas`` (every named site must be
        declared in the spec; undeclared ``home <-> replica`` links are
        resolved by the latency-composition rule in the module
        docstring), and mounts each :class:`MountSpec` (default: a bare
        ``home/`` mount).  Sessions are recorded in ``self.sessions`` —
        any number of users share the one topology.
        """
        home_dir = self._site_root(home, home_root, "home space")
        site_dir = self._site_root(site, site_root, "client cache")
        mounts = tuple(mounts) if mounts is not None else (MountSpec("home/"),)
        prefixes = [ms.prefix for ms in mounts]
        if len(set(prefixes)) != len(prefixes):
            dupes = sorted({p for p in prefixes if prefixes.count(p) > 1})
            raise ValueError(f"duplicate mount prefixes: {dupes}")
        if replicas is not None:
            for rname in replicas.sites:
                self.spec.site(rname)           # KeyError on a topo typo
        kp = KeyPhrase.generate()
        store = HomeStore(os.path.join(home_dir, user),
                          endpoint=self.network.endpoint(home),
                          keyphrase=kp)
        server = UserFileServer(user=user,
                                endpoint=self.network.endpoint(home),
                                store=store)
        # SSH-authenticated login, then challenge-auth the data connections
        self.network.rpc(site, home, "ssh_login", encrypted=True)
        token = _authenticate(server)
        rset: Optional[ReplicaSet] = None
        if replicas is not None and replicas.sites:
            rset = ReplicaSet(network=self.network, home_name=home,
                              home_store=store, token=token,
                              write_quorum=replicas.write_quorum,
                              queue_aware=replicas.queue_aware,
                              eviction=replicas.eviction,
                              write_lease=replicas.write_lease,
                              bulk=replicas.bulk if replicas.bulk
                              is not None else self.spec.bulk)
            for rname in replicas.sites:
                if not self.network.has_link(home, rname):
                    # replica sites are near the compute site but WAN-far
                    # from home: compose the undeclared path through the
                    # site region, so fan-out applies to different
                    # replicas finish at distinct times (what makes W<N
                    # drain time beat W=all under overlap).  A link
                    # already on the live network — spec-declared or
                    # composed by an earlier login — is never
                    # overwritten: a second user logging in from a
                    # different compute site must not retime the first
                    # session's fan-out path.
                    self.network.set_link(home, rname, _dc_replace(
                        self.network.link,
                        latency_s=self.network.link.latency_s +
                        self.network.latency_between(site, rname)))
                rstore = HomeStore(
                    os.path.join(home_dir, ".replicas", rname, user),
                    endpoint=self.network.endpoint(rname))
                rset.add_replica(rname, rstore)
        client = XufsClient(site, self.network,
                            cache_root=os.path.join(site_dir, user, "cache"),
                            oplog_root=os.path.join(site_dir, user, "oplog"),
                            owner=user)
        mount_specs: Dict[str, MountSpec] = {}
        for ms in mounts:
            client.mount(ms.prefix, home, store, token,
                         localized=list(ms.localized), replicas=rset)
            mount_specs[ms.prefix] = ms
        session = Session(user=user, network=self.network, server=server,
                          client=client, token=token, replicas=rset,
                          mount_specs=mount_specs,
                          scheduler=self.scheduler)
        self.sessions.append(session)
        self._register_maintenance(user, site, home, client, rset)
        return session

    def attach(self, session: Session, site: str, *, owner: str,
               mounts: Sequence[MountSpec],
               site_root: Optional[str] = None) -> XufsClient:
        """A further reader at ``site`` joins an existing session's home
        space (the paper's shared-project-data case): its own cache,
        oplog, and auth token on the shared topology, reusing the
        session's replica fabric.  The home store still authenticates
        the newcomer over the HMAC challenge — attach grants no
        ambient authority."""
        site_dir = self._site_root(site, site_root, "client cache")
        token = _authenticate(session.server)
        client = XufsClient(site, self.network,
                            cache_root=os.path.join(site_dir, owner,
                                                    "cache"),
                            oplog_root=os.path.join(site_dir, owner,
                                                    "oplog"),
                            owner=owner)
        for ms in mounts:
            client.mount(ms.prefix, session.server.endpoint.name,
                         session.server.store, token,
                         localized=list(ms.localized),
                         replicas=session.replicas)
        # the attached reader shares the session's replica fabric, so its
        # repair task competes for the SAME per-path locks — this is the
        # two-sessions-never-double-repair case the lock table exists for
        self._register_maintenance(owner, site,
                                   session.server.endpoint.name, client,
                                   session.replicas)
        return client
