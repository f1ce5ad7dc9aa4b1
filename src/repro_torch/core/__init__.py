"""XUFS core fabric: the paper's contribution as a composable library.

The documented public surface is ``__all__``; ``tests/test_public_api.py``
holds it stable.  Topology is declared with the spec layer
(:class:`FabricSpec` et al., ``docs/fabric.md``); ``ussh_login`` survives
only as a deprecated shim over it.
"""
from repro_torch.core.transport import (  # noqa: F401
    Network, Endpoint, LinkModel, Transfer, TransferBatch, TransferRequest,
    KeyPhrase, DisconnectedError, AuthError, QuorumNotReachedError,
    KB, MB, GB,
)
from repro_torch.core.striping import (  # noqa: F401
    plan_stripes, reassemble, StripePlan, StripedTransfer, TransferGroup,
    STRIPE_THRESHOLD, MIN_BLOCK, MAX_STRIPES,
)
from repro_torch.core.bulk import (  # noqa: F401
    BulkResult, BulkSpec, BulkTransfer, ensure_channel_width,
    grant_streams,
)
from repro_torch.core.store import HomeStore, ObjectStat  # noqa: F401
from repro_torch.core.cache import CacheSpace, CacheEntry, CacheStats  # noqa: F401
from repro_torch.core.oplog import (  # noqa: F401
    MetaOpQueue, OpRecord, vts_concurrent, vts_dominates, vts_merge,
)
from repro_torch.core.callbacks import NotificationManager  # noqa: F401
from repro_torch.core.replication import (  # noqa: F401
    EvictionSpec, PendingApply, Replica, ReplicaCatalog, ReplicaSet,
    WriteLeaseContended, WriteLeaseSpec, WritePolicy,
)
from repro_torch.core.lease import LeaseManager  # noqa: F401
from repro_torch.core.tasks import (  # noqa: F401
    ConflictRecord, DeadLetter, LockTable, MaintenanceReport,
    MaintenanceScheduler, MaintenanceSpec, RetryPolicy, ScheduledTask,
)
from repro_torch.core.faults import (  # noqa: F401
    CrashEvent, FaultInjector, FaultPlan, FlapEvent, HealEvent,
    PartitionEvent,
)
from repro_torch.core.namespace import XufsClient, XufsFile, Mount  # noqa: F401
from repro_torch.core.prefetch import Prefetcher  # noqa: F401
from repro_torch.core.session import Session, UserFileServer, ussh_login  # noqa: F401
from repro_torch.core.fabric import (  # noqa: F401
    Fabric, FabricSpec, LinkSpec, MountSpec, ReplicaPolicy, SiteSpec,
)

__all__ = [
    # declarative topology / session surface (docs/fabric.md)
    "Fabric", "FabricSpec", "SiteSpec", "LinkSpec", "ReplicaPolicy",
    "EvictionSpec", "MountSpec", "Session", "UserFileServer", "ussh_login",
    # transport
    "Network", "Endpoint", "LinkModel", "Transfer", "TransferBatch",
    "TransferRequest", "KeyPhrase",
    "DisconnectedError", "AuthError", "QuorumNotReachedError",
    "KB", "MB", "GB",
    # striping
    "plan_stripes", "reassemble", "StripePlan", "StripedTransfer",
    "TransferGroup", "STRIPE_THRESHOLD", "MIN_BLOCK", "MAX_STRIPES",
    # bulk-transfer plane (docs/transport.md)
    "BulkSpec", "BulkTransfer", "BulkResult", "grant_streams",
    "ensure_channel_width",
    # stores / cache / WAL
    "HomeStore", "ObjectStat", "CacheSpace", "CacheEntry", "CacheStats",
    "MetaOpQueue", "OpRecord",
    # coherency / replication / leases
    "NotificationManager", "PendingApply", "Replica", "ReplicaCatalog",
    "ReplicaSet", "WritePolicy", "LeaseManager",
    # concurrent-writer safety (docs/consistency.md)
    "WriteLeaseSpec", "WriteLeaseContended", "ConflictRecord",
    "vts_merge", "vts_dominates", "vts_concurrent",
    # deterministic fault injection (docs/maintenance.md)
    "FaultPlan", "FaultInjector", "PartitionEvent", "HealEvent",
    "FlapEvent", "CrashEvent",
    # background maintenance plane (docs/maintenance.md)
    "MaintenanceSpec", "MaintenanceScheduler", "MaintenanceReport",
    "RetryPolicy", "ScheduledTask", "DeadLetter", "LockTable",
    # client
    "XufsClient", "XufsFile", "Mount", "Prefetcher",
]
