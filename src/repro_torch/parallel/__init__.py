"""Multi-device execution over ``torch.distributed`` (``repro/parallel``):
the sharding context and rules, explicit collectives, and expert-parallel
MoE with all-to-all dispatch."""
from repro_torch.parallel.context import (  # noqa: F401
    NamedSharding, ShardingCtx, current_ctx, shard, sharding_ctx,
)
