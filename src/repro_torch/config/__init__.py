from repro_torch.config.base import (  # noqa: F401
    DENSE, MOE, HYBRID, SSM, ENCDEC, VLM, FAMILIES,
    TRAIN, PREFILL, DECODE, SHAPES,
    MambaConfig, RwkvConfig, MoeConfig, ModelConfig, ShapeConfig,
    MeshConfig, OptimConfig, ShardingConfig, RunConfig,
    reduce_config,
)
