from repro_torch.config.base import (  # noqa: F401
    DENSE, MOE, HYBRID, SSM, ENCDEC, VLM, FAMILIES,
    MambaConfig, RwkvConfig, MoeConfig, ModelConfig,
    reduce_config,
)
