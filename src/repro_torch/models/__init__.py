from repro_torch.models.model import (  # noqa: F401
    init_params, param_axes, forward, loss_fn, init_cache,
    cache_logical_axes, prefill, decode_step, cache_batch_axes,
)
