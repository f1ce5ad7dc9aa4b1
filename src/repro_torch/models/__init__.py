from repro_torch.models.model import (  # noqa: F401
    init_params, forward, loss_fn, init_cache, prefill, decode_step,
    cache_batch_axes,
)
