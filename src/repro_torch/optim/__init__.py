"""The optimizer stack of the port (``repro/optim``): AdamW with fp32 or
blockwise-int8 moments, global-norm clipping, the warm-up + cosine
schedule, and error-feedback int8 gradient compression.  ``state_axes``
waits for the multi-device slice."""
from repro_torch.optim.adamw import (  # noqa: F401
    init_state, adamw_update, clip_by_global_norm, global_norm,
    q8_encode, q8_decode,
)
from repro_torch.optim.schedule import lr_at  # noqa: F401
from repro_torch.optim.compress import init_error, compress_decompress  # noqa: F401
