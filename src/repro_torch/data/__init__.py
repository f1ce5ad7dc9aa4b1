"""Batches for the port's training and eval steps, and the data pipeline
over the XUFS fabric (``repro/data``): Zipf token shards in the home
store, read through the client's cache with read-ahead."""
from repro_torch.data.batches import (  # noqa: F401
    batch_shapes, decode_token_shapes, make_batch, make_decode_tokens,
    make_specs, vlm_patch_count,
)
from repro_torch.data.pipeline import (  # noqa: F401
    DataPipeline, SyntheticCorpus,
)
