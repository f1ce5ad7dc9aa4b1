"""SeamlessM4T-medium — encoder-decoder multimodal backbone (speech stub).

12L(enc) + 12L(dec) d_model=1024 16H (kv=16, i.e. MHA) d_ff=4096 vocab=256206
The speech frontend is a STUB: input_specs() provides precomputed frame
embeddings for the encoder; the text decoder consumes token ids.
[arXiv:2308.11596; hf]
"""
from repro_torch.config import ModelConfig, ENCDEC

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family=ENCDEC,
    num_layers=24,
    encoder_layers=12,
    decoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    qkv_bias=True,
    qk_norm=False,
    rope_theta=10_000.0,
    frontend_embed_dim=1024,
)
