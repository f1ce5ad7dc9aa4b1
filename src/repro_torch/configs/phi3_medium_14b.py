"""Phi-3-medium-14B — dense GQA decoder (RoPE, SwiGLU).

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352
[arXiv:2404.14219; unverified]
"""
from repro_torch.config import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family=DENSE,
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    qkv_bias=False,
    qk_norm=False,
    rope_theta=10_000.0,
)
