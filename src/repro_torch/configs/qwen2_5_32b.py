"""Qwen2.5-32B — dense GQA decoder with QKV bias.

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064
[hf:Qwen/Qwen2.5-0.5B family; hf]
"""
from repro_torch.config import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family=DENSE,
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    qk_norm=False,
    rope_theta=1_000_000.0,
)
