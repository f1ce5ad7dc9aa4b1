"""Qwen3-8B — dense GQA decoder with QK-norm.

36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936  [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.config import ModelConfig, DENSE

CONFIG = ModelConfig(
    name="qwen3-8b",
    family=DENSE,
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qkv_bias=False,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
