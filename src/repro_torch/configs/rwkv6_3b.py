"""RWKV6-3B (Finch) — attention-free RNN with data-dependent decay.

32L d_model=2560 (40 heads x 64) d_ff=8960 vocab=65536
[arXiv:2404.05892; hf]
"""
from repro_torch.config import ModelConfig, RwkvConfig, SSM

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family=SSM,
    num_layers=32,
    d_model=2560,
    num_heads=40,       # d_model / rwkv.head_dim
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    rwkv=RwkvConfig(head_dim=64, decay_lora=64, mix_lora=32, gate_lora=64),
)
