"""Qwen3-MoE-30B-A3B — 128-expert top-8 MoE decoder with QK-norm.

48L d_model=2048 32H (GQA kv=4) d_ff(expert)=768 vocab=151936, MoE 128e top-8
[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.config import ModelConfig, MoeConfig, MOE

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family=MOE,
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    qkv_bias=False,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoeConfig(
        num_experts=128,
        experts_per_token=8,
        d_ff_expert=768,
        moe_every=1,
    ),
)
