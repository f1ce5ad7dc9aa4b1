"""Jamba-1.5-Large-398B — hybrid Mamba+attention (1:7) with 16e top-2 MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2
Attention every 8th layer (1:7 attn:mamba interleave); MoE every 2nd layer.
[arXiv:2403.19887; hf]
"""
from repro_torch.config import ModelConfig, MoeConfig, MambaConfig, HYBRID

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family=HYBRID,
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    qkv_bias=False,
    qk_norm=False,
    rope_theta=0.0,  # Jamba attention layers are NoPE
    moe=MoeConfig(
        num_experts=16,
        experts_per_token=2,
        d_ff_expert=24576,
        moe_every=2,       # MoE on odd layers within each period-8 block
        moe_offset=1,
        # very wide experts: bound the [E,C,d_ff] dispatch working set
        chunk_tokens=8192,
    ),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    hybrid_period=8,
    hybrid_attn_pos=4,     # 1 attention layer per 8 (positions 4, 12, ...)
)
