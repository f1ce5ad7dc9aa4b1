"""DBRX-132B — 16-expert top-4 fine-grained MoE decoder.

40L d_model=6144 48H (GQA kv=8) d_ff(expert)=10752 vocab=100352, MoE 16e top-4
[hf:databricks/dbrx-base; unverified]
"""
from repro_torch.config import ModelConfig, MoeConfig, MOE

CONFIG = ModelConfig(
    name="dbrx-132b",
    family=MOE,
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    qkv_bias=False,
    qk_norm=False,
    rope_theta=500_000.0,
    moe=MoeConfig(
        num_experts=16,
        experts_per_token=4,
        d_ff_expert=10752,
        moe_every=1,
        # wide experts: smaller token chunks keep [E,C,d_ff] ~1 GB
        chunk_tokens=8192,
    ),
)
