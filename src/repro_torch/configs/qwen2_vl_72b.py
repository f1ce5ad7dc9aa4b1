"""Qwen2-VL-72B — VLM backbone with M-RoPE (dynamic resolution frontend stub).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064
mrope sections (t,h,w) = (16, 24, 24) over head_dim/2 = 64.
The vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (already merged/projected to d_model) + 3D M-RoPE position ids.
[arXiv:2409.12191; hf]
"""
from repro_torch.config import ModelConfig, VLM

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family=VLM,
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    qk_norm=False,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    frontend_embed_dim=8192,
)
