"""Model configuration, copied from ``repro/config/base.py``.

The port keeps its own copy (it imports nothing of ``repro``) with the same
fields and values, so a reference config and a port config compare field
by field.  ``MeshConfig`` and ``ShardingConfig`` are plain fields of
``RunConfig`` until the multi-device slice gives them a meaning.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Tuple

# ---------------------------------------------------------------------------
# Model families
# ---------------------------------------------------------------------------

DENSE = "dense"
MOE = "moe"
HYBRID = "hybrid"  # interleaved SSM + attention (Jamba)
SSM = "ssm"        # attention-free (RWKV6)
ENCDEC = "encdec"  # encoder-decoder (Seamless-M4T backbone)
VLM = "vlm"        # vision-language backbone (M-RoPE)

FAMILIES = (DENSE, MOE, HYBRID, SSM, ENCDEC, VLM)


@dataclass(frozen=True)
class MambaConfig:
    """Mamba(-1) selective-SSM block hyperparameters (Jamba defaults)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank > 0 else -(-d_model // 16)


@dataclass(frozen=True)
class RwkvConfig:
    """RWKV6 (Finch) block hyperparameters."""

    head_dim: int = 64
    decay_lora: int = 64     # rank of the data-dependent decay LoRA
    mix_lora: int = 32       # rank of the token-shift mix LoRA
    gate_lora: int = 64


@dataclass(frozen=True)
class MoeConfig:
    num_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0
    # apply MoE on layers where (layer_idx % moe_every) == moe_offset
    moe_every: int = 1
    moe_offset: int = 0
    router_jitter: float = 0.0
    capacity_factor: float = 1.25
    # dense d_ff used on non-MoE layers of a partially-MoE model (0 = none)
    d_ff_shared: int = 0
    # token chunking: bounds the [E, C, d] dispatch buffers for 1M-token
    # batches (32k prefill) to a fixed working set (0 = no chunking)
    chunk_tokens: int = 65536
    # renormalise the top-k gate weights to sum 1 (Qwen3-MoE, the
    # reference's router); false keeps the softmax's top-k as they are
    # (Jamba).  The port's own field: the reference has no such switch.
    norm_topk_prob: bool = True


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False

    # optional sub-configs
    moe: Optional[MoeConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RwkvConfig] = None

    # hybrid (Jamba): block period and which position inside it is attention
    hybrid_period: int = 0
    hybrid_attn_pos: int = 0

    # enc-dec
    encoder_layers: int = 0
    decoder_layers: int = 0

    # vlm: M-RoPE sections over head_dim/2 (temporal, height, width)
    mrope_sections: Tuple[int, ...] = ()

    # modality frontend stub: dims of the precomputed embedding inputs
    frontend_embed_dim: int = 0   # 0 -> token ids only

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # implementation switches
    # "xla" | "pallas".  In the port "pallas" selects the hand-written CUDA
    # flash-attention kernel (kernels/csrc/flash_attention.cu); the value
    # keeps the reference's name so the two configs compare field by field.
    attention_impl: str = "xla"
    scan_impl: str = "xla"        # ssm/rwkv scan: "xla" | "pallas"
    remat: str = "full"           # "none" | "dots" | "full"
    # layers applied per scan step: the carry stash shrinks by this factor
    # (recompute grows by the same); must divide num_layers
    layers_per_step: int = 1

    # ---- derived -----------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.moe is not None and self.moe.num_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.family == SSM

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports 500k-token decode (SSM state or hybrid)."""
        return self.family in (SSM, HYBRID)

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Parameter count (embedding + blocks), used for roofline MODEL_FLOPS.
    def param_count(self, active_only: bool = False) -> int:
        d = self.d_model
        embed = self.vocab_size * d
        unembed = 0 if self.tie_embeddings else self.vocab_size * d
        frontend = self.frontend_embed_dim * d if self.frontend_embed_dim else 0

        def attn_params() -> int:
            p = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                p += self.q_dim + 2 * self.kv_dim
            if self.qk_norm:
                p += 2 * self.head_dim
            return p + 2 * d  # two RMSNorm scales

        def mlp_params(dff: int) -> int:
            return 3 * d * dff  # SwiGLU: gate, up, down

        def moe_params(active: bool) -> int:
            assert self.moe is not None
            n = self.moe.experts_per_token if active else self.moe.num_experts
            p = n * 3 * d * self.moe.d_ff_expert
            p += d * self.moe.num_experts  # router
            if self.moe.d_ff_shared:
                p += mlp_params(self.moe.d_ff_shared)
            return p

        def mamba_params() -> int:
            assert self.mamba is not None
            di = self.mamba.expand * d
            r = self.mamba.resolved_dt_rank(d)
            p = d * 2 * di                      # in_proj (x, z)
            p += di * self.mamba.d_conv + di    # conv1d + bias
            p += di * (r + 2 * self.mamba.d_state)  # x_proj
            p += r * di + di                    # dt_proj
            p += di * self.mamba.d_state + di   # A_log, D
            p += di * d                         # out_proj
            return p + 2 * d

        def rwkv_params() -> int:
            assert self.rwkv is not None
            c = self.rwkv
            p = 4 * d * d + d * d               # r,k,v,g + output
            p += 5 * (d * c.mix_lora + c.mix_lora * d) + 5 * d  # ddlerp
            p += d * c.decay_lora + c.decay_lora * d + d        # decay lora
            p += d + d                          # time_first (u), ln_x
            p += 2 * d * self.d_ff + self.d_ff * d              # channel mix
            return p + 2 * d

        if self.family in (DENSE, VLM):
            block = attn_params() + mlp_params(self.d_ff)
            total = self.num_layers * block
        elif self.family == MOE:
            block = attn_params() + moe_params(active_only)
            total = self.num_layers * block
        elif self.family == HYBRID:
            assert self.hybrid_period > 0
            n_attn = self.num_layers // self.hybrid_period
            n_mamba = self.num_layers - n_attn
            n_moe = self.num_layers // max(self.moe.moe_every, 1) if self.is_moe else 0
            n_mlp = self.num_layers - n_moe
            total = n_attn * attn_params() + n_mamba * mamba_params()
            total += n_moe * (moe_params(active_only) if self.is_moe else 0)
            total += n_mlp * mlp_params(self.d_ff)
        elif self.family == SSM:
            total = self.num_layers * rwkv_params()
        elif self.family == ENCDEC:
            enc = self.encoder_layers * (attn_params() + mlp_params(self.d_ff))
            # decoder adds cross-attention
            dec = self.decoder_layers * (2 * attn_params() + mlp_params(self.d_ff))
            total = enc + dec
        else:  # pragma: no cover
            raise ValueError(self.family)
        return total + embed + unembed + frontend


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------

TRAIN = "train"
PREFILL = "prefill"
DECODE = "decode"


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str             # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == DECODE


# The four assigned LM shape cells.
SHAPES: Mapping[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", TRAIN, 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", PREFILL, 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", DECODE, 32_768, 128),
    "long_500k": ShapeConfig("long_500k", DECODE, 524_288, 1),
}


# ---------------------------------------------------------------------------
# Mesh / run configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    """Production mesh description (see launch/mesh.py)."""

    data: int = 16
    model: int = 16
    pods: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model * self.pods

    @property
    def multi_pod(self) -> bool:
        return self.pods > 1


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    # "fp32" | "int8" blockwise-quantized first/second moments
    state_dtype: str = "fp32"
    int8_block: int = 256
    # cross-pod error-feedback gradient compression ("none" | "int8")
    grad_compress: str = "none"


@dataclass(frozen=True)
class ShardingConfig:
    """Logical->physical sharding policy knobs (parallel/sharding.py)."""

    policy: str = "fsdp"       # "baseline" (DP x TP) | "fsdp" (cached/ZeRO)
    shard_seq: bool = False    # SP: shard sequence/state on data axis (long ctx)
    fsdp_axis: str = "data"
    tp_axis: str = "model"
    pod_axis: str = "pod"


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = MeshConfig()
    optim: OptimConfig = OptimConfig()
    sharding: ShardingConfig = ShardingConfig()
    microbatches: int = 1
    seed: int = 0

    def replace(self, **kw: Any) -> "RunConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Reduction helper: full config -> smoke-test config
# ---------------------------------------------------------------------------

def reduce_config(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
                  heads: int = 4, kv_heads: int = 2, head_dim: int = 16,
                  d_ff: int = 128, vocab: int = 512) -> ModelConfig:
    """Shrink a full architecture config to a CPU-smoke-testable sibling.

    Keeps family, layer pattern (hybrid period, moe stride, enc/dec split)
    and feature flags identical; shrinks all widths.
    """
    kw: dict = dict(
        name=cfg.name + "-tiny",
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=min(kv_heads, heads),
        head_dim=head_dim,
        d_ff=d_ff,
        vocab_size=vocab,
        remat="none",
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 8),
            experts_per_token=min(cfg.moe.experts_per_token, 2),
            d_ff_expert=min(cfg.moe.d_ff_expert, 64) or 64,
            d_ff_shared=min(cfg.moe.d_ff_shared, d_ff) if cfg.moe.d_ff_shared else 0,
        )
    if cfg.mamba is not None:
        kw["mamba"] = dataclasses.replace(cfg.mamba, d_state=8)
    if cfg.rwkv is not None:
        kw["rwkv"] = dataclasses.replace(
            cfg.rwkv, head_dim=16, decay_lora=8, mix_lora=8, gate_lora=8)
        kw["num_heads"] = d_model // 16
        kw["num_kv_heads"] = d_model // 16
        kw["head_dim"] = 16
    if cfg.family == HYBRID:
        kw["num_layers"] = max(layers, cfg.hybrid_period)
        # keep one full hybrid period so the attn/mamba interleave is exercised
        kw["num_layers"] = cfg.hybrid_period
    if cfg.family == ENCDEC:
        kw["encoder_layers"] = layers
        kw["decoder_layers"] = layers
        kw["num_layers"] = 2 * layers
    if cfg.frontend_embed_dim:
        kw["frontend_embed_dim"] = d_model
    if cfg.mrope_sections:
        s = head_dim // 2
        kw["mrope_sections"] = (s - 2 * (s // 3), s // 3, s // 3)
    return cfg.replace(**kw)
