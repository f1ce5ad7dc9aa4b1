"""Architecture registry of the port: the ten ids of the reference's
``repro.configs``, in its order.

Each module defines ``CONFIG`` with the reference's values;
``get_config(arch)`` resolves by id and ``get_tiny_config(arch)`` returns
the reduced smoke-test sibling; ``cells(arch)`` names the shape cells
(``config.SHAPES``) that are runnable for it, as the reference's do.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import (
    SHAPES, ModelConfig, ShapeConfig, reduce_config,
)

_MODULES: Dict[str, str] = {
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen3-4b": "qwen3_4b",
    "qwen3-8b": "qwen3_8b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "dbrx-132b": "dbrx_132b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "rwkv6-3b": "rwkv6_3b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_tiny_config(arch: str) -> ModelConfig:
    return reduce_config(get_config(arch))


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells(arch: str) -> List[str]:
    """The shape cells that are *runnable* for this arch (assignment rules).

    - ``long_500k`` needs sub-quadratic attention: only SSM/hybrid archs.
    - all assigned archs have a decoder, so decode_32k runs everywhere.
    """
    cfg = get_config(arch)
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return names


def skipped_cells(arch: str) -> List[str]:
    return [s for s in SHAPES if s not in cells(arch)]
