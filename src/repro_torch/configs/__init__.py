"""Architecture registry of the port: the dense, MoE, RWKV6 and hybrid ids
of the reference's ``repro.configs``.

Each module defines ``CONFIG`` with the reference's values;
``get_config(arch)`` resolves by id and ``get_tiny_config(arch)`` returns
the reduced smoke-test sibling.  The other families are still to be
ported; asking for one raises and names the ROADMAP slice that ports it.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig, reduce_config

_MODULES: Dict[str, str] = {
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen3-4b": "qwen3_4b",
    "qwen3-8b": "qwen3_8b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "dbrx-132b": "dbrx_132b",
    "rwkv6-3b": "rwkv6_3b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}

# reference arch ids whose family the port does not run yet -> ROADMAP slice
_NOT_PORTED: Dict[str, str] = {
    "seamless-m4t-medium": "port slice (f), enc-dec / VLM",
    "qwen2-vl-72b": "port slice (f), enc-dec / VLM",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported yet: see ROADMAP.md, {_NOT_PORTED[arch]}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_tiny_config(arch: str) -> ModelConfig:
    return reduce_config(get_config(arch))
