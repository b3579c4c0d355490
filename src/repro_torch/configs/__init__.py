"""Architecture registry of the port: ``get_config(arch_id)``.

Each module defines ``CONFIG`` with the published numbers.  The port carries
every one of the JAX package's ten configs.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

ARCH_IDS: List[str] = ["llama3_2_1b", "xlstm_125m", "jamba_v0_1_52b",
                        "gemma2_2b", "gemma3_4b", "minicpm_2b",
                        "qwen2_vl_72b", "musicgen_medium",
                        "qwen3_moe_235b_a22b", "kimi_k2_1t_a32b"]

# CLI ids use dashes / dots; module names use underscores.
ALIASES = {"llama3.2-1b": "llama3_2_1b", "xlstm-125m": "xlstm_125m",
           "jamba-v0.1-52b": "jamba_v0_1_52b", "gemma2-2b": "gemma2_2b",
           "gemma3-4b": "gemma3_4b", "minicpm-2b": "minicpm_2b",
           "qwen2-vl-72b": "qwen2_vl_72b",
           "musicgen-medium": "musicgen_medium",
           "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
           "kimi-k2-1t-a32b": "kimi_k2_1t_a32b"}


def get_config(arch: str) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    return importlib.import_module(f"{__name__}.{mod_name}").CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
