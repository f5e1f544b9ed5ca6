"""Architecture registry: one module per assigned architecture.

``get_config("phi3-medium-14b")`` returns the full published config;
``get_smoke_config(...)`` returns a reduced same-family variant for CPU tests.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig, reduced

# arch-id -> module name
_MODULES: Dict[str, str] = {
    "phi3-medium-14b": "phi3_medium_14b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "whisper-tiny": "whisper_tiny",
    "mamba2-2.7b": "mamba2_2_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen2-vl-7b": "qwen2_vl_7b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch), **overrides)


def list_archs() -> List[str]:
    return list(ARCH_IDS)
