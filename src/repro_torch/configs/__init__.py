"""Architecture config registry: ``get_config("<arch-id>")``."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, INPUT_SHAPES  # noqa: F401

# arch-id -> module name
_REGISTRY: Dict[str, str] = {
    "chatglm3-6b": "chatglm3_6b",
    "qwen2.5-3b": "qwen2_5_3b",
    "qwen2-7b": "qwen2_7b",
    "yi-9b": "yi_9b",
    "mamba2-130m": "mamba2_130m",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-medium": "whisper_medium",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
}

ARCH_IDS: List[str] = list(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch]}")
    cfg: ModelConfig = mod.CONFIG
    cfg.validate()
    return cfg


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
