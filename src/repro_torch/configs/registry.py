"""Architecture registry: ``get_config("<arch-id>")`` for --arch flags."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig, INPUT_SHAPES

_ARCH_MODULES = {
    "yi-9b": "repro_torch.configs.yi_9b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3_8b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t",
    "phi-3-vision-4.2b": "repro_torch.configs.phi3_vision_4_2b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


def get_shape(shape: str) -> ShapeConfig:
    if shape not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {shape!r}; known: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[shape]


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


# (arch, shape) pairs that are skipped, with the reason — see DESIGN.md §4.
SKIPS = {
    ("whisper-small", "long_500k"):
        "enc-dec ASR decoder; 524k decoded tokens vs a 1500-frame encoder "
        "is semantically meaningless (DESIGN.md §4)",
}

# archs whose long_500k runs as the documented sliding-window variant
LONG_CONTEXT_VARIANT = (
    "yi-9b", "phi3-mini-3.8b", "phi4-mini-3.8b", "phi-3-vision-4.2b",
    "deepseek-v3-671b", "kimi-k2-1t-a32b",
)
