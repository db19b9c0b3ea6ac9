"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    SHAPES,
    ArchConfig,
    ShapeCell,
    applicable_shapes,
    smoke_config,
)

_MODULES = {
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "qwen1.5-4b": "qwen1_5_4b",
    "olmo-1b": "olmo_1b",
    "internlm2-20b": "internlm2_20b",
    "qwen3-32b": "qwen3_32b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "mamba2-1.3b": "mamba2_1_3b",
    "musicgen-medium": "musicgen_medium",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def all_cells() -> list[tuple[str, str]]:
    """Every assigned (arch, shape) cell, with inapplicable shapes skipped."""
    cells = []
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        for shape in applicable_shapes(cfg):
            cells.append((arch_id, shape))
    return cells


__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "ArchConfig",
    "ShapeCell",
    "all_cells",
    "applicable_shapes",
    "get_config",
    "smoke_config",
]
