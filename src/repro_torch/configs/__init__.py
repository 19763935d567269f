"""Architecture registry: ``--arch <id>`` resolution (a copy of
``repro.configs``; the arch files are data, copied verbatim)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from .base import SHAPES, ModelConfig, ShapeConfig, TrainConfig  # noqa: F401

_ARCH_MODULES: Dict[str, str] = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "dbrx-132b": "dbrx_132b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "internlm2-20b": "internlm2_20b",
    "gemma3-4b": "gemma3_4b",
    "qwen2-72b": "qwen2_72b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "xlstm-350m": "xlstm_350m",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "hymba-1.5b": "hymba_1_5b",
}

# Archs for which long_500k (524288-token decode) applies: sub-quadratic or
# mostly-local attention (see DESIGN.md §6). Pure full-attention archs skip it.
LONG_500K_OK = {
    "xlstm-350m",
    "hymba-1.5b",
    "gemma3-4b",
    "h2o-danube-3-4b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cell_applicable(arch: str, shape: str) -> bool:
    """Whether an (arch x shape) dry-run cell applies (DESIGN.md §6)."""
    if shape == "long_500k":
        return arch in LONG_500K_OK
    return True
