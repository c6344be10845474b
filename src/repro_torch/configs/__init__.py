"""Architecture registry: one module per assigned arch (+ paper graphs)."""

from __future__ import annotations

import importlib
from typing import Dict, List

from .base import SHAPES, ModelConfig, ShapeConfig, smoke_shape

_ARCH_MODULES = {
    "arctic-480b": "arctic_480b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "gemma2-27b": "gemma2_27b",
    "qwen3-14b": "qwen3_14b",
    "llama3.2-1b": "llama3p2_1b",
    "gemma-7b": "gemma_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "mamba2-130m": "mamba2_130m",
    "zamba2-2.7b": "zamba2_2p7b",
}

ARCHS: List[str] = list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f".{_ARCH_MODULES[arch]}", __package__)
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch × shape) cell."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k context is quadratic (skip per assignment)"
    return True, ""


__all__ = [
    "ARCHS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "get_config",
    "get_shape",
    "shape_applicable",
    "smoke_shape",
]
