"""Plain PyTorch forwards of the benchmark's model families, one module a
family, named by the Hugging Face ``model_type`` of the configuration
(``qwen3.py``, ``qwen2_moe.py``).  Each module exposes :func:`forward`
with the same signature; :func:`family` finds one by name.  Nothing here
imports the program under test."""

from __future__ import annotations

import importlib


def family(name: str):
    """The reference module of ``name`` (a configuration's ``model_type``)."""
    return importlib.import_module(f"{__name__}.{name}")
