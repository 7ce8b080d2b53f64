"""Architecture registry of the port: the configs ported so far.

Each module is a copy of the JAX package's ``repro.configs.<id>``: ``CONFIG``
(the published config) and ``tiny()`` (a reduced same-family config for CPU
tests).  Select with ``--arch <id>`` (or the dashed name); ``get(name)`` /
``get_tiny(name)`` here.  The other four architectures need block kinds the
port does not run yet (``cross``, MoE, the encoder) and are listed in
ROADMAP.md.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCH_IDS", "ALIASES", "get", "get_tiny"]

ARCH_IDS = [
    "qwen2_7b",
    "starcoder2_15b",
    "qwen2_72b",
    "llama3_405b",
    "rwkv6_7b",
    "recurrentgemma_2b",
]

# canonical dashed names -> module ids
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def _module(name: str):
    key = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"architecture {name!r} is not ported yet; ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_tiny(name: str) -> ModelConfig:
    return _module(name).tiny()
