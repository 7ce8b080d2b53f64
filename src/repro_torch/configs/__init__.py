"""Architecture registry of the port: the JAX package's ten architectures,
and the architectures the port runs beyond them.

Each module of ``ARCH_IDS`` is a copy of the JAX package's
``repro.configs.<id>``: ``CONFIG`` (the published config) and ``tiny()`` (a
reduced same-family config for CPU tests).  ``EXTRA_ARCH_IDS`` are modules
of the same form with no JAX counterpart (``moonlight_16b_a3b``: the
published Moonlight-16B-A3B, which the JAX package's ``moonshot_v1_16b_a3b``
stand-in is not); ``ARCH_IDS``, ``ALIASES``, :func:`all_configs` and
:func:`cells` stay the JAX package's.  Select with ``--arch <id>`` (or the
dashed name); ``get(name)`` / ``get_tiny(name)`` here.  ``SHAPES`` are the JAX package's workload
shapes (sequence length x global batch), which the launch layer
(:mod:`repro_torch.launch.spaces`, :mod:`repro_torch.launch.input_specs`,
:mod:`repro_torch.launch.dryrun`) reads; :func:`cells` is the dry run's
grid of (architecture, shape) cells.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCH_IDS", "EXTRA_ARCH_IDS", "ALIASES", "get", "get_tiny", "all_configs", "ShapeSpec", "SHAPES",
           "cells"]

ARCH_IDS = [
    "llama_3_2_vision_11b",
    "qwen2_7b",
    "starcoder2_15b",
    "qwen2_72b",
    "llama3_405b",
    "seamless_m4t_large_v2",
    "rwkv6_7b",
    "arctic_480b",
    "moonshot_v1_16b_a3b",
    "recurrentgemma_2b",
]

#: architectures the port runs that the JAX package does not define
EXTRA_ARCH_IDS = ["moonlight_16b_a3b"]

# canonical dashed names -> module ids
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
ALIASES.update({"llama-3.2-vision-11b": "llama_3_2_vision_11b",
                "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
                "seamless-m4t-large-v2": "seamless_m4t_large_v2"})


def _module(name: str):
    key = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS and key not in EXTRA_ARCH_IDS:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCH_IDS + EXTRA_ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_tiny(name: str) -> ModelConfig:
    return _module(name).tiny()


def all_configs():
    return {a: get(a) for a in ARCH_IDS}


# ----------------------------------------------------------------- shapes
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def cells(include_skips: bool = False):
    """All (arch, shape) cells.  long_500k runs only for sub-quadratic archs
    (rwkv6, recurrentgemma): the 8 full-attention archs skip it."""
    out = []
    for a in ARCH_IDS:
        cfg = get(a)
        for s in SHAPES.values():
            runnable = s.name != "long_500k" or cfg.subquadratic
            if runnable or include_skips:
                out.append((a, s.name, runnable))
    return out
