"""Carry JAX ``Model.init`` parameters over to the port.

:func:`params_from_jax` takes the JAX package's parameter pytree (arrays of
any kind that ``numpy.asarray`` reads) and returns a state dict for
:class:`repro_torch.models.Model`.  The JAX model stacks each repeating
group's parameters on axis 0 (``stages[s]["pos<i>"]``, run under
``lax.scan``); the port has one module per layer in pattern order, so each
stage is unstacked group by group.  The encoder of an encoder–decoder model
(``encoder.stages[0].pos0``, ``enc_layers`` stacked ``attn`` blocks, and
``encoder.norm``) unstacks the same way into ``encoder.<i>`` and
``encoder_norm``; the MoE leaves (router (d, E), experts ``wi``/``wg`` (E,
d, f) and ``wo`` (E, f, d)) are ordinary leaves of a layer.  Loading the result with
``Model.load_state_dict`` casts each weight to the dtype the port stores it
in, which rounds exactly as the JAX model's cast at use does; a
``TrainModel`` keeps the fp32 masters as they are, with no rounding.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .config import ModelConfig

__all__ = ["params_from_jax", "stage_defs"]


def stage_defs(cfg: ModelConfig) -> list:
    """The JAX model's stages: [(kinds, n_groups)], the group then the tail."""
    out = []
    if cfg.n_groups > 0:
        out.append((cfg.group, cfg.n_groups))
    if cfg.tail:
        out.append((cfg.tail, 1))
    return out


def _flatten(tree: dict, prefix: str, out: Dict[str, torch.Tensor], index=None) -> None:
    for name, val in tree.items():
        key = f"{prefix}{name}"
        if isinstance(val, dict):
            _flatten(val, key + ".", out, index)
        else:
            arr = np.asarray(val, dtype=np.float32)
            if index is not None:
                arr = arr[index]
            out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))


def params_from_jax(cfg: ModelConfig, params: dict) -> Dict[str, torch.Tensor]:
    """State dict of the port's ``Model(cfg)`` holding the JAX parameters."""
    sd: Dict[str, torch.Tensor] = {}
    _flatten({"table": params["embed"]["table"]}, "embedding.", sd)
    _flatten(params["final_norm"], "final_norm.", sd)
    if "lm_head" in params:
        _flatten(params["lm_head"], "lm_head.", sd)
    layer = 0
    for stage, (kinds, n_groups) in zip(params["stages"], stage_defs(cfg)):
        for g in range(n_groups):
            for i in range(len(kinds)):
                _flatten(stage[f"pos{i}"], f"layers.{layer}.", sd, index=g)
                layer += 1
    if layer != cfg.n_layers:
        raise ValueError(f"{cfg.name}: unstacked {layer} layers, config has {cfg.n_layers}")
    if cfg.is_encdec:
        (enc,) = params["encoder"]["stages"]
        for i in range(cfg.enc_layers):
            _flatten(enc["pos0"], f"encoder.{i}.", sd, index=i)
        _flatten(params["encoder"]["norm"], "encoder_norm.", sd)
    return sd
