"""Meta-device stand-ins for every model input — shapes and dtypes, no
storage, no device allocation (the JAX package's ``ShapeDtypeStruct``
stand-ins in ``launch/input_specs.py``).

Floating inputs have the JAX dtypes.  Integer inputs are int64, where JAX
has int32: the port's batches (``data.make_batch_for``), its loss
(``torch.gather`` takes int64 indices) and its caches' ``pos`` use int64.
Decode states come from ``Model.init_states`` on a meta-device model, one
dict per layer where JAX stacks each group, so even llama3-405b's and
arctic-480b's caches cost nothing to describe.
"""
from __future__ import annotations

import torch

from repro_torch.configs import SHAPES, ShapeSpec
from repro_torch.models import Model, ModelConfig

__all__ = ["train_inputs", "prefill_inputs", "decode_inputs", "input_specs"]


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _batch_specs(cfg: ModelConfig, B: int, S: int, with_labels: bool) -> dict:
    dt = getattr(torch, cfg.compute_dtype)
    batch = {"tokens": _sds((B, S), torch.int64)}
    if with_labels:
        batch["labels"] = _sds((B, S), torch.int64)
    if cfg.is_encdec:
        batch["frames"] = _sds((B, cfg.ctx_tokens, cfg.d_model), dt)
    if cfg.family == "vlm":
        batch["ctx_embeds"] = _sds((B, cfg.ctx_tokens, cfg.d_model), dt)
    return batch


def train_inputs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    return _batch_specs(cfg, shape.global_batch, shape.seq_len, with_labels=True)


def prefill_inputs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    return _batch_specs(cfg, shape.global_batch, shape.seq_len, with_labels=False)


def decode_inputs(model: Model, shape: ShapeSpec):
    """(token, states, pos) stand-ins; the states are ``init_states`` of
    ``model``'s configuration on the meta device (a meta-device copy when
    ``model`` lives elsewhere): ring-buffer windows and recurrent states get
    their true (small) shapes."""
    B, S = shape.global_batch, shape.seq_len
    if model.device.type != "meta":
        model = Model(model.cfg, model.exec_cfg, device="meta")
    states = model.init_states(B, S, mode="decode")
    return _sds((B, 1), torch.int64), states, _sds((), torch.int64)


def input_specs(model: Model, shape_name: str):
    cfg = model.cfg
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return {"batch": train_inputs(cfg, shape)}
    if shape.kind == "prefill":
        return {"batch": prefill_inputs(cfg, shape)}
    token, states, pos = decode_inputs(model, shape)
    return {"token": token, "states": states, "pos": pos}
