"""Train and serve steps, as in the JAX package's ``repro.train.step``.

``make_train_step`` supports gradient-accumulation microbatching
(``microbatches`` is a tunable): where the JAX step runs the microbatches
under ``lax.scan``, this one is a Python loop whose backward passes
accumulate into the parameters' ``.grad`` (the first sets it, the rest
add), then divides by the count — the same sums in the same order.  The
parameters are the model's own (``model.params()``); the optimizer updates
them in place and the gradients are dropped after the update.

A step runs under the spans ``train.step`` ⊃ ``train.forward`` (the loss
function: forward and loss), ``train.backward`` (both once a microbatch) and
``train.optimizer`` (:mod:`repro_torch.obs.trace`): no-ops unless tracing or
``torch.profiler`` is on; on the card each takes CUDA event marks, so
``Span.device_ms`` gives the phase's device time.
"""
from __future__ import annotations

import torch

from repro_torch.obs.trace import span
from repro_torch.optim import AdamW

from .loss import make_loss_fn

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step"]


def _split_microbatches(batch: dict, n: int) -> list:
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by microbatches {n}")
    size = b // n
    return [{k: v[i * size:(i + 1) * size] for k, v in batch.items()} for i in range(n)]


def make_train_step(
    model,
    optimizer: AdamW,
    *,
    microbatches: int = 1,
    logits_chunk: int = 0,
    aux_weight: float = 0.01,
):
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics)
    for a :class:`~repro_torch.models.TrainModel`; ``params`` is
    ``model.params()``.  The metrics are 0-d tensors on the model's device
    (``loss``, ``ce``, ``aux``, ``tokens`` of the last microbatch,
    ``grad_norm`` before clipping, ``lr``)."""
    loss_fn = make_loss_fn(model, aux_weight=aux_weight, logits_chunk=logits_chunk)
    marks = model.device.type == "cuda"

    def forward_backward(params, batch):
        with span("train.forward", "train", device=marks):
            loss, metrics = loss_fn(params, batch)
        with span("train.backward", "train", device=marks):
            loss.backward()
        return loss.detach(), metrics

    def step(params, opt_state, batch):
        with span("train.step", "train", device=marks):
            for p in params.values():
                p.grad = None
            if microbatches <= 1:
                loss, metrics = forward_backward(params, batch)
            else:
                loss = 0.0
                for mb in _split_microbatches(batch, microbatches):
                    l, metrics = forward_backward(params, mb)
                    loss = loss + l
                with torch.no_grad():
                    for p in params.values():
                        if p.grad is not None:
                            p.grad.div_(microbatches)
                loss = loss / microbatches
            with span("train.optimizer", "train", device=marks):
                grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                         for n, p in params.items()}
                params, opt_state, opt_metrics = optimizer.update(grads, opt_state, params)
                del grads
                for p in params.values():
                    p.grad = None
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, metrics

    return step


def make_prefill_step(model):
    """prefill(params, batch) -> (last-token logits (B,V), states); the
    model reads its own parameters (``params`` is ``model.params()``)."""

    def prefill(params, batch):
        hidden, states = model.prefill(batch)
        logits = model.logits(hidden[:, None])[:, 0]
        return logits, states

    return prefill


def make_decode_step(model):
    """decode(params, token, states, pos) -> (logits (B,V), states)."""

    def decode(params, token, states, pos):
        return model.decode_step(token, states, pos)

    return decode
