"""Cross-entropy loss: full and vocab-chunked (streaming logsumexp) paths,
as in the JAX package's ``repro.train.loss``.

The chunked path never materializes the (B, S, V) logits: it loops over
vocab chunks of the LM head with an online-softmax accumulator, so the
working set is (B, S, chunk); ``logits_chunk`` is a tunable knob.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.parallel.api import einsum, matmul, shard_index

__all__ = ["xent_full", "xent_chunked", "make_loss_fn"]


def _label_logit(h, w, labels):
    """h: (B,S,D), w: (D,V), labels: (B,S) -> (B,S) fp32 logits at the labels."""
    wl = w[:, labels]  # (D,B,S) gather of label columns
    return einsum("bsd,dbs->bs", h.float(), wl.float())


def _mean(per_tok, labels, valid):
    if valid is None:
        valid = torch.ones_like(labels, dtype=torch.float32)
    n = torch.clamp(torch.sum(valid), min=1.0)
    return torch.sum(per_tok * valid) / n, n


def _sharded_lse_and_label(logits, labels):
    """(logsumexp, label logit) of DTensor logits (B,S,V), shard by shard:
    each rank reduces its slice of the vocab and all-reduces of (B,S)
    combine the slices (the max, then the sums), as GSPMD partitions a
    logsumexp and a ``take_along_axis`` over a sharded dim.  DTensor's own
    ``logsumexp`` gathers the vocab, and the backward of its ``gather``
    makes a replicated zero tensor of the global logits' shape."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = logits.device_mesh
    on_v = [i for i, pl in enumerate(logits.placements) if isinstance(pl, Shard) and pl.dim == 2]
    rows = [Replicate() if i in on_v else pl for i, pl in enumerate(logits.placements)]
    lab = labels.redistribute(mesh, rows).to_local()
    local = logits.to_local()
    shard = shard_index(mesh, on_v)
    idx = lab - shard * local.shape[-1]
    mine = (idx >= 0) & (idx < local.shape[-1])
    label_part = torch.gather(local, -1, idx.clamp(0, local.shape[-1] - 1)[..., None])[..., 0]
    label_part = torch.where(mine, label_part, torch.zeros((), device=local.device))

    def combine(part, op):
        placements = [Partial(op) if i in on_v else pl for i, pl in enumerate(rows)]
        return DTensor.from_local(part, mesh, placements, run_check=False).redistribute(mesh,
                                                                                          rows)

    m = combine(local.detach().amax(dim=-1), "max")
    sumexp = combine(torch.exp(local - m.to_local()[..., None]).sum(dim=-1), "sum")
    return m + torch.log(sumexp), combine(label_part, "sum")


def xent_full(h, w, labels, valid=None):
    """Standard CE over the full vocabulary.  Returns (mean_loss, n_tokens)."""
    logits = matmul(h, w.to(h.dtype)).float()  # (B,S,V)
    if isinstance(logits, DTensor):  # the dry run's
        lse, ll = _sharded_lse_and_label(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return _mean(lse - ll, labels, valid)


def xent_chunked(h, w, labels, valid=None, chunk: int = 8192):
    """Streaming-logsumexp CE over vocab chunks of the head weights: the
    accumulator keeps the per-token running (max, sumexp)."""
    B, S, D = h.shape
    V = w.shape[1]
    if V % chunk:
        raise ValueError(f"vocab {V} not divisible by logits_chunk {chunk}")
    m = torch.full((B, S), -torch.inf, dtype=torch.float32, device=h.device)
    s = torch.zeros((B, S), dtype=torch.float32, device=h.device)
    for c0 in range(0, V, chunk):
        lg = matmul(h, w[:, c0:c0 + chunk].to(h.dtype)).float()  # (B,S,chunk)
        nm = torch.maximum(m, torch.amax(lg, dim=-1))
        s = s * torch.exp(m - nm) + torch.sum(torch.exp(lg - nm[..., None]), dim=-1)
        m = nm
    lse = m + torch.log(s)
    return _mean(lse - _label_logit(h, w, labels), labels, valid)


def make_loss_fn(model, aux_weight: float = 0.01, logits_chunk: int = 0):
    """(params, batch) -> (loss, metrics) for a :class:`TrainModel`.
    ``params`` is the model's own parameter dict (``model.params()``): the
    forward pass reads the module's parameters, so gradients land in their
    ``.grad``.  Labels outside [0, vocab_size) (pad) are masked out; the
    vocab-pad columns never receive labels, so their gradient is exactly
    the softmax pull-down."""

    def loss_fn(params, batch):
        hidden, aux = model(batch)
        w = model.head_weights()
        labels = batch["labels"]
        valid = ((labels >= 0) & (labels < model.cfg.vocab_size)).float()
        labels = torch.clamp(labels, 0, model.cfg.vocab_size - 1)
        if logits_chunk and w.shape[1] % logits_chunk == 0:
            ce, n = xent_chunked(hidden, w, labels, valid, logits_chunk)
        else:
            ce, n = xent_full(hidden, w, labels, valid)
        loss = ce + aux_weight * aux
        return loss, {"ce": ce, "aux": aux, "tokens": n}

    return loss_fn
