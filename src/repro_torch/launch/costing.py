"""Dry-run cost accounting: the counts of one rank's step, and the flash
kernel's analytic traffic.

Counterpart of the JAX package's ``launch/costing.py``.  There, XLA's
``cost_analysis`` counts a ``lax.scan`` body once, so a scan-over-layers
program under-reports by ~n_layers and ``stage_probe`` / ``corrected_cost``
lower one stage body apart to add the missing groups back.  The port runs
its layers in a Python loop and counts every op one rank runs
(:class:`~repro_torch.core.costs.StepCounter`), so there is nothing to
correct and those two have no counterpart here.  :func:`attention_traffic`
is the JAX package's, equal bit for bit.
"""
from __future__ import annotations

import dataclasses

__all__ = ["CostTerms", "measure", "attention_traffic"]


@dataclasses.dataclass
class CostTerms:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    coll_bytes: float = 0.0

    def __add__(self, o):
        return CostTerms(
            self.flops + o.flops,
            self.bytes_accessed + o.bytes_accessed,
            self.coll_bytes + o.coll_bytes,
        )

    def scaled(self, f: float):
        return CostTerms(self.flops * f, self.bytes_accessed * f, self.coll_bytes * f)

    def as_dict(self):
        return dataclasses.asdict(self)


def measure(counter) -> CostTerms:
    """The terms a :class:`~repro_torch.core.costs.StepCounter` counted."""
    return CostTerms(float(counter.flops), float(counter.bytes_accessed),
                     float(counter.coll_bytes))


def attention_traffic(cfg, shape, dp: int, tp: int) -> dict:
    """Analytic per-chip HBM traffic of the attention score tensors.

    Used by the launch hill climb for candidates that substitute the flash
    kernel for the plain attention path: the dry run counts the plain path
    or the ``"flashcost"`` surrogate (the kernel cannot run on meta
    tensors), so the kernel's effect on the memory term is applied as
        bytes' = bytes - xla_scores + flash_io
    with the estimates below:

      xla_scores: scores elems × 4 B × passes, passes = 6 (fwd) / 20 (train:
                  fwd + remat recompute + bwd chains), ×0.5 if causal;
      flash_io:   Q/K/V reads + O write only (the S² tile never leaves
                  on-chip memory), ×1 (fwd) / ×3.5 (train).
    Head sharding follows models.attention: KV heads if Kh % tp == 0, else
    the GQA group dim if g % tp == 0, else batch-only.
    """
    train = shape.kind == "train"
    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    Skv_decode = shape.seq_len
    B_loc = B // dp if B % dp == 0 else B
    H, Kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = H // Kh
    hshard = tp if (Kh % tp == 0 or g % tp == 0) else 1
    passes = 20.0 if train else 6.0
    fl_mult = 3.5 if train else 1.0
    # tensor-core dot passes over the S² tile (QK + PV): fwd 2; train adds
    # the remat recompute (2) and the backward chain dQ/dK/dV/dP (~5).
    dot_passes = 9.0 if train else 2.0

    def inst(sq, skv, causal):
        frac = 0.5 if causal and sq == skv else 1.0
        elems = B_loc * (H / hshard) * sq * skv * frac
        xla = elems * 4.0 * passes
        flash = B_loc * (2 * H * sq + 2 * Kh * skv) * hd * 2.0 * fl_mult
        flops = dot_passes * elems * hd * 2.0
        return xla, flash, flops

    xla = flash = flops = 0.0
    skv_self = min(cfg.window, S) if cfg.window else S
    if shape.kind == "decode":
        skv_self = min(cfg.window, Skv_decode) if cfg.window else Skv_decode
    for kind in cfg.pattern:
        if kind in ("attn", "cross"):
            a, f, fl = inst(S, skv_self, causal=True)
            xla += a
            flash += f
            flops += fl
        if kind == "cross":
            a, f, fl = inst(S, cfg.ctx_tokens, causal=False)
            xla += a
            flash += f
            flops += fl
    if cfg.is_encdec and shape.kind != "decode":
        a, f, fl = inst(cfg.ctx_tokens, cfg.ctx_tokens, causal=False)
        xla += a * cfg.enc_layers
        flash += f * cfg.enc_layers
        flops += fl * cfg.enc_layers
    return {"xla_bytes": xla, "flash_bytes": flash, "flash_flops": flops}
