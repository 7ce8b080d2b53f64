"""Synthetic token stream: structured (learnable) sequences, a pure function
of (seed, step), so resume is deterministic.

The tokens come from numpy's ``default_rng((seed << 32) ^ step)`` exactly as
in the JAX package, so a batch here equals the JAX batch value for value;
it is an int64 tensor on the caller's device (the card unless the caller
asks for the CPU)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["SyntheticLM", "make_batch_for"]


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Markov-ish synthetic LM data: next token = (a*tok + b) % vocab with
    per-sequence (a, b) — learnable structure so training loss moves."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    device: str = "cuda"

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 32) ^ step)
        B, S = self.global_batch, self.seq_len
        a = rng.integers(1, 8, (B, 1), dtype=np.int64)
        b = rng.integers(0, self.vocab_size, (B, 1), dtype=np.int64)
        t0 = rng.integers(0, self.vocab_size, (B, 1), dtype=np.int64)
        idx = np.arange(S + 1, dtype=np.int64)[None, :]
        toks = torch.from_numpy((t0 + a * idx + b * (idx // 7)) % self.vocab_size)
        return {
            "tokens": toks[:, :-1].contiguous().to(self.device),
            "labels": toks[:, 1:].contiguous().to(self.device),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_batch_for(cfg, B: int, S: int, step: int = 0, seed: int = 0, *,
                   device="cuda") -> dict:
    """A batch for ``cfg`` with the modality-stub inputs each family needs:
    ``frames`` (encoder–decoder) or ``ctx_embeds`` (VLM), (B, ctx_tokens,
    d_model) fp32 normals scaled by 0.1, drawn on ``device`` from a
    ``torch.Generator`` seeded ``(seed << 8) ^ step`` (the JAX package draws
    them from ``jax.random`` with that key: the same distribution, not the
    same numbers)."""
    base = SyntheticLM(cfg.vocab_size, S, B, seed, str(device)).batch(step)
    if cfg.is_encdec or cfg.family == "vlm":
        gen = torch.Generator(device=device).manual_seed((seed << 8) ^ step)
        shape = (B, cfg.ctx_tokens, cfg.d_model)
        if cfg.is_encdec:
            base["frames"] = 0.1 * torch.randn(shape, generator=gen, device=device)
        if cfg.family == "vlm":
            base["ctx_embeds"] = 0.1 * torch.randn(shape, generator=gen, device=device)
    return base
