"""Inputs made from ``--seed``: token rows, frame embeddings and the order of
the prompt lengths, drawn on the device in a few large calls.

The pattern is the program's ``data/pipeline.py::make_batch_for`` (tokens
and labels one position apart, frames as 0.1 × normals), but every draw
comes from a ``torch.Generator`` seeded by (seed, stream, index) here, so
the harness and the reference get the same inputs and the program gets
nothing but the tensors.  Tokens are uniform below the source's vocabulary
(``source_vocab_size``; never a pad id), so every row of a batch differs.
"""
from __future__ import annotations

import random

import torch

__all__ = ["mix_seed", "train_batch", "serve_batch", "prompt_lengths"]

_STREAMS = {"train": 1, "serve": 2, "frames": 3, "cycle": 4, "weights": 5, "sample": 6}


def mix_seed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit generator seed for draw ``index`` of ``stream`` (any whole
    ``seed``, also one over 32 bits)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + _STREAMS[stream] * 0xBF58476D1CE4E5B9 + int(index))
    x ^= x >> 31
    return (x * 0x94D049BB133111EB) % (1 << 63)


def _gen(device, seed: int, stream: str, index: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix_seed(seed, stream, index))


def _frames(sizes: dict, B: int, n: int, seed: int, index: int, device) -> torch.Tensor:
    gen = _gen(device, seed, "frames", index)
    return 0.1 * torch.randn((B, n, sizes["d_model"]), generator=gen, device=device)


def train_batch(sizes: dict, traffic: dict, seed: int, step: int, device) -> dict:
    """Step ``step``'s batch: ``tokens`` and ``labels`` (B, S) int64, and
    ``frames`` (B, F, d) fp32 for an encoder-decoder.  The first
    ``prompt_len`` positions of each row are a prompt: their labels are -1,
    which the loss leaves out."""
    B, S = traffic["batch"], traffic["seq_len"]
    gen = _gen(device, seed, "train", step)
    rows = torch.randint(0, sizes["source_vocab_size"], (B, S + 1), generator=gen, device=device)
    labels = rows[:, 1:].clone()
    labels[:, :traffic.get("prompt_len", 0)] = -1
    batch = {"tokens": rows[:, :-1].contiguous(), "labels": labels}
    if traffic.get("frames"):
        batch["frames"] = _frames(sizes, B, traffic["frames"], seed, 2 * step, device)
    return batch


def prompt_lengths(traffic: dict, seed: int, n_batches: int) -> list:
    """The prompt length of each of the first ``n_batches`` batches: the
    traffic's lengths in cycles, each cycle a permutation drawn from the
    seed, every cycle complete before the next."""
    lengths = list(traffic["prompt_lens"])
    out = []
    cycle = 0
    while len(out) < n_batches:
        order = lengths[:]
        random.Random(mix_seed(seed, "cycle", cycle)).shuffle(order)
        out.extend(order)
        cycle += 1
    return out[:n_batches]


def serve_batch(sizes: dict, traffic: dict, seed: int, index: int, prompt_len: int,
                device) -> dict:
    """Batch ``index`` of a serving mix: ``tokens`` (B, P) int64, ``max_len``
    and, for an encoder-decoder, ``frames``."""
    B = traffic["batch"]
    gen = _gen(device, seed, "serve", index)
    tokens = torch.randint(0, sizes["source_vocab_size"], (B, prompt_len), generator=gen, device=device)
    batch = {"tokens": tokens, "max_len": prompt_len + traffic["gen"]}
    if traffic.get("frames"):
        batch["frames"] = _frames(sizes, B, traffic["frames"], seed, 2 * index + 1, device)
    return batch
