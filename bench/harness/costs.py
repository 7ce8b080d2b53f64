"""The yardstick's arithmetic shared by every configuration: the card's
peaks and the least time of each hand-written kernel's work.

Frozen here so that no change to the program moves the yardstick.  The
peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity) at its
700 W limit.  A kernel's least time is the larger of its operations over the
peak of their type and its bytes over the memory bandwidth, counting each
input read once and each output written once, whatever the kernel reads
again.  The model FLOPs of a step or a prefill belong to each
configuration's reference (``bench/reference/<name>.py::model_flops``),
which knows the model's layers.
"""
from __future__ import annotations

import dataclasses

__all__ = ["H100", "Peaks", "rwkv_fwd_work", "rwkv_bwd_work", "flash_fwd_work",
           "flash_bwd_work", "least_seconds"]


@dataclasses.dataclass(frozen=True)
class Peaks:
    bf16_flops: float
    tf32_flops: float
    hbm_bytes_per_s: float
    memory_bytes: float


#: NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16 dense, 495 TFLOP/s TF32 dense,
#: 3.35 TB/s HBM3, 80 GB
H100 = Peaks(989e12, 495e12, 3.35e12, 80e9)


# ---------------------------------------------------------------- kernels
def rwkv_fwd_work(B: int, T: int, H: int, hd: int, act_bytes: int = 2) -> tuple:
    """(FLOP, FLOP type, bytes) of one RWKV-6 scan forward call: 5·hd² FLOP
    per (token, head), counted at the TF32 tensor-core peak (the fastest
    that keeps the fp32 state's range: a chunked form runs them there, so
    no design can beat this bound); r, k, v in the activation dtype, lw fp32
    read, y written; u, s0 read and sT written in fp32."""
    n = B * T * H * hd
    return (5.0 * B * T * H * hd * hd, "tf32",
            float(4 * n * act_bytes + n * 4 + H * hd * 4 + 2 * B * H * hd * hd * 4))


def rwkv_bwd_work(B: int, T: int, H: int, hd: int, act_bytes: int = 2) -> tuple:
    """(FLOP, FLOP type, bytes) of one RWKV-6 scan backward call: 14·hd²
    FLOP per (token, head) at the TF32 peak, as the forward's; r, k, v, gy
    read and dr, dk, dv written in
    the activation dtype, lw read and dlw written, u, s0, gs_T read and du,
    ds0 written in fp32."""
    n = B * T * H * hd
    return (14.0 * B * T * H * hd * hd, "tf32",
            float(7 * n * act_bytes + 2 * n * 4 + 2 * H * hd * 4 + 3 * B * H * hd * hd * 4))


def _pairs(Sq: int, Skv: int, causal: bool) -> float:
    if not causal:
        return float(Sq * Skv)
    return float(sum(min(i + 1, Skv) for i in range(Sq)))


def flash_fwd_work(B: int, H: int, Kh: int, Sq: int, Skv: int, hd: int, causal: bool,
                   act_bytes: int = 2) -> tuple:
    """(FLOP, FLOP type, bytes) of one flash-attention forward call with
    ``H`` query heads over ``Kh`` key/value heads: 4·hd bf16 FLOP per kept
    (query, key) pair and query head; q, k, v read, o written."""
    flops = 4.0 * B * H * _pairs(Sq, Skv, causal) * hd
    return flops, "bf16", float((2 * B * Sq * H * hd + 2 * B * Skv * Kh * hd) * act_bytes)


def flash_bwd_work(B: int, H: int, Kh: int, Sq: int, Skv: int, hd: int, causal: bool,
                   act_bytes: int = 2) -> tuple:
    """(FLOP, FLOP type, bytes) of one flash-attention backward call with
    ``H`` query heads over ``Kh`` key/value heads: FlashAttention-2's five
    products, 10·hd bf16 FLOP per kept pair and query head; q, o, dO read
    and dq written, k, v read and dk, dv written, the fp32 logsumexp read."""
    flops = 10.0 * B * H * _pairs(Sq, Skv, causal) * hd
    nbytes = (4 * B * Sq * H * hd + 4 * B * Skv * Kh * hd) * act_bytes + 4 * B * H * Sq
    return flops, "bf16", float(nbytes)


def least_seconds(work: tuple, peaks: Peaks = H100) -> float:
    """The least time of ``work`` = (FLOP, FLOP type, bytes) on the card."""
    flops, kind, nbytes = work
    rate = {"bf16": peaks.bf16_flops, "tf32": peaks.tf32_flops}[kind]
    return max(flops / rate, nbytes / peaks.hbm_bytes_per_s)
