"""The least time of the work that latent attention and drop-free grouped
experts do (Moonlight-16B-A3B's layers), for the roofline shares that read
them (``bench/metrics/moe_roofline.prefill.py``,
``bench/metrics/mla_flash_roofline.prefill.py``).  Counted from shapes as
``costs.py`` counts the other kernels: each input read once, each output
written once, operations at the bf16 tensor-core peak."""
from __future__ import annotations

__all__ = ["grouped_experts_work", "mla_flash_fwd_work"]


def grouped_experts_work(assignments: int, d: int, f: int, experts: int,
                         act_bytes: int = 2) -> tuple:
    """(FLOP, FLOP type, bytes) of one MoE layer's routed experts over
    ``assignments`` (token, expert) pairs, every expert touched: a SwiGLU
    of width ``f`` per assignment, 6·d·f bf16 FLOP (three products); the
    experts' three (d, f) matrices read once, a d-wide row read and one
    written per assignment."""
    flops = 6.0 * assignments * d * f
    nbytes = (3 * experts * d * f + 2 * assignments * d) * act_bytes
    return flops, "bf16", float(nbytes)


def mla_flash_fwd_work(B: int, H: int, S: int, hd_qk: int, hd_v: int,
                       act_bytes: int = 2) -> tuple:
    """(FLOP, FLOP type, bytes) of one causal flash-attention forward over
    ``S`` tokens with query/key heads ``hd_qk`` and value heads ``hd_v``
    wide (as many key/value heads as query heads, latent attention's
    prefill): 2·(hd_qk + hd_v) bf16 FLOP per kept (query, key) pair and
    head; q, k, v read, o written."""
    pairs = S * (S + 1) / 2
    flops = 2.0 * B * H * pairs * (hd_qk + hd_v)
    nbytes = B * S * H * (2 * hd_qk + 2 * hd_v) * act_bytes
    return flops, "bf16", float(nbytes)
