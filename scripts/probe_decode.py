#!/usr/bin/env python3
"""Time the decode-attention kernel at every ``block_kv`` on one CUDA card.

    python3 scripts/probe_decode.py

At the qwen2-7b decode shape (q (8, 28, 128), k/v (8, 4, 32768, 128) bf16,
a random valid prefix per row) and at recurrentgemma-2b's MQA decode shape
(q (8, 10, 256), k/v (8, 1, 2048, 256) bf16, every slot valid), it prints
the card's name and power limit, the kernel's split count and grid, its
max |error| against its plain version at that split count, its time (CUDA
events, one warm-up, 10 repetitions) and its share of the bytes bound at
each ``block_kv`` of the tuning space, the plain version's time at 512 (2
repetitions) and ``F.scaled_dot_product_attention`` with the bool mask and
the KV heads expanded (10 repetitions), beside the roofline bound.  Weights
come from seed 0.  It builds the CUDA kernels first and exits 1 without a
card.
"""
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

SHAPES = ((8, 28, 4, 32768, 128), (8, 10, 1, 2048, 256))  # B, H, Kh, S, hd


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_decode: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.autotuned import roofline

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    print("build (s):", _cuda.build())
    print(_cuda.ptxas_report("decode_attention"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, H, Kh, S, hd in SHAPES:
        q = torch.randn(B, H, hd, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, Kh, S, hd, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, Kh, S, hd, generator=gen, device=dev).bfloat16()
        lens = torch.randint(1, S + 1, (B,), generator=gen, device=dev) if Kh > 1 else torch.full(
            (B,), S, device=dev)
        valid = (torch.arange(S, device=dev)[None] < lens[:, None]).to(torch.int32)
        terms = roofline("decode_attention", q, k, v, valid)
        print(f"shape B,H,Kh,S,hd={(B, H, Kh, S, hd)}: bound {terms.bound_s * 1e3:.4f} ms by "
              f"{terms.dominant}")
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        for bkv in (64, 128, 256, 512, 1024):
            grid = da.grid(B, Kh, H // Kh, S, bkv, n_sm)
            err = (ops.decode_attention(q, k, v, valid, block_kv=bkv).float()
                   - da.decode_attention_plain(q, k, v, valid, block_kv=bkv, splits=grid[2]).float()
                   ).abs().max()
            ms = cuda_ms(lambda: ops.decode_attention(q, k, v, valid, block_kv=bkv), 10)
            print(f"  block_kv {bkv}: {grid[2]} splits, grid {grid} ({grid[0] * grid[1] * grid[2]} "
                  f"blocks), max |kernel - plain| {err.item():.3e}, kernel {ms:.4f} ms, "
                  f"{terms.memory_s * 1e3 / ms:.4f} of the bytes bound")
        print(f"  plain (512): {cuda_ms(lambda: da.decode_attention_plain(q, k, v, valid), 2):.4f} ms")
        k_exp, v_exp = k.repeat_interleave(H // Kh, 1), v.repeat_interleave(H // Kh, 1)
        mask = (valid > 0)[:, None, None, :]
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], k_exp, v_exp,
                                                              attn_mask=mask), 10)
        print(f"  SDPA: {sdpa:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
