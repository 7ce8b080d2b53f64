#!/usr/bin/env python3
"""Time every tile of the tensor-core (``wgmma``) matmul and flash-attention
kernels at qwen2-7b's shapes on one CUDA card.

    python3 scripts/probe_wgmma.py

Builds ``csrc/matmul_wgmma.cu`` and ``csrc/flash_attention_wgmma.cu`` and
prints the card's name and power limit, the build seconds and ptxas'
register and spill lines.  Then it times (CUDA events, one warm-up, 5
repetitions) every ``wgmma`` tile of the tuning space at the shapes of
``chip_smoke.py`` (FFN up (4096, 3584) @ (3584, 18944); causal prefill q
(2, 2048, 28, 128), k/v (2, 4, 2048, 128)), beside the library call
(``torch.matmul``; SDPA with the KV heads expanded) and the roofline bound.
Inputs come from seed 0.  Correctness is checked elsewhere
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Exits 1 without a card.
"""
import math
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

MM_SHAPE = (4096, 3584, 18944)
FA_SHAPE = (2, 2048, 28, 4, 128)


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
        print("probe_wgmma: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels.autotuned import roofline

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    built = _cuda.build(["matmul_wgmma", "flash_attention_wgmma"])
    print("build: " + ", ".join(f"{n} {s:.1f}s" for n, s in built.items()))
    for n in ("matmul_wgmma", "flash_attention_wgmma"):
        for line in _cuda.ptxas_report(n).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {n}: {line.split(':', 1)[-1].strip()}")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    M, K, N = MM_SHAPE
    a, b = randn((M, K)), randn((K, N), 1.0 / math.sqrt(K))
    bound = roofline("matmul", a, b).bound_s * 1e3
    print(f"matmul {M}x{K}x{N}: bound {bound:.4f} ms, torch.matmul {cuda_ms(lambda: torch.matmul(a, b), 20):.4f} ms")
    for bm in (64, 128, 256):
        for bn in (32, 64, 128, 256):
            for bk in (32, 64, 128, 256):
                if mm.design(bm, bn, bk, 2) == "wgmma":
                    ms = cuda_ms(lambda: ops.matmul(a, b, bm=bm, bn=bn, bk=bk), 5)
                    print(f"matmul tile {bm}/{bn}/{bk} stages {mm.ring_stages(bm, bn, bk)}: {ms:.4f} ms "
                          f"({bound / ms:.3f} of the bound)")
    B, S, H, Kh, hd = FA_SHAPE
    q, k, v = randn((B, S, H, hd)), randn((B, Kh, S, hd)), randn((B, Kh, S, hd))
    bound = roofline("flash_attention", q, k, v, causal=True).bound_s * 1e3
    qb, ke, ve = q.transpose(1, 2), k.repeat_interleave(H // Kh, 1), v.repeat_interleave(H // Kh, 1)
    sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(qb, ke, ve, is_causal=True), 20)
    print(f"flash q{tuple(q.shape)} kv{tuple(k.shape)} causal: bound {bound:.4f} ms, SDPA {sdpa:.4f} ms")
    for bq in fa.WGMMA_BLOCK_Q:
        for bkv in fa.WGMMA_BLOCK_KV:
            ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True, block_q=bq, block_kv=bkv), 5)
            print(f"flash tile {bq}/{bkv} stages {fa.ring_stages(hd, bq, bkv)}: {ms:.4f} ms "
                  f"({bound / ms:.3f} of the bound)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
