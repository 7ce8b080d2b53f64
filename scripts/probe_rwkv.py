#!/usr/bin/env python3
"""Time the RWKV-6 scan's two designs at every ``chunk`` on one CUDA card.

    python3 scripts/probe_rwkv.py

At rwkv6-7b's serving prefill shape (r, k, v (8, 2048, 64, 64) bf16, fp32
lw = -exp(N(0, 1)), u and s0, from seed 0) it prints the card's name and
power limit, ptxas' report of ``csrc/rwkv_subchunk.cu``, then for the
serving path's ``chunk=4`` and each ``chunk`` of the tuning space: the
design ``ops.rwkv_scan`` runs, its worst error over the limit (y at bf16's
5e-2, sT at fp32's 1e-5) against the exact plain version, and the times
(CUDA events, one warm-up, 10 repetitions, in the order tensor-core,
per-token, per-token, tensor-core) of the tensor-core design and of the
per-token design through its C entry point on the same inputs, beside the
bytes bound.  It exits 1 without a card.
"""
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

SHAPE = (8, 2048, 64, 64)  # batch, prompt, heads, head dim
TOL = {"y": 5e-2, "sT": 1e-5}


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
        print("probe_rwkv: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels.autotuned import roofline

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    print("build (s):", _cuda.build(["linear_scan", "rwkv_subchunk"]))
    print(_cuda.ptxas_report("rwkv_subchunk"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, T, H, hd = SHAPE
    r, k, v = (torch.randn(SHAPE, generator=gen, device=dev).bfloat16() for _ in range(3))
    lw = -torch.exp(torch.randn(SHAPE, generator=gen, device=dev))
    u = torch.randn(H, hd, generator=gen, device=dev) * 0.5
    s0 = torch.randn(B, H, hd, hd, generator=gen, device=dev)
    args = (r, k, v, lw, u, s0)
    terms = roofline("rwkv_scan", *args)
    bytes_ms = terms.memory_s * 1e3
    print(f"bytes bound {bytes_ms:.4f} ms ({terms.bytes_accessed / 1e6:.1f} MB); fp32 operations "
          f"bound of the per-token design {terms.compute_s * 1e3:.4f} ms")
    want = ls.rwkv_scan_plain(*args)
    for chunk in (4, 16, 32, 64, 128):
        before = dict(ls.launches_by_design)
        got = ops.rwkv_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        design = [d for d in before if ls.launches_by_design[d] > before[d]]
        worst = max(((g.float() - w.float()).abs() / (TOL[n] + TOL[n] * w.float().abs())).max().item()
                    for n, g, w in zip(("y", "sT"), got, want))
        tc = [cuda_ms(lambda: ops.rwkv_scan(*args, chunk=chunk), 10)]
        pt = [cuda_ms(lambda: ls._rwkv_launch(*args, chunk, "per_token"), 10) for _ in range(2)]
        tc.append(cuda_ms(lambda: ops.rwkv_scan(*args, chunk=chunk), 10))
        print(f"chunk {chunk}: {design} worst err/limit {worst:.3f}; tensor-core "
              f"{tc[0]:.4f} / {tc[1]:.4f} ms ({bytes_ms / min(tc):.4f} of the bytes bound), "
              f"per-token {pt[0]:.4f} / {pt[1]:.4f} ms ({min(pt) / min(tc):.2f}x)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
