#!/usr/bin/env python3
"""Time the lru scan on one CUDA card, and measure the error its segment carry adds.

    python3 scripts/probe_lru.py [--src DIR] [--sweep]

At recurrentgemma-2b's prefill scan shape (a, b (8, 2048, 2560) fp32 with
a = sigmoid(N(0, 1)), b and h0 from N(0, 1), seed 0; block_d 128) it prints
the card's name and power limit, then for serving's ``chunk=4`` and every
``chunk`` of the tuning space: the segment count the kernel derives, its
time (CUDA events, one warm-up, 20 repetitions per round, 5 rounds: median,
min, max), its share of the bytes bound and its largest error against the
exact plain version.

``--src DIR`` imports the port from ``DIR/src`` instead of this checkout,
so that two versions (for example the parent commit unpacked into
``build/``) are timed in one call on one card.  ``--sweep`` (this checkout
only) also times the kernel at chunk 4 with every segment count from 16 to
512 (through its launch entry point), and reports, for segments of 1 to 2048
steps, the worst |error| of the segmented arithmetic against a float64
oracle beside that of the plain sequential scan, on two inputs: the decays
above, and long-memory decays a = 0.9 + 0.0999·U(0, 1) (the served model's
σ(Λ)^(8r) lies in such a range).  It exits 1 without a card.
"""
import argparse
import statistics
import subprocess
import sys
from pathlib import Path

import torch

SHAPE = (8, 2048, 2560)  # batch, prompt, RG-LRU width
CHUNKS = (4, 16, 32, 64, 128)


def cuda_ms(fn, reps: int = 20, rounds: int = 5) -> list:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1) / reps)
    return out


def fmt(ts: list) -> str:
    return f"{statistics.median(ts):.4f} ms (min {min(ts):.4f}, max {max(ts):.4f})"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose src/ is imported")
    ap.add_argument("--sweep", action="store_true", help="segment counts and carry error")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_lru: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels.autotuned import roofline

    label = Path(args.src).resolve().name
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    print(f"[{label}] build (s): {_cuda.build(['linear_scan'])}")
    print(f"[{label}] {_cuda.ptxas_report('linear_scan')}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.sigmoid(torch.randn(SHAPE, generator=gen, device=dev))
    b = torch.randn(SHAPE, generator=gen, device=dev)
    h0 = torch.randn(SHAPE[::2], generator=gen, device=dev)
    bound = roofline("lru_scan", a, b, h0).memory_s * 1e3
    want = ls.lru_scan_plain(a, b, h0)
    segmented = hasattr(ls, "lru_segments")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for chunk in CHUNKS:
        hs, hT = ops.lru_scan(a, b, h0, chunk=chunk)
        err = max((hs - want[0]).abs().max().item(), (hT - want[1]).abs().max().item())
        ts = cuda_ms(lambda: ops.lru_scan(a, b, h0, chunk=chunk))
        seg = (f"{ls.lru_segments(*SHAPE, chunk, ls.LRU_BLOCK_D, 4, sms)} segments"
               if segmented else "one block per column")
        print(f"[{label}] chunk {chunk}: {seg}, {fmt(ts)}, "
              f"{bound / statistics.median(ts):.3f} of the bytes bound {bound:.4f} ms, "
              f"max |err| {err:.3e} against the plain version")
    if not args.sweep:
        return 0
    for nseg in (16, 32, 64, 128, 256, 512):
        hs, _ = ls._lru_launch(a, b, h0, 4, ls.LRU_BLOCK_D, nseg)
        err = (hs - want[0]).abs().max().item()
        ts = cuda_ms(lambda: ls._lru_launch(a, b, h0, 4, ls.LRU_BLOCK_D, nseg))
        print(f"[{label}] chunk 4, {nseg} segments of {SHAPE[1] // nseg} steps "
              f"({2 * SHAPE[1] // nseg * ls.LRU_BLOCK_D * 4 // 1024} KB staged): {fmt(ts)}, "
              f"max |err| {err:.3e}")
    a_long = 0.9 + 0.0999 * torch.rand(SHAPE, generator=gen, device=dev)
    for name, dec in (("sigmoid decays", a), ("long-memory decays", a_long)):
        exact, _ = ls.ref.lru_scan_ref(dec.double(), b.double(), h0.double())
        seq = (ls.lru_scan_plain(dec, b, h0)[0].double() - exact).abs().max().item()
        for nseg in (1, 4, 16, 64, 256, 2048):
            hs, _ = ls.lru_scan_segmented_plain(dec, b, h0, segments=nseg)
            err = (hs.double() - exact).abs().max().item()
            print(f"[{label}] {name}: segments of {SHAPE[1] // nseg} steps, max |err| against "
                  f"float64 {err:.3e} (sequential fp32 scan {seq:.3e}; max |h| "
                  f"{exact.abs().max().item():.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
