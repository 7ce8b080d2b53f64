#!/usr/bin/env python3
"""Flash attention's backward kernel on one CUDA card: agreement and times.

    python3 scripts/probe_flash_bwd.py [--no-times]

Builds ``csrc/flash_attention.cu``, ``flash_attention_wgmma.cu`` and
``flash_attention_bwd.cu`` and prints the card's name and power limit and
ptxas' register and spill lines of the backward.  Then, for a spread of
shapes (every head dim, GQA and MQA, causal and not, Sq != Skv, bf16 and
fp32, the strided q/dO views ``ops.flash_attention`` passes), it runs the
forward kernel with ``return_lse``, holds its lse against the plain
version's, and holds the backward kernel's dq, dk and dv against
``flash_attention_bwd_plain`` on the same o and lse by ||kernel - plain|| /
||plain|| (limit 1e-2 bf16, 1e-5 fp32), naming the design that ran.
Unless ``--no-times``, it times (CUDA events, one warm-up, 5 repetitions)
the backward at the trained shapes (seamless-m4t-large-v2's encoder and
decoder, qwen2-7b's layer) beside the eager oracle it replaced (autograd
through ``ref.flash_attention_ref``), SDPA's backward and the bound (five
products at 989 TFLOP/s against the bytes at 3.35 TB/s), with the design
that ran, the dK/dV pass's head split and its fp32 scratch, and each pass
apart: the dq pass, the dK/dV pass and the sum of the split's partials,
each its mean device time over 5 calls from a ``torch.profiler`` trace.
Inputs come from seed 0.  Exits 1 without a card or when a case disagrees.
"""
import argparse
import math
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# (B, Sq, Skv, H, Kh, hd, dtype, causal)
CASES = [
    (1, 64, 64, 2, 2, 16, torch.bfloat16, True),
    (2, 128, 128, 4, 2, 32, torch.bfloat16, False),
    (1, 256, 256, 8, 1, 64, torch.bfloat16, True),
    (2, 128, 128, 4, 4, 128, torch.bfloat16, True),
    (1, 128, 256, 4, 2, 64, torch.bfloat16, True),
    (1, 256, 128, 4, 2, 128, torch.bfloat16, False),
    (1, 96, 96, 4, 2, 64, torch.bfloat16, True),  # not a multiple of 64: simt
    (1, 128, 128, 4, 2, 64, torch.float32, True),
    (2, 64, 128, 2, 1, 128, torch.float32, False),
    (1, 48, 80, 2, 2, 16, torch.float32, True),
]
TIMED = [("seamless encoder", (3, 4096, 4096, 16, 16, 64), False),
         ("seamless decoder self-attention", (3, 512, 512, 16, 16, 64), True),
         ("qwen2-7b layer", (1, 2048, 2048, 28, 4, 128), True)]


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


def pass_ms(fn, reps: int) -> dict:
    """Mean device ms a call of each kernel ``fn`` launches, by pass, from a
    ``torch.profiler`` trace of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = (("dkdv_sum", "sum"), ("dkdv", "dK/dV"), ("dq_", "dq"))
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        label = next((lab for key, lab in names if key in e.key), None)
        if label is not None and us > 0:
            out[label] = out.get(label, 0.0) + us / 1e3 / reps
    return out


def rel(got, want) -> float:
    d = (got.float() - want.float()).norm().item()
    w = want.float().norm().item()
    return d / w if w > 0 else (0.0 if d == 0 else math.inf)


def inputs(gen, dev, B, Sq, Skv, H, Kh, hd, dtype):
    """q and dO as (B,H,Sq,hd) views of (B,Sq,H,hd) tensors, as ops passes them."""
    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    q = randn((B, Sq, H, hd)).transpose(1, 2)
    k, v = randn((B, Kh, Skv, hd)), randn((B, Kh, Skv, hd))
    do = randn((B, Sq, H, hd)).transpose(1, 2)
    return q, k, v, do


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-times", action="store_true", help="check agreement only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_flash_bwd: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.costs import H100_SXM, roofline_terms
    from repro_torch.kernels import _cuda, ref
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    built = _cuda.build(["flash_attention", "flash_attention_wgmma", "flash_attention_bwd"])
    print("build: " + ", ".join(f"{n} {s:.1f}s" for n, s in built.items()))
    for line in _cuda.ptxas_report("flash_attention_bwd").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas flash_attention_bwd: {line.split(':', 1)[-1].strip()}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for B, Sq, Skv, H, Kh, hd, dtype, causal in CASES:
        q, k, v, do = inputs(gen, dev, B, Sq, Skv, H, Kh, hd, dtype)
        blocks = {"block_q": min(64, Sq), "block_kv": min(64, Skv)}
        if Sq % 64 or Skv % 64:
            blocks = {"block_q": 16, "block_kv": 16}
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, return_lse=True, **blocks)
        _, lse_plain = fa.flash_attention_plain(q, k, v, causal=causal, return_lse=True, **blocks)
        before = dict(fa.launches_by_design)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, **blocks)
        torch.cuda.synchronize()
        design = [d for d, n in fa.launches_by_design.items() if n > before[d]]
        want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, **blocks)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, **blocks)
        rels = [rel(g, w) for g, w in zip(got, want)]
        same = all(torch.equal(a_, b_) for a_, b_ in zip(got, again))
        lse_err = (lse - lse_plain).abs().max().item()
        good = (all(r <= BWD_REL[dtype] for r in rels) and same and lse_err < 1e-4
                and all(g.stride() == t.stride() for g, t in zip(got, (q, k, v))))
        ok = ok and good
        print(f"q{tuple(q.shape)} kv{tuple(k.shape)} {str(dtype)[6:]} causal={causal} {blocks}: "
              f"design {design}, lse max|kernel - plain| {lse_err:.2e}, dq/dk/dv rel "
              f"{', '.join(f'{r:.2e}' for r in rels)} (limit {BWD_REL[dtype]:g}), two calls "
              f"bit-identical {same} {'ok' if good else 'FAIL'}")
    if args.no_times:
        return 0 if ok else 1
    for label, (B, Sq, Skv, H, Kh, hd), causal in TIMED:
        q, k, v, do = inputs(gen, dev, B, Sq, Skv, H, Kh, hd, torch.bfloat16)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
        kernel = lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)  # noqa: E731
        terms = roofline_terms(*fa.bwd_flops_bytes(q, k, v, causal), "bfloat16", H100_SXM)
        before = dict(fa.launches_by_design)
        kernel()
        torch.cuda.synchronize()
        design = [d for d, n in fa.launches_by_design.items() if n > before[d]]
        splits = fa.bwd_head_splits(B, Kh, H // Kh, Skv, torch.cuda.get_device_properties(dev).multi_processor_count)
        passes = pass_ms(kernel, 5)
        ms = cuda_ms(kernel, 5)
        leaves = [t.detach().transpose(1, 2) if i == 0 else t.detach() for i, t in enumerate((q, k, v))]
        leaves = [t.requires_grad_(True) for t in leaves]
        g_oracle = do.transpose(1, 2)

        def oracle():
            with torch.enable_grad():
                return torch.autograd.grad(ref.flash_attention_ref(*leaves, causal=causal), leaves, g_oracle)

        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        oracle_ms = cuda_ms(oracle, 1)
        oracle_peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
        torch.cuda.reset_peak_memory_stats(dev)
        kernel()
        kernel_peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
        sq, sk, sv = (t.detach().clone().requires_grad_(True) for t in
                      (q, k.repeat_interleave(H // Kh, 1), v.repeat_interleave(H // Kh, 1)))
        so = F.scaled_dot_product_attention(sq, sk, sv, is_causal=causal)
        sdpa_ms = cuda_ms(lambda: torch.autograd.grad(so, (sq, sk, sv), do, retain_graph=True), 5)
        print(f"{label}: design {design}, {splits} head splits ({fa.bwd_scratch_bytes(B, Kh, Skv, hd, splits) / 1e6:.1f} "
              f"MB of fp32 dK/dV partials); device ms a call by pass: "
              f"{', '.join(f'{n_} {t_:.4f}' for n_, t_ in passes.items())}")
        print(f"{label} q{tuple(q.shape)} kv{tuple(k.shape)} causal={causal}: kernel {ms:.4f} ms "
              f"({min(ms, cuda_ms(kernel, 5)):.4f} best of two), eager oracle {oracle_ms:.2f} ms, SDPA "
              f"backward {sdpa_ms:.4f} ms, bound {terms.bound_s * 1e3:.4f} ms by {terms.dominant} "
              f"({terms.flops / 1e9:.1f} GFLOP, {terms.bytes_accessed / 1e6:.1f} MB); transient peak "
              f"kernel {kernel_peak:.3f} GB, oracle {oracle_peak:.3f} GB")
        del q, k, v, do, o, lse, leaves, sq, sk, sv, so
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
