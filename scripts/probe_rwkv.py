#!/usr/bin/env python3
"""Time the RWKV-6 scan's two designs at every ``chunk`` on one CUDA card,
or (``--bwd``) its backward kernel.

    python3 scripts/probe_rwkv.py
    python3 scripts/probe_rwkv.py --bwd [--src DIR ...]

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

``--bwd``: at rwkv6-7b's training shape (r, k, v, gy (1, 2048, 64, 64)
bf16; lw = -exp(N(0, 1)), u, s0 and gs_T fp32; seed 0) it prints ptxas'
report of the backward kernels, the derived chunk, checkpoint segment and
row slices, then for 1, 2, 4 and 8 slices a (head, batch row)
(``_rwkv_bwd_launch``) the worst ||kernel - plain|| / ||plain|| over the six
outputs against ``rwkv_scan_bwd_plain`` (limit 1e-2), two calls bit-identical,
and the time (CUDA events, one warm-up, 10 repetitions; 1, 2, 4, 8, 8, 4,
2, 1); then where the time goes at the derived slice count: copies of
``csrc/linear_scan.cu`` under ``build/rwkv_bwd_cuts/``, each with one part
cut out (the arithmetic of the forward recompute of the checkpoints and
the segments' chunk starts; the backward walk's per-token step; the cluster's barriers and its
distributed shared-memory reads of dv's terms, each block then reading its
own behind block barriers), timed in ``ROUNDS`` rounds through the same wrapper
(median, min, max, and the share of the whole kernel's median the part
takes).  The cut copies compute wrong results on purpose.  ``--src DIR``
(repeatable) also times ``rwkv_scan_bwd`` of the checkout at DIR in a
subprocess, in the order given then reversed, with the current tree
between, and says whether its six outputs are bit-identical to this
tree's at the derived slice count: unpack a parent commit with ``git
archive`` into the git-ignored ``build/`` and pass ``--src build/parent
--src .``.
"""
import argparse
import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

SHAPE = (8, 2048, 64, 64)  # batch, prompt, heads, head dim
TOL = {"y": 5e-2, "sT": 1e-5}
BWD_SHAPE = (1, 2048, 64, 64)
BWD_REL = 1e-2
ROUNDS = 5
# (name, what the copy leaves out, [(text, replacement), ...])
BWD_CUTS = [
    ("whole", "nothing", []),
    ("no_recompute", "the arithmetic of the forward recompute of the checkpoints and of each segment's chunk "
     "starts (its rows are still staged)",
     [("for (int cc = 0; cc < CW; ++cc) S[cc] = fmaf(wi, S[cc], ki * vs[t * HD + q + TPR * cc]);", "")]),
    ("no_walk", "the backward walk's per-token step (the chunk's states are still recomputed)",
     [("for (int t = chunk - 1; t >= 0; --t) {", "for (int t = chunk - 1; t >= chunk; --t) {")]),
    ("no_cluster_sums", "the cluster's barriers and distributed shared-memory reads of dv's terms (each "
     "block reads its own, block barriers)",
     [("cluster.sync();  // every block's dv terms of this chunk are in its shared memory", "__syncthreads();"),
      ("const float* pc = cluster.map_shared_rank(hist, b2) + t * NR * RS + j;",
       "const float* pc = hist + t * NR * RS + j;"),
      ("cluster.sync();  // the next chunk's states overwrite what other blocks have read", "__syncthreads();")]),
]
# times rwkv_scan_bwd of the checkout whose src/ is argv[1] (--src)
SRC_TIMER = """
import sys, torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import linear_scan as ls
B, T, H, hd = %r
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
r, k, v = (torch.randn((B, T, H, hd), generator=gen, device=dev).bfloat16() for _ in range(3))
lw = -torch.exp(torch.randn((B, T, H, hd), generator=gen, device=dev))
u = torch.randn(H, hd, generator=gen, device=dev) * 0.5
s0 = torch.randn(B, H, hd, hd, generator=gen, device=dev)
gy = torch.randn((B, T, H, hd), generator=gen, device=dev).bfloat16()
gsT = torch.randn(B, H, hd, hd, generator=gen, device=dev)
fn = lambda: ls.rwkv_scan_bwd(r, k, v, lw, u, s0, gy, gsT)
torch.save([t.cpu() for t in fn()], sys.argv[2])
torch.cuda.synchronize()
e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
e0.record()
for _ in range(10): fn()
e1.record(); torch.cuda.synchronize()
print(e0.elapsed_time(e1) / 10)
""" % (BWD_SHAPE,)


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


def bwd_rel(got, want) -> float:
    d = (got.float() - want.float()).norm().item()
    w = want.float().norm().item()
    return d / w if w > 0 else (0.0 if d == 0 else float("inf"))


def backward(srcs) -> int:
    """The ``--bwd`` mode (module docstring)."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels.decode_attention import sm_count

    print("build (s):", _cuda.build(["linear_scan"]))
    lines = _cuda.ptxas_report("linear_scan").splitlines()
    for i, line in enumerate(lines):  # each backward instantiation's entry, spill and register lines
        if "Compiling entry" in line and "rwkv_bwd" in line:
            print("\n".join(lines[i:i + 3]))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, T, H, hd = BWD_SHAPE
    r, k, v = (torch.randn(BWD_SHAPE, generator=gen, device=dev).bfloat16() for _ in range(3))
    lw = -torch.exp(torch.randn(BWD_SHAPE, generator=gen, device=dev))
    u = torch.randn(H, hd, generator=gen, device=dev) * 0.5
    s0 = torch.randn(B, H, hd, hd, generator=gen, device=dev)
    gy = torch.randn(BWD_SHAPE, generator=gen, device=dev).bfloat16()
    gsT = torch.randn(B, H, hd, hd, generator=gen, device=dev)
    derived = ls.rwkv_bwd_slices(B, H, hd, sm_count(dev))
    chunk = ls.rwkv_bwd_chunk(T, hd, derived)
    seg = ls.rwkv_bwd_segment(T, chunk)
    flops, nbytes = ls.rwkv_bwd_flops_bytes(r, k, v, lw, u, s0)
    print(f"rwkv backward {BWD_SHAPE} bf16: chunk {chunk}, checkpoints every {seg} tokens, {derived} slices "
          f"derived ({B * H * derived} blocks on {sm_count(dev)} SMs); bound {flops / 67e12 * 1e3:.4f} ms "
          f"by fp32 operations ({flops / 1e9:.2f} GFLOP), bytes {nbytes / 3.35e12 * 1e3:.4f} ms")
    want = ls.rwkv_scan_bwd_plain(r, k, v, lw, u, s0, gy, gsT)
    # each slice count at the chunk its block holds (derived for it), the derived one first
    calls = {}
    for n in (derived, 1, 2, 4, 8):
        c_n = ls.rwkv_bwd_chunk(T, hd, n)
        calls[n] = (lambda n=n, c_n=c_n: ls._rwkv_bwd_launch(r, k, v, lw, u, s0, gy, gsT, c_n,
                                                            ls.rwkv_bwd_segment(T, c_n), n))
    ok = True
    for n, call in calls.items():
        got, again = call(), call()
        worst = max(bwd_rel(g, w) for g, w in zip(got, want))
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        ok = ok and worst <= BWD_REL and same
        print(f"{n} slices ({B * H * n} blocks, chunk {ls.rwkv_bwd_chunk(T, hd, n)}): worst ||kernel - plain|| "
              f"/ ||plain|| {worst:.2e} (limit {BWD_REL:g}), two calls bit-identical {same}")
    times = {n: [] for n in calls}
    for n in (*calls, *reversed(calls)):
        times[n].append(cuda_ms(calls[n], 10))
    for n, ts in times.items():
        print(f"{n} slices: {ts[0]:.4f} / {ts[1]:.4f} ms")
    for n in calls:  # every chunk a block of n slices can hold (the derived chunk assumes one slice)
        for c in (c for c in (4, 8, 16, 32) if T % c == 0 and ls.rwkv_bwd_smem_bytes(c, hd, n) <= ls.SMEM_LIMIT):
            seg_c = ls.rwkv_bwd_segment(T, c)
            fn = lambda c=c, n=n, seg_c=seg_c: ls._rwkv_bwd_launch(r, k, v, lw, u, s0, gy, gsT, c, seg_c, n)  # noqa: E731
            worst = max(bwd_rel(g, w) for g, w in zip(fn(), want))
            print(f"{n} slices, chunk {c} (segment {seg_c}, {ls.rwkv_bwd_smem_bytes(c, hd, n)} bytes of shared "
                  f"memory): {cuda_ms(fn, 10):.4f} ms, worst rel {worst:.2e}")

    out_dir = ROOT / "build" / "rwkv_bwd_cuts"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_cuda.CSRC / "linear_scan.cu").read_text()
    jobs = []
    for name, _, edits in BWD_CUTS:
        copy = text
        for old, new in edits:
            if old not in copy:
                raise SystemExit(f"probe_rwkv: cut {name} no longer applies: {old!r}")
            copy = copy.replace(old, new)
        path = out_dir / f"linear_scan-{name}.cu"
        path.write_text(copy)
        jobs.append((name, path))
    nvcc = _cuda._nvcc()

    def build(job):
        name, path = job
        lib = path.with_suffix(".so")
        cmd = [nvcc, *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o", str(lib), str(path)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"probe_rwkv: {path.name} did not build:\n{proc.stdout}{proc.stderr}")
        return name, lib

    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(build, jobs))
    real = _cuda.load("linear_scan")
    cut_times = {name: [] for name, _ in libs}
    try:
        for _ in range(ROUNDS):
            for name, lib in libs:
                _cuda._libs["linear_scan"] = ctypes.CDLL(str(lib))
                cut_times[name].append(cuda_ms(calls[derived], 10))
    finally:
        _cuda._libs["linear_scan"] = real
    what = {name: w for name, w, _ in BWD_CUTS}
    whole = statistics.median(cut_times["whole"])
    for name, ts in cut_times.items():
        med = statistics.median(ts)
        print(f"rwkv backward at {derived} slices without {what[name]} ({name}): median {med:.4f} ms "
              f"(min {min(ts):.4f}, max {max(ts):.4f}, {ROUNDS} rounds), "
              f"{(whole - med) / whole:+.3f} of the whole kernel's {whole:.4f} ms")
    mine = [t.cpu() for t in calls[derived]()]
    names = ("dr", "dk", "dv", "dlw", "du", "ds0")
    for src in [*srcs, *reversed(srcs)]:
        saved = out_dir / "src_outputs.pt"
        proc = subprocess.run([sys.executable, "-c", SRC_TIMER, str((Path(src) / "src").resolve()), str(saved)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(f"--src {src}: failed\n{proc.stderr[-2000:]}")
            ok = False
            continue
        same = {n: torch.equal(a, b) for n, a, b in zip(names, torch.load(saved), mine)}
        print(f"--src {src}: rwkv_scan_bwd {BWD_SHAPE} bf16 {float(proc.stdout.split()[-1]):.4f} ms; its outputs "
              f"bit-identical to this tree's at {derived} slices: {same}")
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bwd", action="store_true", help="the backward kernel (module docstring)")
    ap.add_argument("--src", action="append", default=[], help="--bwd: also time this checkout")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_rwkv: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    if opts.bwd:
        return backward(opts.src)
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels.autotuned import roofline

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
