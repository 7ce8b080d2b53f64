#!/usr/bin/env python3
"""Time the lru scan on one CUDA card, and measure the error its segment carry adds.

    python3 scripts/probe_lru.py [--src DIR] [--sweep]
    python3 scripts/probe_lru.py --bwd [--src DIR]

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

``--bwd``: the backward kernel (``linear_scan.lru_scan_bwd``) at
recurrentgemma-2b's training call (a, b, g (4, 256, 2560), h0 and g_T
(4, 2560) fp32, g_T nonzero, seed 0, ``rec_chunk`` 8) in fp32 and bf16 and
at T 2048 (streamed), and at (4, 256, 2560) fp32 with the long-memory
decays: ptxas' report of the kernel, the tiling :func:`lru_bwd_tiling`
derives, ||kernel − plain|| / ||plain|| of da, db and dh0 against
``lru_scan_bwd_plain`` (limit ``BWD_REL``) and against
``lru_scan_bwd_segmented_plain`` at the same tiling, whether two calls are
bit-identical, the time (CUDA events as above), the share of the bytes
bound (5 passes of the dtype over (B, T, D) at 3.35 TB/s), and the device
kernels of a call under ``torch.profiler`` (20 calls) with their device µs
a call, whose sum is the call's device time (the wrapper's host work is
not in it; the CUDA events are).  Then the kernel at other tilings
(channels a block, sub-segments; ``_lru_bwd_launch``) at the training
call in fp32 and bf16 and at one batch row, device µs a call in turns;
then where the time goes at the derived tiling of the fp32 training call:
copies of ``csrc/linear_scan.cu`` under ``build/lru_bwd_cuts/``, each with
one part cut out (``BWD_CUTS``: the stores of da and db; the staging of
g), device µs in turns (the cut copies compute wrong results on purpose).
With ``--src DIR`` (a parent checkout, for example ``git archive`` of it
unpacked into the git-ignored ``build/``) that checkout's ``lru_scan_bwd``
runs in a subprocess before and after this tree's timings, at the same
shapes and seed, with its device kernels by name (the parent's recompute
of hs and its reverse scan apart).
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

SHAPE = (8, 2048, 2560)  # batch, prompt, RG-LRU width
CHUNKS = (4, 16, 32, 64, 128)
BWD_SHAPE = (4, 256, 2560)  # recurrentgemma-2b's training call: batch, tokens, RG-LRU width
BWD_T_STREAMED = 2048
BWD_CHUNK = 8  # the training launcher's rec_chunk
BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
HBM_BYTES_S = 3.35e12  # H100 SXM data sheet
# (label, shape, dtype name, long-memory decays)
BWD_CASES = (("training fp32", BWD_SHAPE, "float32", False),
             ("training bf16", BWD_SHAPE, "bfloat16", False),
             ("training fp32 long-memory", BWD_SHAPE, "float32", True),
             ("T 2048 fp32 (streamed)", (BWD_SHAPE[0], BWD_T_STREAMED, BWD_SHAPE[2]), "float32", False))
# other tilings timed: shapes (dtype name), channels a block, sub-segments
BWD_SWEEP_SHAPES = ((BWD_SHAPE, "float32"), (BWD_SHAPE, "bfloat16"), ((1, 256, 2560), "float32"))
BWD_SWEEP_CW = (8, 16, 32, 64)
BWD_SWEEP_NSUB = (8, 16, 32)
PROFILED_CALLS = 20
# (name, what the copy leaves out, [(text, replacement), ...])
BWD_CUTS = [
    ("whole", "nothing", []),
    ("no_stores", "the stores of da and db (their arithmetic kept behind a store that never runs)",
     [("      write_row<T, CPT>(db + grow(t0 + r), G);\n      write_row<T, CPT>(da + grow(t0 + r), d);",
       "      if (G[0] == -1.2345e-37f && d[0] == -1.2345e-37f) {\n"
       "        write_row<T, CPT>(db + grow(t0 + r), G);\n        write_row<T, CPT>(da + grow(t0 + r), d);\n      }")]),
    ("no_g", "the staging of g (the reverse scan reads whatever shared memory holds)",
     [("    for (int r = lo; r < hi; ++r) stage<T, CPT>(gs + srow(r), g + grow(t0 + r));\n", "")]),
]

# lru_scan_bwd of the checkout whose src/ is argv[1], at BWD_CASES: JSON of
# each case's time (CUDA events) and its device kernels from torch.profiler
SRC_TIMER = r"""
import json, statistics, sys, torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
from probe_lru import BWD_CASES, BWD_CHUNK, PROFILED_CALLS, bwd_inputs, cuda_ms, kernels_of
from repro_torch.kernels import linear_scan as ls
out = {}
for label, shape, dtype, long_memory in BWD_CASES:
    args = bwd_inputs(shape, getattr(torch, dtype), long_memory)
    fn = lambda: ls.lru_scan_bwd(*args, chunk=BWD_CHUNK)
    got = [t.float().cpu() for t in fn()]
    want = ls.lru_scan_bwd_plain(*args, chunk=BWD_CHUNK)
    rel = max(((g - w.float().cpu()).norm() / w.float().cpu().norm()).item() for g, w in zip(got, want))
    out[label] = {"ms": cuda_ms(fn), "kernels": kernels_of(fn, PROFILED_CALLS), "rel": rel}
    del args, got, want
print(json.dumps(out))
"""


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


def bwd_inputs(shape, dtype, long_memory: bool):
    """(a, b, h0, g, g_T) on the card from seed 0: a = sigmoid(N(0, 1)) or
    0.9 + 0.0999·U(0, 1), the rest N(0, 1); a, b, g in ``dtype``."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, T, D = shape
    if long_memory:
        a = 0.9 + 0.0999 * torch.rand(shape, generator=gen, device=dev)
    else:
        a = torch.sigmoid(torch.randn(shape, generator=gen, device=dev))
    b = torch.randn(shape, generator=gen, device=dev)
    h0 = torch.randn((B, D), generator=gen, device=dev)
    g = torch.randn(shape, generator=gen, device=dev)
    gT = torch.randn((B, D), generator=gen, device=dev)
    return a.to(dtype), b.to(dtype), h0, g.to(dtype), gT


def kernels_of(fn, calls: int = 1) -> dict:
    """The device kernels, copies and memsets of ``calls`` calls of ``fn``
    from a ``torch.profiler`` trace (after a warm-up): {name: [count a call,
    device µs a call]}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    path = Path(__file__).resolve().parents[1] / "build" / "probe_lru_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    out = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e:
            row = out.setdefault(e["name"], [0.0, 0.0])
            row[0] += 1 / calls
            row[1] += e["dur"] / calls
    return out


def device_us(fn) -> float:
    """Device µs a call of ``fn``: its kernels' durations over
    ``PROFILED_CALLS`` calls."""
    return sum(us for _, us in kernels_of(fn, PROFILED_CALLS).values())


def bwd_rel(got, want) -> float:
    d = (got.float() - want.float()).norm().item()
    w = want.float().norm().item()
    return d / w if w > 0 else (0.0 if d == 0 else float("inf"))


def parent_run(src: str) -> dict:
    """SRC_TIMER in a subprocess on the checkout at ``src``."""
    proc = subprocess.run([sys.executable, "-c", SRC_TIMER, str((Path(src) / "src").resolve()),
                           str(Path(__file__).resolve().parent)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"probe_lru: --src {src} failed\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def backward(src) -> int:
    """The ``--bwd`` mode (module docstring)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels.decode_attention import sm_count

    print(f"build (s): {_cuda.build(['linear_scan'])}")
    lines = _cuda.ptxas_report("linear_scan").splitlines()
    for i, line in enumerate(lines):  # each backward instantiation's entry, spill and register lines
        if "Compiling entry" in line and "lru_bwd" in line:
            print("\n".join(lines[i:i + 3]))
    dev = torch.device("cuda")
    sms = sm_count(dev)
    parent = {"before": parent_run(src)} if src else {}
    ok = True
    for label, shape, dtype_name, long_memory in BWD_CASES:
        dtype = getattr(torch, dtype_name)
        args = bwd_inputs(shape, dtype, long_memory)
        tiling = ls.lru_bwd_tiling(*shape[1:], args[0].element_size())
        fn = lambda: ls.lru_scan_bwd(*args, chunk=BWD_CHUNK)  # noqa: E731
        got, again = fn(), fn()
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        want = ls.lru_scan_bwd_plain(*args, chunk=BWD_CHUNK)
        seg = ls.lru_scan_bwd_segmented_plain(*args, subsegments=tiling.nsub,
                                              tile=tiling.tile if tiling.tiles > 1 else 0)
        rel = [bwd_rel(x, w) for x, w in zip(got, want)]
        rel_seg = [bwd_rel(x, w) for x, w in zip(got, seg)]
        ok = ok and max(rel) <= BWD_REL[dtype] and same
        bound = ls.lru_bwd_flops_bytes(*args[:3])[1] / HBM_BYTES_S * 1e3
        ts = cuda_ms(fn)
        kernels = kernels_of(fn, PROFILED_CALLS)
        dev_ms = sum(us for _, us in kernels.values()) / 1e3
        print(f"[{label}] {tuple(shape)} {dtype_name}: {tiling}, {shape[0] * shape[2] // tiling.cw} blocks of "
              f"{tiling.cw // tiling.cpt * tiling.nsub} threads on {sms} SMs, "
              f"{ls.lru_bwd_smem_bytes(tiling.cw, tiling.nsub, tiling.tile, args[0].element_size())} bytes "
              f"of shared memory; (da, db, dh0) ||kernel - plain|| / ||plain|| "
              f"{', '.join(f'{r:.2e}' for r in rel)} (limit {BWD_REL[dtype]:g}), against the segmented "
              f"plain version {', '.join(f'{r:.2e}' for r in rel_seg)}; two calls bit-identical {same}")
        print(f"[{label}] CUDA events through lru_scan_bwd {fmt(ts)}; device {dev_ms:.4f} ms a call; bytes "
              f"bound {bound:.4f} ms, {bound / dev_ms:.3f} of it by device time, "
              f"{bound / statistics.median(ts):.3f} by the events; device kernels a call {kernels}")
        del args, got, again, want, seg
    for shape, dtype_name in BWD_SWEEP_SHAPES:
        a, b, h0, g, gT = bwd_inputs(shape, getattr(torch, dtype_name), False)
        B, T, D = shape
        isz = a.element_size()
        want = ls.lru_scan_bwd_plain(a, b, h0, g, gT, chunk=BWD_CHUNK)
        derived = ls.lru_bwd_tiling(T, D, isz)
        calls = {}
        for cw in BWD_SWEEP_CW:
            for nsub in BWD_SWEEP_NSUB:
                smem = ls.lru_bwd_smem_bytes(cw, nsub, T, isz)
                if D % cw or smem > ls.SMEM_LIMIT or cw // 4 * nsub > 1024:
                    continue
                tl = ls.LruBwdTiling(cw, 4, nsub, T, 1)
                calls[(cw, nsub)] = (lambda tl=tl: ls._lru_bwd_launch(a, b, h0, g, gT, tl))
                rel = max(bwd_rel(x, w) for x, w in zip(calls[(cw, nsub)](), want))
                ok = ok and rel <= BWD_REL[a.dtype]
                print(f"[sweep {shape} {dtype_name}] {cw} channels a block, {nsub} sub-segments of "
                      f"{-(-T // nsub)} rows ({B * D // cw} blocks of {cw // 4 * nsub} threads, {smem} bytes "
                      f"of shared memory{', derived' if (cw, nsub) == (derived.cw, derived.nsub) else ''}): worst rel {rel:.2e}")
        times = {k: [] for k in calls}
        for k in (*calls, *reversed(calls)):
            times[k].append(device_us(calls[k]))
        bound = ls.lru_bwd_flops_bytes(a, b, h0)[1] / HBM_BYTES_S * 1e6
        for (cw, nsub), ts in times.items():
            print(f"[sweep {shape} {dtype_name}] {cw} channels, {nsub} sub-segments: device "
                  f"{' / '.join(f'{t:.2f}' for t in ts)} us a call, {bound / min(ts):.3f} of the bytes bound "
                  f"{bound:.2f} us")
        del a, b, h0, g, gT, want, calls

    # where the time goes: cut copies at the derived tiling of the fp32 training call
    a, b, h0, g, gT = bwd_inputs(BWD_SHAPE, torch.float32, False)
    tl = ls.lru_bwd_tiling(*BWD_SHAPE[1:], 4)
    out_dir = Path(__file__).resolve().parents[1] / "build" / "lru_bwd_cuts"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_cuda.CSRC / "linear_scan.cu").read_text()
    jobs = []
    for name, _, edits in BWD_CUTS:
        copy = text
        for old, new in edits:
            if old not in copy:
                raise SystemExit(f"probe_lru: cut {name} no longer applies: {old!r}")
            copy = copy.replace(old, new)
        path = out_dir / f"linear_scan-{name}.cu"
        path.write_text(copy)
        jobs.append((name, path))
    nvcc = _cuda._nvcc()

    def build(job):
        name, path = job
        lib = path.with_suffix(".so")
        proc = subprocess.run([nvcc, *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o", str(lib), str(path)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"probe_lru: {path.name} did not build:\n{proc.stdout}{proc.stderr}")
        return name, ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(build, jobs))
    real = _cuda.load("linear_scan")
    cut_us = {name: [] for name, _ in libs}
    try:
        for _ in range(3):
            for name, lib in libs:
                _cuda._libs["linear_scan"] = lib
                cut_us[name].append(device_us(lambda: ls._lru_bwd_launch(a, b, h0, g, gT, tl)))
    finally:
        _cuda._libs["linear_scan"] = real
    what = {name: w for name, w, _ in BWD_CUTS}
    whole = statistics.median(cut_us["whole"])
    for name, ts in cut_us.items():
        med = statistics.median(ts)
        print(f"[cuts {BWD_SHAPE} fp32, {tl}] without {what[name]} ({name}): device median {med:.2f} us "
              f"(min {min(ts):.2f}, max {max(ts):.2f}, 3 rounds), {(whole - med) / whole:+.3f} of the whole "
              f"kernel's {whole:.2f} us")
    if src:
        parent["after"] = parent_run(src)
        for label, *_ in BWD_CASES:
            runs = [parent[w][label] for w in ("before", "after")]
            ms = [t for r in runs for t in r["ms"]]
            dev = [sum(us for _, us in r["kernels"].values()) / 1e3 for r in runs]
            print(f"[--src {src}] [{label}] lru_scan_bwd: CUDA events {fmt(ms)} (two runs, before and after "
                  f"this tree's), device {' / '.join(f'{d:.4f}' for d in dev)} ms a call; worst rel against its "
                  f"plain version {max(r['rel'] for r in runs):.2e}; device kernels a call {runs[1]['kernels']}")
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None, help="the checkout whose src/ is imported (--bwd: timed beside)")
    ap.add_argument("--sweep", action="store_true", help="segment counts and carry error")
    ap.add_argument("--bwd", action="store_true", help="the backward kernel (module docstring)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_lru: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    if args.bwd:
        return backward(args.src)
    src = args.src or str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, str(Path(src).resolve() / "src"))
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels.autotuned import roofline

    label = Path(src).resolve().name
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
