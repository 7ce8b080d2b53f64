#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card, end to end.

    python3 chip_smoke.py [--out DIR]

Phases, each printing its numbers on lines of its own:

1. device: the card's name and count, and ``nvidia-smi``'s name and power
   limit; then the CUDA kernels are built from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, started together) and ptxas' register report shown;
2. kernels against their plain PyTorch versions at the qwen2-7b shapes
   (FFN up-projection (4096, 3584) @ (3584, 18944) and causal prefill
   attention q (2, 2048, 28, 128), k/v (2, 4, 2048, 128), both bf16) and at
   the serving prefill's scan shapes (RG-LRU a, b (8, 2048, 2560) fp32 of
   recurrentgemma-2b; RWKV-6 r, k, v (8, 2048, 64, 64) bf16 with fp32 lw,
   u, s0 of rwkv6-7b), at default and non-default knobs, plus a small fp32
   case each and the RWKV strong-decay case (lw = -14);
3. the PATSMA tuning loop: ``tune_call`` on the four calls with the default
   CSA budget, committing records to ``DIR/tune.json``;
4. replay: ``autotuned`` on the same DB is an exact hit (one launch, output
   bit-equal to the kernel at the stored knobs, which is launched for the
   comparison only after the main path's counts are read);
5. the pretune CLI (``--smoke``) twice in-process; the second run makes only
   exact hits;
6. times with CUDA events: each kernel at default and tuned knobs (the
   scans also at the serving path's ``chunk=4``), its plain version, one
   library call for the same function where one exists (a yardstick the
   port never calls; no single PyTorch call computes either scan), and the
   analytic roofline bound;
7. serving recurrentgemma-2b at full width and depth through
   ``repro_torch.launch.serve`` (batch 8, prompt 2048, 64 new tokens, random
   weights from seed 0) twice on one DB: the first run tunes the decode
   depth online and commits it, the second must be a DB hit.  Every prefill
   must launch ``lru_scan`` 18 times (one per RG-LRU layer).  Then the
   served model's final prefill hidden state on the kernel path is held
   against the plain path (``attn_impl="xla"``) in fp32 arithmetic, and the
   scan kernel against its plain version on the last layer's scan inputs
   as served (bf16 r, k, v for rwkv);
8. the same for rwkv6-7b at full width and depth (32 ``rwkv_scan`` launches
   per prefill).

Phases 3-5 (the tuning loop) and phases 7-8 (serving) are the main paths:
the kernels' launch counters are set to 0 just before each path and read
just after, and every kernel must have launched on one of them.
The line before the last two is a JSON object with one entry per kernel;
then ``nvidia-smi``'s name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero, and so
does a run without a CUDA card or outside a checkout of the repository.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: atol = rtol per kernel and dtype for kernel vs plain version: the same
#: fp32 arithmetic summed in another order (fp32), plus output rounding
#: (bf16).  The matmul's bf16 outputs are O(1); causal attention over 2048
#: keys averages most rows down to a few hundredths, so its bf16 limit sits
#: just above one bf16 rounding step at those magnitudes.
TOL = {"matmul": {"float32": 1e-5, "bfloat16": 2e-2},
       "flash_attention": {"float32": 1e-5, "bfloat16": 5e-3},
       # the scans: the same fp32 recurrence (the lru kernel fuses the
       # multiply-add); rwkv's bf16 y rounds an fp32 sum of 64 products, at
       # the JAX package's bf16 limit for this scan
       "lru_scan": {"float32": 1e-5, "bfloat16": 3e-2},
       "rwkv_scan": {"float32": 1e-5, "bfloat16": 5e-2}}
#: atol = rtol for the served model's final prefill hidden state, kernel
#: path against plain path, both run in fp32 arithmetic on the served
#: (bf16-stored) weights.  In bf16 the two paths round the scans' outputs
#: differently and 26-32 random layers spread the flips (printed, not held
#: end to end; the served bf16 scan is held at TOL on the model's own inputs).
HIDDEN_TOL = 1e-3

MM_SHAPE = (4096, 3584, 18944)  # tokens (batch 2 x 2048), d_model, d_ff
FA_SHAPE = (2, 2048, 28, 4, 128)  # batch, seq, query heads, KV heads, head dim
LRU_SHAPE = (8, 2048, 2560)  # recurrentgemma-2b prefill: batch, prompt, RG-LRU width
RWKV_SHAPE = (8, 2048, 64, 64)  # rwkv6-7b prefill: batch, prompt, heads, head dim
SERVE = (("recurrentgemma_2b", "lru_scan", 18), ("rwkv6_7b", "rwkv_scan", 32))
SERVE_ARGS = ["--batch", "8", "--prompt-len", "2048", "--gen", "64", "--epsilon", "0.5"]


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _tensors(x) -> list:
    """The tensors of a kernel's result (one tensor, or the scans' pair)."""
    return list(x) if isinstance(x, (tuple, list)) else [x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "chip_smoke"),
                    help="directory for the tuning DBs this run writes")
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is missing: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: the port's kernels run only on the card", file=sys.stderr)
        return 1

    import dataclasses
    import gc

    import torch.nn.functional as F

    from repro_torch.kernels import _cuda, autotuned, ops, tune_call
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import linear_scan as ls
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels.autotuned import exec_cache, get_spec, roofline
    from repro_torch.launch import serve
    from repro_torch.models import ExecConfig
    from repro_torch.tuning import TuningDB
    from repro_torch.tuning import pretune

    # plain versions compute in full fp32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for name in ("tune.json", "pretune.json", "pretune.json.journal",
                 *(f"serve_{arch}.json" for arch, _, _ in SERVE)):
        (out / name).unlink(missing_ok=True)

    # ---------------------------------------------------------- 1. device
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(dev)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    print(f"[1] device: {kind} count={count} torch={torch.__version__} cuda={torch.version.cuda}")
    print(f"[1] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    built = _cuda.build()
    print(f"[1] build: {', '.join(f'{n} {s:.1f}s' for n, s in built.items()) or 'cached'} "
          f"(wall {time.perf_counter() - t0:.1f}s) into {_cuda.BUILD_DIR}")
    for n in _cuda.SOURCES:
        lines = {ln.split(":", 1)[-1].strip() for ln in _cuda.ptxas_report(n).splitlines()
                 if "registers" in ln or "spill" in ln}
        print(f"[1] ptxas {n} (every instantiation): {'; '.join(sorted(lines))}")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    M, K, N = MM_SHAPE
    a = randn((M, K), torch.bfloat16)
    b = randn((K, N), torch.bfloat16, 1.0 / math.sqrt(K))  # weights ~ N(0, 1/d_model)
    B, S, H, Kh, hd = FA_SHAPE
    q = randn((B, S, H, hd), torch.bfloat16)
    k = randn((B, Kh, S, hd), torch.bfloat16)
    v = randn((B, Kh, S, hd), torch.bfloat16)
    # the scans at the serving prefill's shapes: RG-LRU decays in (0, 1)
    lru_a = torch.sigmoid(randn(LRU_SHAPE, torch.float32))
    lru_b = randn(LRU_SHAPE, torch.float32)
    lru_h0 = randn(LRU_SHAPE[::2], torch.float32)
    rB, rT, rH, rhd = RWKV_SHAPE
    rr, rk, rv = (randn(RWKV_SHAPE, torch.bfloat16) for _ in range(3))
    rlw = -torch.exp(randn(RWKV_SHAPE, torch.float32))  # log decay <= 0
    ru = randn((rH, rhd), torch.float32, 0.5)
    rs0 = randn((rB, rH, rhd, rhd), torch.float32)
    call_args = {"matmul": ((a, b), {}), "flash_attention": ((q, k, v), {"causal": True}),
                 "lru_scan": ((lru_a, lru_b, lru_h0), {}),
                 "rwkv_scan": ((rr, rk, rv, rlw, ru, rs0), {})}
    defaults = {name: get_spec(name).defaults(*ca, **kw) for name, (ca, kw) in call_args.items()}
    names = list(call_args)

    # -------------------------------------------- 2. kernels vs plain versions
    max_err = {name: 0.0 for name in names}

    def compare(label, name, got, want, phase=2):
        ok, err, mag, worst = True, 0.0, 0.0, 0.0
        torch.cuda.synchronize()
        for g_, w_ in zip(_tensors(got), _tensors(want)):
            tol = TOL[name][str(g_.dtype).replace("torch.", "")]
            e = (g_.float() - w_.float()).abs().max().item()
            ok = ok and g_.shape == w_.shape and math.isfinite(e) and bool(
                torch.allclose(g_.float(), w_.float(), atol=tol, rtol=tol))
            err, mag = max(err, e), max(mag, w_.float().abs().max().item())
            if g_.shape == w_.shape:  # the largest |error| over its allclose limit
                worst = max(worst, ((g_.float() - w_.float()).abs()
                                    / (tol + tol * w_.float().abs())).max().item())
            if g_.shape == w_.shape and g_.numel() > 1_000_000:
                max_err[name] = max(max_err[name], e)
        tol = TOL[name][str(_tensors(got)[0].dtype).replace("torch.", "")]
        print(f"[{phase}] {label}: max_abs_err={err:.3e} max|plain|={mag:.4g} "
              f"worst err/limit={worst:.3f} allclose(atol={tol:g}, rtol={tol:g}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{label}: kernel disagrees with its plain version")

    for knobs in (defaults["matmul"], {"bm": 64, "bn": 128, "bk": 64}):
        got = ops.matmul(a, b, **knobs)
        compare(f"matmul bf16 {M}x{K}x{N} {knobs}", "matmul", got, mm.matmul_plain(a, b, **knobs))
    a32 = randn((256, 192), torch.float32)
    b32 = randn((192, 128), torch.float32, 1.0 / math.sqrt(192))
    knobs = {"bm": 64, "bn": 32, "bk": 32}
    compare(f"matmul fp32 256x192x128 {knobs}", "matmul", ops.matmul(a32, b32, **knobs),
            mm.matmul_plain(a32, b32, **knobs))

    for knobs in (defaults["flash_attention"], {"block_q": 64, "block_kv": 64}):
        got = ops.flash_attention(q, k, v, causal=True, **knobs)
        want = fa.flash_attention_plain(q.transpose(1, 2), k, v, causal=True, **knobs).transpose(1, 2)
        compare(f"flash_attention bf16 q{tuple(q.shape)} kv{tuple(k.shape)} causal {knobs}",
                "flash_attention", got, want)
    for causal in (True, False):
        q32 = randn((1, 64, 8, 32), torch.float32)
        k32 = randn((1, 2, 64, 32), torch.float32)
        v32 = randn((1, 2, 64, 32), torch.float32)
        knobs = {"block_q": 16, "block_kv": 32}
        got = ops.flash_attention(q32, k32, v32, causal=causal, **knobs)
        want = fa.flash_attention_plain(q32.transpose(1, 2), k32, v32, causal=causal,
                                        **knobs).transpose(1, 2)
        compare(f"flash_attention fp32 q(1, 64, 8, 32) kv(1, 2, 64, 32) causal={causal} {knobs}",
                "flash_attention", got, want)

    lru_args = call_args["lru_scan"][0]
    for knobs in (defaults["lru_scan"], {"chunk": 4}, {"chunk": 32, "block_d": 64}):
        compare(f"lru_scan fp32 a,b{LRU_SHAPE} {knobs}", "lru_scan", ops.lru_scan(*lru_args, **knobs),
                ls.lru_scan_plain(*lru_args, **knobs))
    rwkv_args = call_args["rwkv_scan"][0]
    for knobs in (defaults["rwkv_scan"], {"chunk": 4}):
        compare(f"rwkv_scan bf16 r,k,v{RWKV_SHAPE} lw,u,s0 fp32 {knobs}", "rwkv_scan",
                ops.rwkv_scan(*rwkv_args, **knobs), ls.rwkv_scan_plain(*rwkv_args, **knobs))
    small_lru = (torch.sigmoid(randn((2, 64, 96), torch.float32)), randn((2, 64, 96), torch.float32),
                 randn((2, 96), torch.float32))
    knobs = {"chunk": 16, "block_d": 32}
    compare(f"lru_scan fp32 a,b(2, 64, 96) {knobs}", "lru_scan", ops.lru_scan(*small_lru, **knobs),
            ls.lru_scan_plain(*small_lru, **knobs))
    for hd_, strong in ((8, False), (32, False), (64, True)):
        shape = (2, 64, 2, hd_)
        small = [randn(shape, torch.float32) for _ in range(3)]
        small.append(torch.full(shape, -14.0, device=dev) if strong
                     else -torch.exp(randn(shape, torch.float32)))
        small += [randn((2, hd_), torch.float32, 0.5), randn((2, 2, hd_, hd_), torch.float32)]
        got = ops.rwkv_scan(*small, chunk=16)
        check(bool(torch.isfinite(got[0]).all()), f"rwkv_scan hd {hd_}: non-finite output")
        compare(f"rwkv_scan fp32 r,k,v{shape}{' lw=-14' if strong else ''} chunk=16", "rwkv_scan",
                got, ls.rwkv_scan_plain(*small, chunk=16))

    def counts():
        return {"matmul": mm.launches, "flash_attention": fa.launches, **ls.launches}

    def reset_counts():
        mm.launches = 0
        fa.launches = 0
        for n in ls.launches:
            ls.launches[n] = 0

    check(all(n > 0 for n in counts().values()), f"phase 2 did not launch every kernel: {counts()}")
    print(f"[2] launches: {counts()}")

    # ---------------------------------------- main path 1: tuning loop, 3-5
    reset_counts()
    phase_launches = {}

    # 3. the tuning loop
    tune_db = TuningDB(str(out / "tune.json"))
    records = {}
    for name, (ca, kw) in call_args.items():
        stats: dict = {}
        t0 = time.perf_counter()
        rec = tune_call(name, *ca, db=tune_db, measure_stats=stats, **kw)
        dt = time.perf_counter() - t0
        check(rec is not None, f"tune_call({name}) committed no record")
        print(f"[3] tune_call {name}: point={rec.point} cost={rec.cost * 1e3:.4f}ms "
              f"cost_std={(rec.cost_std or 0.0) * 1e3:.4f}ms repeats_spent={rec.repeats_spent} "
              f"evals={rec.evals} crashed={rec.crashed} reps={stats.get('reps')} "
              f"calibration_reps={stats.get('calibration_reps')} culled={stats.get('culled')} "
              f"pruned={stats.get('pruned_roofline')} backend={rec.key.backend} "
              f"device_kind={rec.key.device_kind} ({dt:.1f}s)")
        check(rec.key.backend == "cuda", f"{name}: record backend {rec.key.backend!r} is not 'cuda'")
        check(rec.key.device_kind == kind, f"{name}: record device_kind {rec.key.device_kind!r}")
        check(math.isfinite(rec.cost), f"{name}: committed cost is not finite")
        records[name] = rec
    phase_launches["tune"] = counts()

    # 4. replay from the DB as written to disk; its output is held against
    # the kernel at the stored knobs after the main path's counts are read
    replay_db = TuningDB(str(out / "tune.json"), autosave=False)
    replayed = {}
    for name, (ca, kw) in call_args.items():
        before = counts()[name]
        got = autotuned(name, *ca, db=replay_db, **kw)
        torch.cuda.synchronize()
        spent = counts()[name] - before
        print(f"[4] autotuned {name}: launches={spent} point={records[name].point} "
              f"shape={[tuple(t.shape) for t in _tensors(got)]}")
        check(spent == 1, f"autotuned({name}) launched {spent} kernels, expected exactly 1")
        replayed[name] = got
    phase_launches["replay"] = {n: c - phase_launches["tune"][n] for n, c in counts().items()}

    # 5. the pretune CLI, twice, in-process
    before = counts()
    for run in (1, 2):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = pretune.main(["--smoke", "--db", str(out / "pretune.json")])
        for line in buf.getvalue().splitlines():
            print(f"[5] run {run}: {line}")
        check(rc == 0, f"pretune run {run} exited {rc}")
        m = re.search(r"(\d+) contexts tuned \((\d+) exact hits, (\d+) searched\)", buf.getvalue())
        check(m is not None, f"pretune run {run}: no summary line")
        if run == 2:
            check(int(m.group(3)) == 0 and int(m.group(2)) == int(m.group(1)) > 0,
                  "pretune run 2 searched again instead of making only exact hits")
    phase_launches["pretune"] = {n: c - before[n] for n, c in counts().items()}
    tuning_launches = counts()
    print(f"[5] tuning-loop launches: {tuning_launches} by phase: {phase_launches}")
    for name, n in tuning_launches.items():
        check(n > 0, f"the tuning loop never launched the {name} kernel")

    for name, got in replayed.items():
        ca, kw = call_args[name]
        want = get_spec(name).fn(*ca, **kw, **records[name].point)
        equal = all(torch.equal(g_, w_) for g_, w_ in zip(_tensors(got), _tensors(want)))
        finite = all(bool(torch.isfinite(g_.float()).all()) for g_ in _tensors(got))
        print(f"[4] autotuned {name}: bit_equal={equal} finite={finite} "
              "(against the kernel at the stored knobs)")
        check(equal and finite, f"autotuned({name}) output differs from the kernel at the stored knobs")
    del replayed

    # -------------------------------------------------------------- 6. times
    def cuda_ms(fn, reps: int) -> float:
        fn()  # warm-up
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    k_exp = k.repeat_interleave(H // Kh, dim=1)  # GQA expanded for the library call
    v_exp = v.repeat_interleave(H // Kh, dim=1)
    q_bhsd = q.transpose(1, 2)
    timing = {
        "matmul": dict(
            default=lambda: ops.matmul(a, b, **defaults["matmul"]),
            tuned=lambda: ops.matmul(a, b, **records["matmul"].point),
            plain=lambda: mm.matmul_plain(a, b, **records["matmul"].point),
            library=lambda: torch.matmul(a, b),
        ),
        "flash_attention": dict(
            default=lambda: ops.flash_attention(q, k, v, causal=True, **defaults["flash_attention"]),
            tuned=lambda: ops.flash_attention(q, k, v, causal=True, **records["flash_attention"].point),
            plain=lambda: fa.flash_attention_plain(q_bhsd, k, v, causal=True,
                                                   **records["flash_attention"].point),
            library=lambda: F.scaled_dot_product_attention(q_bhsd, k_exp, v_exp, is_causal=True),
        ),
        "lru_scan": dict(
            default=lambda: ops.lru_scan(*lru_args, **defaults["lru_scan"]),
            tuned=lambda: ops.lru_scan(*lru_args, **records["lru_scan"].point),
            main_path=lambda: ops.lru_scan(*lru_args, chunk=4),
            plain=lambda: ls.lru_scan_plain(*lru_args, **records["lru_scan"].point),
            library=None,  # no single PyTorch call computes the scan
        ),
        "rwkv_scan": dict(
            default=lambda: ops.rwkv_scan(*rwkv_args, **defaults["rwkv_scan"]),
            tuned=lambda: ops.rwkv_scan(*rwkv_args, **records["rwkv_scan"].point),
            main_path=lambda: ops.rwkv_scan(*rwkv_args, chunk=4),
            plain=lambda: ls.rwkv_scan_plain(*rwkv_args, **records["rwkv_scan"].point),
            library=None,
        ),
    }
    times = {}
    for name, t in timing.items():
        ca, kw = call_args[name]
        terms = roofline(name, *ca, **kw)
        row = {"default": cuda_ms(t["default"], 5), "tuned": cuda_ms(t["tuned"], 5),
               "plain": cuda_ms(t["plain"], 1 if name in ("lru_scan", "rwkv_scan") else 3),
               "library": cuda_ms(t["library"], 20) if t["library"] is not None else None,
               "main_path": cuda_ms(t["main_path"], 5) if "main_path" in t else None,
               "terms": terms}
        times[name] = row
        bound_ms = terms.bound_s * 1e3
        lib = f"{row['library']:.4f} ms" if row["library"] is not None else "none"
        mp = f", serving chunk=4 {row['main_path']:.4f} ms" if row["main_path"] is not None else ""
        print(f"[6] {name}: default {row['default']:.4f} ms {defaults[name]}, tuned "
              f"{row['tuned']:.4f} ms {records[name].point}{mp}, plain {row['plain']:.4f} ms, "
              f"library {lib}, bound {bound_ms:.4f} ms by {terms.dominant} "
              f"({terms.flops / 1e9:.1f} GFLOP, {terms.bytes_accessed / 1e6:.1f} MB; "
              f"{bound_ms / row['tuned']:.4f} of the roofline tuned); launches by phase: "
              f"tune {phase_launches['tune'][name]}, replay {phase_launches['replay'][name]}, "
              f"pretune {phase_launches['pretune'][name]}")
    del a, b, q, k, v, k_exp, v_exp, q_bhsd, lru_a, lru_b, lru_h0, rr, rk, rv, rlw, ru, rs0
    del call_args, lru_args, rwkv_args, timing
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------ main path 2: serving, 7-8
    serve_launches = {}
    plain_scan = {"lru_scan": ls.lru_scan_plain, "rwkv_scan": ls.rwkv_scan_plain}
    for phase, (arch, scan, per_prefill) in enumerate(SERVE, start=7):
        db_path = str(out / f"serve_{arch}.json")
        runs = []
        for run in (1, 2):
            reset_counts()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = serve.serve(["--arch", arch, *SERVE_ARGS, "--db", db_path])
            launched = counts()
            for line in buf.getvalue().splitlines():
                print(f"[{phase}] {arch} run {run}: {line}")
            print(f"[{phase}] {arch} run {run}: prefill {res['prefill_ms']:.1f} ms, decode "
                  f"{res['decode_tok_s']:.1f} tok/s, k={res['k']}, db_hit={res['db_hit']}, "
                  f"launches {launched}")
            check(launched[scan] == per_prefill,
                  f"{arch} run {run}: {scan} launched {launched[scan]} times in one prefill, "
                  f"expected {per_prefill} (one per layer)")
            check(all(n == 0 for name, n in launched.items() if name != scan),
                  f"{arch} run {run}: unexpected launches {launched}")
            h = res["hidden"]
            check(h.shape == (8, res["model"].cfg.d_model) and bool(torch.isfinite(h.float()).all()),
                  f"{arch} run {run}: prefill hidden {tuple(h.shape)} not finite of width d_model")
            check(run == 1 or res["db_hit"], f"{arch} run 2 was not a tuning DB hit")
            for name, n in launched.items():
                serve_launches[name] = serve_launches.get(name, 0) + n
            runs.append({key: res[key] for key in ("prefill_ms", "decode_tok_s", "k", "db_hit")})
            if run == 1:
                h_first = h.clone()
                del res, h
                gc.collect()
                torch.cuda.empty_cache()
        check(torch.equal(h_first, h), f"{arch}: the two runs' prefills differ")

        # the served model, kernel path against plain path (launches made
        # here are checks, not the main path: the counts were read above)
        model, batch = res["model"], res["batch"]
        cfg = model.cfg
        by_dtype: dict = {}
        for prm in model.parameters():
            key = str(prm.dtype).replace("torch.", "")
            by_dtype[key] = by_dtype.get(key, 0) + prm.numel() * prm.element_size()
        print(f"[{phase}] {arch} weights: "
              f"{', '.join(f'{k_} {v_ / 1e9:.3f} GB' for k_, v_ in sorted(by_dtype.items()))}; "
              f"{sum(p_.numel() for p_ in model.parameters()) / 1e9:.3f} B parameters; "
              f"torch.cuda.memory_allocated {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB")
        model.exec_cfg = ExecConfig(attn_impl="xla", rec_chunk=4)
        h_bf16_plain, _ = model.prefill(batch)
        err_bf16 = (h.float() - h_bf16_plain.float()).abs()
        print(f"[{phase}] {arch} bf16 as served, kernel path vs plain path: max |dh| "
              f"{err_bf16.max().item():.4e}, mean {err_bf16.mean().item():.4e}, max |h| "
              f"{h_bf16_plain.float().abs().max().item():.4f} (rounding spread, not held)")
        # the served instantiation on served data: the last layer's scan
        # inputs from one more prefill on the kernel path, in the dtypes the
        # model passes them (rwkv: bf16 r, k, v), kernel against plain version
        served_call, real_scan = {}, getattr(ops, scan)

        def capture(*scan_args, **scan_kw):
            served_call["args"] = [t_.detach().clone() for t_ in scan_args]
            served_call["kw"] = dict(scan_kw, interpret=False)
            return real_scan(*scan_args, **scan_kw)

        model.exec_cfg = ExecConfig(attn_impl="cuda", rec_chunk=4)
        setattr(ops, scan, capture)
        try:
            model.prefill(batch)
        finally:
            setattr(ops, scan, real_scan)
        s_args, s_kw = served_call["args"], served_call["kw"]
        plain_kw = {k_: v_ for k_, v_ in s_kw.items() if k_ != "interpret"}
        compare(f"{scan} on the last layer's served inputs "
                f"({', '.join(f'{tuple(t_.shape)} {str(t_.dtype)[6:]}' for t_ in s_args)}) {plain_kw}",
                scan, real_scan(*s_args, **s_kw), plain_scan[scan](*s_args, **plain_kw), phase=phase)
        del res, h, h_first, h_bf16_plain, err_bf16, served_call, s_args
        gc.collect()
        torch.cuda.empty_cache()
        model.cfg = dataclasses.replace(cfg, compute_dtype="float32")
        hidden32 = {}
        for impl in ("cuda", "xla"):
            model.exec_cfg = ExecConfig(attn_impl=impl, rec_chunk=4)
            hidden32[impl], _ = model.prefill(batch)
            gc.collect()
            torch.cuda.empty_cache()
        hk, hp = hidden32["cuda"], hidden32["xla"]
        err = (hk - hp).abs().max().item()
        ok = hk.dtype == torch.float32 and bool(torch.allclose(hk, hp, atol=HIDDEN_TOL, rtol=HIDDEN_TOL))
        print(f"[{phase}] {arch} fp32 arithmetic on the served weights, kernel path vs plain "
              f"path: max |dh| {err:.4e}, max |h| {hp.abs().max().item():.4f}, "
              f"allclose(atol={HIDDEN_TOL:g}, rtol={HIDDEN_TOL:g}) {'ok' if ok else 'FAIL'}")
        check(ok and math.isfinite(err), f"{arch}: kernel path disagrees with the plain path")
        print(f"[{phase}] {arch} summary: prefill ms {[round(r['prefill_ms'], 1) for r in runs]}, "
              f"decode tok/s {[round(r['decode_tok_s'], 1) for r in runs]} "
              f"(batch 8, prompt 2048, 64 new tokens; {smi})")
        del model, batch, hidden32, hk, hp
        gc.collect()
        torch.cuda.empty_cache()  # free the first model before the second loads

    main_launches = {n: tuning_launches[n] + serve_launches.get(n, 0) for n in names}
    print(f"[8] serving launches: {serve_launches}; all main paths: {main_launches}")
    for name, n in main_launches.items():
        check(n > 0, f"no main path launched the {name} kernel")

    sources = {"matmul": ("src/repro_torch/kernels/csrc/matmul.cu", "src/repro/kernels/matmul.py:40"),
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:79"),
               "lru_scan": ("src/repro_torch/kernels/csrc/linear_scan.cu",
                            "src/repro/kernels/linear_scan.py:147"),
               "rwkv_scan": ("src/repro_torch/kernels/csrc/linear_scan.cu",
                             "src/repro/kernels/linear_scan.py:77")}
    kernels = []
    for name in names:
        row = times[name]
        terms = row["terms"]
        entry = {
            "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
            "launches": main_launches[name], "max_abs_err": max_err[name],
            "ms": row["tuned"], "ms_default": row["default"], "plain_ms": row["plain"],
            "bound_ms": terms.bound_s * 1e3, "bound_by": terms.dominant,
            "library_ms": row["library"],
        }
        if row["main_path"] is not None:
            entry["ms_serving_chunk4"] = row["main_path"]
        kernels.append(entry)
    print(f"[8] total {time.perf_counter() - t_start:.1f}s; DBs in {out}; "
          f"exec cache {exec_cache().stats()}")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
