#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card, end to end.

    python3 chip_smoke.py [--out DIR]

Phases, each printing its numbers on lines of its own:

1. device: the card's name and count, and ``nvidia-smi``'s name and power
   limit; then the CUDA kernels are built from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, started together) and ptxas' register report shown;
2. kernels against their plain PyTorch versions at the qwen2-7b shapes
   (FFN up-projection (4096, 3584) @ (3584, 18944) and causal prefill
   attention q (2, 2048, 28, 128), k/v (2, 4, 2048, 128), both bf16) at
   default and non-default knobs, plus a small fp32 case each;
3. the PATSMA tuning loop: ``tune_call`` on both calls with the default CSA
   budget, committing records to ``DIR/tune.json``;
4. replay: ``autotuned`` on the same DB is an exact hit (one launch, output
   bit-equal to the kernel at the stored knobs, which is launched for the
   comparison only after the main path's counts are read);
5. the pretune CLI (``--smoke``) twice in-process; the second run makes only
   exact hits;
6. times with CUDA events: each kernel at default and tuned knobs, its plain
   version, one library call for the same function (a yardstick the port
   never calls), and the analytic roofline bound.

Phases 3-5 are the main path: the kernels' launch counters are set to 0
just before it and read just after, and every kernel must have launched.
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
       "flash_attention": {"float32": 1e-5, "bfloat16": 5e-3}}

MM_SHAPE = (4096, 3584, 18944)  # tokens (batch 2 x 2048), d_model, d_ff
FA_SHAPE = (2, 2048, 28, 4, 128)  # batch, seq, query heads, KV heads, head dim


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

    import torch.nn.functional as F

    from repro_torch.kernels import _cuda, autotuned, ops, tune_call
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels.autotuned import exec_cache, get_spec, roofline
    from repro_torch.tuning import TuningDB
    from repro_torch.tuning import pretune

    # plain versions compute in full fp32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for name in ("tune.json", "pretune.json", "pretune.json.journal"):
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
    mm_args, fa_args = (a, b), (q, k, v)
    mm_defaults = get_spec("matmul").defaults(*mm_args)
    fa_defaults = get_spec("flash_attention").defaults(*fa_args)

    # -------------------------------------------- 2. kernels vs plain versions
    max_err = {"matmul": 0.0, "flash_attention": 0.0}

    def compare(label, name, got, want):
        dt = str(got.dtype).replace("torch.", "")
        tol = TOL[name][dt]
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
        print(f"[2] {label}: max_abs_err={err:.3e} allclose(atol={tol:g}, rtol={tol:g}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok and math.isfinite(err), f"{label}: kernel disagrees with its plain version")
        if got.shape == want.shape and got.numel() > 1_000_000:
            max_err[name] = max(max_err[name], err)

    for knobs in (mm_defaults, {"bm": 64, "bn": 128, "bk": 64}):
        got = ops.matmul(a, b, **knobs)
        compare(f"matmul bf16 {M}x{K}x{N} {knobs}", "matmul", got, mm.matmul_plain(a, b, **knobs))
    a32 = randn((256, 192), torch.float32)
    b32 = randn((192, 128), torch.float32, 1.0 / math.sqrt(192))
    knobs = {"bm": 64, "bn": 32, "bk": 32}
    compare(f"matmul fp32 256x192x128 {knobs}", "matmul", ops.matmul(a32, b32, **knobs),
            mm.matmul_plain(a32, b32, **knobs))

    for knobs in (fa_defaults, {"block_q": 64, "block_kv": 64}):
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
    check(mm.launches > 0 and fa.launches > 0, "phase 2 launched no kernel")
    print(f"[2] launches: matmul={mm.launches} flash_attention={fa.launches}")

    # ------------------------------------------------- main path: phases 3-5
    mm.launches = 0
    fa.launches = 0
    phase_launches = {}

    def counts():
        return {"matmul": mm.launches, "flash_attention": fa.launches}

    # 3. the tuning loop
    tune_db = TuningDB(str(out / "tune.json"))
    records = {}
    for name, call_args, kw in (("matmul", mm_args, {}),
                                ("flash_attention", fa_args, {"causal": True})):
        stats: dict = {}
        t0 = time.perf_counter()
        rec = tune_call(name, *call_args, db=tune_db, measure_stats=stats, **kw)
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
    for name, call_args, kw, lib in (("matmul", mm_args, {}, mm),
                                     ("flash_attention", fa_args, {"causal": True}, fa)):
        before = lib.launches
        got = autotuned(name, *call_args, db=replay_db, **kw)
        torch.cuda.synchronize()
        spent = lib.launches - before
        print(f"[4] autotuned {name}: launches={spent} point={records[name].point} "
              f"shape={tuple(got.shape)}")
        check(spent == 1, f"autotuned({name}) launched {spent} kernels, expected exactly 1")
        replayed[name] = (got, call_args, kw)
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
    main_launches = counts()
    print(f"[5] main path launches: {main_launches} by phase: {phase_launches}")
    for name, n in main_launches.items():
        check(n > 0, f"the main path never launched the {name} kernel")

    for name, (got, call_args, kw) in replayed.items():
        want = get_spec(name).fn(*call_args, **kw, **records[name].point)
        equal = bool(torch.equal(got, want))
        finite = bool(torch.isfinite(got.float()).all())
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
            default=lambda: ops.matmul(a, b, **mm_defaults),
            tuned=lambda: ops.matmul(a, b, **records["matmul"].point),
            plain=lambda: mm.matmul_plain(a, b, **records["matmul"].point),
            library=lambda: torch.matmul(a, b),
            terms=roofline("matmul", a, b),
        ),
        "flash_attention": dict(
            default=lambda: ops.flash_attention(q, k, v, causal=True, **fa_defaults),
            tuned=lambda: ops.flash_attention(q, k, v, causal=True, **records["flash_attention"].point),
            plain=lambda: fa.flash_attention_plain(q_bhsd, k, v, causal=True,
                                                   **records["flash_attention"].point),
            library=lambda: F.scaled_dot_product_attention(q_bhsd, k_exp, v_exp, is_causal=True),
            terms=roofline("flash_attention", q, k, v, causal=True),
        ),
    }
    sources = {"matmul": ("src/repro_torch/kernels/csrc/matmul.cu", "src/repro/kernels/matmul.py:40"),
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:79")}
    kernels = []
    for name, t in timing.items():
        ms_default = cuda_ms(t["default"], 5)
        ms_tuned = cuda_ms(t["tuned"], 5)
        ms_plain = cuda_ms(t["plain"], 3)
        ms_library = cuda_ms(t["library"], 20)
        terms = t["terms"]
        bound_ms = terms.bound_s * 1e3
        print(f"[6] {name}: default {ms_default:.4f} ms, tuned {ms_tuned:.4f} ms "
              f"{records[name].point}, plain {ms_plain:.4f} ms, library {ms_library:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {terms.dominant} "
              f"({terms.flops / 1e9:.1f} GFLOP, {terms.bytes_accessed / 1e6:.1f} MB; "
              f"{bound_ms / ms_tuned:.4f} of the roofline tuned); launches by phase: "
              f"tune {phase_launches['tune'][name]}, replay {phase_launches['replay'][name]}, "
              f"pretune {phase_launches['pretune'][name]}")
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
            "launches": main_launches[name], "max_abs_err": max_err[name],
            "ms": ms_tuned, "ms_default": ms_default, "plain_ms": ms_plain,
            "bound_ms": bound_ms, "bound_by": terms.dominant,
            "library_ms": ms_library,
        })
    print(f"[6] total {time.perf_counter() - t_start:.1f}s; tuning DBs in {out}; "
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
