#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card, end to end.

    python3 chip_smoke.py [--out DIR]

Phases, each printing its numbers on lines of its own:

1. device: the card's name and count, and ``nvidia-smi``'s name and power
   limit; then the CUDA kernels are built from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, started together, the tensor-core sources on the
   shared ``hopper.cuh``) and ptxas' register, spill and performance-warning
   report shown;
2. kernels against their plain PyTorch versions at the qwen2-7b shapes
   (FFN up-projection (4096, 3584) @ (3584, 18944), causal prefill
   attention q (2, 2048, 28, 128), k/v (2, 4, 2048, 128), and decode
   attention q (8, 28, 128) against a KV cache (8, 4, 32768, 128) with a
   random valid prefix per row, all bf16), at recurrentgemma-2b's served MQA
   decode (q (8, 10, 256), k/v (8, 1, 2048, 256) bf16, valid from the ring
   buffer's positions after 2048 + 64 tokens) and at the serving prefill's
   scan shapes (RG-LRU a, b (8, 2048, 2560) fp32 of recurrentgemma-2b;
   RWKV-6 r, k, v (8, 2048, 64, 64) bf16 with fp32 lw, u, s0 of rwkv6-7b),
   at default and non-default knobs, plus a small fp32 case each, the RWKV
   strong-decay case (lw = -14, fp32 and bf16) and a decode row with no
   valid slot; the matmul and flash attention at their default tile and one
   more tile of the tensor-core (``wgmma``) design and at one tile of the
   SIMT design, each line naming the design that ran; decode with its split
   count and grid, held against the plain version at that split count; the
   RWKV scan naming its design (the bf16 serving shape must run the
   sub-chunked tensor-core design ``tc``, fp32 the ``per_token`` one), and
   the per-token design once through its C entry point; the segmented lru
   scan with its segment count, against the exact scan and against its own
   segmented arithmetic (``lru_scan_segmented_plain``);
3. the PATSMA tuning loop: ``tune_call`` on the five calls with the default
   CSA budget, committing records to ``DIR/tune.json``, and once more on
   the decode call with ``strategy="csa+nm"`` into ``DIR/tune_csa_nm.json``;
4. replay: ``autotuned`` on the same DB is an exact hit (one launch, output
   bit-equal to the kernel at the stored knobs, which is launched for the
   comparison only after the main path's counts are read);
5. the pretune CLI (``--smoke``) twice in-process; the second run makes only
   exact hits; then once with ``--strategy csa+nm --cost analytic
   --obs-dir``, and the host-side ``python -m repro_torch.tune`` commands
   (``db list``, ``db diff``, ``report`` on that run) in subprocesses;
6. the adaptive route: a fresh ``kernel_router`` on a fresh DB serves ~200
   ``routed("decode_attention", ...)`` calls at the qwen2-7b decode shape
   with epsilon 0.1 and a short stream of each other kernel; every output
   is held (after the counts are read) against the kernel at the knobs its
   call was served with, and a second router on the same DB must exact-hit
   the committed decode record and explore nothing;
7. times with CUDA events: each kernel at default and tuned knobs (the
   scans also at the serving path's ``chunk=4``), its plain version, one
   library call for the same function where one exists (a yardstick the
   port never calls; no single PyTorch call computes either scan), and the
   analytic roofline bound; the default and tuned matmul and flash calls
   must run the ``wgmma`` design; decode's split count, grid, share of the
   bytes bound and ratio to SDPA at default and tuned knobs; the RWKV
   tensor-core design at ``chunk=4`` and the tuned chunk beside the
   per-token design on the same inputs, with its share of the bytes bound;
   the lru scan at default, tuned and ``chunk=4`` with its segment count
   and share of the bytes bound;
8. serving recurrentgemma-2b at full width and depth through
   ``repro_torch.launch.serve`` (batch 8, prompt 2048, 64 new tokens, random
   weights from seed 0) twice on one DB: the first run tunes the decode
   depth online and commits it, the second must be a DB hit.  Every prefill
   must launch ``lru_scan`` 18 times (one per RG-LRU layer).  Then the
   served model's final prefill hidden state on the kernel path is held
   against the plain path (``attn_impl="xla"``) in fp32 arithmetic, and the
   scan kernel against its plain version on the last layer's scan inputs
   as served (bf16 r, k, v for rwkv).  Decode runs as CUDA graphs of the
   tuned depth, every capture on the router's pool (none in-band).  Then
   the decode profile: one eager step's wall time, device-busy time and
   kernel launches (``torch.profiler``), the same for a replay of the
   8-step graph, and the first 16 greedy tokens of the eager loop against
   the 1-step and the 8-step graphs (equal tokens; logits within
   ``LOGITS_TOL``);
9. the same for rwkv6-7b at full width and depth (32 ``rwkv_scan`` launches
   per prefill, every one of the tensor-core design).

Phases 3-5 (the tuning loop), phase 6 (the route) and phases 8-9 (serving)
are the main paths:
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
import os
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
       # decode: fp32 m/l/acc and p in both, summed in another order; bf16
       # outputs reach |o| ~ 3 on short valid prefixes, where one bf16
       # rounding step is 1.6e-2 = atol + rtol * |o| at 5e-3
       "decode_attention": {"float32": 1e-5, "bfloat16": 5e-3},
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
#: decode as a CUDA graph against the eager loop: the same kernels on the same
#: inputs, so the tokens must be equal and the bf16 logits agree to within the
#: JAX tests' bf16 limit, 3e-2 of the largest |logit|
LOGITS_TOL = 3e-2
DECODE_TOKENS = 16

MM_SHAPE = (4096, 3584, 18944)  # tokens (batch 2 x 2048), d_model, d_ff
FA_SHAPE = (2, 2048, 28, 4, 128)  # batch, seq, query heads, KV heads, head dim
DA_SHAPE = (8, 28, 4, 32768, 128)  # qwen2-7b decode: batch, heads, KV heads, cache, head dim
RG_DA_SHAPE = (8, 10, 1, 2048, 256)  # recurrentgemma-2b MQA decode over its 2048-slot ring
RING_TOKENS = 2048 + 64  # prompt + generated tokens before the ring's decode step
ROUTE_CALLS = {"decode_attention": 200, "matmul": 20, "flash_attention": 20, "lru_scan": 20,
               "rwkv_scan": 20}
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

    from repro_torch.kernels import _cuda, autotuned, kernel_router, ops, routed, tune_call
    from repro_torch.kernels import decode_attention as da
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
    for name in ("tune.json", "tune_csa_nm.json", "pretune.json", "pretune.json.journal",
                 "pretune_analytic.json", "pretune_analytic.json.journal", "route.json",
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
        report = _cuda.ptxas_report(n).splitlines()
        warned = [re.search(r"\((C\d+)\)", ln) for ln in report]
        lines = {ln.split(":", 1)[-1].strip() for ln, w in zip(report, warned)
                 if w is None and ("registers" in ln or "spill" in ln)}
        codes = sorted({w.group(1) for w in warned if w is not None})
        counts = ", ".join(f"{c} x{sum(1 for w in warned if w is not None and w.group(1) == c)}" for c in codes)
        print(f"[1] ptxas {n} (every instantiation): {'; '.join(sorted(lines))}"
              f"{'; performance warnings ' + counts if codes else ''}")

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
    dB, dH, dKh, dS, dhd = DA_SHAPE
    dq = randn((dB, dH, dhd), torch.bfloat16)
    dk = randn((dB, dKh, dS, dhd), torch.bfloat16)
    dv = randn((dB, dKh, dS, dhd), torch.bfloat16)
    lens = torch.randint(1, dS + 1, (dB,), generator=gen, device=dev)  # a valid prefix per row
    dvalid = (torch.arange(dS, device=dev)[None] < lens[:, None]).to(torch.int32)
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
                 "decode_attention": ((dq, dk, dv, dvalid), {}),
                 "lru_scan": ((lru_a, lru_b, lru_h0), {}),
                 "rwkv_scan": ((rr, rk, rv, rlw, ru, rs0), {})}
    defaults = {name: get_spec(name).defaults(*ca, **kw) for name, (ca, kw) in call_args.items()}
    names = list(call_args)

    # -------------------------------------------- 2. kernels vs plain versions
    max_err = {name: 0.0 for name in names}

    def compare(label, name, got, want, phase=2, full=None):
        """Hold got against want; ``full`` (default: more than a million
        elements) marks a main-path shape, whose error the JSON line reports."""
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
            if g_.shape == w_.shape and (g_.numel() > 1_000_000 if full is None else full):
                max_err[name] = max(max_err[name], e)
        tol = TOL[name][str(_tensors(got)[0].dtype).replace("torch.", "")]
        print(f"[{phase}] {label}: max_abs_err={err:.3e} max|plain|={mag:.4g} "
              f"worst err/limit={worst:.3f} allclose(atol={tol:g}, rtol={tol:g}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{label}: kernel disagrees with its plain version")

    def ran(module, call):
        """Run ``call`` once; the design whose launch count it raised."""
        before = dict(module.launches_by_design)
        got = call()
        torch.cuda.synchronize()
        grew = [d for d, n in module.launches_by_design.items() if n > before[d]]
        return got, grew[0] if len(grew) == 1 else f"unclear {grew}"

    for knobs, want in ((defaults["matmul"], "wgmma"), ({"bm": 64, "bn": 128, "bk": 64}, "wgmma"),
                        ({"bm": 32, "bn": 128, "bk": 32}, "simt")):
        got, design = ran(mm, lambda: ops.matmul(a, b, **knobs))
        compare(f"matmul bf16 {M}x{K}x{N} {knobs} ({design})", "matmul", got,
                mm.matmul_plain(a, b, **knobs))
        check(design == want, f"matmul {knobs} ran the {design} design, expected {want}")
    a32 = randn((256, 192), torch.float32)
    b32 = randn((192, 128), torch.float32, 1.0 / math.sqrt(192))
    knobs = {"bm": 64, "bn": 32, "bk": 32}
    compare(f"matmul fp32 256x192x128 {knobs}", "matmul", ops.matmul(a32, b32, **knobs),
            mm.matmul_plain(a32, b32, **knobs))

    for knobs, want_design in ((defaults["flash_attention"], "wgmma"), ({"block_q": 64, "block_kv": 64}, "wgmma"),
                               ({"block_q": 32, "block_kv": 64}, "simt")):
        got, design = ran(fa, lambda: ops.flash_attention(q, k, v, causal=True, **knobs))
        want = fa.flash_attention_plain(q.transpose(1, 2), k, v, causal=True, **knobs).transpose(1, 2)
        compare(f"flash_attention bf16 q{tuple(q.shape)} kv{tuple(k.shape)} causal {knobs} ({design})",
                "flash_attention", got, want)
        check(design == want_design, f"flash_attention {knobs} ran the {design} design, expected {want_design}")
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

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def split_of(args, knobs):
        """(splits, grid) the decode kernel runs ``args`` with at ``knobs``."""
        q_, k_ = args[0], args[1]
        g_ = q_.shape[1] // k_.shape[1]
        tile = da.legal_tile(g_, q_.shape[2], k_.shape[2], knobs["block_kv"], on_card=True)
        grid_ = da.grid(q_.shape[0], k_.shape[1], g_, k_.shape[2], tile, n_sm)
        return grid_[2], grid_

    da_args = call_args["decode_attention"][0]
    for knobs in (defaults["decode_attention"], {"block_kv": 128}):
        nsplit, grid_ = split_of(da_args, knobs)
        got, design = ran(da, lambda: ops.decode_attention(*da_args, **knobs))
        compare(f"decode_attention bf16 q{tuple(dq.shape)} kv{tuple(dk.shape)} valid prefixes "
                f"{lens.tolist()} {knobs} ({nsplit} splits, grid {grid_} = "
                f"{math.prod(grid_)} blocks on {n_sm} SMs, {design} loads)", "decode_attention", got,
                da.decode_attention_plain(*da_args, **knobs, splits=nsplit), full=True)
        check(design == "vec16", f"decode_attention {knobs} at the main shape ran {design} loads")
    # recurrentgemma-2b's served MQA decode: the ring buffer's slot s holds
    # the latest position p <= t with p = s (mod W); the model's mask keeps
    # p <= t and t - p < W (models/attention.py::_mask)
    gB, gH, gKh, gW, ghd = RG_DA_SHAPE
    t_pos = RING_TOKENS - 1
    slots = torch.arange(gW, device=dev)
    ring_pos = slots + ((t_pos - slots) // gW) * gW
    ring_valid = ((ring_pos >= 0) & (ring_pos <= t_pos) & (t_pos - ring_pos < gW)).to(torch.int32)
    rg_args = (randn((gB, gH, ghd), torch.bfloat16), randn((gB, gKh, gW, ghd), torch.bfloat16),
               randn((gB, gKh, gW, ghd), torch.bfloat16), ring_valid[None].expand(gB, gW).contiguous())
    for knobs in (get_spec("decode_attention").defaults(*rg_args), {"block_kv": 64}):
        nsplit, grid_ = split_of(rg_args, knobs)
        compare(f"decode_attention bf16 recurrentgemma-2b MQA q{tuple(rg_args[0].shape)} "
                f"kv{tuple(rg_args[1].shape)} ring after {RING_TOKENS} tokens "
                f"({int(ring_valid.sum())} of {gW} slots valid) {knobs} ({nsplit} splits, grid "
                f"{grid_})", "decode_attention", ops.decode_attention(*rg_args, **knobs),
                da.decode_attention_plain(*rg_args, **knobs, splits=nsplit), full=True)
    # fp32, and rows with no valid slot (mean of V) or a masked leading part
    small_da = [randn((2, 14, 64), torch.float32), randn((2, 2, 256, 64), torch.float32),
                randn((2, 2, 256, 64), torch.float32), torch.ones(2, 256, dtype=torch.int32, device=dev)]
    small_da[3][0] = 0
    small_da[3][1, :100] = 0
    got = ops.decode_attention(*small_da, block_kv=64)
    small_splits = split_of(small_da, {"block_kv": 64})[0]
    mean_v = small_da[2][0].mean(dim=1).repeat_interleave(7, dim=0)
    invalid_ok = bool(torch.isfinite(got).all()) and bool(
        torch.allclose(got[0], mean_v, atol=1e-5, rtol=1e-5))
    print(f"[2] decode_attention fp32 row with no valid slot: mean of V "
          f"max |o - mean(v)| {(got[0] - mean_v).abs().max().item():.3e} {'ok' if invalid_ok else 'FAIL'}")
    check(invalid_ok, "decode_attention: a row with no valid slot is not the mean of V")
    compare("decode_attention fp32 q(2, 14, 64) kv(2, 2, 256, 64) block_kv=64, rows all / first "
            "100 slots invalid", "decode_attention", got,
            da.decode_attention_plain(*small_da, block_kv=64, splits=small_splits), full=False)

    def lru_segments(args, knobs):
        """Segments the lru kernel runs ``args`` with at ``knobs``."""
        a_ = args[0]
        L, bd = ls.legal_lru(a_.shape[1], a_.shape[2], knobs["chunk"], knobs.get("block_d", ls.LRU_BLOCK_D),
                             on_card=True, itemsize=a_.element_size())
        return ls.lru_segments(*a_.shape, L, bd, a_.element_size(), n_sm)

    def lru_compare(label, args, knobs, got=None, phase=2):
        """The lru kernel against the exact scan and against its segmented
        arithmetic at the segment count it ran."""
        nseg = lru_segments(args, knobs)
        got = ops.lru_scan(*args, **knobs) if got is None else got
        compare(f"{label} (segmented, {nseg} segments) vs the exact scan", "lru_scan", got,
                ls.lru_scan_plain(*args, **knobs), phase=phase)
        compare(f"{label} (segmented, {nseg} segments) vs lru_scan_segmented_plain", "lru_scan", got,
                ls.lru_scan_segmented_plain(*args, segments=nseg), phase=phase)

    lru_args = call_args["lru_scan"][0]
    for knobs in (defaults["lru_scan"], {"chunk": 4}, {"chunk": 32, "block_d": 64}):
        lru_compare(f"lru_scan fp32 a,b{LRU_SHAPE} {knobs}", lru_args, knobs)
    rwkv_args = call_args["rwkv_scan"][0]
    for knobs in (defaults["rwkv_scan"], {"chunk": 4}, {"chunk": 16}):
        got, design = ran(ls, lambda: ops.rwkv_scan(*rwkv_args, **knobs))
        compare(f"rwkv_scan bf16 r,k,v{RWKV_SHAPE} lw,u,s0 fp32 {knobs} ({design})", "rwkv_scan",
                got, ls.rwkv_scan_plain(*rwkv_args, **knobs))
        check(design == "tc", f"rwkv_scan {knobs} at the serving shape ran {design}, not tc")
    got = ls._rwkv_launch(*rwkv_args, 4, "per_token")
    compare(f"rwkv_scan bf16 r,k,v{RWKV_SHAPE} chunk=4 through the per_token entry point", "rwkv_scan",
            got, ls.rwkv_scan_plain(*rwkv_args, chunk=4))
    small_lru = (torch.sigmoid(randn((2, 64, 96), torch.float32)), randn((2, 64, 96), torch.float32),
                 randn((2, 96), torch.float32))
    lru_compare("lru_scan fp32 a,b(2, 64, 96) {'chunk': 16, 'block_d': 32}", small_lru,
                {"chunk": 16, "block_d": 32})
    for hd_, strong in ((8, False), (32, False), (64, True)):
        shape = (2, 64, 2, hd_)
        small = [randn(shape, torch.float32) for _ in range(3)]
        small.append(torch.full(shape, -14.0, device=dev) if strong
                     else -torch.exp(randn(shape, torch.float32)))
        small += [randn((2, hd_), torch.float32, 0.5), randn((2, 2, hd_, hd_), torch.float32)]
        got, design = ran(ls, lambda: ops.rwkv_scan(*small, chunk=16))
        check(bool(torch.isfinite(got[0]).all()), f"rwkv_scan hd {hd_}: non-finite output")
        compare(f"rwkv_scan fp32 r,k,v{shape}{' lw=-14' if strong else ''} chunk=16 ({design})",
                "rwkv_scan", got, ls.rwkv_scan_plain(*small, chunk=16))
        check(design == "per_token", f"rwkv_scan fp32 ran {design}, not per_token")
    # bf16 at strong decay through the tensor-core design
    shape = (2, 64, 2, 64)
    strong = [randn(shape, torch.bfloat16) for _ in range(3)]
    strong += [torch.full(shape, -14.0, device=dev), randn((2, 64), torch.float32, 0.5),
               randn((2, 2, 64, 64), torch.float32)]
    got, design = ran(ls, lambda: ops.rwkv_scan(*strong, chunk=16))
    check(bool(torch.isfinite(got[0].float()).all()) and design == "tc",
          f"rwkv_scan bf16 lw=-14: design {design}, finite {bool(torch.isfinite(got[0].float()).all())}")
    compare(f"rwkv_scan bf16 r,k,v{shape} lw=-14 chunk=16 ({design})", "rwkv_scan", got,
            ls.rwkv_scan_plain(*strong, chunk=16))

    def counts():
        return {"matmul": mm.launches, "flash_attention": fa.launches,
                "decode_attention": da.launches, **ls.launches}

    def reset_counts():
        mm.launches = 0
        fa.launches = 0
        da.launches = 0
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
    # the same decode context searched by the paper's CSA -> NM pipeline
    stats = {}
    t0 = time.perf_counter()
    rec = tune_call("decode_attention", *call_args["decode_attention"][0],
                    db=TuningDB(str(out / "tune_csa_nm.json")), strategy="csa+nm", measure_stats=stats)
    check(rec is not None and rec.strategy == "csa+nm" and math.isfinite(rec.cost),
          "tune_call(decode_attention, strategy='csa+nm') committed no finite csa+nm record")
    print(f"[3] tune_call decode_attention strategy=csa+nm: point={rec.point} "
          f"cost={rec.cost * 1e3:.4f}ms evals={rec.evals} crashed={rec.crashed} "
          f"reps={stats.get('reps')} culled={stats.get('culled')} ({time.perf_counter() - t0:.1f}s)")
    records_csa_nm = rec
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
    buf = io.StringIO()
    analytic_db, obs_dir = out / "pretune_analytic.json", out / "obs"
    with contextlib.redirect_stdout(buf):
        rc = pretune.main(["--smoke", "--strategy", "csa+nm", "--cost", "analytic",
                           "--db", str(analytic_db), "--obs-dir", str(obs_dir)])
    for line in buf.getvalue().splitlines():
        print(f"[5] csa+nm analytic: {line}")
    check(rc == 0 and "5 contexts tuned" in buf.getvalue(), f"pretune --strategy csa+nm --cost "
          f"analytic exited {rc} or did not tune the 5 smoke contexts")
    check(buf.getvalue().count("strategy=csa+nm") == 5, "pretune --strategy csa+nm: records not csa+nm")
    phase_launches["pretune"] = {n: c - before[n] for n, c in counts().items()}
    tuning_launches = counts()

    # the host-side CLI on this run's files (no card needed)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for cmd in (["db", "list", "--db", str(out / "pretune.json")],
                ["db", "diff", str(out / "pretune.json"), str(out / "pretune.json")],
                ["report", str(obs_dir), "--db", str(analytic_db)]):
        proc = subprocess.run([sys.executable, "-m", "repro_torch.tune", *cmd], capture_output=True,
                              text=True, env=env, cwd=str(ROOT), timeout=300)
        for line in (proc.stdout + proc.stderr).splitlines():
            print(f"[5] tune {cmd[0]}{' ' + cmd[1] if cmd[0] == 'db' else ''}: {line}")
        check(proc.returncode == 0, f"python -m repro_torch.tune {' '.join(cmd)} exited {proc.returncode}")
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

    # ------------------------------------------- main path 2: the route, 6
    # every call's knobs are read off its decision; the first output at
    # each knob setting is kept and every later one must equal it (no
    # launch), and after the counts are read each kept output is held
    # against the kernel launched at those knobs
    reset_counts()
    route_db = out / "route.json"
    served: dict = {}
    repeat_equal = [True]

    def stream(router, name, calls):
        decisions = []
        begin = router.begin

        def noting(*b_args, **b_kw):
            d = begin(*b_args, **b_kw)
            decisions.append(dict(d.point))
            return d

        router.begin = noting
        ca, kw = call_args[name]
        t0 = time.perf_counter()
        try:
            for _ in range(calls):
                got = routed(name, *ca, router=router, **kw)
                key = (name, tuple(sorted(decisions[-1].items())))
                if key in served:
                    repeat_equal[0] &= all(torch.equal(g_, w_) for g_, w_ in
                                           zip(_tensors(got), _tensors(served[key])))
                else:
                    served[key] = got
        finally:
            router.begin = begin
        return time.perf_counter() - t0, decisions

    router = kernel_router(db=TuningDB(str(route_db)), epsilon=0.1, fresh=True)
    route_points = {}
    for name, calls in ROUTE_CALLS.items():
        dt, decisions = stream(router, name, calls)
        route_points[name] = decisions
        print(f"[6] routed {name}: {calls} calls in {dt:.2f}s, knobs served "
              f"{sorted({tuple(sorted(p.items())) for p in decisions})}")
    router.wait_pending()
    st = router.stats()
    print(f"[6] router: calls={st['calls']} explores={st['explores']} exploits={st['exploits']} "
          f"deferred_explores={st['deferred_explores']} candidate_failures={st['candidate_failures']} "
          f"searches_completed={st['searches_completed']} drift_resets={st['drift_resets']} "
          f"inband_builds={st['inband_builds']} contexts={st['contexts']}")
    check(st["calls"] == st["explores"] + st["exploits"] == sum(ROUTE_CALLS.values()),
          f"router accounting does not balance: {st}")
    check(st["inband_builds"] == 0, "a router build ran on the serving thread")
    route_recs = {r.key.name: r for r in TuningDB(str(route_db), autosave=False).records()}
    check("decode_attention" in route_recs, "the router committed no decode_attention record")
    drec = route_recs["decode_attention"]
    for n, r in sorted(route_recs.items()):
        print(f"[6] committed {n}: {r.point} cost={r.cost * 1e3:.4f}ms source={r.source} "
              f"evals={r.evals} backend={r.key.backend} device_kind={r.key.device_kind}")
    check(drec.key.backend == "cuda" and drec.key.device_kind == kind,
          f"route record keyed {drec.key.backend}/{drec.key.device_kind}, not this card")
    # a second router on the same DB: an exact hit from its first call
    router2 = kernel_router(db=TuningDB(str(route_db), autosave=False), epsilon=0.1, fresh=True)
    dt, decisions2 = stream(router2, "decode_attention", 20)
    st2 = router2.stats()
    ctx2 = router2.contexts()
    print(f"[6] second router: 20 calls in {dt:.2f}s, explores={st2['explores']} "
          f"exploits={st2['exploits']} finished={[c['finished'] for c in ctx2]} "
          f"knobs {sorted({tuple(sorted(p.items())) for p in decisions2})}")
    check(st2["explores"] == 0 and all(c["finished"] for c in ctx2)
          and all(p == drec.point for p in decisions2),
          "the second router did not exact-hit the committed decode record")
    route_launches = counts()
    phase_launches["route"] = route_launches
    print(f"[6] route launches: {route_launches}")
    check(route_launches["decode_attention"] == ROUTE_CALLS["decode_attention"] + 20,
          f"routed decode calls did not each launch the kernel once: {route_launches}")
    check(all(route_launches[n] == c for n, c in ROUTE_CALLS.items() if n != "decode_attention"),
          f"routed calls did not each launch their kernel once: {route_launches}")
    check(repeat_equal[0], "a routed output differs from an earlier one at the same knobs")
    for (name, knobs), got in served.items():
        ca, kw = call_args[name]
        want = get_spec(name).fn(*ca, **kw, **dict(knobs))
        equal = all(torch.equal(g_, w_) for g_, w_ in zip(_tensors(got), _tensors(want)))
        print(f"[6] routed {name} at {dict(knobs)}: bit_equal={equal} (against the kernel at those knobs)")
        check(equal, f"routed {name} output differs from the kernel at {dict(knobs)}")
    del served, router, router2

    # -------------------------------------------------------------- 7. times
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
    g_da = dH // dKh
    dk_exp, dv_exp = dk.repeat_interleave(g_da, dim=1), dv.repeat_interleave(g_da, dim=1)
    dmask = (dvalid > 0)[:, None, None, :]  # SDPA takes True = attend
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
        "decode_attention": dict(
            default=lambda: ops.decode_attention(*da_args, **defaults["decode_attention"]),
            tuned=lambda: ops.decode_attention(*da_args, **records["decode_attention"].point),
            plain=lambda: da.decode_attention_plain(*da_args, **records["decode_attention"].point),
            library=lambda: F.scaled_dot_product_attention(dq[:, :, None], dk_exp, dv_exp,
                                                           attn_mask=dmask),
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
    designs = {}
    for name, module in (("matmul", mm), ("flash_attention", fa)):
        for which in ("default", "tuned"):
            _, design = ran(module, timing[name][which])
            designs[(name, which)] = design
            print(f"[7] {name} {which} call ran the {design} design")
            check(design == "wgmma", f"the {which} {name} call at the main shape ran {design}, not wgmma")
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
        print(f"[7] {name}: default {row['default']:.4f} ms {defaults[name]}, tuned "
              f"{row['tuned']:.4f} ms {records[name].point}{mp}, plain {row['plain']:.4f} ms, "
              f"library {lib}, bound {bound_ms:.4f} ms by {terms.dominant} "
              f"({terms.flops / 1e9:.1f} GFLOP, {terms.bytes_accessed / 1e6:.1f} MB; "
              f"{bound_ms / row['tuned']:.4f} of the roofline tuned); launches by phase: "
              f"tune {phase_launches['tune'][name]}, replay {phase_launches['replay'][name]}, "
              f"pretune {phase_launches['pretune'][name]}, route {phase_launches['route'][name]}")
    # the two kernels redesigned for the card: split count and grid, share of
    # the bytes bound, decode against SDPA and the rwkv tensor-core design
    # against the per-token design on the same inputs (its C entry point)
    d_row = times["decode_attention"]
    d_bytes_ms = d_row["terms"].memory_s * 1e3
    for which in ("default", "tuned"):
        knobs = defaults["decode_attention"] if which == "default" else records["decode_attention"].point
        nsplit, grid_ = split_of(da_args, knobs)
        d_row[f"splits_{which}"], d_row[f"grid_{which}"] = nsplit, list(grid_)
        print(f"[7] decode_attention {which} {knobs}: {d_row[which]:.4f} ms, {nsplit} splits, grid "
              f"{grid_} = {math.prod(grid_)} blocks on {n_sm} SMs, {d_bytes_ms / d_row[which]:.4f} of "
              f"the bytes bound {d_bytes_ms:.4f} ms; SDPA {d_row['library']:.4f} ms: "
              f"{'faster' if d_row[which] < d_row['library'] else 'SLOWER'} than SDPA "
              f"({d_row['library'] / d_row[which]:.2f}x)")
    r_row, r_terms = times["rwkv_scan"], times["rwkv_scan"]["terms"]
    tc_tensor, tc_cuda = ls.rwkv_tc_flops(rB, rT, rH)
    r_row["tc_bound_ms"] = max(r_terms.memory_s, tc_tensor / 495e12, tc_cuda / 67e12) * 1e3
    r_row["bytes_bound_ms"] = r_terms.memory_s * 1e3
    r_row["per_token"] = {}
    for label, chunk in (("serving chunk=4", 4), (f"tuned chunk={records['rwkv_scan'].point['chunk']}",
                                                   records["rwkv_scan"].point["chunk"])):
        _, design = ran(ls, lambda: ops.rwkv_scan(*rwkv_args, chunk=chunk))
        tc_ms = cuda_ms(lambda: ops.rwkv_scan(*rwkv_args, chunk=chunk), 5)
        pt_ms = cuda_ms(lambda: ls._rwkv_launch(*rwkv_args, chunk, "per_token"), 5)
        tc_ms2 = cuda_ms(lambda: ops.rwkv_scan(*rwkv_args, chunk=chunk), 5)
        r_row["per_token"][chunk] = pt_ms
        print(f"[7] rwkv_scan {label}: {design} design {tc_ms:.4f} / {tc_ms2:.4f} ms, per_token "
              f"design {pt_ms:.4f} ms on the same inputs ({pt_ms / min(tc_ms, tc_ms2):.2f}x); "
              f"{r_row['bytes_bound_ms'] / min(tc_ms, tc_ms2):.4f} of the bytes bound "
              f"{r_row['bytes_bound_ms']:.4f} ms ({r_terms.bytes_accessed / 1e6:.1f} MB); tensor-core "
              f"design's bound {r_row['tc_bound_ms']:.4f} ms ({tc_tensor / 1e9:.1f} GFLOP TF32, "
              f"{tc_cuda / 1e9:.2f} GFLOP fp32); fp32 operations bound of the per-token design "
              f"{r_terms.compute_s * 1e3:.4f} ms")
        check(design == "tc", f"rwkv_scan {label} at the serving shape ran {design}, not tc")
    l_row = times["lru_scan"]
    l_bytes_ms = l_row["terms"].memory_s * 1e3
    l_row["segments"] = {}
    for which, knobs in (("default", defaults["lru_scan"]), ("tuned", records["lru_scan"].point),
                         ("main_path", {"chunk": 4})):
        nseg = lru_segments(lru_args, knobs)
        l_row["segments"][which] = nseg
        blocks = LRU_SHAPE[0] * (LRU_SHAPE[2] // knobs.get("block_d", ls.LRU_BLOCK_D)) * nseg
        print(f"[7] lru_scan {'serving' if which == 'main_path' else which} {knobs}: "
              f"{l_row[which]:.4f} ms, segmented: {nseg} segments of {LRU_SHAPE[1] // nseg} steps, "
              f"{blocks} blocks on {n_sm} SMs, {l_bytes_ms / l_row[which]:.4f} of the bytes bound "
              f"{l_bytes_ms:.4f} ms")
    csa_nm_ms = cuda_ms(lambda: ops.decode_attention(*da_args, **records_csa_nm.point), 5)
    print(f"[7] decode_attention tuned by csa+nm: {csa_nm_ms:.4f} ms {records_csa_nm.point}; "
          f"by the route: {drec.point}")
    # recurrentgemma-2b's MQA decode: K and V are 16.8 MB, so they stay in the 50 MB L2
    # between repetitions (the times below are warm-L2 times)
    rg_terms = roofline("decode_attention", *rg_args)
    rg_defaults = get_spec("decode_attention").defaults(*rg_args)
    rg_k_exp = rg_args[1].repeat_interleave(gH // gKh, dim=1)
    rg_v_exp = rg_args[2].repeat_interleave(gH // gKh, dim=1)
    rg_mask = (rg_args[3] > 0)[:, None, None, :]
    rg_row = {"default": cuda_ms(lambda: ops.decode_attention(*rg_args, **rg_defaults), 20),
              "plain": cuda_ms(lambda: da.decode_attention_plain(*rg_args, **rg_defaults), 3),
              "library": cuda_ms(lambda: F.scaled_dot_product_attention(
                  rg_args[0][:, :, None], rg_k_exp, rg_v_exp, attn_mask=rg_mask), 20)}
    times["decode_attention"]["rg_mqa"] = rg_row
    print(f"[7] decode_attention recurrentgemma-2b MQA q{tuple(rg_args[0].shape)} "
          f"kv{tuple(rg_args[1].shape)}: default {rg_row['default']:.4f} ms {rg_defaults}, plain "
          f"{rg_row['plain']:.4f} ms, library {rg_row['library']:.4f} ms, bound "
          f"{rg_terms.bound_s * 1e3:.4f} ms by {rg_terms.dominant} "
          f"({rg_terms.bytes_accessed / 1e6:.1f} MB: inside the 50 MB L2, warm between repetitions)")
    del a, b, q, k, v, k_exp, v_exp, q_bhsd, lru_a, lru_b, lru_h0, rr, rk, rv, rlw, ru, rs0
    del dq, dk, dv, dvalid, dk_exp, dv_exp, dmask, rg_args, rg_k_exp, rg_v_exp, small_da
    del call_args, lru_args, rwkv_args, da_args, timing
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------ main path 3: serving, 8-9
    def trace_busy(fn, steps: int, name: str) -> tuple:
        """(device-busy ms, kernel launches) per call of ``fn`` from a
        ``torch.profiler`` trace of ``steps`` calls (the union of the kernel,
        copy and memset intervals); the trace is kept, gzipped, in ``out``."""
        import gzip

        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        path = out / f"trace_{name}.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        with gzip.open(f"{path}.gz", "wt") as fh:
            json.dump(events, fh)
        path.unlink()
        spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
        busy, end = 0.0, -math.inf
        for t0_, t1_ in spans:
            busy += max(0.0, t1_ - max(t0_, end))
            end = max(end, t1_)
        return busy / 1e3 / steps, len(spans) / steps

    def decode_profile(phase, arch, model, batch) -> dict:
        """Where one decode step's time goes, eager against a CUDA graph, and
        the graph's greedy tokens against the eager loop's, from fresh
        prefills of the served batch on the kernel path."""
        P = batch["tokens"].shape[1]
        B = batch["tokens"].shape[0]

        def fresh():
            h_, st_ = model.prefill(batch)
            return model.logits(h_[:, None])[:, 0].argmax(-1)[:, None], st_

        tok, st = fresh()
        eager_toks, eager_logits = [], []
        for i in range(DECODE_TOKENS):
            lg, st = model.decode_step(tok, st, P + i)
            tok = lg.argmax(-1)[:, None]
            eager_toks.append(tok)
            eager_logits.append(lg)
        state = {"tok": tok, "st": st, "pos": P + DECODE_TOKENS}

        def eager_step():
            lg_, state["st"] = model.decode_step(state["tok"], state["st"], state["pos"])
            state["tok"] = lg_.argmax(-1)[:, None]
            state["pos"] += 1

        walls = []
        for _ in range(8):
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            eager_step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0_) * 1e3)
        busy, kernels = trace_busy(eager_step, 3, f"{arch}_eager")
        del state, st, tok
        gc.collect()

        prof = {"eager_wall_ms": sorted(walls)[len(walls) // 2], "eager_wall_ms_min": min(walls),
                "eager_wall_ms_max": max(walls), "eager_busy_ms": busy, "eager_kernels": kernels}
        got = {}
        for k in (1, 8):
            tok, st = fresh()
            graphs = serve.DecodeGraphs(model, tok, st, P)
            del tok, st
            t0_ = time.perf_counter()
            run = graphs.build(k)
            prof[f"capture_k{k}_s"] = time.perf_counter() - t0_
            token, states, pos = graphs.token, graphs.states, graphs.pos
            toks_, logits_ = [], []
            for _ in range(DECODE_TOKENS // k):
                token, states, pos, toks = run(token, states, pos)
                toks_.append(toks.clone())
                logits_.append(run.logits.clone())
            got[k] = (torch.cat(toks_, dim=1), logits_)
            if k == 8:
                reps = []
                for _ in range(4):
                    torch.cuda.synchronize()
                    t0_ = time.perf_counter()
                    run(token, states, pos)
                    torch.cuda.synchronize()
                    reps.append((time.perf_counter() - t0_) * 1e3 / k)
                gbusy, gkernels = trace_busy(lambda: run(token, states, pos), 1, f"{arch}_graph8")
                prof.update(graph_step_ms=sorted(reps)[len(reps) // 2], graph_step_ms_min=min(reps),
                            graph_step_ms_max=max(reps), graph_busy_ms=gbusy / k,
                            graph_kernels=gkernels / k)
            del run, graphs, token, states, pos
            gc.collect()
        eager_t = torch.cat(eager_toks, dim=1)
        same = all(torch.equal(got[k][0], eager_t) for k in got)
        mag = max(lg.float().abs().max().item() for lg in eager_logits)
        dlog = max((g_.float() - e_.float()).abs().max().item()
                   for g_, e_ in zip(got[1][1], eager_logits))
        prof.update(tokens_equal=same, logits_max_abs_diff=dlog, logits_max_abs=mag,
                    eager_tok_s=B * 1e3 / prof["eager_wall_ms"], graph_tok_s=B * 1e3 / prof["graph_step_ms"])
        print(f"[{phase}] {arch} decode profile (batch {B}, position {P}+): eager step wall "
              f"{prof['eager_wall_ms']:.2f} ms (min {prof['eager_wall_ms_min']:.2f}, max "
              f"{prof['eager_wall_ms_max']:.2f}), device busy {busy:.3f} ms "
              f"({busy / prof['eager_wall_ms']:.3f} of the step), {kernels:.0f} kernel launches a step; "
              f"8-step graph replay {prof['graph_step_ms']:.3f} ms a step (min "
              f"{prof['graph_step_ms_min']:.3f}, max {prof['graph_step_ms_max']:.3f}), device busy "
              f"{prof['graph_busy_ms']:.3f} ms a step, {prof['graph_kernels']:.0f} kernels a step; "
              f"captures {prof['capture_k1_s']:.2f} s (k=1) / {prof['capture_k8_s']:.2f} s (k=8); "
              f"{prof['eager_tok_s']:.1f} -> {prof['graph_tok_s']:.1f} tok/s per step")
        ok = same and dlog <= LOGITS_TOL * mag
        print(f"[{phase}] {arch} first {DECODE_TOKENS} greedy tokens, eager vs 1-step and 8-step graphs: "
              f"equal={same}; logits max |d| {dlog:.4e} (max |logit| {mag:.3f}, limit "
              f"{LOGITS_TOL:g} x max |logit|) {'ok' if ok else 'FAIL'}")
        check(ok, f"{arch}: decode through CUDA graphs differs from the eager loop")
        return prof

    decode_profiles = {}
    serve_launches = {}
    plain_scan = {"lru_scan": ls.lru_scan_plain, "rwkv_scan": ls.rwkv_scan_plain}
    for phase, (arch, scan, per_prefill) in enumerate(SERVE, start=8):
        db_path = str(out / f"serve_{arch}.json")
        runs = []
        for run in (1, 2):
            reset_counts()
            by_design = dict(ls.launches_by_design)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = serve.serve(["--arch", arch, *SERVE_ARGS, "--db", db_path])
            launched = counts()
            by_design = {d: n - by_design[d] for d, n in ls.launches_by_design.items()}
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
            if scan == "rwkv_scan":
                print(f"[{phase}] {arch} run {run}: rwkv_scan launches by design {by_design}")
                check(by_design["tc"] == per_prefill,
                      f"{arch} run {run}: the prefill's rwkv_scan calls ran {by_design}, "
                      f"not {per_prefill} of the tensor-core design")
            h = res["hidden"]
            check(h.shape == (8, res["model"].cfg.d_model) and bool(torch.isfinite(h.float()).all()),
                  f"{arch} run {run}: prefill hidden {tuple(h.shape)} not finite of width d_model")
            check(run == 1 or res["db_hit"], f"{arch} run 2 was not a tuning DB hit")
            captures = res["graphs"].captures
            print(f"[{phase}] {arch} run {run}: {captures} decode depths captured as CUDA graphs; "
                  f"router {res.get('router')}")
            check(captures >= (len(serve.DECODE_KS) if run == 1 else 1),
                  f"{arch} run {run}: decode captured {captures} CUDA graphs")
            check(res["router"]["inband_builds"] == 0 and res["router"]["candidate_failures"] == 0,
                  f"{arch} run {run}: a decode build ran in-band or failed")
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
        label = (f"{scan} on the last layer's served inputs "
                 f"({', '.join(f'{tuple(t_.shape)} {str(t_.dtype)[6:]}' for t_ in s_args)}) {plain_kw}")
        if scan == "lru_scan":
            lru_compare(label, s_args, plain_kw, got=real_scan(*s_args, **s_kw), phase=phase)
        else:
            compare(label, scan, real_scan(*s_args, **s_kw), plain_scan[scan](*s_args, **plain_kw),
                    phase=phase)
        del res, h, h_first, h_bf16_plain, err_bf16, served_call, s_args
        gc.collect()
        torch.cuda.empty_cache()
        decode_profiles[arch] = decode_profile(phase, arch, model, batch)
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

    main_launches = {n: tuning_launches[n] + route_launches[n] + serve_launches.get(n, 0)
                     for n in names}
    (out / "decode_profile.json").write_text(json.dumps(decode_profiles, indent=1))
    print(f"[9] serving launches: {serve_launches}; all main paths: {main_launches}; launches by "
          f"design since the start: matmul {mm.launches_by_design}, flash_attention {fa.launches_by_design}, "
          f"decode_attention {da.launches_by_design}, rwkv_scan {ls.launches_by_design}")
    for name, n in main_launches.items():
        check(n > 0, f"no main path launched the {name} kernel")

    sources = {"matmul": ("src/repro_torch/kernels/csrc/matmul_wgmma.cu", "src/repro/kernels/matmul.py:40"),
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
                                   "src/repro/kernels/flash_attention.py:79"),
               "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:58"),
               "lru_scan": ("src/repro_torch/kernels/csrc/linear_scan.cu",
                            "src/repro/kernels/linear_scan.py:147"),
               "rwkv_scan": ("src/repro_torch/kernels/csrc/rwkv_subchunk.cu",
                             "src/repro/kernels/linear_scan.py:77")}
    kernels = []
    for name in names:
        row = times[name]
        terms = row["terms"]
        entry = {
            "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
            "design": designs.get((name, "tuned"), "simt"),
            "launches": main_launches[name], "max_abs_err": max_err[name],
            "ms": row["tuned"], "ms_default": row["default"], "plain_ms": row["plain"],
            "bound_ms": terms.bound_s * 1e3, "bound_by": terms.dominant,
            "library_ms": row["library"],
        }
        if name == "rwkv_scan":  # the tensor-core design ran; its bound is the bytes'
            entry.update(design="tc", bound_ms=row["tc_bound_ms"], bound_by="bytes",
                         fp32_operations_bound_ms=terms.compute_s * 1e3,
                         per_token_ms={str(c): t for c, t in row["per_token"].items()},
                         per_token_source="src/repro_torch/kernels/csrc/linear_scan.cu")
        if name == "decode_attention":
            entry.update(design="split_kv", splits=row["splits_tuned"], grid=row["grid_tuned"],
                         splits_default=row["splits_default"], grid_default=row["grid_default"])
        if name == "lru_scan":
            entry.update(design="segmented", segments=row["segments"]["tuned"],
                         segments_default=row["segments"]["default"],
                         segments_serving_chunk4=row["segments"]["main_path"])
        if row["main_path"] is not None:
            entry["ms_serving_chunk4"] = row["main_path"]
        if "rg_mqa" in row:  # recurrentgemma-2b's MQA decode, at its default knobs
            entry["ms_recurrentgemma_2b_mqa"] = row["rg_mqa"]["default"]
            entry["plain_ms_recurrentgemma_2b_mqa"] = row["rg_mqa"]["plain"]
            entry["library_ms_recurrentgemma_2b_mqa"] = row["rg_mqa"]["library"]
        kernels.append(entry)
    print(f"[9] total {time.perf_counter() - t_start:.1f}s; DBs in {out}; "
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
