#!/usr/bin/env python3
"""Where a served prefill's device time goes, per model, on one CUDA card.

    python3 scripts/probe_prefill_profile.py [--arch ARCH ...]

For each architecture (default: seamless_m4t_large_v2, moonshot_v1_16b_a3b,
qwen2_7b) at full width and depth, with ``launch/serve.py``'s model and
batch (weights from seed 0, batch 8, prompt 2048, the context from seed 2,
``ExecConfig(attn_impl="cuda", rec_chunk=4)``), it runs one prefill to warm
up, then one more under ``torch.profiler`` and prints: the wall time, the
device-busy time (the union of kernel, copy and memset intervals), and the
kernel time by class (matrix products, the flash kernel, fp32 copies and
casts, other elementwise kernels, reductions and softmax, scatter and
gather, the rest) with the largest kernels by name.  TF32 is off, as in
``chip_smoke.py``.  It prints the card's name and power limit first and
exits 1 without a card.
"""
import argparse
import collections
import gzip
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("seamless_m4t_large_v2", "moonshot_v1_16b_a3b", "qwen2_7b")
CLASSES = (
    ("flash kernel", r"flash_wgmma|flash_attention"),
    ("matrix products", r"nvjet|gemm|gemv|xmma|cutlass|sm90_|sm80_|splitK|Kernel2"),
    ("copies and casts", r"direct_copy|copy_kernel|CatArrayBatched"),
    ("softmax and reductions", r"softmax|reduce_kernel|Reduce"),
    ("scatter, gather, index", r"index|scatter|gather|take_along"),
    ("other elementwise", r"elementwise"),
)


def classify(name: str) -> str:
    for label, pattern in CLASSES:
        if re.search(pattern, name, re.IGNORECASE):
            return label
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "probe_prefill_profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_prefill_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.models import ExecConfig, Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda", 0)
    for arch in args.arch or ARCHS:
        cfg = configs.get(arch)
        model = Model(cfg, ExecConfig(attn_impl="cuda", rec_chunk=4), device=dev, seed=0)
        gen = torch.Generator(device=dev).manual_seed(1)
        B, P = 8, 2048
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev),
                 "max_len": P + 64}
        if cfg.is_encdec or cfg.family == "vlm":
            gen.manual_seed(2)
            ctx = 0.1 * torch.randn((B, cfg.ctx_tokens, cfg.d_model), generator=gen, device=dev)
            batch["frames" if cfg.is_encdec else "ctx_embeds"] = ctx
        model.prefill(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.prefill(batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        path = out / f"prefill_{arch}.json"
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
        kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
        total = sum(e["dur"] for e in kernels)
        by_class, by_name = collections.Counter(), collections.Counter()
        for e in kernels:
            by_class[classify(e["name"])] += e["dur"]
            by_name[e["name"][:90]] += e["dur"]
        print(f"{arch} prefill (batch {B}, prompt {P}{', context ' + str(cfg.ctx_tokens) if cfg.ctx_tokens else ''}): "
              f"wall {wall:.1f} ms, device busy {busy / 1e3:.1f} ms, {len(kernels)} kernels, "
              f"{total / 1e3:.1f} ms of kernel time; {smi}")
        for label, us in by_class.most_common():
            print(f"  {label}: {us / 1e3:.1f} ms ({us / total:.3f})")
        for name, us in by_name.most_common(6):
            print(f"    {us / 1e3:8.1f} ms  {name}")
        del model, batch, prof, events
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
