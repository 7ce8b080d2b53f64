#!/usr/bin/env python3
"""Find what keeps CUDA memory alive after a served model is dropped.

    python3 scripts/probe_serve_memory.py [--arch rwkv6_7b]

Repeats ``chip_smoke.py`` phase 9's steps on one model at full width (batch
8, prompt 2048, 64 new tokens): two ``serve`` runs on one DB, a prefill on
the plain path, the decode profile (eager steps, CUDA graphs of 1 and 8
steps, ``torch.profiler`` traces) and two prefills in fp32 arithmetic, then
drops the model.  After each step it prints ``chip_smoke.live_cuda_report``:
the allocated memory, the serving objects alive and the largest live CUDA
tensors with what refers to them.  It prints the card's name and power
limit first and exits 1 without a card.
"""
import argparse
import contextlib
import dataclasses
import gc
import io
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6_7b")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "probe_serve_memory"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_serve_memory: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    from repro_torch.launch import serve
    from repro_torch.models import ExecConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "serve.json").unlink(missing_ok=True)
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi())
    cs.live_cuda_report("start", dev)
    res = None
    for run in (1, 2):
        res = None
        gc.collect()
        with contextlib.redirect_stdout(io.StringIO()):
            res = serve.serve(["--arch", args.arch, *cs.SERVE_ARGS, "--db", str(out / "serve.json")])
        cs.live_cuda_report(f"serve run {run}, result held", dev)
    model, batch = res["model"], res["batch"]
    del res
    cs.live_cuda_report("serve result dropped, model held", dev)
    model.exec_cfg = ExecConfig(attn_impl="xla", rec_chunk=4)
    model.prefill(batch)
    cs.live_cuda_report("plain-path prefill", dev)
    model.exec_cfg = ExecConfig(attn_impl="cuda", rec_chunk=4)
    cs.decode_profile(out, "probe", args.arch, model, batch)
    cs.live_cuda_report("decode profile", dev)
    model.cfg = dataclasses.replace(model.cfg, compute_dtype="float32")
    for impl in ("cuda", "xla"):
        model.exec_cfg = ExecConfig(attn_impl=impl, rec_chunk=4)
        model.prefill(batch)
        cs.live_cuda_report(f"fp32 prefill ({impl})", dev)
    del model, batch
    cs.live_cuda_report("model dropped", dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
