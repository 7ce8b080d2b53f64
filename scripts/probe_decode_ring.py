#!/usr/bin/env python3
"""Time the split-KV decode kernel with other K/V ring shapes on one CUDA card.

    python3 scripts/probe_decode_ring.py

Builds copies of ``csrc/decode_attention.cu`` with other ``NSTAGE`` x
``CH_BYTES`` rings (2 x 32 KB is the shipped one) into a temporary
directory, and times each at qwen2-7b's decode shape (q (8, 28, 128), k/v
(8, 4, 32768, 128) bf16) and recurrentgemma-2b's MQA shape (q (8, 10, 256),
k/v (8, 1, 2048, 256) bf16), every slot valid, inputs from seed 0, at
block_kv 128 to 1024 (CUDA events, one warm-up, 20 repetitions), with the
max |error| against the plain version in parentheses.  It prints the
card's name and power limit first and exits 1 without a card.
"""
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

RINGS = ((2, 32768), (3, 32768), (4, 16384), (3, 16384), (2, 49152))  # NSTAGE, CH_BYTES
SHAPES = ((8, 28, 4, 32768, 128), (8, 10, 1, 2048, 256))  # B, H, Kh, S, hd


def cuda_ms(fn, reps: int = 20) -> float:
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
        print("probe_decode_ring: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels import decode_attention as da

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    src = (_cuda.CSRC / "decode_attention.cu").read_text()
    tmp = Path(tempfile.mkdtemp(prefix="decode_ring_"))
    procs = []
    for nst, ch in RINGS:
        s = re.sub(r"constexpr int CH_BYTES = \d+;", f"constexpr int CH_BYTES = {ch};", src)
        s = re.sub(r"constexpr int NSTAGE = \d+;", f"constexpr int NSTAGE = {nst};", s)
        cu = tmp / f"ring_{nst}_{ch}.cu"
        cu.write_text(s)
        procs.append(((nst, ch), cu.with_suffix(".so"), subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for key, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"ring {key}: nvcc exit {proc.returncode}\n{log.decode()}", file=sys.stderr)
            return 1
        libs[key] = ctypes.CDLL(str(so))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shipped = da.RING_BYTES
    try:
        for B, H, Kh, S, hd in SHAPES:
            q = torch.randn(B, H, hd, generator=gen, device=dev).bfloat16()
            k = torch.randn(B, Kh, S, hd, generator=gen, device=dev).bfloat16()
            v = torch.randn(B, Kh, S, hd, generator=gen, device=dev).bfloat16()
            valid = torch.ones(B, S, dtype=torch.int32, device=dev)
            for (nst, ch), lib in libs.items():
                da.RING_BYTES = nst * ch  # the wrapper's shared-memory check
                _cuda._libs["decode_attention"] = lib
                row = []
                for bkv in (128, 256, 512, 1024):
                    ms = cuda_ms(lambda: ops.decode_attention(q, k, v, valid, block_kv=bkv))
                    err = (ops.decode_attention(q, k, v, valid, block_kv=bkv).float()
                           - da.decode_attention_plain(q, k, v, valid, block_kv=bkv).float()
                           ).abs().max().item()
                    row.append(f"{bkv}: {ms:.4f} ({err:.1e})")
                print(f"{(B, H, Kh, S, hd)} ring {nst} x {ch} B: {' | '.join(row)}", flush=True)
    finally:
        da.RING_BYTES = shipped
        _cuda._libs.pop("decode_attention", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
