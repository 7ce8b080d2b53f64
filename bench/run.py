#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch/CUDA port once, on the card.

    python3 bench/run.py --workload rwkv6_7b.train --seed 7 --seconds 30 --trace 0

Makes the weights and inputs on the card from ``--seed``, warms the cell's
own shapes (set-up, reported as ``setup_s``), measures for ``--seconds``,
with ``--trace 1`` traces a short segment after the window, then frees the
program and compares what the window's path produced with the plain
reference under ``bench/reference/``.  The last line of standard output is
the result as one JSON object; the numbers compared, each beside its limit,
are the last lines of standard error.  Without a card, or with fewer cards
than the cell asks for, it exits 2 and prints no result.  Build caches live
under ``build/`` inside the checkout.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _cache_dirs() -> None:
    """Every build and kernel cache in fixed directories inside the checkout
    (the program's own nvcc output is ``build/repro_torch``)."""
    cache = ROOT / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _cache_dirs()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench.harness.cell_run import run_cell
    from bench.harness.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: the cell needs {chips} CUDA card(s), found {found}", file=sys.stderr)
        return 2
    print(f"card: {_card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", STARTED)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the process holds {bad}: nothing of the JAX package may load",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
