#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, on the card, at
the cell's own size, many seeds in one process.

    python3 bench/calibrate.py --workload rwkv6_7b.train --seeds 1-12 --control 1-3
    python3 bench/calibrate.py --workload rwkv6_7b.train --seeds 1-3 --fault half_batch

For a training cell, each seed builds the program's step, runs the first
steps through it, frees it and runs the reference: the numbers of
``correct`` for the program.  ``--control`` seeds put the reference
computed in fp8 (one precision step below the configurations' bf16) in the
program's place.  ``--fault half_batch`` plants a fault in the program's
step: half of the batch's labels masked out, the mean taken over the rest.
For a serving cell, each seed serves one cycle of the mix's prompt lengths
(no time limit), samples as a run does, and reads the program's widest
logit gap and, on ``--control`` seeds, the fp8 reference's.  One JSON line
per seed; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _seeds(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def half_batch(batch: dict) -> dict:
    """The fault: the second half of the rows' labels masked out (for one
    row, the second half of its positions), so the loss is the mean over
    the rest."""
    labels = batch["labels"].clone()
    B, S = labels.shape
    if B > 1:
        labels[B - B // 2:] = -1
    else:
        labels[:, S // 2:] = -1
    return dict(batch, labels=labels)


def train_seed(cell, seed: int, device, fault: str = "") -> dict:
    from bench.harness import train

    run = train.build(cell, seed, device)
    if fault == "half_batch":
        feed = run.batch
        run.batch = lambda i: half_batch(feed(i))
    readings = train.first_steps(run, cell.traffic["ref_steps"])
    train.free(run)
    return train.compare(readings, train.reference(cell, seed, device))


def control_train_seed(cell, seed: int, device) -> dict:
    from bench.harness import train

    return train.compare(train.reference(cell, seed, device, "fp8"),
                         train.reference(cell, seed, device))


def serve_seed(cell, seed: int, device, control: bool) -> dict:
    from bench.harness import serve
    from bench.harness.inputs import prompt_lengths

    t = cell.traffic
    run = serve.build(cell, seed, device)
    n = len(t["prompt_lens"])
    for i, P in enumerate(prompt_lengths(t, seed, n)):
        run.done.append(serve.serve_one(run, i, P, t["gen"]))
    pairs = serve.sample(run, t["sample"])
    serve.free(run)
    return serve.gaps(run, pairs, ("fp8",) if control else ())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="", choices=("", "half_batch"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench.harness.spec import load_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)
    serving = cell.traffic["kind"] == "serve"
    control = set(_seeds(args.control))
    for seed in sorted(set(_seeds(args.seeds)) | control):
        t0 = time.perf_counter()
        if serving:
            out = serve_seed(cell, seed, "cuda", seed in control)
        else:
            out = {}
            if seed in set(_seeds(args.seeds)):
                out["program" if not args.fault else args.fault] = train_seed(
                    cell, seed, "cuda", args.fault)
            if seed in control:
                out["fp8"] = control_train_seed(cell, seed, "cuda")
        print(json.dumps({"workload": cell.name, "seed": seed, "readings": out,
                          "seconds": time.perf_counter() - t0,
                          "left_allocated": torch.cuda.memory_allocated()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
