"""Launch hill climb: PATSMA (CSA, Entire-Execution mode) searching the
execution knobs of one (arch × shape) cell against the dry run's roofline.

Counterpart of the JAX package's ``launch/hillclimb.py``, with its knob
menus in their order.  Each candidate is a (remat × chunking × sharding ×
capacity) configuration; its cost is the dominant roofline term of the
freshly counted cell (:func:`repro_torch.launch.dryrun.run_cell`, the delta
method) on :data:`~repro_torch.core.costs.H100_SXM`, modelled from the
data sheet, not measured.  Every evaluation is logged to JSONL.

The search loop lives in ``repro_torch.runtime``: this launcher builds an
:class:`~repro_torch.runtime.OnlineTuner` (with a
:class:`~repro_torch.runtime.DriftDetector`, so a long-lived caller could
keep feeding it post-search costs and get automatic re-searches) and drives
it to completion with the dry run's cost.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --arch llama3_405b \\
        --shape train_4k --budget 10 --out hc_405b.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch import configs
from repro_torch.core import CSA, Autotuning, ChoiceDim, SearchSpace
from repro_torch.core.costs import H100_SXM
from repro_torch.launch import costing
from repro_torch.launch.dryrun import run_cell
from repro_torch.runtime import DriftDetector, OnlineTuner

__all__ = ["TRAIN_KNOBS", "MOE_KNOBS", "DECODE_KNOBS", "knob_space", "evaluate", "main"]

# knob menus per shape kind
TRAIN_KNOBS = [
    ChoiceDim("attn_impl", ("xla", "flashcost")),  # flash kernel vs plain attention
    ChoiceDim("remat", ("none", "full")),
    ChoiceDim("logits_chunk", (0, 4096, 16384)),
    ChoiceDim("sp", (False, True)),  # sequence-parallel activations
    ChoiceDim("fsdp", (True, False)),
]
MOE_KNOBS = [ChoiceDim("capacity_factor", (1.0, 1.25, 2.0))]
DECODE_KNOBS = [
    ChoiceDim("attn_impl", ("xla", "flashcost")),
    ChoiceDim("fsdp", (True, False)),
    ChoiceDim("logits_chunk", (0, 4096)),
]


def knob_space(cfg, shape_kind: str) -> SearchSpace:
    dims = list(TRAIN_KNOBS if shape_kind != "decode" else DECODE_KNOBS)
    if cfg.ffn == "moe" and shape_kind != "decode":
        dims += MOE_KNOBS
    return SearchSpace(dims)


def evaluate(arch: str, shape: str, knobs: dict, *, multi_pod=False, objective="bound",
             hw=H100_SXM):
    """(cost in seconds, the dry run's result) of one knob point."""
    exec_over = {}
    cfg_over = {}
    kw = {}
    for k, v in knobs.items():
        if k in ("remat", "logits_chunk", "rec_chunk", "attn_impl"):
            exec_over[k] = v
        elif k in ("capacity_factor",):
            cfg_over[k] = v
        elif k in ("fsdp", "sp", "microbatches"):
            kw[k] = v
    r = run_cell(
        arch, shape, multi_pod=multi_pod, exec_overrides=exec_over,
        cfg_overrides=cfg_over, verbose=False, hw=hw, **kw,
    )
    if r["status"] != "ok":
        return float("inf"), r
    rt = dict(r["roofline"])
    if exec_over.get("attn_impl") == "flashcost":
        # the surrogate carries the kernel's HBM and collective traffic;
        # the kernel's tensor-core flops are added back analytically
        cfg = configs.get(arch)
        if cfg_over:
            cfg = dataclasses.replace(cfg, **cfg_over)
        mesh_shape = r["mesh"]
        dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
        tp = mesh_shape.get("model", 1)
        adj = costing.attention_traffic(cfg, configs.SHAPES[shape], dp, tp)
        rt["flops"] = rt["flops"] + adj["flash_flops"]
        rt["compute_s"] = rt["flops"] / hw.peak_for(cfg.compute_dtype)
        r["roofline"] = rt
        r["flash_flops_added"] = adj["flash_flops"]
    if objective == "bound":
        cost = max(rt["compute_s"], rt["memory_s"], rt["collective_s"])
    else:
        cost = rt[objective + "_s"]
    # HBM feasibility: argument bytes (params + optimizer state + caches,
    # exact under the candidate's shardings) must fit the card.  Without
    # this penalty the search "wins" by un-sharding weights.
    args_b = r["memory"]["argument_bytes"]
    if args_b > 0.95 * hw.hbm_bytes:
        r["infeasible"] = f"args {args_b/1e9:.1f} GB > HBM"
        cost = cost + 1e6 * (args_b / hw.hbm_bytes)
    return cost, r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.hillclimb")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(configs.SHAPES))
    ap.add_argument("--budget", type=int, default=10, help="CSA cost evaluations")
    ap.add_argument("--objective", default="bound",
                    choices=["bound", "compute", "memory", "collective"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--num-opt", type=int, default=3)
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    shape_kind = configs.SHAPES[args.shape].kind
    space = knob_space(cfg, shape_kind)
    max_iter = max(2, args.budget // args.num_opt)
    at = Autotuning(
        space=space, ignore=0,
        search=CSA(len(space), num_opt=args.num_opt, max_iter=max_iter, seed=0),
        cache=True, verbose=True,
    )
    tuner = OnlineTuner(at, epsilon=1.0, drift=DriftDetector(window=4, min_samples=3))

    def record(rec):
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    n = 0

    def cost_fn(knobs):
        nonlocal n
        t0 = time.time()
        cost, result = evaluate(args.arch, args.shape, knobs,
                                multi_pod=args.multi_pod, objective=args.objective)
        n += 1
        rec = {
            "eval": n, "knobs": knobs, "cost_s": cost,
            "roofline": result.get("roofline"), "memory": result.get("memory"),
            "status": result.get("status"), "elapsed_s": round(time.time() - t0, 1),
            "arch": args.arch, "shape": args.shape,
        }
        record(rec)
        print(f"[hc] eval {n}: {knobs} -> {cost*1e3:.1f} ms ({rec['elapsed_s']}s)", flush=True)
        return cost

    tuner.drive(cost_fn)

    print(f"\n[hc] best: {at.best_point} -> {at.best_cost*1e3:.1f} ms "
          f"({at.num_evals} evals, cache hits included; modelled on {H100_SXM.name})")
    record({"final": True, "best_knobs": at.best_point, "best_cost_s": at.best_cost,
            "arch": args.arch, "shape": args.shape})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
