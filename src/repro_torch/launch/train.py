"""Training launcher: the fault-tolerant driver end to end.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_7b --tiny --steps 50

The flags are the JAX launcher's plus ``--device`` (default ``cuda``: the
CUDA kernels on the card; ``cpu`` runs their plain versions).  Without a
card and without ``--device cpu`` it exits 1.  ``--tune`` rides PATSMA's
Single-Iteration mode on the training loop (microbatch count), ``--db``
keeps the result across runs: a second run on the same DB adopts it with no
search and says so (``tuning db hit: ...``).  Then it prints the same JSON
summary as the JAX launcher.

Cluster mode is the same program started once per process by ``torchrun``,
with ``--distributed``:

    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 1 \
        -m repro_torch.launch.train --distributed --arch recurrentgemma_2b

It joins ``torch.distributed`` from the environment ``torchrun`` sets (as
the JAX launcher's ``jax.distributed.initialize()`` does): NCCL on card
``LOCAL_RANK``, or gloo with ``--device cpu``.  Each process then runs the
same ``TrainJob`` and leaves the group at exit.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="qwen2_7b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--tune", action="store_true", help="PATSMA single-iteration mode")
    ap.add_argument("--runtime", type=str, default=None, choices=["adaptive"],
                    help="adaptive: keep tuning while training (epsilon-rationed "
                         "exploration + drift-triggered warm re-search)")
    ap.add_argument("--epsilon", type=float, default=1.0,
                    help="explored fraction of steps while a search is live "
                         "(adaptive runtime mode)")
    ap.add_argument("--db", type=str, default=None,
                    help="tuning DB path; warm-starts step knobs across runs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--distributed", action="store_true",
                    help="join torch.distributed from the torchrun environment "
                         "(NCCL on card LOCAL_RANK; gloo with --device cpu)")
    ap.add_argument("--obs-dir", type=str, default=None,
                    help="write observability artifacts (events.jsonl, "
                         "trace.json, metrics.json) into this directory "
                         "(default: the REPRO_OBS env var, else off)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default: the CUDA kernels on the card) or cpu "
                         "(the kernels' plain versions)")
    return ap


def train(argv=None) -> dict:
    """Run the launcher; returns the JSON summary it prints."""
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {args.device!r}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice("no CUDA device: training runs the CUDA kernels on the card "
                           "(pass --device cpu for the plain versions on the CPU)")
    if not args.distributed:
        return _train(args, args.device)

    import os

    import torch.distributed as dist

    missing = [v for v in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if v not in os.environ]
    if missing:
        raise NoTorchrun(f"--distributed: no torchrun environment ({', '.join(missing)} unset); "
                         "start the launcher with python -m torch.distributed.run")

    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    try:
        return _train(args, str(device))
    finally:
        dist.destroy_process_group()


def _train(args, device: str) -> dict:
    from repro_torch import obs

    if args.obs_dir:
        obs.configure(args.obs_dir)
    else:
        obs.configure_from_env()

    from repro_torch.runtime import TrainJob

    job = TrainJob(
        arch=args.arch,
        tiny=args.tiny,
        steps=args.steps,
        global_batch=args.global_batch,
        seq_len=args.seq_len,
        lr=args.lr,
        seed=args.seed,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        tune=args.tune or args.runtime is not None,
        tune_db=args.db,
        runtime=args.runtime,
        tune_epsilon=args.epsilon,
        device=device,
    )
    try:
        with obs.span("train", steps=args.steps):
            hist = job.run()
    finally:
        obs.shutdown()
    if hist["db_hit"]:
        print(f"tuning db hit: train_step/{args.arch} {hist['final_knobs']} (no online tuning)")
    summary = {
        "final_loss": hist["loss"][-1],
        "steps": len(hist["loss"]),
        "mean_step_s": sum(hist["step_time"]) / len(hist["step_time"]),
        "final_knobs": hist["final_knobs"],
        "watchdog_events": len(hist["watchdog_events"]),
        "resets": len(hist["resets"]),
    }
    print(json.dumps(summary, indent=2))
    return summary


class NoCudaDevice(RuntimeError):
    """The launcher was asked for the card and there is none."""


class NoTorchrun(RuntimeError):
    """``--distributed`` outside ``torchrun``'s environment."""


def main(argv=None) -> int:
    try:
        train(argv)
    except (NoCudaDevice, NoTorchrun) as e:
        print(f"train: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
