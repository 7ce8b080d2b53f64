#!/usr/bin/env python3
"""Training steps through the flash kernel on one CUDA card: step time,
peak memory and the flash backward's device time, for one checkout or two.

    python3 scripts/probe_flash_train.py [--src DIR ...] [--seamless-batches 3 4 5]
                                          [--qwen] [--moonshot] [--steps N]

Each configuration runs in a subprocess of its own (the card to itself),
importing ``repro_torch`` from ``DIR/src`` for each ``--src`` in turn (the
default: this checkout; a parent commit unpacked with ``git archive`` into a
git-ignored directory compares the two in one call).  Configurations:
seamless-m4t-large-v2 at full width and depth through ``TrainJob`` (frames
of 4096, 512 decoder tokens) at each ``--seamless-batches`` batch, in
order, stopping after the first that runs out of memory or peaks at 80 GB
or more; ``--qwen``: qwen2-7b at full width with 2 layers, ``--moonshot``:
moonshot-v1-16b-a3b with 2 of 48 layers, each 1 x 2048 through
``make_train_step``; ``--peaks B ...``: one seamless step at batch B taken
apart (the memory resident before it and after the forward, and the peak
of the forward, of the backward and of the optimizer update).  Weights from seed 0, ``--steps`` steps (default 4).
Each prints its step wall ms (each and the median of all but the first),
tokens/s at the median, ``torch.cuda.max_memory_allocated``, the flash
launches and the flash backward's device ms a step (CUDA events around each
call of ``ops._Flash.backward``, whatever it runs), then the card's name
and power limit.  Exits 1 without a card.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RESULT = "probe_flash_train: "


def one(spec: str, steps: int) -> dict:
    """Run configuration ``spec`` (``seamless:B``, ``qwen``, ``moonshot``)
    in this process; ``repro_torch`` is already importable."""
    import dataclasses

    import torch

    from repro_torch import configs as tconfigs
    from repro_torch.data import make_batch_for
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import ExecConfig, TrainModel
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime import TrainJob
    from repro_torch.train import make_train_step

    dev = torch.device("cuda", 0)
    events = []
    backward = ops._Flash.backward

    def timed(ctx, *grads):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        got = backward(ctx, *grads)
        e1.record()
        events.append((e0, e1))
        return got

    ops._Flash.backward = staticmethod(timed)
    torch.cuda.init()  # the peak statistics need an initialized device
    torch.cuda.reset_peak_memory_stats(dev)
    fwd0 = fa.launches
    out = {"config": spec}
    if spec.startswith("peaks:"):  # one step of seamless at this batch, phase by phase
        from repro_torch.train import make_loss_fn

        batch = int(spec.split(":")[1])
        gb = 1e9
        _, model, opt, params, opt_state = TrainJob(arch="seamless_m4t_large_v2", tiny=False, steps=1,
                                                    global_batch=batch, seq_len=512, warmup=0, seed=0,
                                                    device="cuda").build()
        b_ = make_batch_for(model.cfg, batch, 512, step=0, seed=0, device=dev)
        torch.cuda.synchronize()
        out["resident_gb"] = torch.cuda.memory_allocated(dev) / gb
        torch.cuda.reset_peak_memory_stats(dev)
        loss, _ = make_loss_fn(model, logits_chunk=model.exec_cfg.logits_chunk)(params, b_)
        torch.cuda.synchronize()
        out["after_forward_gb"] = torch.cuda.memory_allocated(dev) / gb
        out["forward_peak_gb"] = torch.cuda.max_memory_allocated(dev) / gb
        torch.cuda.reset_peak_memory_stats(dev)
        loss.backward()
        torch.cuda.synchronize()
        out["backward_peak_gb"] = torch.cuda.max_memory_allocated(dev) / gb
        del loss
        grads = {n: p_.grad for n, p_ in params.items()}
        torch.cuda.reset_peak_memory_stats(dev)
        opt.update(grads, opt_state, params)
        torch.cuda.synchronize()
        out["update_peak_gb"] = torch.cuda.max_memory_allocated(dev) / gb
        out["parameters"] = sum(p_.numel() for p_ in params.values())
        return out
    if spec.startswith("seamless:"):
        batch = int(spec.split(":")[1])
        job = TrainJob(arch="seamless_m4t_large_v2", tiny=False, steps=steps, global_batch=batch,
                       seq_len=512, warmup=0, seed=0, device="cuda")
        hist = job.run()
        walls = [t * 1e3 for t in hist["step_time"]]
        tokens = batch * 512
        out["loss"] = hist["loss"]
    else:
        arch = {"qwen": "qwen2_7b", "moonshot": "moonshot_v1_16b_a3b"}[spec]
        cfg = dataclasses.replace(tconfigs.get(arch), n_layers=2, n_groups=0)
        model = TrainModel(cfg, ExecConfig(attn_impl="cuda"), device=dev, seed=0)
        params = model.params()
        opt = AdamW(lr=cosine_schedule(1e-3, 0, 50))
        opt_state = opt.init(params)
        step_fn = make_train_step(model, opt)
        walls, losses = [], []
        for i in range(steps):
            b_ = make_batch_for(cfg, 1, 2048, step=i, seed=0, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, met = step_fn(params, opt_state, b_)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(met["loss"].item())
        tokens = 2048
        out["loss"] = losses
    torch.cuda.synchronize()
    med = sorted(walls[1:])[len(walls[1:]) // 2] if len(walls) > 1 else walls[0]
    out.update(step_ms=walls, median_step_ms=med, tokens_per_s=tokens / (med / 1e3),
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               flash_launches_per_step=(fa.launches - fwd0) / steps,
               flash_bwd_calls_per_step=len(events) / steps,
               flash_bwd_device_ms_per_step=sum(a.elapsed_time(b) for a, b in events) / steps)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=None, help="checkouts to import repro_torch from")
    ap.add_argument("--seamless-batches", type=int, nargs="*", default=[])
    ap.add_argument("--qwen", action="store_true")
    ap.add_argument("--moonshot", action="store_true")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--peaks", type=int, nargs="*", default=[],
                    help="seamless batches to run one step of phase by phase, printing the memory "
                         "resident before it, after the forward, and the peaks of the forward, the "
                         "backward and the optimizer update")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_flash_train: no CUDA device", file=sys.stderr)
        return 1
    if args.one is not None:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(RESULT + json.dumps(one(args.one, args.steps)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    for src in args.src or [str(ROOT)]:
        env = {"PYTHONPATH": str(Path(src).resolve() / "src")}
        specs = [f"seamless:{b}" for b in args.seamless_batches]
        specs += ["qwen"] * args.qwen + ["moonshot"] * args.moonshot + [f"peaks:{b}" for b in args.peaks]
        seamless_done = False
        for spec in specs:
            if seamless_done and spec.startswith("seamless:"):
                continue
            proc = subprocess.run([sys.executable, __file__, "--one", spec, "--steps", str(args.steps)],
                                  capture_output=True, text=True, env={**os.environ, **env})
            got = [json.loads(ln[len(RESULT):]) for ln in proc.stdout.splitlines() if ln.startswith(RESULT)]
            if not got:
                oom = "OutOfMemoryError" in proc.stderr
                last = " | ".join(proc.stderr.strip().splitlines()[-3:])
                print(f"[{src}] {spec}: exit {proc.returncode}{' (out of memory)' if oom else ''}: {last}")
                seamless_done = seamless_done or spec.startswith("seamless:")
                continue
            r = got[0]
            if spec.startswith("peaks:"):
                print(f"[{src}] {spec}: {r['parameters'] / 1e9:.3f} B parameters; GB resident before the step "
                      f"{r['resident_gb']:.2f}, after the forward {r['after_forward_gb']:.2f}; peaks: forward "
                      f"{r['forward_peak_gb']:.2f}, backward {r['backward_peak_gb']:.2f}, optimizer update "
                      f"{r['update_peak_gb']:.2f}; {smi}")
                continue
            print(f"[{src}] {spec}: step ms {[round(w, 1) for w in r['step_ms']]}, median (after the first) "
                  f"{r['median_step_ms']:.1f} ms, {r['tokens_per_s']:.1f} tokens/s, peak {r['peak_gb']:.2f} GB, "
                  f"flash launches a step {r['flash_launches_per_step']:g}, flash backward "
                  f"{r['flash_bwd_calls_per_step']:g} calls and {r['flash_bwd_device_ms_per_step']:.2f} device ms "
                  f"a step, loss {[round(x, 4) for x in r['loss']]}; {smi}")
            seamless_done = seamless_done or (spec.startswith("seamless:") and r["peak_gb"] >= 80.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
