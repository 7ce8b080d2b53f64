"""The training loop: one training step of the program, built once, driven
from the seed through its first steps in set-up and then back to back for
the window.

The step is the program's ``make_train_step(TrainModel, AdamW)`` composed as
its ``runtime.TrainJob`` composes it (AdamW over fp32 masters,
the cosine schedule, one microbatch, the full loss), on the kernels
(``attn_impl="cuda"``).  The first ``ref_steps`` steps go through the same
call and feed as the window's and give the readings that the reference
checks: each step's loss, each leaf's first gradient as AdamW got it
(before its clipping) and each leaf's change after the last of them.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import time

import torch

from . import weights
from .inputs import train_batch
from .reference_runs import reference_train

__all__ = ["TrainRun", "build", "first_steps", "run_window", "free", "program_config", "compare",
           "reference"]


def program_config(cell):
    """The program's ``ModelConfig`` for the cell's configuration: its
    architecture module's config (or the tiny one) with the file's
    overrides; every size must equal the configuration file's."""
    from repro_torch import configs

    port = cell.config["port"]
    cfg = configs.get_tiny(port["arch"]) if port.get("tiny") else configs.get(port["arch"])
    cfg = dataclasses.replace(cfg, **port.get("overrides", {}))
    sizes = cell.sizes
    for key in ("n_layers", "enc_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff",
                "vocab_size", "padded_vocab"):
        if getattr(cfg, key) != sizes[key]:
            raise ValueError(f"{cell.config['port']}: program {key}={getattr(cfg, key)}, "
                             f"configuration file {sizes[key]}")
    return cfg


@dataclasses.dataclass
class TrainRun:
    cell: object
    seed: int
    device: torch.device
    model: object
    opt: object
    params: dict
    opt_state: dict
    step_fn: object
    done: int = 0
    metrics: dict = None

    def batch(self, i: int) -> dict:
        return train_batch(self.cell.sizes, self.cell.traffic, self.seed, i, self.device)

    def step(self) -> float:
        with torch.profiler.record_function("bench.train"):
            batch = self.batch(self.done)
            self.params, self.opt_state, self.metrics = self.step_fn(self.params, self.opt_state,
                                                                     batch)
            loss = self.metrics["loss"].item()  # waits for the step, as the program's TrainJob does
        self.done += 1
        return loss

    @property
    def positions(self) -> int:
        t = self.cell.traffic
        return t["batch"] * (t["seq_len"] + t.get("frames", 0))


def build(cell, seed: int, device) -> TrainRun:
    from repro_torch.models import ExecConfig, TrainModel
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import make_train_step

    t = cell.traffic
    device = torch.device(device)
    exec_cfg = ExecConfig(attn_impl="cuda", rec_chunk=t["rec_chunk"],
                          interpret=device.type == "cpu")
    model = TrainModel(program_config(cell), exec_cfg, device=device, seed=0)
    params = model.params()
    weights.load_into(params, cell.reference().recipe(cell.sizes), seed)
    opt = AdamW(lr=cosine_schedule(t["lr"], t["warmup"], t["total_steps"]), **t["adamw"])
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, microbatches=1, logits_chunk=exec_cfg.logits_chunk)
    return TrainRun(cell, seed, device, model, opt, params, opt_state, step_fn)


@torch.no_grad()
def _change_norms(run: TrainRun) -> dict:
    recipe = run.cell.reference().recipe(run.cell.sizes)
    out = {}
    for i in range(len(recipe)):
        for name, p0 in weights.group_values(recipe, run.seed, i, run.device).items():
            out[name] = (run.params[name].float() - p0).norm()
    return {k: float(v) for k, v in out.items()}


def first_steps(run: TrainRun, n: int) -> dict:
    """Steps 1..n through the window's call and feed; returns the readings:
    each step's loss, each leaf's first gradient norm as AdamW got it
    (before its clipping: ||m|| / (1 − β1) after one step, over the clip
    scale that the step's global norm gives) and each leaf's change."""
    losses, grads = [], None
    for i in range(n):
        losses.append(run.step())
        if i == 0:
            names = sorted(run.params)
            norms = torch.stack([run.opt_state["m"][k].float().norm() for k in names])
            unclip = max(1.0, (float(run.metrics["grad_norm"]) + 1e-12) / run.opt.clip_norm)
            grads = dict(zip(names, (norms * unclip / (1 - run.opt.b1)).tolist()))
    return {"loss": losses, "grad": grads, "change": _change_norms(run)}


def run_window(run: TrainRun, seconds: float) -> dict:
    """Steps back to back until ``seconds`` have passed; the rate is over all
    the steps and all their time."""
    failed = 0
    t0 = time.perf_counter()
    n = 0
    while True:
        loss = run.step()
        n += 1
        failed += not math.isfinite(loss)
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    return {"steps": n, "seconds": elapsed, "failed": failed,
            "positions": n * run.positions}


def free(run: TrainRun) -> None:
    run.model = run.opt = run.params = run.opt_state = run.step_fn = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _leaf_gaps(prog: dict, ref: dict, names: list) -> dict:
    """|prog − ref| / max(ref, median ref) of each leaf in ``names``."""
    med = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers ``correct`` may be decided on (a cell's limits say which
    are): the worst step's relative loss gap and the first step's; the
    worst and the median
    leaf's gap of the first gradient's norm and of the change's norm.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's (round-off moves them under AdamW) are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"]))
    names = sorted(ref["grad"])
    med = statistics.median(ref["grad"].values())
    grad = _leaf_gaps(prog["grad"], ref["grad"], names)
    change = _leaf_gaps(prog["change"], ref["change"],
                        [k for k in names if ref["grad"][k] >= 1e-3 * med])
    worst_g, worst_c = max(grad, key=grad.get), max(change, key=change.get)
    first = abs(prog["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0])
    return {"loss_gap": loss, "loss_gap_first": first,
            "grad_gap": grad[worst_g], "change_gap": change[worst_c],
            "grad_gap_median": statistics.median(grad.values()),
            "change_gap_median": statistics.median(change.values()),
            "worst_grad_leaf": worst_g, "worst_change_leaf": worst_c}


def reference(cell, seed: int, device, prec: str = "fp32") -> dict:
    t = cell.traffic
    batches = [train_batch(cell.sizes, t, seed, i, device) for i in range(t["ref_steps"])]
    return reference_train(cell, seed, batches, device, prec)
