"""Fault-tolerant training driver, as in the JAX package's
``repro.runtime.driver``.

Wires together the substrates: data pipeline, train step, checkpointing
(async, atomic, keep-k), PATSMA auto-tuning of step knobs (Single-Iteration
mode riding the training loop — paper Fig. 1a), and the step-time watchdog
that calls ``Autotuning.reset(level)`` when the environment drifts
(straggler mitigation: the paper's reset semantics).  With
``runtime="adaptive"`` the drift handling moves inside the
:class:`~repro_torch.core.TunedStep` (an ``OnlineTuner`` + ``DriftDetector``
doing a warm half-budget re-search) and the watchdog only observes.

Crash/preemption recovery: the driver resumes from the newest complete
checkpoint; the data pipeline is a pure function of (seed, step), so the
replayed trajectory is identical.

The job runs on ``device`` (the card unless the caller asks for the CPU).
Its default ``exec_cfg`` is the JAX launcher's ``ExecConfig(rec_chunk=8)``
on the kernels (``attn_impl="cuda"``), with ``interpret`` (the kernels'
plain versions) only on the CPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import SearchSpace, TunedStep
from repro_torch.core.measure import block_until_ready
from repro_torch.core.space import ChoiceDim
from repro_torch.data import make_batch_for
from repro_torch.models import ExecConfig, TrainModel
from repro_torch.optim import AdamW, cosine_schedule, tree_leaves
from repro_torch.train import make_train_step

__all__ = ["TrainJob", "Watchdog"]


class Watchdog:
    """EWMA step-time monitor.  ``check`` returns an escalation level when the
    current step time drifts beyond ``factor``× the smoothed time (0 = fine)."""

    def __init__(self, factor: float = 1.8, alpha: float = 0.2, warmup: int = 3):
        self.factor = factor
        self.alpha = alpha
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self.n = 0
        self.events: list = []

    def check(self, dt: float, step: int) -> int:
        self.n += 1
        if self.ewma is None:
            self.ewma = dt
            return 0
        level = 0
        if self.n > self.warmup and dt > self.factor * self.ewma:
            level = 1 if dt < 2 * self.factor * self.ewma else 2
            self.events.append({"step": step, "dt": dt, "ewma": self.ewma, "level": level})
        # don't fold outliers into the smoothed estimate
        if level == 0:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return level


@dataclasses.dataclass
class TrainJob:
    arch: str = "qwen2_7b"
    tiny: bool = True
    steps: int = 50
    global_batch: int = 8
    seq_len: int = 64
    lr: float = 1e-3
    warmup: int = 10
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 20
    ckpt_keep: int = 2
    ckpt_async: bool = True
    # PATSMA integration (Single Iteration mode over step knobs)
    tune: bool = False
    tune_microbatches: tuple = (1, 2, 4)
    tune_max_iter: int = 4
    tune_num_opt: int = 3
    tune_db: Optional[str] = None  # tuning DB path: warm-start knobs across runs
    ignore: int = 1
    watchdog_factor: float = 1.8
    # runtime="adaptive": the TunedStep owns drift handling (OnlineTuner +
    # DriftDetector with a warm half-budget re-search) instead of the
    # external watchdog->reset wiring below; epsilon rations how many steps
    # measure a candidate while a search is live (1.0 = classic behaviour)
    runtime: Optional[str] = None
    tune_epsilon: float = 1.0
    drift: Optional[dict] = None  # DriftDetector kwargs for adaptive mode
    device: str = "cuda"
    exec_cfg: Optional[ExecConfig] = None  # None: the kernels, rec_chunk 8 (module doc)
    # stop this many steps after the tuning finishes (None: run every step)
    stop_after_tuned: Optional[int] = None
    # test hooks
    delay_hook: Optional[Callable[[int], None]] = None

    def build(self):
        dev = torch.device(self.device)
        cfg = configs.get_tiny(self.arch) if self.tiny else configs.get(self.arch)
        exec_cfg = self.exec_cfg or ExecConfig(attn_impl="cuda", rec_chunk=8,
                                               interpret=dev.type == "cpu")
        model = TrainModel(cfg, exec_cfg, device=dev, seed=self.seed)
        opt = AdamW(lr=cosine_schedule(self.lr, self.warmup, self.steps))
        params = model.params()
        opt_state = opt.init(params)
        return cfg, model, opt, params, opt_state

    def run(self, on_step: Optional[Callable] = None) -> dict:
        """Train; ``on_step(step, metrics)`` is called after every step (the
        parameters and optimizer state are in ``self.state`` then).  Returns
        the history: per-step ``loss``, ``step_time``, ``steps`` and the
        ``knobs`` each step ran, plus ``resets``, ``final_knobs``,
        ``watchdog_events``, ``db_hit`` (the tuning DB held the answer, so
        nothing was searched) and ``tuned_at`` (the first step after the
        tuning finished, or None)."""
        cfg, model, opt, params, opt_state = self.build()
        self.state = (params, opt_state)
        start_step = 0
        ckpt = CheckpointManager(self.ckpt_dir, keep=self.ckpt_keep) if self.ckpt_dir else None
        if ckpt is not None and ckpt.latest_step() is not None:
            loaded, step_loaded, _ = ckpt.restore((params, opt_state))
            with torch.no_grad():
                for dst, src in zip(tree_leaves((params, opt_state)), tree_leaves(loaded)):
                    dst.copy_(src)
            del loaded
            start_step = step_loaded + 1

        def factory(microbatches=1):
            return make_train_step(model, opt, microbatches=microbatches,
                                   logits_chunk=model.exec_cfg.logits_chunk)

        ran = {"knobs": {}}
        tuned: Optional[TunedStep] = None
        if self.tune:
            valid_mbs = tuple(
                m for m in self.tune_microbatches if self.global_batch % m == 0
            ) or (1,)
            space = SearchSpace([ChoiceDim("microbatches", valid_mbs)])
            db = None
            if self.tune_db is not None:
                from repro_torch.tuning import TuningDB

                db = TuningDB(self.tune_db)
            tuned = TunedStep(
                factory,
                space,
                ignore=self.ignore,
                num_opt=self.tune_num_opt,
                max_iter=self.tune_max_iter,
                cache=True,
                seed=self.seed,
                on_candidate=lambda knobs: ran.update(knobs=dict(knobs)),
                db=db,
                name=f"train_step/{self.arch}",
                key_extra={
                    "tiny": self.tiny,
                    "global_batch": self.global_batch,
                    "seq_len": self.seq_len,
                },
                device=self.device,
                runtime=self.runtime,
                epsilon=self.tune_epsilon,
                drift=self.drift,
            )
        else:
            step_fn = factory()

        watchdog = Watchdog(factor=self.watchdog_factor)
        # a fresh search is finished before its first step only on an exact DB hit
        db_hit = tuned is not None and tuned.finished
        history = {"loss": [], "step_time": [], "resets": [], "steps": [], "knobs": [],
                   "db_hit": db_hit, "tuned_at": start_step if db_hit else None}
        for step in range(start_step, self.steps):
            batch = make_batch_for(cfg, self.global_batch, self.seq_len, step, self.seed,
                                   device=self.device)
            t0 = time.perf_counter()
            if self.delay_hook is not None:
                self.delay_hook(step)  # inside the timed window (straggler sim)
            if tuned is not None:
                params, opt_state, metrics = tuned(params, opt_state, batch)
            else:
                params, opt_state, metrics = step_fn(params, opt_state, batch)
            block_until_ready(metrics["loss"])
            dt = time.perf_counter() - t0
            level = watchdog.check(dt, step)
            if (
                level
                and tuned is not None
                and tuned.finished
                and tuned.online is None  # adaptive mode resets itself
            ):
                # environment drift: re-enter tuning (paper reset semantics)
                tuned.reset(level - 1)
                history["resets"].append({"step": step, "level": level - 1})
            history["loss"].append(float(metrics["loss"]))
            history["step_time"].append(dt)
            history["steps"].append(step)
            history["knobs"].append(dict(ran["knobs"]) if tuned is not None else {})
            if on_step is not None:
                on_step(step, metrics)
            if ckpt is not None and (step + 1) % self.ckpt_every == 0:
                payload = (params, opt_state)
                if self.ckpt_async:
                    ckpt.save_async(step, payload, extra={"loss": float(metrics["loss"])})
                else:
                    ckpt.save(step, payload, extra={"loss": float(metrics["loss"])})
            if tuned is not None and tuned.finished and history["tuned_at"] is None:
                history["tuned_at"] = step + 1
            if (self.stop_after_tuned is not None and history["tuned_at"] is not None
                    and step + 1 >= history["tuned_at"] + self.stop_after_tuned):
                break
        if ckpt is not None:
            ckpt.wait()
            ckpt.save(history["steps"][-1] if history["steps"] else self.steps - 1,
                      (params, opt_state))
        history["final_knobs"] = tuned.best_knobs if tuned is not None else {}
        history["watchdog_events"] = watchdog.events
        if tuned is not None and tuned.online is not None:
            # drift resets happened inside the TunedStep; surface them in the
            # same shape the watchdog path uses (seq counts calls from resume)
            for ev in tuned.drift_events:
                history["resets"].append(
                    {"step": start_step + ev["seq"] - 1, "level": ev["level"]}
                )
            history["online_stats"] = tuned.online.stats()
        return history
