"""TunedStep — PATSMA wired into a step function, as in the JAX package's
``repro.core.tuned_jit`` (the file keeps its name so a reader finds the
counterpart).

The *target method* is a step produced by a ``step_factory(knobs) -> step``
(knobs are the step's build arguments: microbatch count, kernel block
sizes, ...).  Here the factory builds an eager PyTorch step; where the JAX
factory returns a jitted one, ``ignore=1`` absorbed XLA compilation, and here
it absorbs a candidate's first-call warm-up (allocator growth, cuBLAS
handles, the kernels' first build).

* **Single Iteration mode** (paper Fig. 1a): call the :class:`TunedStep` as
  your training step.  While tuning is live, each real step evaluates one
  candidate; afterwards the best step runs with zero overhead.
* **Entire Execution mode** (paper Fig. 1b): call :meth:`tune` with a replica
  batch before the loop.

Persistent warm-start: pass ``db=`` (``repro_torch.tuning.TuningDB``) plus
either an explicit ``key=`` or ``name=``/``key_extra=`` to fingerprint the
step (with ``device=``, the key names the card; without it the CPU).  A
prior run's result is then replayed (exact hit: tuning is skipped entirely)
or seeds the search, and new results are committed back automatically.

Each candidate's step is built once and memoized, so a revisited candidate
is not rebuilt.  Completion is awaited with ``core.measure.block_until_ready``
over the step's whole output, e.g. ``(params, opt_state, metrics)``.

**Adaptive runtime mode** (``runtime="adaptive"``): calls route through a
:class:`repro_torch.runtime.online.OnlineTuner` — while the search is live an
ε-fraction of steps measures a candidate (``epsilon=1.0`` by default, the
classic Single-Iteration behaviour); once converged, step times stream into
a :class:`repro_torch.runtime.drift.DriftDetector`, and sustained
degradation triggers ``reset(level)`` plus a half-budget warm re-search.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from .autotuning import Autotuning
from .measure import block_until_ready
from .optimizer import NumericalOptimizer
from .space import SearchSpace

__all__ = ["TunedStep"]


class TunedStep:
    def __init__(
        self,
        step_factory: Callable[..., Callable],
        space: SearchSpace,
        *,
        ignore: int = 1,
        num_opt: int = 4,
        max_iter: int = 10,
        search=None,
        optimizer: Optional[NumericalOptimizer] = None,
        strategy: Optional[str] = None,
        cache: bool = True,
        seed: int = 0,
        verbose: bool = False,
        on_candidate: Optional[Callable[[dict], None]] = None,
        db=None,
        key=None,
        name: Optional[str] = None,
        key_extra: Optional[dict] = None,
        device=None,
        warm_start: bool = True,
        runtime: Optional[str] = None,
        epsilon: float = 1.0,
        drift=None,
        warm_frac: float = 0.5,
        measure=None,
    ) -> None:
        if db is not None and key is None and name is not None:
            # fingerprint a step by its name + knob space + caller context
            from repro_torch.tuning import make_key

            dev = torch.device(device if device is not None else "cpu")
            backend, kind = ("cuda", torch.cuda.get_device_name(dev)) if dev.type == "cuda" \
                else ("cpu", "cpu")
            key = make_key(name, space=space, extra=key_extra, backend=backend, device_kind=kind)
        given = [v for v in (search, optimizer, strategy) if v is not None]
        if len(given) > 1:
            raise ValueError(
                "pass a single search method (optimizer= and strategy= are "
                "aliases of search=)"
            )
        self._factory = step_factory
        self.at = Autotuning(
            ignore=ignore,
            space=space,
            num_opt=num_opt,
            max_iter=max_iter,
            search=given[0] if given else None,
            cache=cache,
            seed=seed,
            verbose=verbose,
            db=db,
            key=key,
            warm_start=warm_start,
        )
        self._steps: dict = {}  # knobs key -> built step
        self._on_candidate = on_candidate
        self._online = None
        if runtime is not None:
            if runtime != "adaptive":
                raise ValueError(f"unknown runtime mode {runtime!r} (use 'adaptive')")
            # late import: repro_torch.runtime depends on repro_torch.core
            from repro_torch.runtime.drift import DriftDetector
            from repro_torch.runtime.online import OnlineTuner

            if not isinstance(drift, DriftDetector):
                drift = DriftDetector(**(drift or {}))
            self._online = OnlineTuner(
                self.at,
                epsilon=epsilon,
                drift=drift,
                warm_frac=warm_frac,
                name=name or "tuned_step",
                measure=measure,
            )

    # ------------------------------------------------------------------ api
    @property
    def finished(self) -> bool:
        return self.at.finished

    @property
    def knobs(self) -> dict:
        return self.at.point

    @property
    def best_knobs(self) -> dict:
        return self.at.best_point

    def reset(self, level: int = 0) -> None:
        self.at.reset(level)

    def _step_for(self, knobs: dict) -> Callable:
        key = self.at.space.key(knobs)
        step = self._steps.get(key)
        if step is None:
            step = self._factory(**knobs)
            self._steps[key] = step
        return step

    @property
    def online(self):
        """The adaptive-mode :class:`OnlineTuner` (None in classic mode)."""
        return self._online

    @property
    def drift_events(self) -> list:
        return list(self._online.events) if self._online is not None else []

    def __call__(self, *args, **kwargs):
        """Single Iteration mode: run one (possibly tuning) step."""
        if self._online is not None:
            return self._adaptive_call(args, kwargs)
        knobs = self.at.start()
        if self._on_candidate is not None:
            self._on_candidate(knobs)
        step = self._step_for(knobs)
        out = step(*args, **kwargs)
        self.at.end(out)  # blocks on out; no-op once finished
        return out

    def _adaptive_call(self, args: tuple, kwargs: dict):
        """Adaptive runtime mode: explore/exploit via the online tuner, with
        drift-triggered warm re-searches.  ``ignore`` still absorbs a fresh
        candidate's warm-up: explore costs flow through ``Autotuning.exec``."""
        decision = self._online.begin()
        knobs = dict(decision.point)
        if self._on_candidate is not None:
            self._on_candidate(knobs)
        step = self._step_for(knobs)
        t0 = time.perf_counter()
        out = step(*args, **kwargs)
        block_until_ready(out)
        self._online.observe(decision, time.perf_counter() - t0)
        return out

    def tune(self, *replica_args, **replica_kwargs) -> dict:
        """Entire Execution mode: run the whole tuning loop on replica args."""
        while not self.at.finished:
            knobs = self.at.start()
            if self._on_candidate is not None:
                self._on_candidate(knobs)
            step = self._step_for(knobs)
            out = step(*replica_args, **replica_kwargs)
            self.at.end(out)
        return self.at.point

