"""The ``Autotuning`` driver — PATSMA's user-facing class (paper §2.3/§2.4).

Execution modes (paper Fig. 1):

  * **Single Iteration** (Fig. 1a): one auto-tuning iteration per natural
    iteration of the target loop — ``single_exec_runtime`` /
    ``single_exec``, or the raw ``start()``/``end()`` brackets.
  * **Entire Execution** (Fig. 1b): the full tuning loop is run up-front on a
    replica of the target — ``entire_exec_runtime`` / ``entire_exec``.

Each mode has a **Runtime** flavour (PATSMA measures the wall time of the
bracketed section itself — adapted here by synchronizing the CUDA device the
result lives on, so asynchronous kernel launches do not hide the cost) and a
user-cost flavour
(``exec(cost)`` — the application supplies any cost it likes).

``ignore`` (paper §2.3): per candidate solution, the first ``ignore`` target
iterations are measured and discarded so execution stabilizes (first-launch
and allocator warm-up costs land there).  Evaluation counts follow paper
Eq. (1)/(2).

Beyond-paper (flagged, default off → faithful): ``cache=True`` memoizes cost
by decoded point so the optimizer never re-measures a revisited candidate.

Persistent warm-start (beyond-paper, default off → faithful): pass ``db=``
(a :class:`repro_torch.tuning.TuningDB`) and ``key=`` (a context fingerprint from
``repro_torch.tuning.make_key``).  An exact key hit adopts the stored best with
**zero** measurements; a near-miss (same computation/hardware, different
shapes) seeds the optimizer around the stored point and halves the budget.
When tuning finishes the result is committed back to the DB automatically.
"""
from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.obs import events as _events
from repro_torch.obs.log import get_logger
from repro_torch.obs.trace import tracer as _tracer

log = get_logger(__name__)

from .csa import CSA
from .measure import block_until_ready
from .nelder_mead import NelderMead
from .optimizer import NumericalOptimizer
from .space import SearchSpace

__all__ = ["Autotuning"]


def _known_std(record) -> Optional[float]:
    """A record's meaningful measurement std (see TuningRecord.known_std)."""
    return record.known_std()


class Autotuning:
    """Paper API::

        Autotuning(min, max, ignore, dim, num_opt, max_iter)      # default CSA
        Autotuning(min, max, ignore, search=<spec | optimizer | strategy>)

    plus the extended form ``Autotuning(space=SearchSpace(...), ...)``.

    ``search=`` is the single knob picking the search method.  It accepts

    * a **spec string** (``"csa+nm"``, ``"csa:0.7+nm:0.3"``, ``"csa|nm"``)
      parsed by :func:`repro_torch.core.strategy.make_strategy` — the paper's
      CSA→NM hybrid as a staged pipeline, portfolios, ... — over the same
      ``num_opt * max_iter`` tell budget the default CSA consumes;
    * a raw :class:`~repro_torch.core.optimizer.NumericalOptimizer` instance;
    * any :data:`~repro_torch.core.strategy.SearchStrategy` object (pipelines
      and portfolios are themselves optimizers).

    The legacy ``optimizer=`` / ``strategy=`` kwargs remain as deprecated
    aliases of ``search=`` (they emit a ``DeprecationWarning`` and stay
    trajectory-identical); passing more than one of the three is an error.
    The resolved spec is exposed as :attr:`strategy` and stamped on
    committed tuning records.  Decoded points are dicts
    ``{dim_name: value}``; the paper-style vector form is available via
    ``point_vector``.
    """

    def __init__(
        self,
        min: Any = -1.0,  # noqa: A002 - paper parameter names
        max: Any = 1.0,  # noqa: A002
        ignore: int = 0,
        dim: int = 1,
        num_opt: int = 4,
        max_iter: int = 20,
        *,
        search: Any = None,
        optimizer: Optional[NumericalOptimizer] = None,
        strategy: Any = None,
        space: Optional[SearchSpace] = None,
        integer: bool = True,
        seed: int = 0,
        cache: bool = False,
        verbose: bool = False,
        db=None,
        key=None,
        warm_start: bool = True,
        db_source: str = "online",
        objective: Optional[str] = None,
    ) -> None:
        if ignore < 0:
            raise ValueError("ignore must be >= 0")
        self.space = space if space is not None else SearchSpace.uniform(
            min, max, dim, integer=integer
        )
        d = len(self.space)
        given = [n for n, v in (
            ("search", search), ("optimizer", optimizer), ("strategy", strategy)
        ) if v is not None]
        if len(given) > 1:
            raise ValueError(
                f"pass a single search method, got {' and '.join(given)} "
                "(optimizer= and strategy= are deprecated aliases of search=)"
            )
        if optimizer is not None or strategy is not None:
            alias = "optimizer" if optimizer is not None else "strategy"
            warnings.warn(
                f"Autotuning({alias}=...) is deprecated; pass the same value "
                "as search= (spec string, optimizer, or SearchStrategy)",
                DeprecationWarning,
                stacklevel=2,
            )
            search = optimizer if optimizer is not None else strategy
        if isinstance(search, str):
            from .strategy import make_strategy

            search = make_strategy(
                search, d, num_opt=num_opt, max_iter=max_iter, seed=seed
            )
        self.optimizer = search if search is not None else CSA(
            d, num_opt=num_opt, max_iter=max_iter, seed=seed
        )
        # provenance spec stamped on committed TuningRecords (records.strategy)
        from .strategy import strategy_label

        self.strategy = getattr(self.optimizer, "spec", None) or strategy_label(
            self.optimizer
        )
        # the statistic the fed costs minimize ("median" | "p95" | "p99" |
        # None = unknown/user cost) — pure provenance here, stamped on
        # committed TuningRecords; the measurement layer computes it
        self.objective = str(objective).strip().lower() if objective else None
        if self.optimizer.get_dimension() != d:
            raise ValueError(
                f"optimizer dim {self.optimizer.get_dimension()} != space dim {d}"
            )
        self.ignore = int(ignore)
        self.verbose = verbose
        self._use_cache = bool(cache)
        self._cost_cache: dict = {}
        self._t0: Optional[float] = None
        self._ignore_left = self.ignore
        self._evals = 0  # completed cost evaluations fed to the optimizer
        self._measurements = 0  # target iterations spent on tuning (incl. ignored)
        self._history: list = []  # (point_dict, cost)
        self.skip_reasons: dict = {}  # reason -> count of tagged skip() calls
        # declarative validity predicates (space.constraints): candidates a
        # predicate rejects are charged inf via skip(reason="constraint") at
        # zero compile/measure cost — before measure_batch ever sees them
        self.constraint_violations: dict = {}  # constraint name -> prune count
        self._constraint_keys: set = set()  # space.key of pruned points
        self._in_constraint_skip = False  # re-entrancy guard for _skip_invalid
        self._round_no = 0  # batch round counter (obs candidate_asked events)
        self._measure_meta: dict = {}  # space.key -> measurement bookkeeping
        self._measured_costs: dict = {}  # space.key -> last *real* measured cost
        # persistent tuning store (repro_torch.tuning): exact hit / warm seed
        self.db = db
        self.key = key
        self._db_source = str(db_source)  # provenance stamped on auto-commit
        self._db_hit = None  # record adopted wholesale (exact fingerprint hit)
        self._db_seeded = False  # near-miss: optimizer seeded + budget shrunk
        self._committed = False
        if db is not None and key is not None and warm_start:
            rec, exact = db.lookup(key)
            if exact and rec is not None:
                self._db_hit = rec
                self._point = dict(rec.point)
                if self.verbose:
                    log.info("db hit %s (cost %.6g); skipping tuning",
                             rec.point, rec.cost)
                _events.emit("warm_start", name=self.ctx_name(),
                             kind="exact", point=dict(rec.point))
                return  # finished before the first measurement
            if rec is not None:
                from repro_torch.tuning.warm_start import apply_warm_start

                self._db_seeded = apply_warm_start(self.space, self.optimizer, rec)
                if self._db_seeded:
                    if self.verbose:
                        log.info("warm start from neighbor %s", rec.point)
                    _events.emit("warm_start", name=self.ctx_name(),
                                 kind="neighbor", point=dict(rec.point))
        # prime: first run() call's cost is ignored by contract
        self._z = self.optimizer.run(np.nan)
        self._point = self.space.decode(self._z)
        self._advance_through_cache()

    def ctx_name(self) -> str:
        """Stable label for this search in spans and the obs event stream
        (the DB key's name + shapes when tuning a fingerprinted context)."""
        if self.key is not None:
            try:
                return f"{self.key.name}{self.key.shapes()}"
            except Exception:
                return str(getattr(self.key, "name", self.key))
        return f"search@{id(self):x}"

    # ----------------------------------------------------------- properties
    @property
    def finished(self) -> bool:
        return self._db_hit is not None or self.optimizer.is_end()

    @property
    def warm_started(self) -> bool:
        """True if a stored record shaped this run (exact hit or neighbor seed)."""
        return self._db_hit is not None or self._db_seeded

    @property
    def point(self) -> dict:
        """Current candidate (or final solution once finished), decoded."""
        return dict(self._point)

    @property
    def point_vector(self) -> list:
        return list(self._point.values())

    def _history_best(self):
        """(point, cost) of the best delivered measurement, (None, inf) if
        none.  The optimizer's own best can lag behind this by up to one
        batch round: the ``run`` adapter buffers costs until a full
        ask/tell round is delivered, so a driver that stops mid-round
        (e.g. a short serving stream) would otherwise under-report."""
        best_p, best_c = None, np.inf
        for p, c in self._history:
            if c < best_c:
                best_p, best_c = p, c
        return best_p, best_c

    @property
    def best_point(self) -> dict:
        if self._db_hit is not None:
            return dict(self._db_hit.point)
        hist_p, hist_c = self._history_best()
        opt_c = self.optimizer.best_cost
        if np.isfinite(opt_c) and opt_c <= hist_c:
            return self.space.decode(self.optimizer.best_solution)
        if hist_p is not None:
            return dict(hist_p)
        return dict(self._point)

    @property
    def best_cost(self) -> float:
        if self._db_hit is not None:
            return float(self._db_hit.cost)
        _, hist_c = self._history_best()
        return float(min(self.optimizer.best_cost, hist_c))

    @property
    def num_evals(self) -> int:
        return self._evals

    @property
    def num_measurements(self) -> int:
        return self._measurements

    @property
    def num_crashed(self) -> int:
        """Distinct visited candidates whose (final) cost was non-finite —
        i.e. configurations that crashed or were rejected by the measurement
        layer.  Constraint-pruned candidates are excluded: a validity
        predicate rejecting a point is the *space* working as declared, not a
        crash.  Surfaced on committed tuning records."""
        seen: dict = {}
        for p, c in self._history:
            seen[self.space.key(p)] = c
        return sum(
            1 for k, c in seen.items()
            if not np.isfinite(c) and k not in self._constraint_keys
        )

    @property
    def history(self) -> list:
        return list(self._history)

    def measurement_meta(self, point: Optional[dict] = None) -> Optional[dict]:
        """Measurement bookkeeping for ``point`` (default: the best point):
        ``{"cost_std", "repeats_spent", "culled", "pruned"}`` when the
        adaptive measurement engine (or a rich ``measure_batch``) delivered a
        :class:`~repro_torch.core.measure.MeasureResult` for it; ``None`` for
        plain-float costs, DB hits, and points this run never measured.  A
        ``pruned="roofline"`` entry marks a candidate that was charged its
        analytic bound without a single repetition — cleared (so the point is
        re-measured) by ``reset(level >= 1)``."""
        if point is None:
            point = self.best_point
        try:
            k = self.space.key({n: point[n] for n in self.space.names})
        except Exception:
            return None
        meta = self._measure_meta.get(k)
        return dict(meta) if meta is not None else None

    def reset(
        self,
        level: int = 0,
        *,
        warm_point: Optional[dict] = None,
        budget_frac: Optional[float] = None,
        spread: float = 0.2,
        refine: bool = False,
    ) -> None:
        """Re-enter tuning (e.g. when the watchdog detects environment drift).

        Forwards to the optimizer's reset (paper §2.2) and clears the cost
        cache: a drift reset means the old measurements no longer describe
        the environment, and a kept cache would answer every revisited
        candidate instantly — finishing the "re-tune" with zero fresh
        measurements and committing pre-drift data to the DB.  At
        ``level >= 1`` the measurement history is dropped for the same
        reason (level 0 retains found solutions per the paper, so their
        record stays).

        ``warm_point`` turns the reset into a *warm re-search*: the
        optimizer is re-seeded around the given decoded point (normally the
        pre-drift best, which is already deployed) and, with ``budget_frac``,
        its budget is shrunk — the online-tuning analogue of the DB
        near-miss warm start.

        ``refine=True`` asks a staged strategy to re-enter through its final
        *refinement* stage alone (``Pipeline.enter_refinement``) instead of
        resetting at ``level`` — the environment-drift response: the optimum's
        basin is assumed unchanged, so a local NM walk from ``warm_point``
        beats re-running the global stage.  Optimizers without a refinement
        stage fall back to the plain ``reset(level)``."""
        refiner = getattr(self.optimizer, "enter_refinement", None) if refine else None
        if refiner is not None and refiner():
            pass  # the strategy re-entered via its refinement stage
        else:
            self.optimizer.reset(level)
        self._cost_cache.clear()
        if level >= 1:
            self._constraint_keys.clear()  # derived from the cleared history
            self._history.clear()
            # measurement bookkeeping is pre-drift data too: in particular a
            # roofline-pruned candidate (charged its analytic bound, never
            # run) must be eligible for a real measurement in the re-search
            self._measure_meta.clear()
            self._measured_costs.clear()
        # a reset means the environment drifted: re-enter real tuning even if
        # this run was answered from the DB, and allow a fresh commit
        self._db_hit = None
        self._committed = False
        self._t0 = None
        self._ignore_left = self.ignore
        if warm_point is not None:
            from repro_torch.tuning.warm_start import effective_spread

            try:
                z0 = self.space.encode(warm_point)
            except Exception:
                z0 = None  # incompatible point (renamed dims): cold restart
            if z0 is not None and self.optimizer.seed(
                z0, spread=effective_spread(self.space, spread)
            ):
                if budget_frac is not None and budget_frac < 1.0:
                    self.optimizer.shrink_budget(budget_frac)
        self._z = self.optimizer.run(np.nan)
        self._point = self.space.decode(self._z)
        self._advance_through_cache()

    def print(self) -> None:  # noqa: A003 - paper API name
        self.optimizer.print()

    # ------------------------------------------------- start/end (Runtime)
    def start(self) -> dict:
        """Begin the measured section; returns the candidate to use."""
        self._skip_invalid()
        if not self.finished:
            self._t0 = time.perf_counter()
        return self.point

    def end(self, result: Any = None) -> None:
        """End the measured section (blocks on ``result`` if given)."""
        if self.finished or self._t0 is None:
            return
        block_until_ready(result)  # wall time includes the device work
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._feed(dt)

    # ------------------------------------------------------ exec (user cost)
    def exec(self, cost: float) -> dict:  # noqa: A003 - paper API name
        """Deliver a user-computed cost for the current candidate; returns the
        next candidate (paper §2.4: cost is always associated with the last
        returned solution)."""
        if not self.finished:
            self._feed(float(cost))
        self._skip_invalid()
        return self.point

    def skip(
        self,
        cost: float = np.inf,
        *,
        reason: Optional[str] = None,
        detail: Optional[str] = None,
    ) -> dict:
        """Reject the current candidate outright and advance to the next one.

        Unlike :meth:`exec`, the cost is delivered immediately — ``ignore``
        stabilization is bypassed, because no target iteration actually ran.
        Used by the online tuner when a candidate's executable fails to
        build: the candidate is charged ``inf`` without spending a serving
        request on it.  The charge is *not* written to the cost cache — a
        failure may be transient (compile resource pressure), so a revisited
        candidate must be offered for a fresh build attempt rather than have
        the cached ``inf`` replayed for the rest of the search.

        ``reason`` tags the rejection for run summaries (``skip_reasons``):
        the resilience layer distinguishes ``"build-failed"``, ``"timeout"``,
        and ``"quarantined"`` skips when reporting why a search starved;
        the constraint layer charges predicate-pruned candidates through
        ``reason="constraint"`` with the violated predicate as ``detail``."""
        if not self.finished:
            if reason is not None:
                self.skip_reasons[reason] = self.skip_reasons.get(reason, 0) + 1
                if self.verbose:
                    log.info("skip %s (%s)", self._point, reason)
                if reason == "quarantined":
                    _events.emit("candidate_quarantined",
                                 name=self.ctx_name(), point=dict(self._point))
                elif detail is not None:
                    _events.emit("candidate_skipped", name=self.ctx_name(),
                                 point=dict(self._point), reason=str(reason),
                                 detail=str(detail))
                else:
                    _events.emit("candidate_skipped", name=self.ctx_name(),
                                 point=dict(self._point), reason=str(reason))
            self._deliver(float(cost), cacheable=False)
        self._skip_invalid()
        return self.point

    def note(self, point: dict, cost: float) -> None:
        """Record an out-of-band measurement into this run's history.

        The optimizer is *not* fed — this is for costs observed outside the
        search itself, e.g. the live serving cost of the currently deployed
        point right after a drift reset.  It gives :attr:`best_point` /
        :meth:`commit` an honest, current-environment view of points the
        (re-)search has not visited yet: a warm re-search that fails to beat
        the incumbent still commits the incumbent at its *fresh* cost."""
        missing = [n for n in self.space.names if n not in point]
        if missing:
            raise ValueError(f"note(): point is missing dims {missing}")
        self._history.append(
            ({n: point[n] for n in self.space.names}, float(cost))
        )

    # --------------------------------------------------------- cost plumbing
    def _feed(self, cost: float) -> None:
        self._measurements += 1
        if self._ignore_left > 0:  # stabilization iterations (paper `ignore`)
            self._ignore_left -= 1
            return
        self._deliver(cost, cacheable=True)

    def _deliver(self, cost: float, cacheable: bool) -> None:
        key = self.space.key(self._point)
        if cacheable and self._use_cache:
            self._cost_cache[key] = cost
        self._evals += 1
        self._history.append((dict(self._point), float(cost)))
        if self.verbose:
            log.info("eval#%d %s -> %.6g", self._evals, self._point, cost)
        self._z = self.optimizer.run(cost)
        self._point = self.space.decode(self._z)
        self._ignore_left = self.ignore
        if self.optimizer.is_end():
            self.commit()
        self._advance_through_cache()

    def _visited(self, point: dict) -> bool:
        """Whether ``point`` was measured (or noted) during this run."""
        try:
            k = self.space.key({n: point[n] for n in self.space.names})
        except Exception:
            return False
        return any(self.space.key(p) == k for p, _ in self._history)

    def commit(self, *, source: Optional[str] = None, force: bool = False) -> bool:
        """Persist the current best into the attached tuning DB (idempotent;
        called automatically when the optimizer finishes).  ``source``
        defaults to the constructor's ``db_source`` provenance label.

        Clobber guard: if the DB already holds a *better* record for this
        key whose point this run never re-measured (so nothing says it
        stopped being good — e.g. a drifted, worse re-search that wandered
        elsewhere), the stored record is kept.  A run that did re-measure
        the stored point always wins — its best already accounts for that
        point under current conditions, so committing it is a refresh, not a
        clobber.  When both records carry measurement confidence
        (``cost_std``), a *near-tie* — the new best beats the stored cost by
        less than the larger of the two standard deviations — also keeps a
        lower-variance stored record: inside the noise band the
        better-trusted measurement wins, not the luckier one.  ``force=True``
        bypasses the guard.  Returns True iff a record was written."""
        if self.db is None or self.key is None or self._committed:
            return False
        if self._db_hit is not None:
            return False  # answered from the DB; nothing new to write back
        from repro_torch.tuning.warm_start import record_from

        rec = record_from(self, self.key, source=source or self._db_source)
        if rec is None:
            return False
        if not force:
            existing = self.db.get(self.key)
            if (
                existing is not None
                and existing.objective is not None
                and rec.objective is not None
                and existing.objective != rec.objective
            ):
                # tuned for a different statistic: a p99 cost and a median
                # cost are not comparable, so the clobber guard cannot
                # arbitrate — the caller changed what they optimize and the
                # fresh record wins
                existing = None
            if (
                existing is not None
                and np.isfinite(existing.cost)
                and not self._visited(existing.point)
            ):
                keep = existing.cost < rec.cost  # ties: fresher data wins
                if not keep:
                    # near-tie tiebreak: inside the noise band the better-
                    # measured record stands, symmetric in both directions.
                    # A single-rep record has *unknown* variance, not zero —
                    # its std must neither read as perfect confidence nor
                    # widen the band (see _known_std).
                    e_std = _known_std(existing)
                    r_std = _known_std(rec)
                    stds = [s for s in (e_std, r_std) if s is not None]
                    if stds and (existing.cost - rec.cost) <= max(stds):
                        if e_std is not None and (r_std is None or e_std < r_std):
                            keep = True  # the lower-variance record stands
                if keep:
                    self._committed = True  # nothing better to say for this run
                    return False
        with _tracer().span("commit"):
            self.db.put(rec)
        _events.emit("db_commit", name=self.ctx_name(),
                     point=dict(rec.point), cost=rec.cost)
        self._committed = True
        return True

    def _advance_through_cache(self) -> None:
        """If caching is on, answer revisited candidates from the cache."""
        if not self._use_cache:
            return
        guard = 0
        while not self.finished:
            key = self.space.key(self._point)
            if key not in self._cost_cache:
                return
            self._deliver(self._cost_cache[key], cacheable=False)
            guard += 1
            if guard > 100_000:  # safety: pathological optimizer loop
                return

    def _note_pruned(self, point: dict, violated: str) -> None:
        """Bookkeeping shared by both prune paths: the violated-predicate
        tally and the key set that keeps pruned points out of
        :attr:`num_crashed`."""
        self.constraint_violations[violated] = (
            self.constraint_violations.get(violated, 0) + 1
        )
        self._constraint_keys.add(self.space.key(point))

    def _skip_invalid(self) -> None:
        """Auto-skip constraint-invalid candidates before presenting one.

        Runs at the sequential presentation points (``start``/``exec``/
        ``skip``/``single_exec``) — *not* inside ``__init__``/``reset`` —
        so the batch ask/tell protocol never sees a half-delivered round:
        batch mode prunes inside :meth:`_batch_round` instead.  Each invalid
        candidate is charged ``inf`` through :meth:`skip`
        (``reason="constraint"``) with zero compile/measure cost, and is
        *not* cached, so ``reset(level >= 1)`` makes it revisitable."""
        if not self.space.constraints or self._in_constraint_skip:
            return
        self._in_constraint_skip = True
        try:
            guard = 0
            while not self.finished:
                violated = self.space.check(self._point)
                if violated is None:
                    return
                self._note_pruned(self._point, violated)
                self.skip(reason="constraint", detail=violated)
                guard += 1
                if guard > 100_000:  # safety: fully-infeasible space
                    return
        finally:
            self._in_constraint_skip = False

    # ------------------------------------------------- pre-programmed modes
    # Paper Algorithm 3.  `point_arg` semantics: the function receives the
    # decoded point dict's values in declaration order, prepended to *args
    # (paper: "the initial variable must serve as both input and output").
    def single_exec_runtime(self, func: Callable, *args, **kwargs):
        """One tuning iteration per call; PATSMA measures the runtime
        (paper ``singleExecRuntime``, Fig. 1a).  Returns func's result."""
        point = self.start()
        result = func(*self._point_args(point), *args, **kwargs)
        self.end(result)
        return result

    def single_exec(self, func: Callable, *args, **kwargs):
        """One tuning iteration per call; ``func`` returns the cost
        (paper ``singleExec``)."""
        self._skip_invalid()
        if self.finished:
            return func(*self._point_args(self.point), *args, **kwargs)
        cost = func(*self._point_args(self.point), *args, **kwargs)
        self.exec(float(cost))
        return cost

    def entire_exec_runtime(self, func: Callable, *args, **kwargs) -> dict:
        """Run the complete tuning loop now, measuring runtimes of replica
        executions (paper ``entireExecRuntime``, Fig. 1b).  Returns the final
        point."""
        while not self.finished:
            self.single_exec_runtime(func, *args, **kwargs)
        return self.point

    def entire_exec(self, func: Callable, *args, **kwargs) -> dict:
        """Run the complete tuning loop now with func-supplied costs
        (paper ``entireExec``)."""
        while not self.finished:
            self.single_exec(func, *args, **kwargs)
        return self.point

    # ----------------------------------------------------------- batch mode
    def entire_exec_batch(self, measure_batch: Callable) -> dict:
        """Entire Execution over the optimizer's batch protocol.

        Per round, :meth:`NumericalOptimizer.ask` yields the full set of
        candidates the optimizer needs next (CSA's m probes, NM's simplex).
        The round is **deduplicated by decoded point** — duplicates within the
        round, and (with ``cache=True``) candidates revisited from earlier
        rounds, are never re-measured — and the surviving unique points are
        handed to ``measure_batch(points) -> costs`` in one call, so the
        measurement layer can compile them concurrently.  ``ignore``
        stabilization calls are issued per round on the same unique points and
        discarded, matching the sequential modes' per-candidate accounting.

        ``measure_batch`` may return plain floats or
        :class:`~repro_torch.core.measure.MeasureResult` objects (the adaptive
        measurement engine's output): rich results contribute their ``cost``
        to the optimizer exactly like a float, while their bookkeeping
        (``cost_std``, ``repeats_spent``, racing/roofline flags) is kept per
        point — see :meth:`measurement_meta` — and ``num_measurements``
        counts the repetitions actually spent rather than one per point.

        The candidate trajectory, history, and final point are identical to
        :meth:`entire_exec` with a deterministic cost function (same seed ⇒
        same visited points); only the measurement schedule changes.  With a
        *speculative* optimizer (``NelderMead(speculative=True)``) the
        optimizer's internal ``evaluations`` budget stays bit-identical to
        the sequential run, but the driver-side ``num_evals``/``history``
        (and hence a committed record's ``evals``/``crashed``) honestly count
        every point that was actually measured, including speculative probes
        the optimizer discarded.
        """
        ctx = self.ctx_name()
        _events.emit("search_start", name=ctx)
        with _tracer().span("search", ctx=ctx):
            rounds = self._batch_loop(measure_batch)
        # expose the final solution as the current point (as the sequential
        # staging does once the optimizer ends) and persist it
        if self._db_hit is None and self.optimizer.is_end():
            self._z = self.optimizer.best_solution
            self._point = self.space.decode(self._z)
        self.commit()
        _events.emit(
            "search_end", name=ctx,
            best_point=dict(self.best_point) if self.best_point else None,
            best_cost=self.best_cost, evals=self._evals, rounds=rounds,
        )
        return self.point

    def _batch_loop(self, measure_batch: Callable) -> int:
        """The ask → dedup → measure → tell rounds of
        :meth:`entire_exec_batch`; returns how many rounds ran.  Each round
        runs under a ``round`` span so worker-side compile/measure spans
        nest where they belong."""
        round_no = 0
        while not self.finished:
            zs = self.optimizer.ask()
            if not zs:
                break
            round_no += 1
            self._round_no = round_no
            with _tracer().span("round", round=round_no):
                self._batch_round(zs, measure_batch)
        return round_no

    def _batch_round(self, zs, measure_batch: Callable) -> None:
        points = [self.space.decode(z) for z in zs]
        keys = [self.space.key(p) for p in points]
        self._z = zs[0]
        self._point = dict(points[0])
        # unique decoded points, in first-seen order
        unique: dict = {}
        for k, p in zip(keys, points):
            unique.setdefault(k, p)
        to_measure = [
            k for k in unique
            if not (self._use_cache and k in self._cost_cache)
        ]
        # constraint predicates run *before* compile/measure: invalid points
        # are charged inf here at zero cost — measure_batch never sees them.
        # The driver emits the asked/skipped event pair itself (the
        # measurement layer's emitter only sees the points it receives), so
        # the completeness identity asked == terminals keeps holding.
        pruned: dict = {}
        if self.space.constraints:
            for k in to_measure:
                violated = self.space.check(unique[k])
                if violated is None:
                    continue
                pruned[k] = float(np.inf)
                self.skip_reasons["constraint"] = (
                    self.skip_reasons.get("constraint", 0) + 1
                )
                self._note_pruned(unique[k], violated)
                if self.verbose:
                    log.info("prune %s (constraint %s)", unique[k], violated)
                if _events.sink() is not None:
                    ctx = self.ctx_name()
                    _events.emit("candidate_asked", name=ctx,
                                 point=dict(unique[k]), round=self._round_no)
                    _events.emit("candidate_skipped", name=ctx,
                                 point=dict(unique[k]), reason="constraint",
                                 detail=violated)
            to_measure = [k for k in to_measure if k not in pruned]
        measured: dict = {}
        if to_measure:
            pts = [dict(unique[k]) for k in to_measure]
            for _ in range(self.ignore):  # stabilization (paper `ignore`)
                measure_batch([dict(p) for p in pts])
                self._measurements += len(pts)
            costs = list(measure_batch([dict(p) for p in pts]))
            if len(costs) != len(pts):
                raise ValueError(
                    f"measure_batch returned {len(costs)} costs for {len(pts)} points"
                )
            from .measure import MeasureResult

            measured = {}
            for k, c in zip(to_measure, costs):
                if isinstance(c, MeasureResult):
                    prev = self._measure_meta.get(k)
                    if (
                        c.pruned is not None
                        and prev is not None
                        and prev.get("pruned") is None
                        and k in self._measured_costs
                    ):
                        # the point was *really* measured in an earlier
                        # round — typically by a previous pipeline stage —
                        # and a later revisit came back analytically
                        # pruned (the engine's incumbent moved on).  The
                        # optimistic lower bound must not clobber the
                        # real measurement: keep the stored meta and
                        # deliver the measured cost, or the next stage
                        # would sit on a bound it can never realize.
                        measured[k] = self._measured_costs[k]
                    else:
                        measured[k] = float(c.cost)
                        self._measure_meta[k] = c.meta()
                        if c.pruned is None and np.isfinite(c.cost):
                            self._measured_costs[k] = float(c.cost)
                    # pruned/failed candidates honestly spent zero reps
                    self._measurements += int(c.repeats_spent)
                else:
                    measured[k] = float(c)
                    if np.isfinite(c):
                        self._measured_costs[k] = float(c)
                    self._measurements += 1
        full = []
        for k, p in zip(keys, points):
            # measured this round, constraint-pruned this round, or answered
            # by the cross-round cache
            if k in measured:
                c = measured[k]
            elif k in pruned:
                c = pruned[k]
            else:
                c = self._cost_cache[k]
            if self._use_cache:
                self._cost_cache[k] = c
            self._evals += 1
            self._history.append((dict(p), float(c)))
            if self.verbose:
                log.info("eval#%d %s -> %.6g", self._evals, p, c)
            full.append(c)
        self.optimizer.tell(full)

    @staticmethod
    def _point_args(point: dict) -> tuple:
        return tuple(point.values())
