"""Adaptive measurement engine — spend repetitions where they buy information.

PATSMA's premise is that every cost evaluation is expensive, yet a fixed
``RuntimeCost(warmup, repeats)`` loop spends identical wall-clock on every
candidate, whether it is a near-tie with the incumbent or 40× slower.  This
module is the measurement layer's answer, three tiers deep — all
deterministic given the observed rep times, all seedable:

* **Noise-floor calibration** (:meth:`MeasureEngine.calibrate`): replaying
  one executable a few times estimates timer/scheduler jitter, from which
  per-candidate confidence intervals are derived.  No candidate is ever
  culled against another inside that noise floor.
* **Successive-halving racing** (:meth:`MeasureEngine.measure_round`): every
  candidate of a deduped tuning round gets one measured repetition;
  candidates whose CI lower bound exceeds the running round-best's CI upper
  bound (by a configurable margin) are culled with their single-rep median —
  a real, finite ``tell`` cost, never ``inf`` — while survivors escalate
  through a repeat ladder (1→3→7 by default) until the top-k are
  statistically separated or the ladder is exhausted.
* **Roofline prefilter**: the candidate's analytic lower bound (the
  kernel's FLOP and byte counts over the card's peaks, see
  :func:`repro_torch.core.costs.roofline_terms`) is compared against the best cost
  measured so far; a candidate whose *lower bound* already loses is charged
  at the bound without a single repetition, flagged ``pruned="roofline"`` so
  re-searches after a drift reset revisit it.

``MeasurePolicy(mode="fixed")`` reproduces the classic fixed-repeat loop
(:class:`repro_torch.core.costs.RuntimeCost` semantics) for trajectory-pinned
tests and CI; ``mode="adaptive"`` is the racing engine.  The process default
comes from the ``REPRO_TUNE_MEASURE`` env var (see
:func:`resolve_measure_policy`).
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.obs import metrics as _metrics
from repro_torch.obs.trace import tracer as _tracer

__all__ = [
    "ENV_TUNE_MEASURE",
    "OBJECTIVES",
    "MeasurePolicy",
    "MeasureResult",
    "NoiseEstimate",
    "MeasureEngine",
    "resolve_measure_policy",
    "time_rep",
    "block_until_ready",
    "summarize",
    "quantile",
    "objective_value",
    "objective_quantile",
]

#: env var: process-default measurement policy for tune_call/pretune
#: ("adaptive" | "fixed"; unset → adaptive)
ENV_TUNE_MEASURE = "REPRO_TUNE_MEASURE"

#: tuning objectives: which statistic of a candidate's rep times the search
#: minimizes.  ``median``/``p50`` are synonyms (the classic behaviour);
#: ``p95``/``p99`` optimize tail latency — production serving cares about
#: the slow requests, and a knob that wins the median can lose the tail.
OBJECTIVES = ("median", "p50", "p95", "p99")

_OBJECTIVE_Q = {"median": 0.5, "p50": 0.5, "p95": 0.95, "p99": 0.99}


def objective_quantile(objective: str) -> float:
    """The quantile (in [0, 1]) a named objective minimizes."""
    try:
        return _OBJECTIVE_Q[str(objective).strip().lower()]
    except KeyError:
        raise ValueError(
            f"objective must be one of {OBJECTIVES}, got {objective!r}"
        ) from None


def quantile(times: Sequence[float], q: float) -> float:
    """Deterministic linear-interpolated quantile of ``times``.

    ``q=0.5`` reproduces :func:`summarize`'s median exactly (even-length
    inputs average the two middle values), so the default objective is
    bit-identical to the pre-objective behaviour."""
    ts = sorted(float(t) for t in times)
    n = len(ts)
    if n == 0:
        return math.inf
    if n == 1:
        return ts[0]
    pos = min(max(q, 0.0), 1.0) * (n - 1)
    i = int(math.floor(pos))
    frac = pos - i
    if frac <= 0.0 or i + 1 >= n:
        return ts[i]
    return ts[i] * (1.0 - frac) + ts[i + 1] * frac


def objective_value(times: Sequence[float], objective: str = "median") -> float:
    """The objective statistic of one candidate's rep times."""
    return quantile(times, objective_quantile(objective))


def _tensors(x):
    """Every tensor in ``x`` (a tensor, or nested tuples/lists/dict values)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def block_until_ready(x):
    """Wait until the device work behind ``x`` is done; returns ``x``.

    CUDA launches return before the kernel finishes, so each CUDA device an
    output tensor lives on is synchronized.  CPU results are complete when
    the call returns.  There is no silent fallback: a wall clock around an
    unsynchronized launch would time the enqueue only."""
    for dev in {t.device for t in _tensors(x) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return x


def time_rep(fn: Callable, *args, **kwargs) -> float:
    """One timed repetition of ``fn(*args)``; blocks on the result so
    asynchronous dispatch is included (the unit the ladder escalates in)."""
    t0 = time.perf_counter()
    block_until_ready(fn(*args, **kwargs))
    return time.perf_counter() - t0


# -------------------------------------------------------------------- policy
@dataclasses.dataclass(frozen=True)
class MeasurePolicy:
    """How to spend repetitions on a candidate set.

    ``mode="fixed"``: every candidate gets ``warmup`` discarded + ``repeats``
    measured reps, cost is the median — byte-for-byte the classic
    :class:`~repro_torch.core.costs.RuntimeCost` schedule.

    ``mode="adaptive"``: racing over the repeat ``ladder`` (cumulative rep
    targets per stage), culling against the round best with ``margin`` extra
    half-widths of slack, plus the roofline prefilter when analytic bounds
    are available.  ``rel_noise``/``abs_noise`` are the noise-floor *priors*
    used until :meth:`MeasureEngine.calibrate` has run (and as lower bounds
    afterwards — a calibration fluke must not shrink the floor to zero).
    """

    mode: str = "adaptive"
    warmup: int = 1
    repeats: int = 3  # fixed-mode measured reps (and online fixed reps)
    ladder: Tuple[int, ...] = (1, 3, 7)  # cumulative reps per racing stage
    margin: float = 0.5  # cull slack, in units of the best's CI half-width
    top_k: int = 1  # stop escalating once this many are separated
    calibrate_reps: int = 5
    rel_noise: float = 0.02  # noise-floor prior, fraction of the median
    abs_noise: float = 5e-7  # noise-floor prior, seconds
    roofline: bool = True
    prune_margin: float = 1.0  # prune iff bound > incumbent * prune_margin
    # which statistic of a candidate's reps the search minimizes.  Racing
    # CIs and cull decisions stay median-based (the robust statistic noise
    # calibration is built around); the objective is applied when a
    # candidate's cost is finalized, so "median" is bit-identical to the
    # pre-objective engine.
    objective: str = "median"

    def __post_init__(self) -> None:
        if self.mode not in ("fixed", "adaptive"):
            raise ValueError(f"mode must be 'fixed' or 'adaptive', got {self.mode!r}")
        obj = str(self.objective).strip().lower()
        objective_quantile(obj)  # raises on unknown names
        object.__setattr__(self, "objective", obj)
        if self.warmup < 0 or self.repeats < 1:
            raise ValueError("warmup must be >= 0 and repeats >= 1")
        lad = tuple(int(x) for x in self.ladder)
        if not lad or lad[0] < 1 or any(b <= a for a, b in zip(lad, lad[1:])):
            raise ValueError(f"ladder must be strictly increasing from >= 1, got {lad}")
        object.__setattr__(self, "ladder", lad)


def resolve_measure_policy(
    measure=None,
    *,
    warmup: Optional[int] = None,
    repeats: Optional[int] = None,
    objective: Optional[str] = None,
) -> MeasurePolicy:
    """Coerce a user-facing ``measure=`` value into a :class:`MeasurePolicy`.

    ``None`` reads ``REPRO_TUNE_MEASURE`` (default ``"adaptive"``); a string
    names the mode; a mapping supplies :class:`MeasurePolicy` fields (mode
    defaulting from the env var — the declarative route-spec form, e.g.
    ``measure={"objective": "p99"}``); a policy object passes through
    untouched.  ``warmup`` / ``repeats`` / ``objective`` override the
    named-mode defaults (they are the classic ``tune_call(warmup=,
    repeats=)`` knobs plus the tail-latency objective) but never an
    explicit policy or an explicit mapping field."""
    if isinstance(measure, MeasurePolicy):
        return measure
    fields: dict = {}
    if measure is not None and not isinstance(measure, str):
        try:
            fields = dict(measure)
        except (TypeError, ValueError):
            raise TypeError(
                "measure must be None, 'fixed', 'adaptive', a field mapping, "
                f"or MeasurePolicy; got {measure!r}"
            ) from None
        measure = fields.pop("mode", None)
    if measure is None:
        measure = os.environ.get(ENV_TUNE_MEASURE, "") or "adaptive"
    fields["mode"] = str(measure).strip().lower()
    if warmup is not None:
        fields.setdefault("warmup", int(warmup))
    if repeats is not None:
        fields.setdefault("repeats", int(repeats))
    if objective is not None:
        fields.setdefault("objective", objective)
    return MeasurePolicy(**fields)


# -------------------------------------------------------------------- results
@dataclasses.dataclass
class MeasureResult:
    """One candidate's measurement outcome within a round.

    ``cost`` is always finite for measured/pruned candidates and ``inf`` for
    failures; ``pruned`` is ``"roofline"`` when the candidate was never
    measured (cost == its analytic bound), ``culled`` is True when racing
    stopped it before the full ladder (cost == median of the reps it got).
    """

    cost: float
    cost_std: float = 0.0
    repeats_spent: int = 0
    culled: bool = False
    pruned: Optional[str] = None
    times: list = dataclasses.field(default_factory=list)
    # the racing CI at finalization time — what the cull decision actually
    # compared (obs event stream: candidate_culled carries these)
    ci_lo: float = 0.0
    ci_hi: float = 0.0

    def meta(self) -> dict:
        """The bookkeeping the driver stores per measured point."""
        return {
            "cost_std": float(self.cost_std),
            "repeats_spent": int(self.repeats_spent),
            "culled": bool(self.culled),
            "pruned": self.pruned,
        }


@dataclasses.dataclass(frozen=True)
class NoiseEstimate:
    """Timer-jitter floor: no two costs closer than this are distinguishable."""

    abs_floor: float  # seconds
    rel: float  # fraction of the measured median
    n: int = 0  # calibration reps behind the estimate (0 = priors only)

    def floor(self, median: float) -> float:
        """The indifference band around a measurement at ``median``."""
        return max(self.abs_floor, self.rel * abs(median))


def summarize(times: Sequence[float], noise: NoiseEstimate):
    """``(median, std, ci_lo, ci_hi)`` of one candidate's rep times.

    The CI half-width is the larger of the calibrated noise floor and the
    standard error of the observed reps — deterministic given the times, and
    never narrower than what the timer can actually resolve."""
    ts = sorted(float(t) for t in times)
    n = len(ts)
    if n == 0:
        return math.inf, 0.0, math.inf, math.inf
    med = ts[n // 2] if n % 2 == 1 else 0.5 * (ts[n // 2 - 1] + ts[n // 2])
    if n > 1:
        mean = sum(ts) / n
        std = math.sqrt(sum((t - mean) ** 2 for t in ts) / (n - 1))
    else:
        std = 0.0
    hw = max(noise.floor(med), 2.0 * std / math.sqrt(n))
    return med, std, med - hw, med + hw


# --------------------------------------------------------------------- engine
class MeasureEngine:
    """Stateful per-search measurement engine (one instance per tuning run).

    Feed it one deduped optimizer round at a time via
    :meth:`measure_round`; it remembers the best *measured* cost across
    rounds (the roofline prefilter's incumbent) and the calibrated noise
    floor.  ``stats`` accumulates repetitions, culls, and prunes for run
    summaries and the overhead benchmark.
    """

    def __init__(
        self,
        policy: Optional[MeasurePolicy] = None,
        *,
        noise: Optional[NoiseEstimate] = None,
        on_error: Optional[Callable[[int, BaseException], None]] = None,
        guard=None,
    ) -> None:
        self.policy = policy if policy is not None else MeasurePolicy()
        self.noise = noise
        self.on_error = on_error
        # optional FaultPolicy: every repetition runs under its watchdog
        # deadline (a hung candidate is charged inf, the run survives) with
        # transient failures retried in place
        self.guard = guard
        self.best_measured = math.inf  # incumbent for the roofline prefilter
        # every increment mirrors into the process metrics registry as
        # measure.<key> — one bookkeeping site, two views
        self.stats = _metrics.MirroredStats("measure", {
            "mode": self.policy.mode,
            "rounds": 0,
            "candidates": 0,
            "measured": 0,
            "culled": 0,
            "pruned_roofline": 0,
            "failed": 0,
            "reps": 0,
            "warmup_reps": 0,
            "calibration_reps": 0,
            "timeouts": 0,
            "retried": 0,
        })

    # ------------------------------------------------------------- internals
    def _rep(self, idx: int, fn: Callable[[], float], counter: str = "reps"):
        """One repetition; returns the observed time or the exception.
        Control-flow exceptions always propagate — a Ctrl-C mid-measurement
        must never be classified into a candidate's failure cost."""
        from .guard import GuardTimeout, guarded_call

        g = self.guard
        try:
            if g is not None and (g.measure_timeout is not None or g.retries > 0):
                def _on_retry(attempt, exc, delay):
                    self.stats["retried"] += 1

                t = float(guarded_call(
                    fn,
                    timeout=g.measure_timeout,
                    retries=g.retries,
                    backoff=g.backoff,
                    backoff_mult=g.backoff_mult,
                    jitter=g.jitter,
                    label=f"measure[{idx}]",
                    on_retry=_on_retry,
                ))
            else:
                t = float(fn())
        except (KeyboardInterrupt, SystemExit):
            raise
        except GuardTimeout as e:
            self.stats["timeouts"] += 1
            if self.on_error is not None:
                self.on_error(idx, e)
            return e
        except Exception as e:
            if self.on_error is not None:
                self.on_error(idx, e)
            return e
        self.stats[counter] += 1
        _metrics.histogram("measure.rep_seconds").observe(t)
        return t

    def _noise(self) -> NoiseEstimate:
        if self.noise is None:
            p = self.policy
            return NoiseEstimate(p.abs_noise, p.rel_noise, 0)
        return self.noise

    def _objective_cost(self, times: Sequence[float], med: float) -> float:
        """Finalized cost of one candidate: ``med`` for the median objective
        (bit-identical to the classic engine), the objective quantile of the
        reps otherwise."""
        if objective_quantile(self.policy.objective) == 0.5:
            return med
        return objective_value(times, self.policy.objective)

    # ------------------------------------------------------------ calibration
    def calibrate(self, rep_fn: Callable[[], float], idx: int = -1) -> NoiseEstimate:
        """Estimate the timer noise floor by replaying one known-good
        callable (the incumbent, or the round's first compiled candidate —
        ``idx`` is its round index, forwarded to ``on_error`` so a failure
        is attributed to the right candidate).  The policy's priors are kept
        as lower bounds: a lucky streak of identical timings must not
        collapse the floor to zero."""
        p = self.policy
        times: List[float] = []
        for _ in range(max(2, p.calibrate_reps)):
            t = self._rep(idx, rep_fn, counter="calibration_reps")
            if isinstance(t, BaseException):
                break
            times.append(t)
        if len(times) < 2:
            self.noise = NoiseEstimate(p.abs_noise, p.rel_noise, len(times))
            return self.noise
        med, std, _, _ = summarize(times, NoiseEstimate(0.0, 0.0))
        abs_floor = max(p.abs_noise, 2.0 * std)
        rel = max(p.rel_noise, (2.0 * std / med) if med > 0 else 0.0)
        self.noise = NoiseEstimate(abs_floor, rel, len(times))
        return self.noise

    # ------------------------------------------------------------ measurement
    def measure_round(
        self,
        reps: Sequence[Optional[Callable[[], float]]],
        *,
        bounds: Optional[Sequence[Optional[float]]] = None,
    ) -> List[MeasureResult]:
        """Measure one deduped candidate round.

        ``reps[i]`` is a zero-arg callable timing ONE repetition of candidate
        ``i`` (``None`` marks a candidate whose executable failed to build —
        charged ``inf`` with zero reps).  ``bounds[i]`` is an optional
        analytic lower bound in the same units as the rep times; with a
        finite cross-round incumbent, a candidate whose bound already loses
        is pruned unmeasured.  Returns one :class:`MeasureResult` per input,
        in order.
        """
        p = self.policy
        n = len(reps)
        self.stats["rounds"] += 1
        self.stats["candidates"] += n
        with _tracer().span("measure", candidates=n):
            return self._measure_round_inner(reps, bounds)

    def _measure_round_inner(self, reps, bounds) -> List[MeasureResult]:
        p = self.policy
        n = len(reps)
        results: List[Optional[MeasureResult]] = [None] * n
        alive: List[int] = []
        for i, fn in enumerate(reps):
            if fn is None:
                results[i] = MeasureResult(cost=math.inf)
                self.stats["failed"] += 1
            else:
                alive.append(i)

        # ------------------------------------------------ roofline prefilter
        if (
            p.mode == "adaptive"
            and p.roofline
            and bounds is not None
            and math.isfinite(self.best_measured)
        ):
            cutoff = self.best_measured * p.prune_margin
            for i in list(alive):
                b = bounds[i]
                if b is not None and math.isfinite(b) and b > cutoff:
                    results[i] = MeasureResult(cost=float(b), pruned="roofline")
                    self.stats["pruned_roofline"] += 1
                    alive.remove(i)

        if p.mode == "fixed":
            for i in alive:
                results[i] = self._measure_fixed(i, reps[i])
        else:
            calibrated_on = None
            if self.noise is None:
                # first round: the first warm candidate doubles as the
                # calibration target.  Warm it up *before* calibrating —
                # first-call overhead (dispatch caches, page faults) would
                # otherwise inflate the noise floor enough to disable racing.
                for i in list(alive):
                    failed = False
                    for _ in range(p.warmup):
                        t = self._rep(i, reps[i], counter="warmup_reps")
                        if isinstance(t, BaseException):
                            results[i] = MeasureResult(cost=math.inf)
                            self.stats["failed"] += 1
                            alive.remove(i)
                            failed = True
                            break
                    if not failed:
                        self.calibrate(reps[i], idx=i)
                        calibrated_on = i
                        break
            self._race(alive, reps, results, skip_warmup=calibrated_on)

        finite = [
            r.cost
            for r in results
            if r is not None and r.pruned is None and math.isfinite(r.cost)
        ]
        if finite:
            self.best_measured = min(self.best_measured, min(finite))
        return [r if r is not None else MeasureResult(cost=math.inf) for r in results]

    def _measure_fixed(self, idx: int, fn: Callable[[], float]) -> MeasureResult:
        p = self.policy
        for _ in range(p.warmup):
            t = self._rep(idx, fn, counter="warmup_reps")
            if isinstance(t, BaseException):
                self.stats["failed"] += 1
                return MeasureResult(cost=math.inf)
        times: List[float] = []
        for _ in range(p.repeats):
            t = self._rep(idx, fn)
            if isinstance(t, BaseException):
                self.stats["failed"] += 1
                return MeasureResult(cost=math.inf, times=times)
            times.append(t)
        med, std, lo, hi = summarize(times, self._noise())
        self.stats["measured"] += 1
        return MeasureResult(
            cost=self._objective_cost(times, med), cost_std=std,
            repeats_spent=len(times), times=times,
            ci_lo=lo, ci_hi=hi,
        )

    def _race(
        self,
        alive: List[int],
        reps: Sequence[Optional[Callable[[], float]]],
        results: List[Optional[MeasureResult]],
        skip_warmup: Optional[int] = None,
    ) -> None:
        """Successive-halving over the repeat ladder, culling vs round-best."""
        p = self.policy
        noise = self._noise()
        times: dict = {i: [] for i in alive}

        def fail(i: int) -> None:
            results[i] = MeasureResult(
                cost=math.inf, repeats_spent=len(times[i]), times=list(times[i])
            )
            self.stats["failed"] += 1
            alive.remove(i)

        def finalize(i: int, culled: bool) -> None:
            med, std, lo, hi = summarize(times[i], noise)
            results[i] = MeasureResult(
                cost=self._objective_cost(times[i], med),
                cost_std=std,
                repeats_spent=len(times[i]),
                culled=culled,
                times=list(times[i]),
                ci_lo=lo,
                ci_hi=hi,
            )
            self.stats["measured"] += 1
            if culled:
                self.stats["culled"] += 1
            alive.remove(i)

        # per-candidate warmup (the calibration target already ran)
        for i in list(alive):
            if i == skip_warmup:
                continue
            for _ in range(p.warmup):
                t = self._rep(i, reps[i], counter="warmup_reps")
                if isinstance(t, BaseException):
                    fail(i)
                    break

        for target in p.ladder:
            # escalate every surviving candidate to `target` cumulative reps
            for i in list(alive):
                while len(times[i]) < target:
                    t = self._rep(i, reps[i])
                    if isinstance(t, BaseException):
                        fail(i)
                        break
                    times[i].append(t)
            if not alive:
                return
            stats = {i: summarize(times[i], noise) for i in alive}
            order = sorted(alive, key=lambda i: stats[i][0])
            best = order[0]
            med_b, _, lo_b, hi_b = stats[best]
            # the cross-round incumbent races too: a round of uniformly
            # regressive candidates must not escalate the ladder against
            # each other when every one of them already loses to the best
            # measurement of an earlier round
            inc_line = None
            if math.isfinite(self.best_measured):
                f = noise.floor(self.best_measured)
                inc_line = self.best_measured + f * (1.0 + p.margin)
            cull_line = hi_b + p.margin * (hi_b - med_b)
            if inc_line is not None:
                cull_line = min(cull_line, inc_line)
            for i in list(alive):
                if i == best:
                    # only the incumbent may cull the round's own best
                    if inc_line is not None and lo_b > inc_line:
                        finalize(i, culled=True)
                    continue
                if stats[i][2] > cull_line:  # CI low end already loses
                    finalize(i, culled=True)
            if len(alive) <= max(1, p.top_k):
                break
            # separated: the top-k's CI high ends clear everyone else's low end
            order = [i for i in order if results[i] is None]
            k = min(max(1, p.top_k), len(order) - 1)
            top_hi = max(stats[i][3] for i in order[:k])
            rest_lo = min(stats[i][2] for i in order[k:])
            if top_hi < rest_lo:
                break
        for i in list(alive):
            finalize(i, culled=False)
