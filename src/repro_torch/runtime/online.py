"""OnlineTuner — PATSMA tuning in-band with live traffic.

The offline modes (PR 1/PR 2) stop the world: ``entire_exec*`` runs the
whole search on a replica before serving starts.  :class:`OnlineTuner`
instead rides a live request stream:

* an **ε-fraction** of calls *explore* — they serve the request at the
  search's current candidate and feed the measured cost into the
  ``Autotuning`` driver (the paper's Single-Iteration mode, rationed);
* the remaining calls *exploit* the best-known knobs, and once the search
  has converged their costs stream into a :class:`~repro_torch.runtime.drift
  .DriftDetector`;
* when drift fires, the tuner calls ``Autotuning.reset(level)`` with a
  **warm re-search**: the optimizer is re-seeded around the deployed point
  at half budget, the deployed point's fresh (post-drift) cost is recorded
  via ``Autotuning.note``, and the refreshed result is committed back to
  the tuning DB with ``source="online"`` when the re-search converges.

Exploration never blocks the serving thread on a build: candidate executables
are built through an :class:`~repro_torch.core.costs.ExecutableCache` on a
background thread pool, and a candidate is only *offered* for exploration
once its executable is ready (``ExecutableCache.peek`` — a non-building
probe).  A scheduled exploration whose compile is still in flight silently
degrades to exploitation and retries on a later call.  Candidates whose
build *failed* are charged ``inf`` via ``Autotuning.skip`` without spending
a request on them.  Builds are admission-controlled per exact call
signature: a shape seen only once is served by the caller's fallback
dispatch rather than paying an AOT compile that may never be reused.

The ε-scheduler is a deterministic credit counter, not a coin flip: call
``i`` of a search episode explores iff ``explored + 1 <= ε * i`` (so the
explored fraction tracks ε exactly and tests can assert the schedule).
Episode counters restart when a search converges or a drift reset begins.

With a ``measure`` policy (:class:`~repro_torch.core.measure.MeasurePolicy`) the
tuner additionally races candidates *across requests*: each explore request
contributes one repetition to the current candidate, and the candidate's
cost is only fed to the search once it is decided — immediately (one rep)
when its observed cost is dominated by the incumbent beyond the noise
floor, after climbing the repeat ladder otherwise.  Explore credits are
charged per repetition actually spent, so a culled candidate consumes a
fraction of the ε-budget a full ladder evaluation would, and exploration
converges in fewer live requests than a fixed multi-rep schedule.
``measure=None`` (default) keeps the classic one-request-per-candidate
behaviour; ``MeasurePolicy(mode="fixed", repeats=k)`` spends exactly ``k``
requests per candidate and feeds the median.

``begin``/``observe`` are **thread-safe**: every state transition runs under
one per-tuner lock (striped locking — different contexts never contend), so
many concurrent request streams can route through the same context.  Under a
``measure`` policy the racing protocol extends *across streams*: concurrent
requests exploring the same candidate each contribute one repetition to its
current rung, and a rep that arrives after its candidate was already decided
by a sibling stream is discarded as stale (``stats_["stale_explore_reps"]``)
rather than polluting the next candidate's rung.  Per-``tenant`` ε-credit
budgets (``begin(..., tenant=)``) additionally ration exploration per
request stream: each tenant may explore at most an ε-fraction of *its own*
calls, so one chatty tenant cannot burn the whole episode's explore budget.
The lock is never held across a compile or a measured request — builds stay
on the background pool and the serving work happens between ``begin`` and
``observe``.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import wait as _wait_futures
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core import Autotuning, CircuitBreaker, ExecutableCache
from repro_torch.core.measure import (
    NoiseEstimate,
    objective_value,
    resolve_measure_policy,
    summarize,
)
from repro_torch.obs import events as _events
from repro_torch.obs import metrics as _metrics
from repro_torch.obs.trace import tracer as _tracer

from .drift import DriftDetector

__all__ = ["Decision", "OnlineTuner", "EXPLORE", "EXPLOIT"]

EXPLORE = "explore"
EXPLOIT = "exploit"

_ABSENT = object()  # peek() sentinel: "no completed build for this key"


@dataclasses.dataclass
class Decision:
    """One routed call: which knobs to serve this request with.

    ``executable`` is the ready AOT-compiled artifact for ``point`` when the
    tuner has one (never compiled on the calling thread), else ``None`` and
    the caller uses its own fallback dispatch.  Hand the decision back to
    :meth:`OnlineTuner.observe` (or ``ContextRouter.observe``) with the
    measured cost.
    """

    kind: str  # EXPLORE | EXPLOIT
    point: dict
    executable: Any = None
    seq: int = 0
    tuner: Optional["OnlineTuner"] = dataclasses.field(default=None, repr=False)
    tenant: Optional[str] = None  # request stream this decision was billed to
    traced: bool = dataclasses.field(default=False, repr=False)  # tuner.begin span kept


class OnlineTuner:
    """Explore/exploit wrapper around one :class:`Autotuning` context.

    Parameters
    ----------
    at:
        The search driver (may be DB-warm-started, may already be finished
        on an exact DB hit — then every call exploits the stored best).
    build:
        Optional ``build(point, *args, **kwargs) -> executable``.  When
        given, explore candidates are compiled off-thread through ``cache``
        and exploration waits (without blocking) for readiness.  When
        ``None`` (analytic costs, or compile time absorbed by ``ignore``),
        every candidate is immediately explorable.
    epsilon:
        Target explored fraction of calls while a search is active.
        ``1.0`` reproduces the paper's Single-Iteration mode (every call
        measures); ``0.0`` never explores (replay-only).
    drift:
        Optional :class:`DriftDetector` fed with exploit costs once the
        search has converged; a non-zero level triggers the warm re-search.
    warm_frac / warm_spread:
        Budget fraction and seeding spread of the drift-triggered re-search.
    default_point:
        Knobs to exploit before any measurement exists (a registered
        kernel's defaults); otherwise the driver's current best is used.
    measure:
        Optional per-candidate repetition policy
        (:class:`~repro_torch.core.measure.MeasurePolicy`, ``"adaptive"``, or
        ``"fixed"``).  ``None`` keeps the classic behaviour: every explore
        request is one full candidate evaluation.
    breaker:
        Optional :class:`~repro_torch.core.guard.CircuitBreaker` (or a kwargs dict
        for one).  A context whose explores keep failing — builds erroring,
        measured costs coming back non-finite — trips the breaker: explores
        and failed-candidate absorption are suspended (the incumbent/default
        keeps serving, no ε-credits burn) until the count-based cooldown
        lapses, then half-open probes decide whether exploration resumes.
        Denied calls do not advance the ε-episode, so recovery does not
        start with a burst of catch-up explores.
    """

    def __init__(
        self,
        at: Autotuning,
        *,
        build: Optional[Callable] = None,
        cache: Optional[ExecutableCache] = None,
        jobs: int = 1,
        epsilon: float = 0.1,
        drift: Optional[DriftDetector] = None,
        warm_frac: float = 0.5,
        warm_spread: float = 0.2,
        default_point: Optional[dict] = None,
        name: str = "online",
        measure=None,
        breaker=None,
    ) -> None:
        if not 0.0 <= epsilon <= 1.0:
            raise ValueError(f"epsilon must be in [0, 1], got {epsilon}")
        self.at = at
        self.epsilon = float(epsilon)
        self.drift = drift
        self.warm_frac = float(warm_frac)
        self.warm_spread = float(warm_spread)
        self.name = str(name)
        self._build = build
        # default cache never memoizes failures: without domain knowledge of
        # which build errors are deterministic (the kernel layer's cache has
        # that via its cache_failures predicate), a transient compile failure
        # (e.g. RESOURCE_EXHAUSTED under load) must not poison the candidate
        # for the process lifetime — a revisit retries the build instead
        self._cache = cache if cache is not None else (
            ExecutableCache(cache_failures=lambda e: False)
            if build is not None else None
        )
        self._jobs = max(1, int(jobs))
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: dict = {}  # exec key -> Future (builds this tuner asked for)
        self._sig_seen: dict = {}  # exact call signature -> sightings (bounded)
        self._default = dict(default_point) if default_point else None
        self._seq = 0
        # one lock per tuner (the router's stripe): every begin/observe state
        # transition runs under it, so concurrent streams through the same
        # context stay consistent while different contexts never contend.
        # RLock: internal transitions (drift reset → commit) re-enter.
        self._lock = threading.RLock()
        # per-search-episode ε accounting (reset on converge / drift reset)
        self._episode_calls = 0
        self._episode_explores = 0
        # per-tenant ε accounting within the episode: tenant -> counters
        self._tenant_calls: dict = {}
        self._tenant_explores: dict = {}
        # multi-rep explore measurement (None → one request per candidate)
        self.measure = None if measure is None else resolve_measure_policy(measure)
        if isinstance(breaker, dict):
            breaker = CircuitBreaker(**breaker)
        self.breaker: Optional[CircuitBreaker] = breaker
        self._rep_times: list = []  # current explore candidate's observed reps
        self._rep_key = None  # space.key of the candidate being repped
        # explore decisions issued but not yet observed (begin..observe gap):
        # the term that closes the rep-accounting identity mid-request
        self._explore_inflight = 0
        self.events: list = []  # drift resets, with context
        # mirrored: every numeric increment lands in the process metrics
        # registry as online.<key> (ε-credit spend = online.explores)
        self.stats_ = _metrics.MirroredStats("online", {
            "calls": 0,
            "explores": 0,  # explore *requests* (= repetitions spent)
            "exploits": 0,
            "explore_candidates": 0,  # candidates decided (fed to the search)
            "culled_explores": 0,  # candidates raced out before the full ladder
            "deferred_explores": 0,  # scheduled explore, compile still in flight
            "inband_builds": 0,  # builds that ran on the serving thread (must stay 0)
            "compiles_submitted": 0,
            "candidate_failures": 0,  # candidates charged inf for a failed build
            "breaker_denied": 0,  # calls whose exploration the breaker blocked
            "drift_resets": 0,
            "searches_completed": 0,
            # cross-stream racing accounting: every explore request resolves
            # to exactly one of {decided-candidate rep, buffered rep, stale
            # rep, still-in-flight rep}, so explores == explore_reps_decided
            # + stale_explore_reps + len(current rep buffer) +
            # _explore_inflight at any consistent read point
            "explore_reps_decided": 0,  # reps consumed by decided candidates
            "stale_explore_reps": 0,  # reps for candidates already decided
        })

    # ------------------------------------------------------------ properties
    @property
    def finished(self) -> bool:
        return self.at.finished

    @property
    def best_point(self) -> dict:
        return self.at.best_point

    def exploit_point(self) -> dict:
        """Knobs a non-exploring call should serve with *right now*."""
        with self._lock:
            return self._exploit_point_locked()

    def _exploit_point_locked(self) -> dict:
        at = self.at
        if at.finished or np.isfinite(at.best_cost):
            return at.best_point
        return dict(self._default) if self._default is not None else at.best_point

    def snapshot(self) -> dict:
        """Cheap point-in-time view (no cache walk, no drift window math):
        the serving counters plus the breaker's gate state — what a
        dashboard polls between summary dumps.
        Taken under the tuner lock, so the accounting identities (calls ==
        explores + exploits; explores == decided + stale + buffered +
        in-flight reps) hold even while other threads are mid-``begin``."""
        with self._lock:
            out = {
                "name": self.name,
                "calls": self.stats_["calls"],
                "explores": self.stats_["explores"],
                "exploits": self.stats_["exploits"],
                "breaker_denied": self.stats_["breaker_denied"],
                "drift_resets": self.stats_["drift_resets"],
                "explore_reps_decided": self.stats_["explore_reps_decided"],
                "stale_explore_reps": self.stats_["stale_explore_reps"],
                "explore_reps_buffered": len(self._rep_times),
                "explore_inflight": self._explore_inflight,
                "finished": self.at.finished,
            }
        if self.breaker is not None:
            out["breaker"] = self.breaker.snapshot()
        return out

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.stats_)
            out["finished"] = self.at.finished
            out["num_evals"] = self.at.num_evals
            out["explore_reps_buffered"] = len(self._rep_times)
            out["explore_inflight"] = self._explore_inflight
            if self._tenant_calls:
                out["tenants"] = {
                    t: {
                        "calls": self._tenant_calls.get(t, 0),
                        "explores": self._tenant_explores.get(t, 0),
                    }
                    for t in self._tenant_calls
                }
            if self.drift is not None:
                out["drift"] = self.drift.stats()
        if self._cache is not None:
            out["cache"] = self._cache.stats()
        if self.breaker is not None:
            out["breaker"] = self.breaker.stats()
        return out

    # -------------------------------------------------------- build plumbing
    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self._jobs, thread_name_prefix="patsma-online"
            )
        return self._pool

    @staticmethod
    def _call_sig(args: tuple, kwargs: dict) -> str:
        from repro_torch.tuning.records import signature_of

        return json.dumps(signature_of(args, kwargs), default=repr, sort_keys=True)

    def _exec_key(self, point: dict, args: tuple, kwargs: dict):
        return (self.name, self.at.space.key(point), self._call_sig(args, kwargs))

    def _note_signature(self, args: tuple, kwargs: dict) -> bool:
        """Admission control for background builds: record this call's exact
        signature and admit compiles only once it has been seen more than
        once.  Long-tail one-off shapes (each request a new sequence length)
        are served by the caller's fallback dispatch instead of paying one
        AOT compile per request — compiling for a shape that never returns
        is pure waste and churns the shared executable cache.  Signature-free
        calls (serve's fixed decode context, TunedStep) are always admitted."""
        if not args and not kwargs:
            return True
        sig = self._call_sig(args, kwargs)
        if len(self._sig_seen) >= 4096:
            self._sig_seen.clear()
        n = self._sig_seen.get(sig, 0) + 1
        self._sig_seen[sig] = n
        return n >= 2

    def _submit(self, point: dict, args: tuple, kwargs: dict) -> Optional[Future]:
        """Queue a background build for ``point`` (idempotent); returns the
        future tracking it.  Never builds on the calling thread."""
        if self._build is None:
            return None
        key = self._exec_key(point, args, kwargs)
        fut = self._pending.get(key)
        if fut is not None:
            return fut
        done = self._cache.peek(key, default=_ABSENT)
        if done is not _ABSENT:  # someone else (prewarm, sibling) built it
            fut = Future()
            fut.set_result(done)
            self._pending[key] = fut
            return fut
        point = dict(point)
        args = tuple(args)
        kwargs = dict(kwargs)
        serving_thread = threading.get_ident()

        def job():
            def build():
                if threading.get_ident() == serving_thread:
                    # only possible if a caller runs the future inline —
                    # surfaced in stats so benchmarks can assert it never does
                    with self._lock:
                        self.stats_["inband_builds"] += 1
                return self._build(point, *args, **kwargs)

            return self._cache.get_or_build(key, build)

        fut = self._ensure_pool().submit(job)
        self._pending[key] = fut
        self.stats_["compiles_submitted"] += 1
        if len(self._pending) > 4 * self._cache.maxsize:
            self._pending = {k: f for k, f in self._pending.items() if not f.done()}
        return fut

    def _ready(self, point: dict, args: tuple, kwargs: dict, admit: bool = True):
        """(ready, executable-or-exception-or-None) for ``point``, submitting
        a background build on first sight (if ``admit``).  Never blocks."""
        if self._build is None:
            return True, None
        if not admit:
            key = self._exec_key(point, args, kwargs)
            if (
                self._pending.get(key) is None
                and self._cache.peek(key, default=_ABSENT) is _ABSENT
            ):
                return False, None  # no build exists and none is admitted
        fut = self._submit(point, args, kwargs)
        if fut is None or not fut.done():
            return False, None
        result = fut.result()
        if isinstance(result, (KeyboardInterrupt, SystemExit)):
            # a user interrupt captured by a background build is control
            # flow, never a candidate failure to absorb as inf
            raise result
        if isinstance(result, BaseException):
            key = self._exec_key(point, args, kwargs)
            if self._cache.peek(key, default=_ABSENT) is _ABSENT:
                # the cache declined to keep this failure (transient): drop
                # our memo of the failed future too, so a revisit — e.g. the
                # same candidate in a drift re-search — rebuilds
                self._pending.pop(key, None)
        return True, result

    def _absorb_failed_candidates(self, args: tuple, kwargs: dict, admit: bool = True) -> None:
        """Charge candidates whose executable failed to build ``inf`` without
        spending a serving request on them."""
        if self._build is None:
            return
        for _ in range(100_000):  # safety: pathological optimizer loop
            if self.at.finished:
                return
            ready, ex = self._ready(self.at.point, args, kwargs, admit=admit)
            if not ready or not isinstance(ex, BaseException):
                return
            self.stats_["candidate_failures"] += 1
            if self.breaker is not None:
                self.breaker.record_failure()
            self.at.skip(np.inf, reason="build-failed")
            if self.at.finished:
                self._on_search_complete()
                return
            if self.breaker is not None and self.breaker.state != CircuitBreaker.CLOSED:
                # the breaker tripped mid-absorb: stop charging candidates —
                # a failure storm should suspend the search, not drain it
                return

    def executable_for(self, point: dict, *args, **kwargs):
        """Ready executable for ``point`` if one exists, else ``None``.
        Non-blocking: a miss submits a background build so a later call can
        hit; it never compiles on the calling thread."""
        with self._lock:
            ready, ex = self._ready(dict(point), args, kwargs)
        if ready and not isinstance(ex, BaseException):
            return ex
        return None

    def wait_pending(self, timeout: Optional[float] = None) -> None:
        """Block until every background build submitted so far has finished.
        For tests, shutdown, and pre-stream prewarming — never call from the
        serving hot path.  The tuner lock is *not* held while waiting (a
        build must never deadlock against a serving thread)."""
        with self._lock:
            futs = list(self._pending.values())
        _wait_futures(futs, timeout=timeout)

    def prewarm(self, points, *args, wait: bool = True, **kwargs) -> None:
        """Submit builds for ``points`` (e.g. every candidate of a small
        space) before serving starts; with ``wait`` blocks until done so the
        stream begins with a fully warm cache."""
        with self._lock:
            for p in points:
                self._submit(dict(p), args, kwargs)
        if wait:
            self.wait_pending()

    # ------------------------------------------------------------- decisions
    def _want_explore(self, tenant: Optional[str] = None) -> bool:
        if self.epsilon <= 0.0:
            return False
        if not (
            (self._episode_explores + 1)
            <= self.epsilon * self._episode_calls + 1e-12
        ):
            return False
        if tenant is None:
            return True
        # per-tenant budget: the same deterministic credit rule applied to
        # the tenant's own calls — a single tenant reproduces the global
        # schedule exactly, and no tenant can spend more than ε of its own
        # traffic on exploration regardless of how chatty it is
        return (
            (self._tenant_explores.get(tenant, 0) + 1)
            <= self.epsilon * self._tenant_calls.get(tenant, 0) + 1e-12
        )

    def begin(
        self, *args, tenant: Optional[str] = None, _force_explore: bool = False, **kwargs
    ) -> Decision:
        """Decide how to serve the next request (thread-safe).

        ``args``/``kwargs`` are the request's call arguments — they key the
        executable cache (shape-exact) and are what background builds
        compile against.  ``tenant`` names the request stream for per-tenant
        ε-credit accounting (``None`` = unattributed, global budget only)."""
        with _tracer().span("tuner.begin", cat="serve", sampled=True, ctx=self.name) as sp:
            with self._lock:
                d = self._begin_locked(args, kwargs, tenant, _force_explore)
            if sp is not None:  # kept, so the decision's tuner.observe is traced too
                sp.args["seq"] = d.seq
                d.traced = True
            return d

    def _begin_locked(
        self, args: tuple, kwargs: dict, tenant: Optional[str], _force_explore: bool
    ) -> Decision:
        self._seq += 1
        self.stats_["calls"] += 1
        at = self.at
        admit = self._note_signature(args, kwargs) if self._build is not None else True
        gate = True
        if self.breaker is not None and not at.finished:
            # one gate decision per serving call: a denied call neither
            # explores nor absorbs failures nor advances the ε-episode —
            # the context serves its incumbent and the cooldown ticks
            gate = self.breaker.allow()
            if not gate:
                self.stats_["breaker_denied"] += 1
        if not at.finished and gate:
            self._episode_calls += 1
            if tenant is not None:
                if len(self._tenant_calls) >= 4096:  # bounded, like _sig_seen
                    self._tenant_calls.clear()
                    self._tenant_explores.clear()
                self._tenant_calls[tenant] = self._tenant_calls.get(tenant, 0) + 1
            self._absorb_failed_candidates(args, kwargs, admit=admit)
        if not at.finished and gate and (_force_explore or self._want_explore(tenant)):
            ready, ex = self._ready(at.point, args, kwargs, admit=admit or _force_explore)
            if ready and not isinstance(ex, BaseException):
                self._episode_explores += 1
                if tenant is not None:
                    self._tenant_explores[tenant] = (
                        self._tenant_explores.get(tenant, 0) + 1
                    )
                self.stats_["explores"] += 1
                self._explore_inflight += 1
                return Decision(EXPLORE, at.point, ex, self._seq, self, tenant)
            if not ready:
                self.stats_["deferred_explores"] += 1
            # failed build: absorbed on the next call; exploit this one
        self.stats_["exploits"] += 1
        point = self._exploit_point_locked()
        executable = None
        if self._build is not None:
            ready, ex = self._ready(point, args, kwargs, admit=admit)
            if ready and not isinstance(ex, BaseException):
                executable = ex
        return Decision(EXPLOIT, point, executable, self._seq, self, tenant)

    def observe(self, decision: Decision, cost: float) -> int:
        """Deliver the measured cost of a served decision (thread-safe).

        Explore costs feed the search (committing to the DB on
        convergence); exploit costs feed drift detection once the search has
        converged.  With a ``measure`` policy an explore cost is one
        *repetition* — the candidate advances only once racing decides it,
        and concurrent streams' reps accumulate on the same rung.  A rep
        whose candidate was already decided by a sibling stream (or swept
        away by a drift reset) between this request's ``begin`` and its
        ``observe`` is discarded as stale — feeding it would attribute the
        old candidate's cost to the new one.  Returns the drift level acted
        on this call (0 = none)."""
        if not decision.traced:
            return self._observe(decision, float(cost))
        with _tracer().span("tuner.observe", cat="serve", ctx=self.name, seq=decision.seq):
            return self._observe(decision, float(cost))

    def _observe(self, decision: Decision, cost: float) -> int:
        with self._lock:
            at = self.at
            if decision.kind == EXPLORE:
                if self._explore_inflight > 0:  # lands from the begin() gap
                    self._explore_inflight -= 1
                if self.breaker is not None:
                    if np.isfinite(cost):
                        self.breaker.record_success()
                    else:
                        self.breaker.record_failure()
                if at.finished:
                    # decided after this decision was issued (sibling stream
                    # finished the search / absorbed the candidate)
                    self.stats_["stale_explore_reps"] += 1
                    return 0
                _events.emit("explore_rep", name=self.name,
                             point=dict(decision.point), cost=cost)
                if self.measure is None:
                    if at.space.key(decision.point) != at.space.key(at.point):
                        self.stats_["stale_explore_reps"] += 1
                        return 0
                    self.stats_["explore_reps_decided"] += 1
                    self.stats_["explore_candidates"] += 1
                    at.exec(cost)
                else:
                    self._feed_rep(cost, decision)
                if at.finished:
                    self._on_search_complete()
                return 0
            if self.drift is not None and at.finished:
                level = self.drift.observe(cost)
                if level > 0:
                    self._drift_reset(level)
                    return level
        return 0

    # ------------------------------------------------- multi-rep exploration
    def _feed_rep(self, cost: float, decision: Decision) -> None:
        """One observed repetition of the current explore candidate; feeds
        the search only once the racing policy reaches a verdict.  Keyed by
        the *decision's* point: under cross-stream racing the candidate may
        have advanced between this request's begin and observe, in which
        case the rep is stale and dropped with accounting."""
        at = self.at
        key = at.space.key(at.point)
        if at.space.key(decision.point) != key:
            # the candidate this rep was served at is no longer the one
            # being raced — a sibling stream's rep decided it already
            self.stats_["stale_explore_reps"] += 1
            return
        if self._rep_key != key:  # candidate changed under us (reset, skip)
            self._rep_times = []
            self._rep_key = key
        self._rep_times.append(float(cost))
        verdict = self._race_verdict()
        if verdict is None:
            return  # escalate: the next explore request reps this candidate
        final_cost, culled = verdict
        self.stats_["explore_reps_decided"] += len(self._rep_times)
        self._rep_times = []
        self._rep_key = None
        self.stats_["explore_candidates"] += 1
        if culled:
            self.stats_["culled_explores"] += 1
        at.exec(final_cost)

    def _race_verdict(self):
        """``None`` (needs another rep) or ``(cost, culled)`` for the
        buffered candidate.  Deterministic given the observed costs: decisions
        happen at ladder rungs only, culling when the candidate's CI low end
        is beyond the incumbent's noise band (plus margin), stopping early
        when it clearly wins, finalizing at the ladder top regardless.  The
        racing/cull arithmetic is always median-based; the *finalized* cost
        fed to the search is the policy's objective statistic over the reps
        (identical for ``objective="median"``)."""
        p = self.measure
        n = len(self._rep_times)
        noise = NoiseEstimate(p.abs_noise, p.rel_noise)
        med, _, lo, hi = summarize(self._rep_times, noise)
        if p.objective in ("median", "p50"):
            final = med
        else:
            final = objective_value(self._rep_times, p.objective)
        if p.mode == "fixed":
            return (final, False) if n >= p.repeats else None
        if n >= p.ladder[-1]:
            return (final, False)
        if n not in p.ladder:
            return None  # between rungs
        inc = float(self.at.best_cost)
        if not np.isfinite(inc):
            # establishing the incumbent: a mid-ladder median is denoised
            # enough to race everything that follows against
            rung = p.ladder[min(1, len(p.ladder) - 1)]
            return (final, False) if n >= rung else None
        inc_floor = noise.floor(inc)
        if lo > inc + inc_floor * (1.0 + p.margin):
            return (final, True)  # dominated beyond the noise floor: cull
        if hi < inc - inc_floor:
            return (final, False)  # clear improvement: no more reps needed
        return None  # within noise of the incumbent: climb the ladder

    # --------------------------------------------------------- state changes
    def _on_search_complete(self) -> None:
        self.stats_["searches_completed"] += 1
        self._episode_calls = 0
        self._episode_explores = 0
        self._tenant_calls.clear()
        self._tenant_explores.clear()
        if self._rep_times:  # an undecided rung at convergence is stale
            self.stats_["stale_explore_reps"] += len(self._rep_times)
        self._rep_times = []
        self._rep_key = None
        if self.drift is not None:
            self.drift.rebaseline()

    def _drift_reset(self, level: int) -> None:
        """The tuned config degraded: re-enter tuning with a warm re-search
        seeded at the deployed point, at ``warm_frac`` of the cold budget.

        Level-aware when the search runs a staged strategy (``strategy=
        "csa+nm"`` → a :class:`~repro_torch.core.strategy.Pipeline`): level 1
        (environment drift — the deployed point's cost floor moved, its
        basin did not) re-tunes through the final **NM refinement stage
        alone**, warm-seeded at the deployed point; level 2 (workload shift
        — the landscape itself changed) restarts the full pipeline.  Plain
        single-optimizer searches keep the classic warm ``reset(level)``."""
        at = self.at
        incumbent = at.best_point
        # the trigger event holds the post-drift median (the detector clears
        # its recent window when it fires, so recent_median() is stale here)
        fresh = None
        if self.drift is not None and self.drift.events:
            fresh = self.drift.events[-1].get("recent")
        at.reset(
            1 if level < 2 else 2,
            warm_point=incumbent,
            budget_frac=self.warm_frac,
            spread=self.warm_spread,
            refine=level < 2,
        )
        if fresh is not None and np.isfinite(fresh):
            # the incumbent's live post-drift cost: keeps best_point/commit
            # honest even if the re-search never revisits it
            at.note(incumbent, float(fresh))
        if self.drift is not None:
            self.drift.rebaseline()
        self._episode_calls = 0
        self._episode_explores = 0
        self._tenant_calls.clear()
        self._tenant_explores.clear()
        if self._rep_times:
            self.stats_["stale_explore_reps"] += len(self._rep_times)
        self._rep_times = []  # pre-reset reps describe the old environment
        self._rep_key = None
        self.stats_["drift_resets"] += 1
        _events.emit("drift_reset", name=self.name, level=int(level),
                     point=dict(incumbent), recent_cost=fresh)
        self.events.append(
            {"seq": self._seq, "level": int(level), "point": dict(incumbent),
             "recent_cost": fresh,
             "refined": bool(getattr(at.optimizer, "refining", False))}
        )

    # ------------------------------------------------------------- offline
    def drive(self, cost_fn: Callable[[dict], float], *args, **kwargs) -> dict:
        """Entire-Execution glue: run the search to completion now, with
        ``cost_fn(point)`` supplying each candidate's cost (the launcher /
        hillclimb loop).  Exploration is forced — ε only rations *live*
        traffic, and here every call is a replica evaluation.  Offline there
        is no serving thread to protect, so a pending candidate build is
        simply waited for."""
        stalls = 0
        while not self.at.finished:
            d = self.begin(*args, _force_explore=True, **kwargs)
            if d.kind != EXPLORE:  # compile in flight or just failed
                self.wait_pending()
                stalls += 1
                if stalls > 10_000:  # safety: candidate never materializes
                    break
                continue
            stalls = 0
            self.observe(d, float(cost_fn(dict(d.point))))
        return self.at.best_point
