"""ContextRouter — bucket live calls into tuning contexts and dispatch each
at that context's current-best knobs.

A *context* is what a tuning result is valid for: (route name ×
shape-bucket × caller extra such as batch size), fingerprinted with the
same :class:`repro_torch.tuning.TuningKey` machinery the persistent DB uses — so
pretuned records exact-hit router contexts, near-miss records warm-start
them, and whatever the router learns online commits straight back.

Shapes are bucketed to the next power of two (:func:`pow2_bucket`) before
fingerprinting: a decode call at sequence length 1000 and one at 1024 share
knobs (good tiles move with the problem size by powers of two — the same
assumption behind ``TuningKey.distance``), while 64 → 128 opens a fresh
context.  Exact shapes still key the *executables* (a built artifact is
shape-exact); only the knob search is shared across a bucket.

Each context owns an :class:`~repro_torch.runtime.online.OnlineTuner` (created
lazily on first sight, DB-warm-started) with its own
:class:`~repro_torch.runtime.drift.DriftDetector`; the router is the front door::

    router = ContextRouter(db=TuningDB("tuned/serve.json"))
    router.register("decode", space=lambda *a: SearchSpace([...]),
                    build=compile_decode_step, epsilon=0.1)
    ...
    d = router.begin("decode", token_batch)      # knobs for THIS request
    out = d.executable(token_batch) if d.executable else fallback(d.point)
    router.observe(d, measured_seconds)          # feeds search / drift

``begin``/``observe`` are **thread-safe** and lock-light on the hot path:
the exact-signature fast path reads one immutable dispatch snapshot (a dict
swapped atomically whenever a context is created — no lock, no contention at
any thread count), and the slow path (first sight of a signature, context
creation) runs under the router lock while per-context state transitions are
striped onto each tuner's own lock.  Compiles happen off-thread inside the
tuners (see :mod:`repro_torch.runtime.online`); ``begin(..., tenant=)`` threads
per-tenant ε-credit accounting through to the context's tuner.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from typing import Any, Callable, Mapping, Optional

from repro_torch.core import Autotuning, ExecutableCache
from repro_torch.core.measure import objective_quantile, resolve_measure_policy
from repro_torch.core.optimizer import NumericalOptimizer
from repro_torch.obs import metrics as _metrics

from .drift import DriftDetector
from .online import Decision, OnlineTuner

__all__ = ["ContextRouter", "RouteSpec", "pow2_bucket", "bucket_args"]


# ----------------------------------------------------------- shape bucketing
def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (n >= 1); the canonical shape bucket."""
    n = int(n)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


class _BucketedArray:
    """Shape/dtype proxy standing in for an array when fingerprinting a
    bucketed context (``signature_of`` reads these two attributes; the
    tensor's ``device`` rides along so the key names the card the call
    runs on, as :func:`~repro_torch.tuning.records.default_device` reads it)."""

    __slots__ = ("shape", "dtype", "device")

    def __init__(self, shape: tuple, dtype: Any, device: Any = None) -> None:
        self.shape = tuple(shape)
        self.dtype = dtype
        self.device = device


def bucket_args(
    args=(), kwargs: Optional[Mapping[str, Any]] = None,
    bucket: Callable[[int], int] = pow2_bucket,
):
    """Replace every array in a call's arguments by a proxy whose dims are
    bucketed; non-array values pass through.  Returns ``(args, kwargs)``."""

    def one(v):
        if hasattr(v, "shape") and hasattr(v, "dtype"):
            return _BucketedArray([bucket(int(d)) for d in v.shape], v.dtype,
                                  getattr(v, "device", None))
        return v

    return tuple(one(v) for v in args), {k: one(v) for k, v in (kwargs or {}).items()}


# ----------------------------------------------------------------- registry
@dataclasses.dataclass
class RouteSpec:
    """How to tune one route (a kernel, a decode step, ...).

    ``space``/``defaults``/``build`` receive the live call's arguments, so
    knob domains follow the request shapes exactly as the kernel registry's
    specs do.  ``drift=None`` disables drift detection for the route;
    otherwise the dict is passed to :class:`DriftDetector`.  ``measure``
    (a :class:`~repro_torch.core.measure.MeasurePolicy` or ``"adaptive"`` /
    ``"fixed"``) turns on multi-repetition explore racing in the route's
    tuners; ``None`` keeps one request per candidate.  ``strategy`` is a
    search-strategy spec string (``"csa+nm"``, ``"csa|nm"``, ... — see
    :func:`repro_torch.core.strategy.make_strategy`) used to build each
    context's search; with a staged strategy, environment drift (level 1) re-tunes
    through the refinement stage alone.  ``optimizer`` (a ``space -> opt``
    factory) overrides it.  ``breaker`` (kwargs dict for a
    :class:`~repro_torch.core.guard.CircuitBreaker`, e.g. ``{"threshold": 3,
    "cooldown": 8}``) arms per-context explore gating: each context gets its
    own breaker, so one failing shape-bucket stops burning ε-credits without
    suspending its healthy siblings; ``None`` disables gating.
    """

    name: str
    space: Callable  # (*args, **kwargs) -> SearchSpace
    build: Optional[Callable] = None  # (point, *args, **kwargs) -> executable
    defaults: Optional[Callable] = None  # (*args, **kwargs) -> dict
    epsilon: float = 0.1
    ignore: int = 0
    num_opt: int = 3
    max_iter: int = 4
    seed: int = 0
    optimizer: Optional[Callable[..., NumericalOptimizer]] = None  # (space) -> opt
    strategy: Optional[str] = None  # strategy spec (make_strategy grammar)
    drift: Optional[dict] = dataclasses.field(default_factory=dict)
    extra: dict = dataclasses.field(default_factory=dict)
    measure: Any = None  # explore repetition policy (None = classic)
    breaker: Optional[dict] = None  # CircuitBreaker kwargs (None = no gating)


class ContextRouter:
    """Maps live calls onto per-context :class:`OnlineTuner` instances.

    One router per process (or per serving component); contexts are created
    lazily as traffic reveals them and warm-start from ``db`` — an exact
    fingerprint hit serves the stored best from the first request with zero
    exploration, a neighbor record seeds a half-budget search.
    """

    def __init__(
        self,
        *,
        db=None,
        cache: Optional[ExecutableCache] = None,
        jobs: int = 1,
        bucket: Callable[[int], int] = pow2_bucket,
        db_source: str = "online",
        warm_start: bool = True,
    ) -> None:
        self.db = db
        # like OnlineTuner's default: never memoize build failures — a
        # transient compile error must not poison a candidate for the
        # process lifetime (callers with a failure classifier, e.g. the
        # kernel layer's _EXEC_CACHE, pass their own cache)
        self.cache = cache if cache is not None else ExecutableCache(
            cache_failures=lambda e: False
        )
        self._jobs = max(1, int(jobs))
        self._bucket = bucket
        self._db_source = str(db_source)
        self._warm_start = bool(warm_start)
        self._specs: dict = {}
        # router lock guards the slow path only (registration, context /
        # fast-path-snapshot creation); the hot path never takes it
        self._lock = threading.RLock()
        self._tuners: dict = {}  # encoded TuningKey -> OnlineTuner
        # exact call signature -> OnlineTuner: an IMMUTABLE snapshot.  Reads
        # are lock-free (reference load); updates copy-on-write under the
        # router lock and swap the reference atomically.
        self._fast: dict = {}
        self._fast_max = 4096  # bound: naturally varied exact shapes on a
        # long-lived server must not grow the memo forever (rebuild is one
        # make_key, so wholesale clearing is cheap)

    # ---------------------------------------------------------- registration
    def register(self, name: str, **fields) -> RouteSpec:
        """Register a route; ``fields`` are :class:`RouteSpec` fields."""
        spec = RouteSpec(name=name, **fields)
        with self._lock:
            self._specs[name] = spec
        return spec

    def spec(self, name: str) -> RouteSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise KeyError(
                f"unknown route {name!r}; registered: {sorted(self._specs)}"
            ) from None

    # ------------------------------------------------------------- contexts
    def context_key(self, name: str, args=(), kwargs=None, extra=None, space=None):
        """The bucketed :class:`TuningKey` fingerprint of one call context.

        Both the signature *and* the search space come from the bucketed
        shapes: every exact shape in a bucket must map to the identical
        fingerprint (and knob domain), or contexts would fragment by
        whichever exact shape arrived first and pretuned pow2 records could
        never exact-hit non-pow2 traffic."""
        from repro_torch.tuning import make_key

        spec = self.spec(name)
        kwargs = kwargs or {}
        b_args, b_kwargs = bucket_args(args, kwargs, self._bucket)
        if space is None:
            space = spec.space(*b_args, **b_kwargs)
        return make_key(
            name, args=b_args, kwargs=b_kwargs, space=space,
            extra={**spec.extra, **(extra or {})},
        )

    def _call_sig(self, name, args, kwargs, extra):
        try:
            if extra:
                try:  # common case: flat dict of hashable scalars — no
                    e = tuple(sorted(extra.items()))  # json round-trip
                    hash(e)
                except TypeError:
                    e = json.dumps(dict(extra), sort_keys=True, default=repr)
            else:
                e = ()
            parts = [name, e]
            for src in (args, sorted((kwargs or {}).items())):
                for v in src:
                    if hasattr(v, "shape") and hasattr(v, "dtype"):
                        parts.append(("a", tuple(int(d) for d in v.shape), str(v.dtype)))
                    else:
                        parts.append(("p", repr(v)))
            return tuple(parts)
        except Exception:
            return None

    def tuner(self, name: str, *args, extra=None, **kwargs) -> OnlineTuner:
        """The (lazily created) tuner owning this call's context.

        Hot path: one signature build + one lock-free dict read against the
        immutable dispatch snapshot.  Slow path (snapshot miss): context
        lookup/creation under the router lock, then a copy-on-write snapshot
        swap so subsequent calls for this signature go lock-free."""
        sig = self._call_sig(name, args, kwargs, extra)
        if sig is not None:
            t = self._fast.get(sig)  # immutable snapshot: no lock
            if t is not None:
                return t
        with self._lock:
            return self._tuner_slow(name, sig, args, kwargs, extra)

    def _tuner_slow(self, name, sig, args, kwargs, extra) -> OnlineTuner:
        if sig is not None:
            t = self._fast.get(sig)  # re-check: another thread raced us here
            if t is not None:
                return t
        spec = self.spec(name)
        b_args, b_kwargs = bucket_args(args, kwargs, self._bucket)
        # knob domain from the bucketed shapes (shared across the bucket);
        # candidates that turn out illegal for an off-bucket *exact* shape
        # fail their build and are absorbed as inf by the tuner
        space = spec.space(*b_args, **b_kwargs)
        key = self.context_key(name, args, kwargs, extra=extra, space=space)
        enc = key.encode()
        t = self._tuners.get(enc)
        if t is None:
            opt = spec.optimizer(space) if spec.optimizer is not None else None
            policy = (
                resolve_measure_policy(spec.measure)
                if spec.measure is not None else None
            )
            at = Autotuning(
                space=space,
                ignore=spec.ignore,
                # factory-built optimizer override, else the route's strategy
                # spec, else the default CSA
                search=opt if opt is not None else spec.strategy,
                num_opt=spec.num_opt,
                max_iter=spec.max_iter,
                seed=spec.seed,
                cache=True,
                db=self.db,
                key=key,
                warm_start=self._warm_start,
                db_source=self._db_source,
                objective=policy.objective if policy is not None else None,
            )
            # the drift detector watches the same statistic the route tunes:
            # a p99-objective route gets a 0.99-quantile detector unless the
            # caller pinned one explicitly
            drift_kw = dict(spec.drift) if spec.drift is not None else None
            if (
                drift_kw is not None
                and policy is not None
                and "quantile" not in drift_kw
            ):
                q = objective_quantile(policy.objective)
                if q != 0.5:
                    drift_kw["quantile"] = q
            drift = DriftDetector(**drift_kw) if drift_kw is not None else None
            # defaults from the EXACT shapes: the caller's fallback dispatch
            # runs the kernel with these knobs on the real arguments, so they
            # must be legal for the shapes actually served, not the bucket
            default_point = (
                spec.defaults(*args, **kwargs) if spec.defaults is not None else None
            )
            t = OnlineTuner(
                at,
                build=spec.build,
                cache=self.cache if spec.build is not None else None,
                jobs=self._jobs,
                epsilon=spec.epsilon,
                drift=drift,
                default_point=default_point,
                name=enc,  # executables are keyed per-context + exact shapes
                measure=policy if policy is not None else spec.measure,
                # a fresh breaker per context: failure storms are gated where
                # they happen, not across the whole route
                breaker=dict(spec.breaker) if spec.breaker is not None else None,
            )
            self._tuners[enc] = t
            _metrics.gauge("router.contexts").set(len(self._tuners))
        if sig is not None:
            # copy-on-write: readers keep their lock-free reference while we
            # publish a new snapshot (wholesale restart when the memo is full)
            fast = {} if len(self._fast) >= self._fast_max else dict(self._fast)
            fast[sig] = t
            self._fast = fast
        return t

    # ------------------------------------------------------------- serving
    def begin(
        self, name: str, *args, extra=None, tenant=None, **kwargs
    ) -> Decision:
        """Route one call: returns the decision of its context's tuner.

        A decision that carries an ``executable`` is always safe to run —
        the artifact was compiled for this exact call.  A decision *without*
        one (cold context, compile in flight) is served by the caller's
        fallback dispatch, so its knobs are clamped from the bucket's space
        into the exact shapes' space first: a bucket-legal block size is not
        necessarily legal for an off-bucket exact shape.  ``tenant`` names
        the request stream for per-tenant ε-credit budgeting."""
        d = self.tuner(name, *args, extra=extra, **kwargs).begin(
            *args, tenant=tenant, **kwargs
        )
        if d.executable is None and (args or kwargs):
            try:
                exact_space = self.spec(name).space(*args, **kwargs)
                d.point = exact_space.decode(exact_space.encode(d.point))
            except Exception:
                pass  # incompatible knobs: leave as-is, caller's fallback guards
        return d

    def observe(self, decision: Decision, cost: float) -> int:
        """Feed a served decision's measured cost back to its tuner."""
        if decision.tuner is None:
            raise ValueError("decision is not attached to a tuner")
        return decision.tuner.observe(decision, cost)

    def prewarm(self, name: str, points, *args, extra=None, wait=True, **kwargs):
        """Compile a route's candidate executables before serving starts."""
        self.tuner(name, *args, extra=extra, **kwargs).prewarm(
            points, *args, wait=wait, **kwargs
        )

    def wait_pending(self) -> None:
        with self._lock:
            tuners = list(self._tuners.values())
        for t in tuners:
            t.wait_pending()

    # ------------------------------------------------------------ inspection
    def contexts(self) -> list:
        """One summary dict per live context (for logs / debugging)."""
        with self._lock:
            items = list(self._tuners.items())
        out = []
        for enc, t in items:
            out.append(
                {
                    "key": enc,
                    "finished": t.finished,
                    "best_point": t.best_point,
                    "warm_started": t.at.warm_started,
                    "stats": t.stats(),
                }
            )
        return out

    def stats(self) -> dict:
        """Aggregate serving counters across every context.  Each context's
        counters are read under its own tuner lock, so per-tuner accounting
        identities survive into the aggregate even mid-traffic."""
        keys = (
            "calls", "explores", "exploits", "explore_candidates",
            "culled_explores", "deferred_explores", "inband_builds",
            "candidate_failures", "breaker_denied", "drift_resets",
            "searches_completed", "explore_reps_decided", "stale_explore_reps",
        )
        with self._lock:
            tuners = list(self._tuners.values())
        total = {"contexts": len(tuners)}
        total.update({k: 0 for k in keys})
        for t in tuners:
            with t._lock:
                for k in keys:
                    total[k] += t.stats_[k]
        total["cache"] = self.cache.stats()
        return total

    def snapshot(self) -> dict:
        """Cheap per-context health: each tuner's :meth:`OnlineTuner.snapshot`
        keyed by the encoded context (no cache walk, no drift stats)."""
        with self._lock:
            items = list(self._tuners.items())
        return {enc: t.snapshot() for enc, t in items}
