"""DB-backed entry point for the hand-written kernels.

``autotuned(name, *args)`` is the one call sites use when they want tuned
block shapes without owning a tuning loop: it fingerprints the call context
(kernel name, input shapes/dtypes, search space, backend/device), consults the
:class:`repro_torch.tuning.TuningDB`, and dispatches the kernel with

* the stored best on an **exact** fingerprint hit (zero overhead),
* a stored **neighbor**'s point clamped into this shape's space (near miss),
* the kernel's registered defaults on a cold miss — or, with ``tune=True``,
  a measured PATSMA search (warm-seeded from the neighbor when one exists)
  whose result is committed back to the DB.

The ``pretune`` CLI sweeps the registered grid below offline so production
processes land on the first branch.

``routed(name, *args)`` goes one step further: every call flows through a
:class:`~repro_torch.runtime.ContextRouter` (:func:`kernel_router`) that
keeps tuning the context online from live calls (ε-exploration) and commits
what it learns to the DB.

CUDA tensors launch the CUDA kernels; ``interpret=True`` runs their plain
versions on CPU tensors (and keys the records ``{"interpret": true}``, the
same key the JAX package's interpret-mode records carry).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core import (
    H100_SXM,
    Autotuning,
    ExecutableCache,
    FaultPolicy,
    GuardTimeout,
    LogIntDim,
    MeasureEngine,
    MeasurePolicy,
    MeasureResult,
    Quarantine,
    RuntimeCost,
    SandboxUnavailable,
    SearchSpace,
    block_until_ready,
    compile_fanout,
    guarded_call,
    is_transient_failure,
    resolve_measure_policy,
    roofline_terms,
    sandboxed_probe,
    time_rep,
)
from repro_torch.obs import events as _events
from repro_torch.obs.log import get_logger
from repro_torch.obs.trace import tracer as _tracer
from repro_torch.tuning import TuningDB, default_db, make_key
from repro_torch.tuning.records import signature_of

from . import decode_attention as _da
from . import flash_attention as _fa
from . import linear_scan as _ls
from . import matmul as _mm
from . import ops

log = get_logger(__name__)

__all__ = [
    "autotuned",
    "tune_call",
    "routed",
    "kernel_router",
    "register",
    "get_spec",
    "registered",
    "KernelSpec",
    "exec_cache",
    "classify_failure",
]

#: env var: default build fan-out width for tune_call (0/unset → cpu count)
ENV_TUNE_JOBS = "REPRO_TUNE_JOBS"

# ------------------------------------------------------------------ registry
@dataclasses.dataclass(frozen=True)
class KernelSpec:
    name: str
    fn: Callable  # fn(*args, **kwargs, **knobs, interpret=...)
    space: Callable  # space(*args, **kwargs) -> SearchSpace over the knobs
    defaults: Callable  # defaults(*args, **kwargs) -> dict of knob values
    work: Callable  # work(*args, **kwargs) -> (FLOP, bytes) of one call
    # the dtype the arithmetic runs in, for the roofline's peak; None means
    # the first input's (the scans take bf16 inputs and compute in fp32)
    arith_dtype: Optional[str] = None
    # check(*args, interpret=..., **kwargs, **knobs): the wrapper's own tile
    # rules, raising ValueError for knobs the kernel refuses at these shapes,
    # without a launch (the router's background builds; see kernel_router)
    check: Optional[Callable] = None


_REGISTRY: dict = {}


def register(spec: KernelSpec) -> KernelSpec:
    _REGISTRY[spec.name] = spec
    return spec


def get_spec(name: str) -> KernelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown kernel {name!r}; registered: {sorted(_REGISTRY)}") from None


def registered() -> list:
    return sorted(_REGISTRY)


def _pow2_floor(n: int) -> int:
    """Largest power of two that divides n (n>0)."""
    return n & (-n)


def _log_dim(name: str, n: int, lo: int, cap: int) -> LogIntDim:
    """Power-of-two tile dim that always divides ``n``: bounds clamp to the
    largest power-of-two divisor of n, so every decodable value is legal."""
    g = _pow2_floor(int(n))
    lo = max(1, min(lo, g))
    hi = max(lo, min(cap, g, int(n)))
    return LogIntDim(name, lo, hi)


# --------------------------------------------------------- registered kernels
# Spaces are the JAX package's (same fingerprints, so both packages' records
# key alike).  Defaults are tiles the CUDA kernels can run at any size: the
# JAX defaults (256³ matmul tiles) exceed a Hopper block.
register(
    KernelSpec(
        name="matmul",
        fn=ops.matmul,
        space=lambda a, b: SearchSpace(
            [
                _log_dim("bm", a.shape[0], 32, 256),
                _log_dim("bn", b.shape[1], 32, 256),
                _log_dim("bk", a.shape[1], 32, 256),
            ]
        ),
        # clamped to each dim's largest power-of-two divisor, so they divide it
        defaults=lambda a, b: dict(zip(("bm", "bn", "bk"), _mm.default_tiles(
            _pow2_floor(a.shape[0]), _pow2_floor(b.shape[1]), _pow2_floor(a.shape[1]),
            a.element_size(), _mm.aligned(a, b),
        ))),
        work=lambda a, b: _mm.flops_bytes(a, b),
        check=lambda a, b, *, bm, bn, bk, interpret: _mm.legal_tiles(
            a.shape[0], b.shape[1], a.shape[1], bm, bn, bk, a.element_size(), not interpret,
            _mm.aligned(a, b),
        ),
    )
)

register(
    KernelSpec(
        name="flash_attention",
        fn=ops.flash_attention,
        # q: (B,Sq,H,hd); k/v: (B,Kh,Skv,hd)
        space=lambda q, k, v, **kw: SearchSpace(
            [
                _log_dim("block_q", q.shape[1], 16, 512),
                _log_dim("block_kv", k.shape[2], 16, 512),
            ]
        ),
        defaults=lambda q, k, v, **kw: {
            "block_q": min(128, _pow2_floor(q.shape[1])),
            "block_kv": min(128, _pow2_floor(k.shape[2])),
        },
        work=lambda q, k, v, causal=True: _fa.flops_bytes(q.transpose(1, 2), k, v, causal),
        check=lambda q, k, v, causal=True, *, block_q, block_kv, interpret: _fa.legal_blocks(
            q.shape[3], q.shape[1], k.shape[2], block_q, block_kv, q.element_size(), not interpret
        ),
    )
)

register(
    KernelSpec(
        name="decode_attention",
        fn=ops.decode_attention,
        # q: (B,H,hd); k/v: (B,Kh,S,hd); valid: (B,S) int32
        space=lambda q, k, v, valid: SearchSpace(
            [_log_dim("block_kv", k.shape[2], 64, 1024)]
        ),
        defaults=lambda q, k, v, valid: {"block_kv": _da.default_block_kv(q, k)},
        work=_da.flops_bytes,
        arith_dtype="float32",  # the kernel computes in fp32 whatever its inputs
        check=lambda q, k, v, valid, *, block_kv, interpret: _da.legal_tile(
            q.shape[1] // k.shape[1], q.shape[2], k.shape[2], block_kv, not interpret
        ),
    )
)

register(
    KernelSpec(
        name="lru_scan",
        fn=ops.lru_scan,
        # a,b: (B,T,D); h0: (B,D)
        space=lambda a, b, h0: SearchSpace([_log_dim("chunk", a.shape[1], 16, 256)]),
        defaults=lambda a, b, h0: {"chunk": min(128, _pow2_floor(a.shape[1]))},
        work=_ls.lru_flops_bytes,
        arith_dtype="float32",
        check=lambda a, b, h0, *, chunk, block_d=_ls.LRU_BLOCK_D, interpret: _ls.legal_lru(
            a.shape[1], a.shape[2], chunk, block_d, not interpret
        ),
    )
)

register(
    KernelSpec(
        name="rwkv_scan",
        fn=ops.rwkv_scan,
        # r,k,v,lw: (B,T,H,hd); u: (H,hd); s0: (B,H,hd,hd)
        space=lambda r, k, v, lw, u, s0: SearchSpace(
            [_log_dim("chunk", r.shape[1], 16, 128)]
        ),
        defaults=lambda r, k, v, lw, u, s0: {"chunk": min(64, _pow2_floor(r.shape[1]))},
        work=_ls.rwkv_flops_bytes,
        arith_dtype="float32",
        check=lambda r, k, v, lw, u, s0, *, chunk, interpret: _ls.legal_rwkv(
            r.shape[1], r.shape[3], chunk, not interpret, r.element_size(),
            all(x.data_ptr() % 16 == 0 for x in (r, k, v, lw, u, s0)),
        ),
    )
)


def roofline(name: str, *args, **kwargs):
    """:class:`~repro_torch.core.costs.RooflineTerms` of one call of kernel
    ``name`` on the H100: analytic FLOP and byte counts over the data-sheet
    peaks for the spec's ``arith_dtype``, else the first input's dtype."""
    spec = get_spec(name)
    flops, nbytes = spec.work(*args, **kwargs)
    dtype = spec.arith_dtype or signature_of(args[:1])[0][1]
    return roofline_terms(flops, nbytes, dtype, H100_SXM)


# ------------------------------------------------------------------- tuning
#: substrings that mark an *expected* failure: a candidate whose tile/block
#: configuration is illegal for this shape or doesn't fit the target memory.
#: Anything else is an unexpected error — a real bug the search must not eat.
_ILLEGAL_MARKERS = (
    "block",
    "tile",
    "grid",
    "divisible",
    "divides",
    "not a multiple",
    "memory space",
    "vmem",
    "smem",
    "out of memory",
    "resource_exhausted",
    "resource exhausted",
    # CUDA refusals of a launch configuration (normally caught before launch
    # by the wrappers' tile checks, which name the tile in a ValueError)
    "shared memory",
    "too many resources requested for launch",
    "invalid configuration argument",
)

#: exception types that are programmer errors no matter what the message says:
#: the knob names themselves ("block_q", "tile"...) show up in e.g. a TypeError
#: about an unknown kwarg, which must never pass for an illegal-tile failure
_BUG_EXC_TYPES = (TypeError, AttributeError, NameError, ImportError, SyntaxError)


def exec_cache() -> ExecutableCache:
    """The process-wide executable cache used by :func:`tune_call`."""
    return _EXEC_CACHE


def classify_failure(exc: BaseException) -> str:
    """``"illegal"`` (expected: bad tile for this shape/memory) or
    ``"unexpected"`` (a real bug that deserves a log line)."""
    if isinstance(exc, GuardTimeout):
        # a watchdog-expired candidate is an expected hazard of tuning on
        # live hardware, not a framework bug: charge inf quietly
        return "illegal"
    if isinstance(exc, _BUG_EXC_TYPES):
        return "unexpected"
    msg = f"{type(exc).__name__}: {exc}".lower()
    return "illegal" if any(m in msg for m in _ILLEGAL_MARKERS) else "unexpected"


def _failure_is_deterministic(exc: BaseException) -> bool:
    """Whether a build failure may be cached for the process lifetime.

    Only clearly deterministic illegal-tile failures qualify; unexpected
    errors, watchdog timeouts, and resource exhaustion (which can all be
    artifacts of concurrent compile load rather than the candidate itself)
    are retried on revisit."""
    return classify_failure(exc) == "illegal" and not is_transient_failure(exc)


#: process-level cache of built kernel callables, keyed by (context
#: fingerprint, decoded knobs) — revisited candidates across rounds,
#: optimizer resets, and pretune grid cells never rebuild.  Only
#: deterministic illegal-tile failures are cached; transient/unexpected
#: build failures are retried on revisit.
_EXEC_CACHE = ExecutableCache(
    maxsize=int(os.environ.get("REPRO_EXEC_CACHE_SIZE", "1024")),
    cache_failures=_failure_is_deterministic,
)


def _resolve_jobs(jobs: Optional[int]) -> int:
    if jobs is None:
        jobs = int(os.environ.get(ENV_TUNE_JOBS, "0") or 0)
    if jobs <= 0:
        # leave one core for the serial measurement thread; capped at 8 by
        # default — tuning rounds rarely have more unique candidates
        jobs = min(8, max(1, (os.cpu_count() or 2) - 1))
    return max(1, jobs)


def tune_call(
    name: str,
    *args,
    db: Optional[TuningDB] = None,
    interpret: bool = False,
    num_opt: int = 3,
    max_iter: int = 4,
    seed: int = 0,
    warmup: int = 1,
    repeats: int = 2,
    verbose: bool = False,
    source: str = "online",
    jobs: Optional[int] = None,
    cost_fn: Optional[Callable] = None,
    measure=None,
    bound_fn: Optional[Callable] = None,
    measure_stats: Optional[dict] = None,
    strategy: Optional[str] = None,
    objective: Optional[str] = None,
    warm_start: bool = True,
    fault_policy: Optional[FaultPolicy] = None,
    fault_plan=None,
    **kwargs,
):
    """Run a measured PATSMA search for this call context and commit the
    result to ``db``.  Warm-seeds from the nearest stored neighbor when one
    exists (half budget).  Returns the TuningRecord for the context.

    Candidates are evaluated in batches: each optimizer round is deduplicated,
    its unique points built concurrently (``jobs`` threads, default
    ``REPRO_TUNE_JOBS`` or min(8, CPU count − 1); a build checks the knobs
    and does one warm launch) through the process-level executable cache.
    Under either policy every build of a round finishes before its first
    measured repetition, and candidates are then measured strictly serially
    (one at a time), so no launch lands in another candidate's timing.  CUDA tensors are timed with the device
    synchronized after each repetition.

    ``measure`` picks the measurement policy (a
    :class:`~repro_torch.core.measure.MeasurePolicy`, ``"adaptive"``, ``"fixed"``,
    or ``None`` → the ``REPRO_TUNE_MEASURE`` env var, default adaptive):

    * **adaptive** — the racing engine: every candidate of a round gets one
      measured repetition, dominated candidates are culled at their single-rep
      cost, survivors escalate through the repeat ladder until separated;
      candidates whose roofline lower bound already exceeds the incumbent's
      measured cost skip measurement entirely.
    * **fixed** — the classic :class:`RuntimeCost` ``warmup``/``repeats``
      median per candidate, trajectory-identical to earlier releases.

    Failures are classified either way: expected illegal-tile candidates
    quietly cost ``inf``, each distinct unexpected error is logged once per
    search, and the committed record carries a ``crashed`` count plus the
    best point's ``cost_std``/``repeats_spent`` measurement confidence.

    ``cost_fn(callable, *args) -> float`` overrides wall-clock timing
    (used by tests/benchmarks for deterministic costs); under the adaptive
    policy each call supplies one repetition, and the roofline prefilter is
    disabled unless an explicit ``bound_fn(point, executable)`` provides
    bounds in the cost function's own units.  ``measure_stats``, if given a
    dict, receives the measurement engine's counters (reps spent, culls,
    roofline prunes) when the search finishes.

    ``strategy`` picks the search strategy (``"csa+nm"``, ``"csa|nm"``, ...
    — the :func:`repro_torch.core.strategy.make_strategy` grammar) over the
    same ``num_opt * max_iter`` tell budget the default CSA consumes; ``None``
    keeps the classic CSA search.  A :class:`~repro_torch.core.strategy.Portfolio`
    strategy reuses the adaptive engine's calibrated noise floor for its
    statistically-separated-lead culls.  The spec is stamped on the committed
    record (``strategy``).

    ``objective`` picks the statistic a candidate's repetitions reduce to
    (``"median"`` default, ``"p95"``, ``"p99"`` — see
    :data:`repro_torch.core.measure.OBJECTIVES`).  Tail objectives tune for
    worst-case latency: the search minimizes the chosen quantile of each
    candidate's measured repetitions, and the committed record is stamped
    with the objective so a p99 cost is never compared against a median one.

    ``warm_start=False`` disables the DB neighbor seeding, making each
    context's search independent of what else the DB holds — the fleet's
    shard-equivalence contract (a sharded sweep must reproduce the
    unsharded sweep's points) needs searches whose trajectories do not
    depend on the sweep's visiting order.

    ``fault_policy`` (a :class:`~repro_torch.core.guard.FaultPolicy`, default
    ``None`` = unguarded, trajectory-identical to earlier releases) arms the
    resilience layer: per-stage watchdog timeouts charge hung candidates
    ``inf`` instead of wedging the run, transient failures
    (RESOURCE_EXHAUSTED class) are retried in place with deterministic
    backoff, a candidate failing ``max_failures`` times is quarantined
    (skipped without a build, charged ``inf``), and with
    ``sandbox_first_touch`` each never-seen candidate is crash-probed in a
    forked child first so a hard crash is contained (CPU tensors only: a
    forked child cannot use CUDA, so with CUDA tensors or CUDA initialized
    it raises :class:`~repro_torch.core.guard.SandboxUnavailable`).
    ``fault_plan`` injects
    a deterministic :class:`~repro_torch.testing.faults.FaultPlan` at the
    ``"tune"``/``"build"``/``"cost"`` seams (``None`` reads the
    ``REPRO_FAULT_PLAN`` env var — the chaos CI lane's hook).
    """
    spec = get_spec(name)
    space = spec.space(*args, **kwargs)
    key = make_key(name, args=args, kwargs=kwargs, space=space,
                   extra={"interpret": bool(interpret)})
    db = db if db is not None else default_db()
    policy = resolve_measure_policy(
        measure, warmup=warmup, repeats=repeats, objective=objective
    )
    cost = cost_fn if cost_fn is not None else RuntimeCost(
        warmup=warmup, repeats=repeats, objective=policy.objective
    )
    jobs = _resolve_jobs(jobs)
    ctx = key.encode()
    logged: set = set()  # distinct unexpected errors already reported

    # --- resilience layer (all opt-in; None → identical trajectories)
    if fault_plan is None:
        from repro_torch.testing.faults import active_plan

        fault_plan = active_plan()
    plan = fault_plan
    fpol = fault_policy
    if fpol is not None and fpol.sandbox_first_touch and any(
        getattr(x, "is_cuda", False) for x in (*args, *kwargs.values())
    ):
        raise SandboxUnavailable(
            f"{name}: sandbox_first_touch forks a child per candidate, and a "
            "forked child cannot use CUDA; tune CUDA kernels without it"
        )
    quarantine = Quarantine(fpol.max_failures) if fpol is not None else None

    def qkey(p: dict):
        return tuple(sorted(p.items()))

    if plan is not None:
        plan.fire("tune", key=name)

    fatal = None
    if fpol is not None and fpol.fail_fast:
        def fatal(e: BaseException) -> bool:
            # a poisoned round: an error that is neither an expected illegal
            # tile nor a load transient would hit every candidate identically
            return classify_failure(e) == "unexpected" and not is_transient_failure(e)
    compile_deadline = fpol.compile_deadline if fpol is not None else None

    def build_for(knobs: dict):
        def build():
            if plan is not None:
                plan.fire("build", key=knobs)
            # a build is the knob check and one warm launch (the kernel
            # library itself is compiled once per process): an illegal tile
            # raises here, before any measurement
            fn = functools.partial(spec.fn, **kwargs, **knobs, interpret=interpret)
            block_until_ready(fn(*args))
            return fn

        if fpol is None:
            return build

        def probed():
            if fpol.sandbox_first_touch:
                # crash canary: a hard crash dies in a forked child and
                # surfaces as SandboxCrash, charged inf by the layers above
                sandboxed_probe(
                    build, timeout=fpol.sandbox_timeout, label=f"{name}:{knobs}"
                )
            return build()

        return fpol.wrap(probed, stage="compile", label=f"{name}:build")

    def note_failure(knobs: dict, exc: BaseException, stage: str) -> None:
        if isinstance(exc, (KeyboardInterrupt, SystemExit, SandboxUnavailable)):
            raise exc  # user interrupt or misconfiguration, not a candidate failure
        if quarantine is not None and quarantine.note_failure(qkey(knobs)):
            log.info(
                "%s: candidate %s quarantined after %d failures",
                name, knobs, quarantine.max_failures,
            )
        kind = classify_failure(exc)
        if kind == "unexpected":
            sig = (type(exc).__name__, str(exc).splitlines()[0] if str(exc) else "")
            if sig not in logged:
                logged.add(sig)
                log.warning(
                    "%s: unexpected %s error for %s: %s: %s",
                    name, stage, knobs, type(exc).__name__, exc,
                )
        elif verbose:
            log.info("%s: illegal candidate %s: %s", name, knobs, exc)

    # fixed-path counters (the adaptive engine keeps its own): measure_stats
    # must report repetitions spent in either mode
    fixed_counts = {"rounds": 0, "candidates": 0, "measured": 0, "failed": 0,
                    "reps": 0, "warmup_reps": 0, "timeouts": 0, "retried": 0}

    # obs forensics: every candidate a round asks for gets exactly one
    # terminal event — this is the completeness invariant the acceptance
    # gate checks (committed + culled + pruned + skipped + quarantined =
    # asked).  Emission lives here, after measurement, because only this
    # frame sees both the quarantine decision and the final MeasureResult.
    ev_round = [0]

    def emit_round_events(points, live, results) -> None:
        if _events.sink() is None:
            return
        ev_round[0] += 1
        sname = at.ctx_name()
        rnd = ev_round[0]
        live_set = set(live)
        for i, p in enumerate(points):
            _events.emit("candidate_asked", name=sname, point=dict(p), round=rnd)
            if i not in live_set:
                _events.emit("candidate_quarantined", name=sname, point=dict(p))
                continue
            r = results[i]
            if isinstance(r, MeasureResult):
                if r.pruned is not None:
                    _events.emit("candidate_pruned", name=sname, point=dict(p),
                                 bound=float(r.cost))
                elif r.culled:
                    _events.emit("candidate_culled", name=sname, point=dict(p),
                                 cost=float(r.cost), ci_lo=float(r.ci_lo),
                                 ci_hi=float(r.ci_hi))
                elif math.isfinite(r.cost):
                    _events.emit("candidate_committed", name=sname,
                                 point=dict(p), cost=float(r.cost))
                else:
                    _events.emit("candidate_skipped", name=sname,
                                 point=dict(p), reason="failed")
            else:
                c = float(r)
                if math.isfinite(c):
                    _events.emit("candidate_committed", name=sname,
                                 point=dict(p), cost=c)
                else:
                    _events.emit("candidate_skipped", name=sname,
                                 point=dict(p), reason="failed")

    def measure_one(p, ex):
        if isinstance(ex, BaseException):
            note_failure(p, ex, "compile")
            fixed_counts["failed"] += 1
            return np.inf

        def run():
            if plan is not None:
                plan.fire("cost", key=p)
            return float(cost(ex, *args))

        try:
            if fpol is not None and (
                fpol.measure_timeout is not None or fpol.retries > 0
            ):
                c = guarded_call(
                    run,
                    timeout=fpol.measure_timeout,
                    retries=fpol.retries,
                    backoff=fpol.backoff,
                    backoff_mult=fpol.backoff_mult,
                    jitter=fpol.jitter,
                    label=f"{name}:measure",
                    on_retry=lambda *_: fixed_counts.__setitem__(
                        "retried", fixed_counts["retried"] + 1
                    ),
                )
            else:
                c = run()
        except Exception as e:
            if isinstance(e, GuardTimeout):
                fixed_counts["timeouts"] += 1
            note_failure(p, e, "measure")
            fixed_counts["failed"] += 1
            return np.inf
        if quarantine is not None:
            quarantine.note_success(qkey(p))
        fixed_counts["measured"] += 1
        if isinstance(cost, RuntimeCost):
            fixed_counts["reps"] += len(cost.last_times)
            fixed_counts["warmup_reps"] += cost.warmup
            # surface the fixed schedule's measurement confidence too
            return MeasureResult(
                cost=c,
                cost_std=cost.last_std,
                repeats_spent=len(cost.last_times),
                times=list(cost.last_times),
            )
        fixed_counts["reps"] += 1  # one cost_fn call per candidate
        return c

    def measure_batch_fixed(points):
        # Concurrent build of the round's unique candidates, deduped
        # against every candidate this process ever built, then strictly
        # serial measurement (one candidate at a time, in order).  Every
        # build of the round finishes first: a build launches the kernel on
        # the card being timed, so a build still running would land in
        # another candidate's repetitions.
        fixed_counts["rounds"] += 1
        fixed_counts["candidates"] += len(points)
        results: list = [None] * len(points)
        live: list = []  # indices not quarantined
        for i, p in enumerate(points):
            if quarantine is not None and qkey(p) in quarantine:
                results[i] = np.inf  # skipped outright: no build, no measure
            else:
                live.append(i)
        items = [((ctx, qkey(points[i])), build_for(points[i])) for i in live]
        compiled = compile_fanout(
            items,
            cache=_EXEC_CACHE,
            jobs=min(jobs, max(1, len(items))),
            deadline=compile_deadline,
            fatal=fatal,
        )
        for i, ex in zip(live, compiled):
            results[i] = measure_one(points[i], ex)
        emit_round_events(points, live, results)
        return results

    # --- adaptive policy: racing engine over each built round
    if bound_fn is not None:
        analytic = bound_fn
    elif cost_fn is None:
        bound_s = roofline(name, *args, **kwargs).bound_s

        def analytic(point: dict, ex) -> float:
            # the knobs change the kernel's time, not the work the call must
            # do: every candidate shares the call's roofline lower bound
            return bound_s
    else:
        analytic = None

    def make_rep(p, ex):
        def rep():
            if plan is not None:
                plan.fire("cost", key=p)
            t = float(cost_fn(ex, *args)) if cost_fn is not None else time_rep(ex, *args)
            if quarantine is not None:
                quarantine.note_success(qkey(p))
            return t

        return rep

    engine_policy = policy
    if cost_fn is not None and policy.mode == "adaptive" and not isinstance(
        measure, MeasurePolicy
    ):
        # a user cost function owns its own stabilization (per-rep warmup
        # would burn extra cost_fn calls) and returns costs in *its own
        # units* — the seconds-denominated abs_noise prior would swamp
        # small-magnitude costs and disable racing, so only the relative
        # floor applies.  An explicitly passed MeasurePolicy is authoritative.
        import dataclasses as _dc

        engine_policy = _dc.replace(policy, warmup=0, abs_noise=0.0)
    engine = MeasureEngine(engine_policy, guard=fpol)

    def measure_batch_adaptive(points):
        # racing compares candidates *within* the round; as in the fixed
        # policy, the round's builds all finish before the first repetition
        if engine.noise is not None and hasattr(at.optimizer, "set_noise"):
            # a Portfolio strategy separates leads with the same noise floor
            # the engine calibrated for candidate racing
            at.optimizer.set_noise(engine.noise)
        live = [
            i for i, p in enumerate(points)
            if quarantine is None or qkey(p) not in quarantine
        ]
        items = [((ctx, qkey(points[i])), build_for(points[i])) for i in live]
        compiled_live = compile_fanout(
            items,
            cache=_EXEC_CACHE,
            jobs=min(jobs, max(1, len(items))),
            deadline=compile_deadline,
            fatal=fatal,
        )
        by_index = dict(zip(live, compiled_live))
        # bounds are only worth computing once a finite incumbent exists —
        # the prefilter is disabled before the first measured round anyway,
        # so round 1 never computes bounds per candidate
        want_bounds = analytic is not None and math.isfinite(engine.best_measured)
        reps, bounds = [], []
        for i, p in enumerate(points):
            ex = by_index.get(i)  # quarantined candidates never compiled
            if ex is None or isinstance(ex, BaseException):
                if ex is not None:
                    note_failure(p, ex, "compile")
                reps.append(None)
                bounds.append(None)
            else:
                reps.append(make_rep(p, ex))
                bounds.append(analytic(p, ex) if want_bounds else None)
        engine.on_error = lambda i, e: note_failure(points[i], e, "measure")
        results = engine.measure_round(reps, bounds=bounds)
        emit_round_events(points, live, results)
        return results

    measure_batch = (
        measure_batch_adaptive if policy.mode == "adaptive" else measure_batch_fixed
    )
    at = Autotuning(
        space=space,
        ignore=0,  # RuntimeCost already discards warmup runs
        search=strategy,  # None -> the classic default CSA search
        num_opt=num_opt,
        max_iter=max_iter,
        seed=seed,
        cache=True,
        verbose=verbose,
        db=db,
        key=key,
        warm_start=warm_start,
        db_source=source,
        objective=policy.objective,
    )
    at.entire_exec_batch(measure_batch)
    at.commit()  # no-op if auto-committed / exact hit
    if measure_stats is not None:
        if policy.mode == "fixed":
            stats = dict(engine.stats)  # zeroed template (right key set)
            stats.update(fixed_counts)
        else:
            stats = dict(engine.stats)
            if engine.noise is not None:
                stats["noise_abs_floor"] = engine.noise.abs_floor
                stats["noise_rel"] = engine.noise.rel
        stats["mode"] = policy.mode
        if quarantine is not None:
            stats["quarantined"] = quarantine.stats()["quarantined"]
        if plan is not None:
            stats["faults_fired"] = plan.count()
        measure_stats.update(stats)
    return db.get(key)


# --------------------------------------------------- router-backed dispatch
_ROUTERS: dict = {}  # interpret flag -> process-wide ContextRouter
_ROUTER_EPSILON = 0.1


def _router_build(spec: KernelSpec, interpret: bool) -> Callable:
    """One candidate's executable; runs on the router's background pool.

    A build is the knob check alone (the kernel library is compiled once
    per process, at its first launch).  Unlike :func:`tune_call`'s builds it
    launches nothing: the pool runs while the serving thread times routed
    calls on the same card, and a launch from the pool would land inside
    that timing.  An illegal tile raises here and is charged ``inf`` by the
    tuner without spending a call on it."""

    def build(point: dict, *args, **kwargs):
        if spec.check is not None:  # a spec without one fails at its first call
            spec.check(*args, **kwargs, **point, interpret=interpret)
        return functools.partial(spec.fn, **kwargs, **point, interpret=interpret)

    return build


def kernel_router(
    *,
    interpret: bool = False,
    db: Optional[TuningDB] = None,
    epsilon: float = _ROUTER_EPSILON,
    jobs: Optional[int] = None,
    fresh: bool = False,
):
    """The process-wide :class:`repro_torch.runtime.ContextRouter` over every
    registered kernel (one router per ``interpret`` flavour).

    Contexts are (kernel × pow2 shape-bucket); each starts from the tuning
    DB (exact pretuned fingerprints replay instantly, neighbors warm-start a
    half-budget search) and keeps adapting online: an ``epsilon`` fraction
    of live calls measures a candidate whose knobs were checked on the
    background pool (:func:`_router_build`), and drift in the exploit costs
    triggers a warm re-search.  ``fresh=True`` builds an independently
    configured router (tests, custom db/epsilon) instead of the cached
    singleton; asking the existing singleton for a different configuration
    is an error, not a silent no-op.
    """
    from repro_torch.runtime.context import ContextRouter

    flag = bool(interpret)
    if not fresh and flag in _ROUTERS:
        if db is not None or epsilon != _ROUTER_EPSILON or jobs is not None:
            raise ValueError(
                f"kernel_router(interpret={flag}) is already configured; "
                "pass fresh=True for a differently-configured router"
            )
        return _ROUTERS[flag]
    router = ContextRouter(
        db=db if db is not None else default_db(),
        cache=_EXEC_CACHE,
        jobs=_resolve_jobs(jobs),
    )
    for name in registered():
        spec = get_spec(name)
        router.register(
            name,
            space=spec.space,
            defaults=spec.defaults,
            build=_router_build(spec, flag),
            epsilon=epsilon,
            extra={"interpret": flag},
        )
    if not fresh:
        _ROUTERS[flag] = router
    return router


def routed(
    name: str,
    *args,
    router=None,
    interpret: bool = False,
    **kwargs,
):
    """Adaptive kernel dispatch: like :func:`autotuned`, but every call flows
    through the kernel router — knobs keep improving while the process
    serves, and a drifted context re-tunes itself.

    A call explores a candidate only once its knobs were checked on the
    router's pool; otherwise it runs the context's current best.  The
    fallback path (no executable yet for the exploit knobs — e.g. the very
    first call of a cold context) launches the kernel itself at the knobs
    the router clamped into this exact shape's space.  Each call's time is
    taken with the output's CUDA device synchronized and fed to the router.
    """
    r = router if router is not None else kernel_router(interpret=interpret)
    decision = r.begin(name, *args, **kwargs)
    t0 = time.perf_counter()
    if decision.executable is not None:
        out = decision.executable(*args)
    else:
        spec = get_spec(name)
        out = spec.fn(*args, **kwargs, **decision.point, interpret=interpret)
    block_until_ready(out)
    r.observe(decision, time.perf_counter() - t0)
    return out


def autotuned(
    name: str,
    *args,
    db: Optional[TuningDB] = None,
    tune: bool = False,
    interpret: bool = False,
    **kwargs,
):
    """Dispatch kernel ``name`` with the best knobs known for this context."""
    spec = get_spec(name)
    space = spec.space(*args, **kwargs)
    key = make_key(name, args=args, kwargs=kwargs, space=space,
                   extra={"interpret": bool(interpret)})
    db = db if db is not None else default_db()
    rec, exact = db.lookup(key)
    if not exact and tune:
        tuned_rec = tune_call(name, *args, db=db, interpret=interpret, **kwargs)
        if tuned_rec is not None:  # all-crashed run: keep the neighbor fallback
            rec, exact = tuned_rec, True
    if exact:
        knobs = {n: rec.point[n] for n in space.names}
    elif rec is not None and all(n in rec.point for n in space.names):
        # neighbor: reuse its point, clamped into this shape's (smaller) space
        knobs = space.decode(space.encode(rec.point))
    else:
        knobs = spec.defaults(*args, **kwargs)
    return spec.fn(*args, **kwargs, **knobs, interpret=interpret)
