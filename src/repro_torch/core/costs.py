"""Cost backends for the tuner.

* :class:`RuntimeCost` — the paper's Runtime mode: wall time of a callable,
  synchronizing the CUDA device its output lives on so asynchronous kernel
  launches are included.
* :class:`ExecutableCache` + :func:`compile_fanout` — the batched
  measurement layer: candidate builds (a knob check plus one warm launch of
  the hand-written kernel, see :mod:`repro_torch.kernels.autotuned`) fanned
  out over a thread pool with a process-level cache, so revisited
  candidates — across tuning rounds, optimizer resets, and pretune grid
  cells — never rebuild.  Wall-clock *measurement* stays strictly serial for
  timing fidelity; only builds overlap.
* :class:`HardwareSpec` + :func:`roofline_terms` — the analytic lower bound
  of a kernel call from the FLOP and byte counts its shapes imply, over the
  card's data-sheet peaks (:data:`H100_SXM`).
* :class:`StepCounter` — the torch form of the JAX package's
  ``hlo_flops_bytes`` and ``collective_bytes``: a dispatch mode that counts
  what one rank of a step does (FLOPs, bytes, collective bytes by type, the
  peak of live bytes), on any device, the ``meta`` device of the dry run
  (:mod:`repro_torch.launch.dryrun`) included.  The JAX package's
  ``aot_compile`` has no torch form: eager PyTorch has no compiler to ask.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from collections import OrderedDict
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Any, Callable, Hashable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.obs import metrics as _metrics
from repro_torch.obs.trace import tracer as _tracer

__all__ = [
    "HardwareSpec",
    "H100_SXM",
    "RooflineTerms",
    "RuntimeCost",
    "ExecutableCache",
    "CachePartition",
    "compile_fanout",
    "roofline_terms",
    "StepCounter",
    "COLLECTIVES",
]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Per-card peak numbers (data sheet, not measured): the kernel roofline
    reads the peaks and the memory rate, the launch space
    (:mod:`repro_torch.launch.spaces`) also the links and the capacity.

    ``link_bw`` is the rate of one link in one direction, and ``links`` the
    card's count of them: a ring collective sends and receives at once, so
    ``link_bw * links`` is what each card can send while it receives as
    much."""

    name: str
    peak_flops: float  # FLOP/s, bf16 / fp16 dense on the tensor cores
    peak_flops_fp32: float  # FLOP/s, fp32 outside the tensor cores
    hbm_bw: float  # bytes/s
    link_bw: float = 25e9  # bytes/s per link, one direction
    links: int = 18  # links per card
    hbm_bytes: float = 80e9  # device memory per card

    def peak_for(self, dtype: str) -> float:
        """Peak FLOP/s for arithmetic on inputs of ``dtype`` (numpy name)."""
        return self.peak_flops if dtype in ("bfloat16", "float16") else self.peak_flops_fp32

    def __str__(self) -> str:
        return self.name


#: NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16 dense, 67 TFLOP/s fp32
#: non-tensor, 3.35 TB/s HBM3 — peaks that assume the 700 W power limit —
#: 80 GB of HBM3, and 18 NVLink-4 links of 25 GB/s each way (50 GB/s both
#: ways; 900 GB/s a card in total, 450 GB/s each way).
H100_SXM = HardwareSpec("h100-sxm", 989e12, 67e12, 3.35e12, link_bw=25e9, links=18,
                        hbm_bytes=80e9)


class RuntimeCost:
    """Wall time of ``fn(*args)`` over ``repeats`` runs (after ``warmup``
    discarded runs — the `ignore` idea at measurement level); the returned
    statistic is the ``objective`` over those reps (median by default,
    ``"p95"``/``"p99"`` for tail-latency tuning — see
    :data:`repro_torch.core.measure.OBJECTIVES`).

    The per-repeat raw times of the most recent call are kept on
    :attr:`last_times` (:attr:`last_std` is their sample standard deviation),
    so callers can surface measurement confidence — ``cost_std`` /
    ``repeats_spent`` on committed :class:`~repro_torch.tuning.TuningRecord`\\ s —
    without re-measuring.  Control-flow exceptions (``KeyboardInterrupt``,
    ``SystemExit``) raised by the measured callable always propagate; they
    must never be classified into a candidate failure cost by the layers
    above."""

    def __init__(
        self, warmup: int = 1, repeats: int = 3, objective: str = "median"
    ) -> None:
        from .measure import objective_quantile

        self.warmup = warmup
        self.repeats = repeats
        objective_quantile(objective)  # raises on unknown names
        self.objective = str(objective).strip().lower()
        self.last_times: list = []  # raw measured reps of the latest call

    def __call__(self, fn: Callable, *args, **kwargs) -> float:
        from .measure import block_until_ready as block

        self.last_times = []
        try:
            for _ in range(self.warmup):
                block(fn(*args, **kwargs))
            times = []
            for _ in range(self.repeats):
                t0 = time.perf_counter()
                block(fn(*args, **kwargs))
                times.append(time.perf_counter() - t0)
        except (KeyboardInterrupt, SystemExit):
            # an interrupt mid-measurement is a user action, not a candidate
            # cost — re-raise before any classifying handler can eat it
            raise
        self.last_times = list(times)
        if self.objective not in ("median", "p50"):
            from .measure import objective_value

            return objective_value(times, self.objective)
        times.sort()
        return times[len(times) // 2]

    @property
    def last_std(self) -> float:
        """Sample standard deviation of the latest call's measured reps."""
        ts = self.last_times
        if len(ts) < 2:
            return 0.0
        mean = sum(ts) / len(ts)
        return (sum((t - mean) ** 2 for t in ts) / (len(ts) - 1)) ** 0.5


# ------------------------------------------------------------ build cache
class ExecutableCache:
    """Thread-safe process-level cache of compiled executables.

    Keys are caller-chosen hashables (the tuning layer uses the context
    fingerprint + decoded knobs).  Values are whatever ``build`` returns —
    or the exception it raised: an illegal tile stays illegal, so a revisited
    crashing candidate should not pay a recompile either.  ``cache_failures``
    (a predicate on the exception) can veto that for failures that may be
    transient — e.g. RESOURCE_EXHAUSTED under concurrent compile load — so a
    revisit rebuilds instead of replaying a stale error; ``None`` caches every
    failure.  Concurrent requests for the same key share one build (per-key
    future).

    Stats: ``hits`` / ``misses`` count lookups, ``recompiles`` counts builds
    of a key that had already been built once (only possible after an LRU
    eviction — the acceptance gate for the batched tuner is that this stays
    at zero on the smoke grid; an uncached transient failure counts as a
    plain miss on retry, not a recompile).

    Multi-tenant budgets (default off): ``max_entries`` caps live entries
    below ``maxsize`` and ``max_bytes`` caps the summed ``size_of(result)``
    of *completed* builds — both evict least-recently-used completed entries
    (in-flight builds are never dropped mid-compile: racing waiters hold the
    future).  Every eviction increments :attr:`evictions` and the process
    registry counter ``cache.evictions``.
    """

    def __init__(
        self,
        maxsize: int = 1024,
        *,
        max_entries: Optional[int] = None,
        max_bytes: Optional[int] = None,
        size_of: Optional[Callable[[Any], int]] = None,
        cache_failures: Optional[Callable[[BaseException], bool]] = None,
        guard: Optional[Callable[[Callable[[], Any]], Callable[[], Any]]] = None,
    ) -> None:
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.maxsize = int(maxsize)
        self.max_entries = int(max_entries) if max_entries is not None else None
        self.max_bytes = int(max_bytes) if max_bytes is not None else None
        self._size_of = size_of
        self._cache_failures = cache_failures
        # optional resilience hook: wraps every owner build (e.g.
        # ``FaultPolicy.wrap`` adds a watchdog timeout + transient retries)
        # without callers having to wrap each build thunk themselves
        self._guard = guard
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Hashable, Future]" = OrderedDict()
        self._built: set = set()  # keys ever built (recompile accounting)
        self._sizes: dict = {}  # key -> size_of(result), completed builds only
        self._bytes = 0
        # lookup accounting on the obs metric primitive (repro_torch.obs.metrics):
        # stats() below is a snapshot of these counters, not a parallel copy
        self.hits = _metrics.Counter()
        self.misses = _metrics.Counter()
        self.recompiles = _metrics.Counter()
        self.evictions = _metrics.Counter()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _evict_one(self, key: Hashable) -> None:
        # caller holds self._lock
        del self._entries[key]
        self._bytes -= self._sizes.pop(key, 0)
        self.evictions.inc()
        _metrics.counter("cache.evictions").inc()

    def _enforce_caps(self) -> None:
        # caller holds self._lock; in-flight builds (no recorded size — their
        # future is unresolved) are skipped so waiters never lose their build
        entry_cap = self.maxsize
        if self.max_entries is not None:
            entry_cap = min(entry_cap, self.max_entries)
        while len(self._entries) > entry_cap:
            victim = next(
                (k for k in self._entries if k in self._sizes or
                 self._entries[k].done()),
                None,
            )
            if victim is None:
                break
            self._evict_one(victim)
        if self.max_bytes is not None:
            while self._bytes > self.max_bytes:
                victim = next((k for k in self._entries if k in self._sizes), None)
                if victim is None:
                    break
                self._evict_one(victim)

    def get_or_build(self, key: Hashable, build: Callable[[], Any]) -> Any:
        """Return the cached executable for ``key``, building it (once) on a
        miss.  Build failures are returned (and cached) as the exception
        object rather than raised — the measurement layer classifies them."""
        with self._lock:
            fut = self._entries.get(key)
            if fut is not None:
                self.hits.inc()
                self._entries.move_to_end(key)
                owner = False
            else:
                fut = Future()
                self._entries[key] = fut
                self.misses.inc()
                if key in self._built:
                    self.recompiles.inc()
                self._built.add(key)
                owner = True
                self._enforce_caps()
        if owner:
            t_build = time.perf_counter()
            try:
                run = self._guard(build) if self._guard is not None else build
                result: Any = run()
            except Exception as e:  # cached: deterministic for a fixed context
                result = e
                _metrics.counter("compile.failed").inc()
                if self._cache_failures is not None and not self._cache_failures(e):
                    # possibly transient: answer current waiters with the
                    # error but drop the entry so a revisit rebuilds
                    with self._lock:
                        if self._entries.get(key) is fut:
                            del self._entries[key]
                        self._built.discard(key)
            except BaseException as e:
                # never cache (e.g. KeyboardInterrupt mid-compile would
                # poison the key): drop the entry, unblock waiters, propagate
                with self._lock:
                    if self._entries.get(key) is fut:
                        del self._entries[key]
                    self._built.discard(key)
                fut.set_result(e)
                raise
            if not isinstance(result, BaseException):
                _metrics.histogram("compile.seconds").observe(
                    time.perf_counter() - t_build
                )
                if self.max_bytes is not None:
                    size = self._measure_size(result)
                    with self._lock:
                        if self._entries.get(key) is fut:
                            self._bytes += size - self._sizes.get(key, 0)
                            self._sizes[key] = size
                            self._enforce_caps()
            fut.set_result(result)
        return fut.result()

    def _measure_size(self, result: Any) -> int:
        """Byte size of one completed build for the ``max_bytes`` budget:
        the caller's ``size_of`` when given, else a ``sys.getsizeof``
        floor."""
        if self._size_of is not None:
            try:
                return max(0, int(self._size_of(result)))
            except Exception:
                return 0
        import sys

        try:
            return int(sys.getsizeof(result))
        except Exception:
            return 0

    def peek(self, key: Hashable, default: Any = None) -> Any:
        """Non-building, non-blocking lookup: the cached value (executable or
        cached exception object) if the build for ``key`` has *completed*,
        else ``default``.  Does not count toward hit/miss stats and does not
        touch LRU order — this is the serving hot path's "is it ready yet?"
        probe, which must never trigger or wait on a compile."""
        with self._lock:
            fut = self._entries.get(key)
        if fut is not None and fut.done():
            return fut.result()
        return default

    def stats(self) -> dict:
        with self._lock:
            return {
                "size": len(self._entries),
                "bytes": self._bytes,
                "hits": self.hits.value,
                "misses": self.misses.value,
                "recompiles": self.recompiles.value,
                "evictions": self.evictions.value,
            }

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._built.clear()
            self._sizes.clear()
            self._bytes = 0
            for c in (self.hits, self.misses, self.recompiles, self.evictions):
                c.inc(-c.value)

    def partition(self, tag: Hashable) -> "CachePartition":
        """A namespaced view of this cache: every key is transparently
        prefixed with ``tag``.  Fleet workers pinned to different devices
        compile the *same* candidate into device-specific executables —
        partitioned views keep those from colliding under one key while
        still sharing the process-wide LRU budget, stats, and per-key
        build deduplication."""
        return CachePartition(self, tag)


class CachePartition:
    """A key-prefixed view over a shared :class:`ExecutableCache` (see
    :meth:`ExecutableCache.partition`).  Same surface as the base cache;
    ``stats()``/``clear()`` act on the *shared* underlying cache."""

    def __init__(self, base: ExecutableCache, tag: Hashable) -> None:
        self.base = base
        self.tag = tag

    def _key(self, key: Hashable) -> Hashable:
        return ("__partition__", self.tag, key)

    def get_or_build(self, key: Hashable, build: Callable[[], Any]) -> Any:
        return self.base.get_or_build(self._key(key), build)

    def peek(self, key: Hashable, default: Any = None) -> Any:
        return self.base.peek(self._key(key), default)

    def partition(self, tag: Hashable) -> "CachePartition":
        return CachePartition(self.base, (self.tag, tag))

    def stats(self) -> dict:
        return self.base.stats()

    def clear(self) -> None:
        self.base.clear()

    def __len__(self) -> int:
        return len(self.base)


def compile_fanout(
    items: Sequence[Tuple[Hashable, Callable[[], Any]]],
    *,
    cache: Optional[ExecutableCache] = None,
    jobs: int = 1,
    deadline: Optional[float] = None,
    fatal: Optional[Callable[[BaseException], bool]] = None,
) -> List[Any]:
    """Compile ``items`` = [(key, build), ...] concurrently, deduped through
    ``cache``.  Returns one executable-or-exception per item, in order.

    A build's kernel launch and its synchronization run in native code with
    the GIL released, so a thread pool overlaps them; the Python around each
    ``build`` stays GIL-bound.

    ``deadline`` bounds the *whole round* in seconds: builds not finished at
    the deadline are cancelled where possible (never-started futures) or
    abandoned (in-flight builds keep running in the background and still
    populate the cache for a later round), and their items come back as
    :class:`~repro_torch.core.guard.GuardTimeout` failure objects.

    ``fatal`` is a predicate on completed failure results: the first failure
    it marks fatal cancels every outstanding future and is **raised** instead
    of returned — a poisoned round (e.g. a TypeError that would hit every
    candidate identically) fails fast instead of silently draining the
    executor.  Non-fatal failures keep the classic returned-not-raised
    contract.
    """
    from .guard import GuardTimeout

    if cache is None:
        cache = ExecutableCache(maxsize=max(len(items), 1))
    if jobs <= 1 or len(items) <= 1:
        t0 = time.monotonic()
        results: List[Any] = []
        for k, b in items:
            if deadline is not None and (time.monotonic() - t0) >= deadline:
                results.append(GuardTimeout(
                    f"compile round exceeded deadline of {deadline:.3g}s"
                ))
                continue
            # span the build thunk, not the lookup: a cache hit never runs
            # ``b``, so hits cost no span and the trace shows real compiles
            r = cache.get_or_build(k, _tracer().wrap(b, "compile"))
            if fatal is not None and isinstance(r, BaseException) and fatal(r):
                raise r
            results.append(r)
        return results
    pool = ThreadPoolExecutor(max_workers=min(jobs, len(items)))
    # wrap() captures *this* thread's current span, so worker-side compile
    # spans attach to the round that submitted them (pool threads have no
    # ambient span of their own); wrapping the build thunk rather than the
    # lookup means cache hits cost no span and the trace shows real compiles
    tr = _tracer()
    futs = [pool.submit(cache.get_or_build, k, tr.wrap(b, "compile"))
            for k, b in items]
    results = [None] * len(items)
    pending = {f: i for i, f in enumerate(futs)}
    try:
        t0 = time.monotonic()
        while pending:
            budget = None
            if deadline is not None:
                budget = deadline - (time.monotonic() - t0)
                if budget <= 0:
                    break
            done, _ = futures_wait(
                list(pending), timeout=budget, return_when=FIRST_COMPLETED
            )
            if not done:
                break  # deadline expired with builds still in flight
            for f in done:
                i = pending.pop(f)
                r = f.result()
                results[i] = r
                if fatal is not None and isinstance(r, BaseException) and fatal(r):
                    for pf in pending:
                        pf.cancel()
                    raise r
        for f, i in pending.items():
            f.cancel()
            results[i] = GuardTimeout(
                f"compile round exceeded deadline of {deadline:.3g}s"
            )
    finally:
        # never wait: a hung build must not block the round past its deadline
        pool.shutdown(wait=False)
    return results


# ----------------------------------------------------------------- roofline
@dataclasses.dataclass
class RooflineTerms:
    """The roofline terms of one kernel call or one rank's step, in seconds:
    a kernel call has the two single-card terms; the launch layer's dry run
    also sets the collective term, its bytes and the rank count (the JAX
    package's three-term ``RooflineTerms``)."""

    compute_s: float
    memory_s: float
    flops: float
    bytes_accessed: float
    hw: HardwareSpec
    collective_s: float = 0.0
    coll_bytes: float = 0.0
    chips: int = 1

    @property
    def dominant(self) -> str:
        """``"operations"``, ``"bytes"`` or ``"collective"``: the side that
        sets the bound."""
        if self.collective_s > max(self.compute_s, self.memory_s):
            return "collective"
        return "operations" if self.compute_s >= self.memory_s else "bytes"

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        """The JAX package's keys (``dominant`` in the port's words)."""
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "coll_bytes": self.coll_bytes,
            "chips": self.chips,
        }


def roofline_terms(
    flops: float, nbytes: float, dtype: str, hw: HardwareSpec = H100_SXM
) -> RooflineTerms:
    """Analytic roofline of a call that does ``flops`` operations on
    ``dtype`` inputs and must move ``nbytes`` (each input read once, each
    output written once): the least time the card could take."""
    return RooflineTerms(
        compute_s=float(flops) / hw.peak_for(dtype),
        memory_s=float(nbytes) / hw.hbm_bw,
        flops=float(flops),
        bytes_accessed=float(nbytes),
        hw=hw,
    )


# ------------------------------------------------------------ step counter
#: the JAX package's collective kinds (``collective_bytes``), by the
#: functional-collective op that does each on one rank
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_COLLECTIVE_OPS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
}
#: ops that move no bytes (besides views): allocation without a write,
#: aliases (``_unsafe_view`` is a view that autograd does not track as one),
#: and the collectives' bookkeeping
_NO_TRAFFIC = {"aten.empty", "aten.empty_strided", "aten.empty_like", "aten.detach",
               "aten.alias", "aten._unsafe_view", "aten.lift_fresh", "aten._local_scalar_dense",
               "_c10d_functional.wait_tensor", "_c10d_functional._wrap_tensor_autograd"}


#: FLOPs per output element of the pointwise ops the models issue, counted
#: as XLA's ``cost_analysis`` counts the HLO ops of the same formula, which
#: the JAX dry run reads: 1 for each elementwise arithmetic op, compare and
#: select; 0 for a transcendental (exp, log, sqrt, rsqrt, sin, cos, tanh:
#: XLA counts these under "transcendentals", not FLOPs).  A composite is
#: the sum of its formula's ops (sigmoid 1/(1+exp(-x)) = 3, silu = 4, the
#: tanh gelu 8, softplus 6); a backward op counts what XLA counts for the
#: JAX VJP of the same function less its forward (sigmoid 3, silu 5, the
#: tanh gelu 12, tanh 4, softplus 6, relu's select 1).  Read from
#: ``jax.jit(f).lower(...).compile().cost_analysis()`` one op at a time.
_PER_ELEMENT = {
    **dict.fromkeys(("add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "relu", "clamp",
                     "where", "masked_fill", "eq", "lt", "le", "gt", "ge", "bitwise_not",
                     "bitwise_and", "remainder", "threshold_backward"), 1),
    **dict.fromkeys(("exp", "log", "sqrt", "rsqrt", "sin", "cos", "tanh"), 0),
    "sigmoid": 3, "silu": 4, "gelu": 8, "softplus": 6,
    "sigmoid_backward": 3, "silu_backward": 5, "gelu_backward": 12, "tanh_backward": 4,
    "softplus_backward": 6,
}


#: a product with an output dtype of its own: ``flop_counter``'s bmm
#: formula takes no ``out_dtype`` argument and raises
_BMM_DTYPE = torch.ops.aten.bmm.dtype


def _rows(x, dim) -> int:
    """The number of 1-D slices of ``x`` along ``dim``."""
    return x.numel() // max(x.shape[dim], 1) if x.ndim else 1


def pointwise_flops(func, args, kwargs, out) -> float:
    """FLOPs of one pointwise, reduction or scatter op, counted as XLA's
    ``cost_analysis`` counts the same formula (:data:`_PER_ELEMENT`); 0
    for an op that moves data only (copies, views, gathers, concatenation)
    or that XLA does not count (top-k).  A convert counts 1 an element
    where the dtype changes, x² and x³ 1 and 2 (any other power is a
    transcendental).  Of N inputs in M slices: a sum or max counts N − M, a
    mean N (with its divides), a cumulative sum N − M, an argmax 9(N − M)
    (XLA's value-and-index reducer), softmax 4N − 2M (max, subtract, exp,
    sum, divide) and its backward 5N + 2M (the JAX VJP's count less the
    forward's); an index-add or scatter-add one add per source element."""
    name = func._opname.rstrip("_")
    out = out[0] if isinstance(out, (tuple, list)) else out
    if not isinstance(out, torch.Tensor):
        return 0.0
    x = args[0] if args and isinstance(args[0], torch.Tensor) else None
    m = out.numel()
    per = _PER_ELEMENT.get(name)
    if per is not None:
        return float(per * m)
    if name == "_to_copy":
        return float(m) if x.dtype != out.dtype else 0.0
    if name == "copy":
        return float(m) if args[0].dtype != args[1].dtype else 0.0
    if name == "pow":
        e = args[1] if len(args) > 1 else kwargs.get("exponent")
        squares = x is not None and not isinstance(e, torch.Tensor) and e in (2, 3)
        return float((e - 1) * m) if squares else 0.0
    if x is None:
        return 0.0
    n = x.numel()
    if name in ("sum", "amax"):
        return float(n - m)
    if name == "mean":
        return float(n)
    if name == "cumsum":
        return float(n - _rows(x, args[1]))
    if name == "argmax":
        return float(9 * (n - m))
    if name == "_softmax":
        return float(4 * n - 2 * _rows(x, args[1]))
    if name == "_softmax_backward_data":
        return float(5 * n + 2 * _rows(x, args[2]))
    if name in ("index_add", "scatter_add"):
        return float(args[3].numel())
    if name == "embedding_dense_backward":
        return float(n)
    if name == "index_put" and (args[3] if len(args) > 3 else kwargs.get("accumulate", False)):
        return float(args[2].numel())
    return 0.0


def _tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(*values) -> list:
    """The tensors among ``values`` and in the lists, tuples and dicts
    among them, one level deep: the shapes an op's arguments and results
    take."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(x for x in v if isinstance(x, torch.Tensor))
        elif isinstance(v, dict):
            out.extend(x for x in v.values() if isinstance(x, torch.Tensor))
    return out


class StepCounter(TorchDispatchMode):
    """Counts what one rank does while the mode is active: the torch
    counterpart of the JAX package's ``hlo_flops_bytes`` and
    ``collective_bytes`` (XLA's per-partition ``cost_analysis`` and the
    collectives of the partitioned HLO).

    It sees each rank's local ops only.  An op on DTensors reaches a
    dispatch mode first at the DTensor level, with global shapes; the
    counter hands it back (``NotImplemented``) so that DTensor runs it, and
    counts the local ops that DTensor then issues (``FlopCounterMode``
    counts both and so counts a sharded product twice).  The ops that
    DTensor's sharding propagation runs on fake tensors are not counted.

    * ``flops``: the products by ``torch.utils.flop_counter``'s formulas
      (mm, addmm, bmm, baddbmm, convolutions, SDPA) and ``aten::bmm.dtype``
      (the attention's scores on bf16 operands) by 2·B·M·N·K;
      every other floating-point op as XLA's ``cost_analysis`` counts it
      (:func:`pointwise_flops`).
    * ``bytes_accessed``: each op's input and output bytes, views and
      allocations excepted.  That is eager PyTorch's unfused traffic: XLA
      counts after fusion, so these bytes run higher than the JAX package's.
    * ``coll``: result bytes of each functional collective by kind, the
      ``collective_bytes`` convention (a reduce-scatter's result is the
      shard).
    * ``peak_bytes``: the peak of the live storages: those :meth:`hold`
      registered (the arguments) plus every storage an op made, until its
      last tensor dies.

    ``device`` (a device type, e.g. ``"meta"``) counts only the ops whose
    tensors lie there: DTensor plans its redistributions with small CPU
    tensors of its own, which are not the step's work.
    """

    def __init__(self, device: Optional[str] = None) -> None:
        super().__init__()
        self.device = device
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.coll = {k: 0.0 for k in COLLECTIVES}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: dict = {}

    @property
    def coll_bytes(self) -> float:
        return float(sum(self.coll.values()))

    def hold(self, tensors) -> None:
        """Count these tensors' storages as live (a DTensor by its local
        shard): the arguments of the step."""
        for t in tensors:
            self._track(getattr(t, "_local_tensor", t))

    def _track(self, t, nbytes: Optional[int] = None) -> None:
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._storages:
            return
        n = storage.nbytes() if nbytes is None else nbytes
        self._storages[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._release, key)

    def _release(self, key) -> None:
        self.live_bytes -= self._storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        inputs = _tensors(*args, *kwargs.values())
        if any(isinstance(a, DTensor) for a in inputs):
            return NotImplemented  # DTensor runs it; its local ops come back here
        out = func(*args, **kwargs)
        outputs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in inputs + outputs):
            return out  # sharding propagation, not a rank's work
        if self.device is not None and all(t.device.type != self.device
                                           for t in inputs + outputs):
            return out
        name = f"{func.namespace}.{func._opname}"
        kind = _COLLECTIVE_OPS.get(name)
        if kind is not None:
            self.coll[kind] += sum(_tensor_bytes(o) for o in outputs)
        elif not func.is_view and name not in _NO_TRAFFIC:
            if func is _BMM_DTYPE:
                self.flops += 2.0 * args[0].numel() * args[1].shape[-1]
            elif (formula := flop_registry.get(func.overloadpacket)) is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            else:
                self.flops += pointwise_flops(func, args, kwargs, out)
            self.bytes_accessed += (sum(_tensor_bytes(a) for a in inputs)
                                    + sum(_tensor_bytes(o) for o in outputs))
        for o in outputs:
            # a collective's result is a buffer of its own size (a fake
            # process group's may be a view of a larger scratch tensor)
            self._track(o, _tensor_bytes(o) if kind is not None else None)
        return out
