"""Process-level metrics registry: counters, gauges, fixed-bucket histograms,
and device counters (tensors summed on the card, read after the work).

The primitives (:class:`Counter`, :class:`Gauge`, :class:`Histogram`) are
plain thread-safe objects that components own directly — the executable
cache's hit/miss accounting and the breaker/quarantine state counters are
*built on* these rather than kept as parallel ad-hoc ints.  The process
:class:`MetricsRegistry` additionally get-or-creates metrics by name for
cross-cutting series that no single object owns (compile seconds, rep
seconds, ε-credit spend, retries/timeouts, drift events), and snapshots the
whole registry to one JSON-able dict for ``python -m repro_torch.tune report`` and the
``metrics.json`` artifact.

Everything here is always-on: an increment is one lock acquisition on ints,
cheap enough that no call site needs gating (the <2% disabled-overhead gate
in ``benchmarks/obs_overhead.py`` measures exactly this).
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Union

__all__ = [
    "Counter",
    "DeviceCounter",
    "MirroredStats",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry",
    "counter",
    "gauge",
    "histogram",
    "TIME_BUCKETS",
]

# log-spaced seconds ladder: 1µs .. 100s — covers timer reps (µs–ms) through
# AOT compiles and whole searches (s)
TIME_BUCKETS = (
    1e-6, 3e-6, 1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3,
    1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0, 10.0, 30.0, 100.0,
)


class Counter:
    """Monotonic counter.

    Number-like on read (``==``/``<``/``int()``/``bool()``) so it can
    replace a public int attribute (``CircuitBreaker.opens``,
    ``Quarantine.strikes``) without breaking existing comparisons."""

    __slots__ = ("_lock", "_value")

    def __init__(self, value: int = 0) -> None:
        self._lock = threading.Lock()
        self._value = int(value)

    def inc(self, n: Union[int, float] = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> Union[int, float]:
        with self._lock:
            return self._value

    def snapshot(self) -> Union[int, float]:
        return self.value

    def _cmp_value(self, other):
        if isinstance(other, Counter):
            return other.value
        if isinstance(other, (int, float)):
            return other
        return NotImplemented

    def __eq__(self, other):
        v = self._cmp_value(other)
        return NotImplemented if v is NotImplemented else self.value == v

    def __lt__(self, other):
        v = self._cmp_value(other)
        return NotImplemented if v is NotImplemented else self.value < v

    def __le__(self, other):
        v = self._cmp_value(other)
        return NotImplemented if v is NotImplemented else self.value <= v

    def __gt__(self, other):
        v = self._cmp_value(other)
        return NotImplemented if v is NotImplemented else self.value > v

    def __ge__(self, other):
        v = self._cmp_value(other)
        return NotImplemented if v is NotImplemented else self.value >= v

    # mutable, so identity hash (value-eq Counters are not dict-key equal)
    __hash__ = object.__hash__

    def __int__(self) -> int:
        return int(self.value)

    def __float__(self) -> float:
        return float(self.value)

    def __index__(self) -> int:
        return int(self.value)

    def __bool__(self) -> bool:
        return bool(self.value)

    def __repr__(self) -> str:
        return f"Counter({self.value})"


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("_lock", "_value")

    def __init__(self, value: float = 0.0) -> None:
        self._lock = threading.Lock()
        self._value = value

    def set(self, v: Union[int, float, str]) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: Union[int, float] = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: Union[int, float] = 1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self):
        with self._lock:
            return self._value

    def snapshot(self):
        return self.value

    def __repr__(self) -> str:
        return f"Gauge({self.value})"


class Histogram:
    """Fixed-bucket histogram: ``counts[i]`` counts observations ``<=
    buckets[i]`` (last bucket is the +inf overflow), plus running sum/count
    so means survive the bucketing."""

    __slots__ = ("_lock", "buckets", "counts", "sum", "count", "min", "max")

    def __init__(self, buckets: Sequence[float] = TIME_BUCKETS) -> None:
        b = sorted(float(x) for x in buckets)
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        self._lock = threading.Lock()
        self.buckets: List[float] = b
        self.counts: List[int] = [0] * (len(b) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, x: float) -> None:
        x = float(x)
        i = bisect.bisect_left(self.buckets, x)
        with self._lock:
            self.counts[i] += 1
            self.sum += x
            self.count += 1
            if x < self.min:
                self.min = x
            if x > self.max:
                self.max = x

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "count": self.count,
                "sum": self.sum,
                "buckets": list(self.buckets),
                "counts": list(self.counts),
            }
            if self.count:
                out["mean"] = self.sum / self.count
                out["min"] = self.min
                out["max"] = self.max
            return out

    def __repr__(self) -> str:
        return f"Histogram(count={self.count}, sum={self.sum:.6g})"


class DeviceCounter:
    """A counter of many values kept on the device: :meth:`add` adds a
    tensor elementwise into one held there (created at the first add, with
    that tensor's shape, dtype and device), so a hot path counts without a
    host synchronisation.  A tensor of another shape, dtype or device
    starts the count over (another model in the process).  :meth:`snapshot`
    reads it to the host (a synchronisation) as a list; call it after the
    work."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = None

    def add(self, values) -> None:
        with self._lock:
            v = self._value
            if v is None or (v.shape, v.dtype, v.device) != (values.shape, values.dtype,
                                                             values.device):
                self._value = values.detach().clone()
            else:
                v.add_(values)

    def snapshot(self):
        with self._lock:
            return None if self._value is None else self._value.tolist()

    def __repr__(self) -> str:
        return f"DeviceCounter({self.snapshot()!r})"


class MirroredStats(dict):
    """A stats dict whose numeric increments mirror into the process
    registry under ``<prefix>.<key>`` — existing ``stats["x"] += 1``
    bookkeeping (measurement engine, online tuner) is thereby re-implemented
    on top of the metrics layer without changing a single read site.

    Only *growth* of numeric values is mirrored (counter semantics);
    non-numeric entries (``mode`` strings) and resets pass through to the
    dict alone.

    The per-key :class:`Counter` objects are cached after the first
    increment so the serving hot path pays one per-counter lock, not a name
    format plus the registry's global lock, per request.  The cache is
    invalidated by registry generation so a test's ``registry().reset()``
    never leaves increments flowing into detached counters."""

    __slots__ = ("_prefix", "_mirrors", "_gen")

    def __init__(self, prefix: str, init: Optional[dict] = None) -> None:
        super().__init__(init or {})
        self._prefix = prefix
        self._mirrors: Dict[str, Counter] = {}
        self._gen = -1

    def __setitem__(self, key, value) -> None:
        old = self.get(key, 0)
        super().__setitem__(key, value)
        if (
            isinstance(value, (int, float))
            and isinstance(old, (int, float))
            and value > old
        ):
            gen = _REGISTRY._generation
            if self._gen != gen:
                self._mirrors = {}
                self._gen = gen
            c = self._mirrors.get(key)
            if c is None:
                c = self._mirrors[key] = counter(f"{self._prefix}.{key}")
            c.inc(value - old)


class MetricsRegistry:
    """Name → metric, get-or-create, one :meth:`snapshot` for all of them.

    Names are dotted (``compile.seconds``, ``measure.rep_seconds``,
    ``online.eps_credit_spent``) so the snapshot reads as a flat namespace.
    Asking for an existing name with a different type raises — silent
    shadowing would corrupt the series."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}
        # bumped on reset() so cached metric handles (MirroredStats mirrors)
        # know to re-resolve instead of incrementing dropped counters
        self._generation = 0

    def _get_or_create(self, name: str, cls, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {type(m).__name__}, "
                    f"not {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge, Gauge)

    def device_counter(self, name: str) -> DeviceCounter:
        return self._get_or_create(name, DeviceCounter, DeviceCounter)

    def histogram(
        self, name: str, buckets: Optional[Sequence[float]] = None
    ) -> Histogram:
        return self._get_or_create(
            name, Histogram, lambda: Histogram(buckets or TIME_BUCKETS)
        )

    def snapshot(self) -> dict:
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in sorted(items)}

    def reset(self) -> None:
        """Drop every metric (tests and benchmark isolation)."""
        with self._lock:
            self._metrics = {}
            self._generation += 1


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry."""
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str, buckets: Optional[Sequence[float]] = None) -> Histogram:
    return _REGISTRY.histogram(name, buckets)
