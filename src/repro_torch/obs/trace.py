"""Nestable spans over the port's layers, exported as Chrome trace JSON and
entered into any running ``torch.profiler`` trace.

Two span trees.  The tuning search::

    search                      one tune_call / pretune case
    └─ round                    one optimizer ask/tell round
       ├─ compile               one candidate's AOT build (per fan-out worker)
       ├─ measure               the round's repetition racing
       └─ commit                DB keep-better commit

and the hot paths of training and serving::

    train.step                  one make_train_step call
    ├─ train.forward            forward + loss, once a microbatch
    │  └─ ops.<kernel>.fwd      each kernel wrapper's forward
    ├─ train.backward           loss.backward(), once a microbatch
    │  └─ ops.<kernel>.bwd      each wrapper's backward (a root where autograd
    │                           runs it on its own thread, as on the card)
    └─ train.optimizer          the optimizer's update
    tuner.begin / tuner.observe one routed call's decision and its feedback,
                                joined by the decision's ``seq``
    graphs.replay               a decode chunk: the state loads + graph replay

The four ``train.*`` spans take device marks.

Design constraints, in order:

* **default-off and cheap**: every instrumentation site goes through
  :func:`span`, which returns a shared no-op context manager unless the
  tracer is enabled or a ``torch.profiler`` session is recording — no
  allocation, no clock read, no lock, no ``record_function``.
* **one span, two sinks**: a live span is kept by the tracer (``trace.json``
  and :meth:`Tracer.finished`), and while ``torch.profiler`` records it is
  also a ``record_function`` range, a ``user_annotation`` in the profiler's
  trace on the same clock as the device's kernels.  The profiler's own
  enabled flag is read once per span.
* **device marks on phase spans only**: a span opened with ``device=True``
  records a CUDA timing event on the current stream at entry and exit (only
  while live, only once CUDA is initialised, never while the stream is
  capturing a graph); :attr:`Span.device_ms` resolves them lazily, after the
  reader's own synchronize, so no sync is added to the hot path.
* **thread-safe and pool-aware**: each thread keeps its own span stack, so
  concurrent workers can't cross-nest.  ``ThreadPoolExecutor`` does *not*
  carry the submitting thread's context into workers, so cross-thread
  parenting is explicit: capture :func:`current_span` before ``submit`` and
  open the worker's span with ``parent=``, or wrap the callable with
  :meth:`Tracer.wrap`.  This is how ``compile_fanout`` builds and
  ``ShardedPortfolio`` member turns attach to the search that spawned them.
* **fork-aware**: a forked child (``sandbox_first_touch`` probes) must not
  re-export the parent's buffered spans; ``os.register_at_fork`` clears the
  child's buffer and stacks.
* **monotonic clocks**: timestamps are ``time.perf_counter_ns`` offsets from
  a per-process epoch — immune to wall-clock steps; the wall-clock anchor is
  kept once per export for correlating with the event stream.
* **samplable request spans**: per-request serving spans (opened with
  ``sampled=True``) can be decimated with :meth:`Tracer.set_sample_rate` —
  a deterministic 1-in-N counter stride, not an RNG, so a replayed workload
  keeps the same spans.  Sampled-out spans cost one counter tick and return
  the shared no-op.  Structural spans (search/round/compile) are never
  sampled out.

Spans kept while only the profiler records stay on the tracer until
:meth:`Tracer.reset` (``obs.configure`` resets it).  Export is the Chrome
trace ("complete" ``ph: "X"`` events) consumed by ``chrome://tracing`` and
https://ui.perfetto.dev.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = [
    "Span",
    "Tracer",
    "tracer",
    "span",
    "current_span",
    "export_chrome",
    "set_sample_rate",
]


class Span:
    """One timed region.  Created by :meth:`Tracer.span`; finished spans are
    buffered on the tracer until export."""

    __slots__ = (
        "name", "cat", "span_id", "parent_id", "pid", "tid",
        "t0_ns", "dur_ns", "args", "marks",
    )

    def __init__(
        self,
        name: str,
        cat: str,
        span_id: int,
        parent_id: Optional[int],
        pid: int,
        tid: int,
        t0_ns: int,
        args: Optional[Dict[str, Any]],
    ) -> None:
        self.name = name
        self.cat = cat
        self.span_id = span_id
        self.parent_id = parent_id
        self.pid = pid
        self.tid = tid
        self.t0_ns = t0_ns
        self.dur_ns: Optional[int] = None
        self.args = args
        self.marks = None  # (start, end) CUDA events of a device=True span

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds the stream took from the span's start to its end, or
        None without device marks.  The caller synchronizes first."""
        if self.marks is None:
            return None
        start, end = self.marks
        return start.elapsed_time(end)

    def __repr__(self) -> str:  # debugging aid only
        state = "open" if self.dur_ns is None else f"{self.dur_ns / 1e6:.3f}ms"
        return f"<Span {self.name} id={self.span_id} parent={self.parent_id} {state}>"


class _NullSpanContext:
    """The disabled-tracer fast path: one shared, stateless no-op."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpanContext()


def _cuda_event() -> "torch.cuda.Event":
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _SpanContext:
    __slots__ = ("_tracer", "_span", "_record", "_device", "_start")

    def __init__(self, tracer: "Tracer", span: Span, profiling: bool, device: bool) -> None:
        self._tracer = tracer
        self._span = span
        self._record = _autograd_profiler.record_function(span.name) if profiling else None
        self._device = device
        self._start = None

    def __enter__(self) -> Span:
        self._tracer._push(self._span)
        if self._record is not None:
            self._record.__enter__()
        if (self._device and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            self._start = _cuda_event()
        return self._span

    def __exit__(self, *exc) -> bool:
        if self._start is not None:
            self._span.marks = (self._start, _cuda_event())
        if self._record is not None:
            self._record.__exit__(None, None, None)
        self._tracer._pop(self._span)
        return False


class Tracer:
    """Thread-safe span collector (see module docstring)."""

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._finished: List[Span] = []
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._pid = os.getpid()
        self._epoch_ns = time.perf_counter_ns()
        self._epoch_unix = time.time()
        # request-span sampling: keep 1 in _sample_stride of sampled=True
        # spans (deterministic counter, no RNG — replays keep the same spans)
        self._sample_stride = 1
        self._sample_counter = itertools.count(0)

    # ----------------------------------------------------------- lifecycle
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._finished = []
            self._ids = itertools.count(1)
        self._local = threading.local()
        self._epoch_ns = time.perf_counter_ns()
        self._epoch_unix = time.time()
        self._sample_stride = 1
        self._sample_counter = itertools.count(0)

    def set_sample_rate(self, rate: float) -> None:
        """Keep roughly ``rate`` of ``sampled=True`` spans (1-in-N stride,
        ``N = round(1/rate)``).  ``rate >= 1`` keeps everything."""
        rate = float(rate)
        if not rate > 0.0:
            raise ValueError(f"sample rate must be > 0, got {rate}")
        self._sample_stride = max(1, round(1.0 / rate)) if rate < 1.0 else 1
        self._sample_counter = itertools.count(0)

    def _after_fork(self) -> None:
        # the child inherits the parent's buffer; it must not re-export it
        self._finished = []
        self._local = threading.local()
        self._pid = os.getpid()
        self._lock = threading.Lock()

    # --------------------------------------------------------------- spans
    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = []
            self._local.stack = st
        return st

    def current(self) -> Optional[Span]:
        """The innermost open span on *this* thread (None outside any)."""
        st = getattr(self._local, "stack", None)
        return st[-1] if st else None

    def span(
        self,
        name: str,
        cat: str = "tuning",
        *,
        parent: Optional[Span] = None,
        sampled: bool = False,
        device: bool = False,
        **args: Any,
    ):
        """Context manager opening a child of ``parent`` (default: this
        thread's current span).  Returns a shared no-op unless the tracer is
        enabled or ``torch.profiler`` is recording; under the profiler the
        span is also a ``record_function`` range.  ``sampled=True`` marks a
        high-rate per-request span subject to :meth:`set_sample_rate`
        decimation; ``device=True`` takes CUDA event marks (:attr:`Span.device_ms`)."""
        profiling = _autograd_profiler._is_profiler_enabled
        if not (self.enabled or profiling):
            return _NULL_SPAN
        return self._open(name, cat, parent, sampled, device, profiling, args)

    def _open(self, name, cat, parent, sampled, device, profiling, args):
        if sampled and self._sample_stride > 1:
            if next(self._sample_counter) % self._sample_stride:
                return _NULL_SPAN
        if parent is None:
            parent = self.current()
        sid = next(self._ids)  # itertools.count: atomic under the GIL
        s = Span(
            name=name,
            cat=cat,
            span_id=sid,
            parent_id=parent.span_id if parent is not None else None,
            pid=self._pid,
            tid=threading.get_ident(),
            t0_ns=time.perf_counter_ns() - self._epoch_ns,
            args=args or None,
        )
        return _SpanContext(self, s, profiling, device)

    def wrap(
        self,
        fn: Callable,
        name: str,
        cat: str = "tuning",
        **args: Any,
    ) -> Callable:
        """Wrap ``fn`` so it runs under a child span of the *submitting*
        thread's current span — the ``pool.submit(tracer.wrap(f, "compile"))``
        pattern.  A no-op passthrough while spans are off."""
        if not (self.enabled or _autograd_profiler._is_profiler_enabled):
            return fn
        parent = self.current()

        def wrapped(*a, **kw):
            with self.span(name, cat, parent=parent, **args):
                return fn(*a, **kw)

        return wrapped

    def _push(self, s: Span) -> None:
        self._stack().append(s)

    def _pop(self, s: Span) -> None:
        s.dur_ns = (time.perf_counter_ns() - self._epoch_ns) - s.t0_ns
        st = self._stack()
        # tolerate exotic unwind orders (generators, exceptions): remove the
        # span wherever it sits rather than corrupting neighbours
        if st and st[-1] is s:
            st.pop()
        elif s in st:
            st.remove(s)
        with self._lock:
            self._finished.append(s)

    # -------------------------------------------------------------- export
    def finished(self) -> List[Span]:
        with self._lock:
            return list(self._finished)

    def to_chrome(self) -> dict:
        """The Chrome trace JSON object (``traceEvents`` list of ``ph: "X"``
        complete events; timestamps/durations in microseconds; a span with
        device marks carries ``device_ms`` in its args)."""
        events: List[dict] = []
        with self._lock:
            spans = list(self._finished)
        if any(s.marks is not None for s in spans):
            torch.cuda.synchronize()
        tids = sorted({s.tid for s in spans})
        tid_map = {t: i for i, t in enumerate(tids)}  # compact, stable tids
        for i in tid_map.values():
            events.append({
                "ph": "M", "pid": self._pid, "tid": i,
                "name": "thread_name", "args": {"name": f"worker-{i}"},
            })
        for s in spans:
            args = dict(s.args) if s.args else {}
            args["span_id"] = s.span_id
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            if s.marks is not None:
                args["device_ms"] = s.device_ms
            events.append({
                "name": s.name,
                "cat": s.cat,
                "ph": "X",
                "ts": s.t0_ns / 1e3,
                "dur": (s.dur_ns or 0) / 1e3,
                "pid": s.pid,
                "tid": tid_map.get(s.tid, 0),
                "args": args,
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"epoch_unix": self._epoch_unix, "pid": self._pid},
        }

    def export_chrome(self, path: str) -> int:
        """Write the Chrome trace JSON to ``path``; returns #spans."""
        blob = self.to_chrome()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(blob, f)
        return sum(1 for e in blob["traceEvents"] if e.get("ph") == "X")


_TRACER = Tracer()
if hasattr(os, "register_at_fork"):  # not on every platform
    os.register_at_fork(after_in_child=_TRACER._after_fork)


def tracer() -> Tracer:
    """The process-wide tracer instance."""
    return _TRACER


def span(
    name: str,
    cat: str = "tuning",
    *,
    parent: Optional[Span] = None,
    sampled: bool = False,
    device: bool = False,
    **args,
):
    """Open a span on the process tracer (no-op context while neither the
    tracer nor ``torch.profiler`` is on).  The off check is repeated here,
    not delegated, so an off site costs one call."""
    profiling = _autograd_profiler._is_profiler_enabled
    if not (_TRACER.enabled or profiling):
        return _NULL_SPAN
    return _TRACER._open(name, cat, parent, sampled, device, profiling, args)


def set_sample_rate(rate: float) -> None:
    """Set the process tracer's request-span sample rate."""
    _TRACER.set_sample_rate(rate)


def current_span() -> Optional[Span]:
    """This thread's innermost open span — capture before handing work to a
    pool, pass as ``parent=`` inside the worker."""
    return _TRACER.current()


def export_chrome(path: str) -> int:
    return _TRACER.export_chrome(path)
