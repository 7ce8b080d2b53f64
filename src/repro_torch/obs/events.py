"""Structured JSONL event stream — every tuning decision, reconstructible.

One line per event, appended with the durability discipline of the pretune
``RunJournal`` scaled to a hot loop's event rate.  The ``RunJournal``
fsyncs per append because its appends are per-case, seconds apart; an
event stream emits hundreds of times per second inside the search loop it
observes, so the same guarantee is delivered at milestone granularity
instead of per line:

* events queue in memory and a daemon writer thread JSON-encodes, writes
  and flushes them on a :data:`DRAIN_INTERVAL_S` cadence — emitting costs
  the loop a stamp, a schema check and a queue append, nothing more (an
  eager wake per event was measured to cost several percent of tuning
  throughput in GIL ping-pong alone);
* durable milestones — ``db_commit``, ``search_end``, ``drift_reset``,
  ``breaker_transition`` (:data:`DURABLE_EVENTS`) — make the writer's next
  drain ``os.fsync`` (rate-limited to once per :data:`FSYNC_INTERVAL_S`
  seconds), so a ``SIGKILL`` can cost at most one drain interval's tail of
  *forensic* events — the tuning results themselves are durably owned by
  the ``TuningDB``/``RunJournal``, never by this stream;
* :meth:`EventSink.flush` / :meth:`EventSink.close` (``obs.shutdown()``)
  drain, flush + fsync whatever remains, and the directory is fsynced when
  the file is created.

:func:`read_events` tolerates the torn trailing line a crash can leave
either way.

Event vocabulary (``EVENT_SCHEMA`` maps type → required fields; the sink
stamps ``ts`` (unix seconds), ``type`` and ``pid`` on every event):

=========================  ====================================================
``search_start``           a measured search began for context ``name``
``search_end``             it finished: ``best_point``/``best_cost``/``evals``
``candidate_asked``        the optimizer asked for a (deduped) candidate
``candidate_committed``    measured to completion; its cost entered the search
``candidate_culled``       racing stopped it early (with its CI bounds)
``candidate_pruned``       roofline bound killed it before any repetition
``candidate_skipped``      build/measure failure (``reason`` says which)
``candidate_quarantined``  refused outright: the key is quarantined
``warm_start``             DB seeded the search (``kind``: exact | neighbor)
``db_commit``              the keep-better commit that actually stored
``drift_reset``            a drift detector triggered a re-search
``breaker_transition``     circuit breaker state change
``explore_rep``            one online explore repetition landed (high-rate)
``sampling_summary``       emitted at close: how many events sampling dropped
=========================  ====================================================

The invariant the acceptance gate (and ``tests/test_obs.py``) checks: within
one search, every ``candidate_asked`` is answered by **exactly one** terminal
event — committed + culled + pruned + skipped + quarantined = asked
(:func:`completeness`).

High-rate per-request forensics (:data:`SAMPLED_EVENTS` — currently
``explore_rep``) can be decimated with :meth:`EventSink.set_sample_rate`
(the ``REPRO_OBS_SAMPLE`` env var): a deterministic 1-in-N counter stride
keeps replays reproducible, dropped events are tallied per context, and
``close()`` emits one ``sampling_summary`` event carrying the tallies —
:func:`completeness` surfaces them as ``sampled_out`` per name, so the
account of what happened still balances under sampling.  Accounting events
(``candidate_asked`` / terminals) are never sampled.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Union

__all__ = [
    "EVENT_SCHEMA",
    "TERMINAL_EVENTS",
    "DURABLE_EVENTS",
    "SAMPLED_EVENTS",
    "EventSink",
    "read_events",
    "validate_events",
    "completeness",
]

EVENT_SCHEMA: Dict[str, frozenset] = {
    "search_start": frozenset({"name"}),
    "search_end": frozenset({"name", "best_point", "best_cost", "evals"}),
    "candidate_asked": frozenset({"name", "point", "round"}),
    "candidate_committed": frozenset({"name", "point", "cost"}),
    "candidate_culled": frozenset({"name", "point", "cost"}),
    "candidate_pruned": frozenset({"name", "point", "bound"}),
    "candidate_skipped": frozenset({"name", "point", "reason"}),
    "candidate_quarantined": frozenset({"name", "point"}),
    "warm_start": frozenset({"name", "kind"}),
    "db_commit": frozenset({"name", "point", "cost"}),
    "drift_reset": frozenset({"name", "level"}),
    "breaker_transition": frozenset({"from_state", "to_state"}),
    "explore_rep": frozenset({"name", "point", "cost"}),
    "sampling_summary": frozenset({"sampled_out"}),
}

TERMINAL_EVENTS = frozenset({
    "candidate_committed",
    "candidate_culled",
    "candidate_pruned",
    "candidate_skipped",
    "candidate_quarantined",
})

#: high-rate per-request forensic events subject to sink-side sampling.
#: Never includes accounting events: ``candidate_asked``/terminals must stay
#: exact for the :func:`completeness` identity.
SAMPLED_EVENTS = frozenset({
    "explore_rep",
})

#: milestones after which durable state changed (a commit landed, a search
#: concluded, a guard tripped): these make the writer's next drain
#: ``os.fsync``
DURABLE_EVENTS = frozenset({
    "search_end",
    "db_commit",
    "drift_reset",
    "breaker_transition",
})

#: writer-thread wake interval: a milestone-free stretch of events queues
#: at most this long before being encoded + pushed to the OS (the most a
#: SIGKILL can cost)
DRAIN_INTERVAL_S = 0.2

#: fsync rate limit: requested syncs coalesce to at most one per this many
#: seconds (close() always syncs), bounding the power-loss window without
#: paying an fsync per milestone in a hot tuning loop
FSYNC_INTERVAL_S = 1.0


def _jsonable(x: Any):
    """numpy scalars / arrays / anything exotic → JSON-safe."""
    for attr in ("item",):  # numpy scalar
        if hasattr(x, attr):
            try:
                return x.item()
            except Exception:
                pass
    if hasattr(x, "tolist"):
        try:
            return x.tolist()
        except Exception:
            pass
    return str(x)


#: one shared C-accelerated encoder — ``json.dumps(..., default=...)``
#: builds a fresh ``JSONEncoder`` per call, which costs more than the
#: encode itself on the small dicts a hot loop emits
_ENCODER = json.JSONEncoder(sort_keys=True, separators=(",", ":"),
                            default=_jsonable)


class EventSink:
    """Append-only JSONL sink (thread-safe).

    ``emit`` stamps + schema-checks the event and enqueues it; a daemon
    writer thread JSON-encodes and writes the queue every
    :data:`DRAIN_INTERVAL_S`, so the serialization cost stays off the
    instrumented loop.  :data:`DURABLE_EVENTS` make the writer's next
    drain ``os.fsync`` (rate-limited to once per
    :data:`FSYNC_INTERVAL_S`).  Order is preserved: there is one queue and
    every drain holds the one I/O lock.

    Holds the file open across drains (one ``open()`` per event would cost
    more than the search loop it observes); a forked child transparently
    reopens its own handle, restarts its own writer, and stamps its own
    pid."""

    def __init__(self, path: str) -> None:
        self.path = str(path)
        self._q: deque = deque()
        self._wake = threading.Event()
        self._io_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._writer: Optional[threading.Thread] = None
        self._closed = False
        self._sync_due = False
        self._fresh = not os.path.exists(self.path)
        self._pid = os.getpid()
        self._f = None
        self._last_sync = 0.0
        self.emitted = 0
        # deterministic 1-in-N sampling of SAMPLED_EVENTS (no RNG: replayed
        # workloads drop the same events); dropped events are tallied per
        # context name and reported once via a close-time sampling_summary
        self._sample_stride = 1
        self._sample_n = 0
        self.sampled_out = 0
        self._sampled_out_by_name: Dict[str, int] = {}
        self._summary_emitted = False
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)

    def set_sample_rate(self, rate: float) -> None:
        """Keep roughly ``rate`` of :data:`SAMPLED_EVENTS` (1-in-N stride,
        ``N = round(1/rate)``).  ``rate >= 1`` keeps everything."""
        rate = float(rate)
        if not rate > 0.0:
            raise ValueError(f"sample rate must be > 0, got {rate}")
        self._sample_stride = max(1, round(1.0 / rate)) if rate < 1.0 else 1
        self._sample_n = 0

    def emit(self, type: str, **fields: Any) -> dict:  # noqa: A002 - event type
        """Append one event; returns the stamped dict."""
        ev = dict(fields)
        ev["type"] = type
        ev["ts"] = time.time()
        ev["pid"] = os.getpid()
        required = EVENT_SCHEMA.get(type)
        if required is not None:
            missing = required - set(ev)
            if missing:
                raise ValueError(f"event {type!r} missing fields {sorted(missing)}")
        if self._sample_stride > 1 and type in SAMPLED_EVENTS:
            n = self._sample_n
            self._sample_n = n + 1
            if n % self._sample_stride:
                self.sampled_out += 1
                name = ev.get("name")
                if name is not None:
                    by = self._sampled_out_by_name
                    by[name] = by.get(name, 0) + 1
                return ev  # stamped + validated, deliberately not persisted
        self._q.append(ev)
        self.emitted += 1
        self._ensure_writer()
        if type in DURABLE_EVENTS:
            self._sync_due = True
        return ev

    # ------------------------------------------------------------- internals
    def _ensure_writer(self) -> None:
        w = self._writer
        if w is not None and w.is_alive() and self._pid == os.getpid():
            return
        with self._state_lock:
            w = self._writer
            if (w is None or not w.is_alive()) and not self._closed:
                # first use, or a forked child whose parent's writer thread
                # did not survive the fork
                self._writer = threading.Thread(
                    target=self._writer_loop, name="obs-events-writer",
                    daemon=True)
                self._writer.start()

    def _writer_loop(self) -> None:
        while not self._closed:
            self._wake.wait(timeout=DRAIN_INTERVAL_S)
            self._wake.clear()
            if self._q or self._sync_due:
                try:
                    self._drain()
                except Exception:
                    if self._closed:
                        return
                    raise

    def _drain(self) -> None:
        """Encode + write everything queued; flush; fsync when a durable
        event requested it (rate-limited)."""
        with self._io_lock:
            if self._closed:
                return
            pid = os.getpid()
            if self._f is None or pid != self._pid:
                if self._f is not None:  # post-fork: drop the inherited handle
                    try:
                        self._f.close()
                    except OSError:
                        pass
                self._f = open(self.path, "a", encoding="utf-8")
                self._pid = pid
            wrote = False
            while True:
                try:
                    ev = self._q.popleft()
                except IndexError:
                    break
                self._f.write(_ENCODER.encode(ev) + "\n")
                wrote = True
            sync = self._sync_due
            if not (wrote or sync):
                return
            self._f.flush()
            now = time.time()
            if sync and now - self._last_sync >= FSYNC_INTERVAL_S:
                os.fsync(self._f.fileno())
                self._last_sync = now
                self._sync_due = False
            if self._fresh:
                self._fsync_dir()
                self._fresh = False

    def flush(self) -> None:
        """Drain the queue, push buffered lines to the OS and fsync."""
        if self._closed:
            return
        self._drain()
        with self._io_lock:
            if self._f is not None:
                try:
                    os.fsync(self._f.fileno())
                    self._last_sync = time.time()
                    self._sync_due = False
                except (OSError, ValueError):
                    pass

    def close(self) -> None:
        """Drain + flush + fsync whatever is pending and release the
        handle (idempotent).  If sampling dropped events, one
        ``sampling_summary`` carrying the tallies is appended first."""
        if (self.sampled_out and not self._closed
                and not self._summary_emitted):
            self._summary_emitted = True  # before emit: close() may re-enter
            self.emit(
                "sampling_summary",
                sampled_out=self.sampled_out,
                per_name=dict(self._sampled_out_by_name),
                stride=self._sample_stride,
            )
        with self._state_lock:
            if self._closed:
                return
            w = self._writer
            self._writer = None
        try:
            self._drain()
        except (OSError, ValueError):
            pass
        self._closed = True
        self._wake.set()
        if w is not None and w.is_alive() and w is not threading.current_thread():
            w.join(timeout=2.0)
        with self._io_lock:
            if self._f is None:
                return
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except (OSError, ValueError):
                pass
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None

    def _fsync_dir(self) -> None:
        d = os.path.dirname(os.path.abspath(self.path))
        try:
            fd = os.open(d, os.O_RDONLY)
        except OSError:
            return  # platform without directory fds
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)


def read_events(path: str) -> List[dict]:
    """All events in ``path`` in order; a torn/garbled trailing line (the
    crash case fsync discipline allows) ends the read instead of raising."""
    out: List[dict] = []
    if not os.path.exists(path):
        return out
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                break  # torn trailing line: keep the readable prefix
            if isinstance(ev, dict):
                out.append(ev)
    return out


def validate_events(
    events: Union[str, Iterable[dict]], *, strict_types: bool = True
) -> List[str]:
    """Schema-check an event stream (path or parsed list); returns the list
    of problems (empty = valid).  ``strict_types=False`` lets unknown event
    types pass (forward compatibility), still checking the known ones."""
    if isinstance(events, str):
        events = read_events(events)
    problems: List[str] = []
    for i, ev in enumerate(events):
        t = ev.get("type")
        if t is None:
            problems.append(f"event {i}: no 'type'")
            continue
        for base in ("ts", "pid"):
            if base not in ev:
                problems.append(f"event {i} ({t}): missing {base!r}")
        required = EVENT_SCHEMA.get(t)
        if required is None:
            if strict_types:
                problems.append(f"event {i}: unknown type {t!r}")
            continue
        missing = required - set(ev)
        if missing:
            problems.append(f"event {i} ({t}): missing fields {sorted(missing)}")
    return problems


def completeness(events: Union[str, Iterable[dict]]) -> dict:
    """Candidate accounting per search ``name``: asked vs terminal events.

    Returns ``{name: {"asked": n, "committed": ..., "culled": ...,
    "pruned": ..., "skipped": ..., "quarantined": ...,
    "sampled_out": ..., "balanced": bool}}`` where ``balanced`` is the
    acceptance invariant (terminals sum == asked — sampling never touches
    accounting events, so the identity holds at any sample rate;
    ``sampled_out`` reports how many forensic events the sink dropped for
    that name, recovered from the close-time ``sampling_summary``)."""
    if isinstance(events, str):
        events = read_events(events)
    short = {
        "candidate_committed": "committed",
        "candidate_culled": "culled",
        "candidate_pruned": "pruned",
        "candidate_skipped": "skipped",
        "candidate_quarantined": "quarantined",
    }
    def _fresh() -> Dict[str, Any]:
        return {
            "asked": 0, "committed": 0, "culled": 0,
            "pruned": 0, "skipped": 0, "quarantined": 0, "sampled_out": 0,
        }

    acc: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        t = ev.get("type")
        if t == "sampling_summary":
            for name, n in (ev.get("per_name") or {}).items():
                acc.setdefault(name, _fresh())["sampled_out"] += int(n)
            continue
        name = ev.get("name")
        if name is None or (t != "candidate_asked" and t not in TERMINAL_EVENTS):
            continue
        a = acc.setdefault(name, _fresh())
        if t == "candidate_asked":
            a["asked"] += 1
        else:
            a[short[t]] += 1
    for a in acc.values():
        terminal = sum(a[k] for k in
                       ("committed", "culled", "pruned", "skipped", "quarantined"))
        a["terminal"] = terminal
        # sequential (non-batch) searches emit terminal events without asked
        # events — only the batched ask/tell path owes the exact identity
        a["balanced"] = terminal == a["asked"] if a["asked"] else True
    return acc


# ------------------------------------------------------------ process sink
_SINK: Optional[EventSink] = None
_SINK_LOCK = threading.Lock()


def set_sink(sink: Optional[EventSink]) -> None:
    global _SINK
    with _SINK_LOCK:
        _SINK = sink


def sink() -> Optional[EventSink]:
    return _SINK


def emit(type: str, **fields: Any) -> None:  # noqa: A002 - event type
    """Emit on the process sink; no-op (and allocation-free on the common
    path) while no sink is configured."""
    s = _SINK
    if s is None:
        return
    s.emit(type, **fields)
