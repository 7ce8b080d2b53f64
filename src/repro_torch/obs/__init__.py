"""repro_torch.obs — observability for the tuning stack and
the port's hot paths.

Four pieces, one switch:

* :mod:`repro_torch.obs.trace` — nestable spans, thread-pool and fork aware,
  exported as Chrome trace JSON (``chrome://tracing`` / Perfetto): the
  tuning search (search → round → compile / measure / commit), a training
  step's phases (``train.step`` → ``train.forward`` / ``train.backward`` /
  ``train.optimizer``, each with CUDA event marks on the card), each kernel
  wrapper's forward and backward (``ops.<kernel>.fwd`` / ``.bwd``), the
  online tuner's ``tuner.begin`` / ``tuner.observe`` and each decode
  chunk's ``graphs.replay``.
* :mod:`repro_torch.obs.metrics` — process-level counters / gauges / fixed-bucket
  histograms; always on (increments are too cheap to gate).
* :mod:`repro_torch.obs.events` — a durable JSONL stream of every tuning decision,
  with the fsync discipline of the pretune run journal.
* :mod:`repro_torch.obs.log` — the ``REPRO_LOG``-controlled diagnostic logger
  library code uses instead of ad-hoc ``print``.

Observability is a **sidecar**: the tuning DB schema, committed records and
search trajectories are identical with it on or off.  Tracing and the event
stream are opt-in via :func:`configure` — the CLIs wire ``--obs-dir`` (or
the ``REPRO_OBS`` env var) to it — and every instrumentation site costs a
single attribute check while disabled.  Spans are also live, without
:func:`configure`, while a ``torch.profiler`` session records: each is then
a ``record_function`` range in the profiler's trace, on the device's clock,
and is kept by the tracer (:func:`tracer` ``().finished()``) as well.

    from repro_torch import obs
    obs.configure("artifacts/obs")      # or: REPRO_OBS=artifacts/obs
    ... tune ...
    obs.shutdown()                      # writes trace.json + metrics.json
                                        # (events.jsonl streamed all along)

Serving at scale: ``REPRO_OBS_SAMPLE=0.01`` (or ``configure(...,
sample=0.01)``) decimates the high-rate per-request artifacts — serving
``tuner.begin`` spans (each ``tuner.observe`` follows its ``tuner.begin``)
and ``explore_rep`` events — to 1-in-N with a deterministic counter stride.
Structural spans and accounting events are never sampled; the sink reports
what it dropped in a close-time ``sampling_summary`` so :func:`completeness`
still balances.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from . import events as events  # noqa: F401 (re-export)
from . import metrics as metrics  # noqa: F401
from . import trace as trace  # noqa: F401
from .events import EventSink, completeness, emit, read_events, validate_events
from .log import get_logger, set_level
from .metrics import counter, gauge, histogram, registry
from .trace import current_span, export_chrome, span, tracer

__all__ = [
    "configure",
    "configure_from_env",
    "shutdown",
    "enabled",
    "obs_dir",
    "span",
    "current_span",
    "tracer",
    "export_chrome",
    "emit",
    "read_events",
    "validate_events",
    "completeness",
    "EventSink",
    "counter",
    "gauge",
    "histogram",
    "registry",
    "get_logger",
    "set_level",
]

_OBS_DIR: Optional[str] = None

#: env var: sample rate in (0, 1] for per-request spans + events
ENV_OBS_SAMPLE = "REPRO_OBS_SAMPLE"

TRACE_FILE = "trace.json"
EVENTS_FILE = "events.jsonl"
METRICS_FILE = "metrics.json"


def enabled() -> bool:
    """Whether tracing + the event stream are active."""
    return _OBS_DIR is not None


def obs_dir() -> Optional[str]:
    return _OBS_DIR


def configure(directory: Optional[str], *, sample: Optional[float] = None) -> bool:
    """Enable tracing + events into ``directory`` (created if missing).

    ``None`` / empty disables (and flushes what was buffered).  Returns
    whether observability is enabled afterwards.  Idempotent for the same
    directory; a new directory re-points the sink and resets the tracer.
    ``sample`` (default: the ``REPRO_OBS_SAMPLE`` env var, else keep
    everything) decimates per-request spans/events to roughly that
    fraction."""
    global _OBS_DIR
    if not directory:
        if _OBS_DIR is not None:
            shutdown()
        return False
    directory = os.path.abspath(directory)
    if sample is None:
        raw = os.environ.get(ENV_OBS_SAMPLE)
        if raw:
            sample = float(raw)
    if _OBS_DIR == directory:
        if sample is not None:
            t = tracer()
            t.set_sample_rate(sample)
            s = events.sink()
            if s is not None:
                s.set_sample_rate(sample)
        return True
    if _OBS_DIR is not None:
        shutdown()
    os.makedirs(directory, exist_ok=True)
    _OBS_DIR = directory
    t = tracer()
    t.reset()
    t.enable()
    sink = EventSink(os.path.join(directory, EVENTS_FILE))
    if sample is not None:
        t.set_sample_rate(sample)
        sink.set_sample_rate(sample)
    events.set_sink(sink)
    return True


def configure_from_env() -> bool:
    """Opt in via ``REPRO_OBS=<dir>`` (how ``serve``/``train``/``pretune``
    pick it up without a flag); ``REPRO_OBS_SAMPLE`` tunes request-level
    sampling."""
    return configure(os.environ.get("REPRO_OBS") or None)


def shutdown() -> Optional[str]:
    """Flush artifacts (``trace.json``, ``metrics.json``), fsync and close
    the event stream, and disable.  Returns the directory written, or
    ``None`` if obs was off."""
    global _OBS_DIR
    d = _OBS_DIR
    if d is None:
        return None
    t = tracer()
    try:
        t.export_chrome(os.path.join(d, TRACE_FILE))
        with open(os.path.join(d, METRICS_FILE), "w", encoding="utf-8") as f:
            json.dump(registry().snapshot(), f, indent=1, sort_keys=True)
    finally:
        s = events.sink()
        if s is not None:
            s.close()
        t.disable()
        events.set_sink(None)
        _OBS_DIR = None
    return d
