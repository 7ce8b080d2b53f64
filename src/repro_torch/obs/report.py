"""``python -m repro_torch.tune report`` — render a search's forensics from obs artifacts.

Input is the directory ``--obs-dir`` produced (``events.jsonl``,
``trace.json``, ``metrics.json``), plus optionally a tuning DB and run
journals for fleet shard health.  Everything prints as plain text — this is
the human summary; the artifacts themselves stay machine-readable.

Sections:

* **timeline** — one bar per search (event stream), offset + duration
  against the run's span of wall time;
* **phase breakdown** — wall-clock per span phase (compile / measure /
  commit / other; ``compile`` is the span of a candidate's build) computed
  as *interval unions* over the trace, so concurrent fan-out builds are not
  double-counted; the total equals the root span's duration;
* **candidate accounting** — per search: asked vs committed + culled +
  pruned + skipped + quarantined (the completeness invariant);
* **metrics** — the registry snapshot's counters and histogram summaries;
* **shard health** — per run journal: committed / failed / interrupted
  cases and the age of its last event (liveness from the fsynced streams).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .events import completeness, read_events, validate_events

__all__ = ["render_report", "load_trace_spans", "phase_breakdown"]

PHASES = ("compile", "measure", "commit")


def load_trace_spans(trace_path: str) -> List[dict]:
    """The ``ph: "X"`` complete events of a Chrome trace file (``ts``/``dur``
    in microseconds)."""
    with open(trace_path, "r", encoding="utf-8") as f:
        blob = json.load(f)
    evs = blob.get("traceEvents", blob if isinstance(blob, list) else [])
    return [e for e in evs if e.get("ph") == "X"]


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    if not intervals:
        return 0.0
    intervals = sorted(intervals)
    total = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s)


def phase_breakdown(spans: Sequence[dict]) -> dict:
    """Wall-clock per phase from trace spans, as interval unions.

    Returns ``{"total_s", "phases": {phase: seconds}, "other_s"}`` where
    ``total_s`` is the union of root spans (spans with no ``parent_id`` —
    the run/search roots) and ``other_s = total_s - union(all phases)``, so
    the rows always sum to the total."""
    by_name: Dict[str, List[Tuple[float, float]]] = {}
    roots: List[Tuple[float, float]] = []
    allp: List[Tuple[float, float]] = []
    for e in spans:
        iv = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
        name = e.get("name", "?")
        if e.get("args", {}).get("parent_id") is None:
            roots.append(iv)
        if name in PHASES:
            by_name.setdefault(name, []).append(iv)
            allp.append(iv)
    total_us = _union_us(roots) if roots else _union_us(allp)
    covered_us = _union_us(allp)
    return {
        "total_s": total_us / 1e6,
        "phases": {p: _union_us(by_name.get(p, [])) / 1e6 for p in PHASES},
        "other_s": max(0.0, total_us - covered_us) / 1e6,
    }


def _fmt_s(s: float) -> str:
    return f"{s * 1e3:.1f}ms" if s < 1.0 else f"{s:.2f}s"


def _bar(frac: float, width: int = 28) -> str:
    n = max(0, min(width, int(round(frac * width))))
    return "#" * n + "." * (width - n)


def _timeline_lines(events: List[dict]) -> List[str]:
    starts: Dict[str, float] = {}
    rows: List[Tuple[str, float, float]] = []  # (name, t0, dur)
    for ev in events:
        if ev.get("type") == "search_start":
            starts[ev["name"]] = float(ev["ts"])
        elif ev.get("type") == "search_end" and ev.get("name") in starts:
            t0 = starts.pop(ev["name"])
            rows.append((ev["name"], t0, float(ev["ts"]) - t0))
    now = time.time()
    for name, t0 in starts.items():  # crashed / still-running searches
        rows.append((name + " (unfinished)", t0, max(0.0, now - t0)))
    if not rows:
        return ["  (no search_start/search_end events)"]
    t_min = min(t0 for _, t0, _ in rows)
    t_max = max(t0 + d for _, t0, d in rows)
    span_s = max(t_max - t_min, 1e-9)
    width = 40
    out = []
    for name, t0, d in sorted(rows, key=lambda r: r[1]):
        lo = int((t0 - t_min) / span_s * width)
        hi = max(lo + 1, int((t0 + d - t_min) / span_s * width))
        lane = " " * lo + "=" * (hi - lo) + " " * (width - hi)
        out.append(f"  [{lane}] {name}  +{_fmt_s(t0 - t_min)} for {_fmt_s(d)}")
    out.append(f"  span of run: {_fmt_s(span_s)} across {len(rows)} searches")
    return out


def _metrics_lines(metrics: dict) -> List[str]:
    out = []
    for name, v in sorted(metrics.items()):
        if isinstance(v, dict) and "count" in v:
            if v["count"]:
                out.append(
                    f"  {name:<34} n={v['count']:<7} mean={_fmt_s(v.get('mean', 0.0))}"
                    f" min={_fmt_s(v.get('min', 0.0))} max={_fmt_s(v.get('max', 0.0))}"
                )
        else:
            out.append(f"  {name:<34} {v}")
    return out or ["  (no metrics recorded)"]


def _journal_lines(journal_paths: Sequence[str], stale_s: float) -> List[str]:
    from repro_torch.tuning.db import RunJournal

    out = []
    for p in journal_paths:
        if not os.path.exists(p):
            out.append(f"  {p}: MISSING")
            continue
        j = RunJournal(p)
        s = j.summary()
        evs = j.events()
        # journals written before events carried timestamps: file mtime is
        # still a truthful "last fsynced append" signal
        last_ts = max((float(e.get("ts", 0.0)) for e in evs), default=0.0)
        if not last_ts:
            last_ts = os.path.getmtime(p)
        age = time.time() - last_ts
        interrupted = len(s.get("interrupted", ()))
        if interrupted == 0:
            health = "done"
        elif age <= stale_s:
            health = "live"
        else:
            health = f"STALLED ({_fmt_s(age)} since last event)"
        out.append(
            f"  {os.path.basename(p):<28} committed={len(s['committed'])} "
            f"failed={len(s['failed'])} interrupted={interrupted}  {health}"
        )
    return out


def render_report(
    obs_dir: str,
    *,
    db_path: Optional[str] = None,
    journals: Sequence[str] = (),
    stale_s: float = 300.0,
) -> Tuple[str, int]:
    """Build the full text report.  Returns ``(text, exit_code)`` — nonzero
    when the event stream fails schema validation or the candidate
    accounting does not balance."""
    lines: List[str] = []
    code = 0
    events_path = os.path.join(obs_dir, "events.jsonl")
    trace_path = os.path.join(obs_dir, "trace.json")
    metrics_path = os.path.join(obs_dir, "metrics.json")

    events = read_events(events_path)
    lines.append(f"obs report: {obs_dir}")
    lines.append(f"  events={len(events)} ({events_path})")

    problems = validate_events(events)
    if problems:
        code = 1
        lines.append(f"  SCHEMA: {len(problems)} problem(s):")
        lines.extend(f"    {p}" for p in problems[:20])
    else:
        lines.append("  schema: ok")

    lines.append("")
    lines.append("search timeline:")
    lines.extend(_timeline_lines(events))

    if os.path.exists(trace_path):
        spans = load_trace_spans(trace_path)
        br = phase_breakdown(spans)
        lines.append("")
        lines.append(f"phase breakdown ({len(spans)} spans, "
                     f"total {_fmt_s(br['total_s'])}):")
        total = max(br["total_s"], 1e-12)
        for p in PHASES:
            s = br["phases"][p]
            lines.append(f"  {p:<10} {_bar(s / total)} {_fmt_s(s)}"
                         f"  ({100.0 * s / total:5.1f}%)")
        lines.append(f"  {'other':<10} {_bar(br['other_s'] / total)} "
                     f"{_fmt_s(br['other_s'])}  ({100.0 * br['other_s'] / total:5.1f}%)")
    else:
        lines.append("")
        lines.append(f"phase breakdown: no trace at {trace_path} "
                     "(run still in flight? shutdown() writes it)")

    lines.append("")
    lines.append("candidate accounting (asked = committed+culled+pruned+skipped+quarantined):")
    acc = completeness(events)
    if not acc:
        lines.append("  (no candidate events)")
    for name, a in sorted(acc.items()):
        ok = "ok" if a["balanced"] else "IMBALANCED"
        if not a["balanced"]:
            code = 1
        lines.append(
            f"  {name:<34} asked={a['asked']:<4} committed={a['committed']:<4}"
            f" culled={a['culled']:<3} pruned={a['pruned']:<3}"
            f" skipped={a['skipped']:<3} quarantined={a['quarantined']:<3} {ok}"
        )

    if os.path.exists(metrics_path):
        with open(metrics_path, "r", encoding="utf-8") as f:
            metrics = json.load(f)
        lines.append("")
        lines.append("metrics:")
        lines.extend(_metrics_lines(metrics))

    if journals:
        lines.append("")
        lines.append("fleet shard health:")
        lines.extend(_journal_lines(journals, stale_s))
    elif db_path is not None:
        from repro_torch.tuning.db import RunJournal

        jp = RunJournal.path_for(db_path)
        if os.path.exists(jp):
            lines.append("")
            lines.append("fleet shard health:")
            lines.extend(_journal_lines([jp], stale_s))

    return "\n".join(lines) + "\n", code
