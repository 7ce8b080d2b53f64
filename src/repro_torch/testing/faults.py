"""Deterministic fault injection — every resilience behavior testable
without real hangs, real OOMs, or real power loss.

A :class:`FaultPlan` is a list of :class:`FaultSpec` entries, each saying
*where* (an injection ``site`` and optional candidate/call match), *what*
(hang, transient error, hard crash, straggler slowdown, process kill), and
*how often* (``times`` firings).  Execution paths that opted in call
``plan.fire(site, key)`` at their injection seams — ``tune_call`` fires
``"tune"`` on entry, ``"build"`` per candidate compile, and ``"cost"`` per
cost evaluation — and the plan deterministically raises/sleeps per its specs.

Everything is counted, never random: the n-th call at a site always behaves
the same, so a faulted run is exactly reproducible and tests can assert the
recovery, not chase the injection.

Activation: pass a plan to ``tune_call(fault_plan=...)`` directly, or set
``REPRO_FAULT_PLAN`` to the plan's JSON — the CI chaos lane runs the whole
guard suite with a straggler plan injected this way.  :func:`active_plan`
caches one plan instance per distinct env value, so firing counters persist
across ``tune_call`` invocations within a process (a "kill at tune-call #2"
spec means the second *overall*, not the second per call).

:func:`tear_file` simulates a torn write (power loss mid-append) by
truncating a file mid-record — the journal/DB loaders must tolerate it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "ENV_FAULT_PLAN",
    "InjectedCrash",
    "FaultSpec",
    "FaultPlan",
    "parse_plan",
    "active_plan",
    "tear_file",
]

#: env var: JSON fault plan injected into every tune_call of the process
ENV_FAULT_PLAN = "REPRO_FAULT_PLAN"

_KINDS = ("hang", "slow", "transient", "crash", "kill")


class InjectedCrash(RuntimeError):
    """A deterministic stand-in for a hard candidate crash.  Classified
    "unexpected" by the kernel layer's failure classifier — a permanent,
    non-transient failure the guard must charge ``inf``, never retry."""


@dataclasses.dataclass
class FaultSpec:
    """One injected fault.

    ``site`` names the injection seam (``"tune"`` / ``"build"`` /
    ``"cost"`` / ``"save"`` — or any label a harness fires).  ``match``
    restricts firing to keys it matches: a dict matches candidate points by
    subset (``{"bm": 32}`` fires on every candidate with that knob), a
    string matches ``str(key)`` by substring.  ``calls`` restricts firing to
    the given 1-based call indices *at that site* (counted across the whole
    plan lifetime).  ``times`` caps total firings of this spec.

    Kinds: ``hang`` sleeps ``seconds`` (pair with a watchdog deadline
    shorter than that — the sleep bounds test runtime where a real hang
    would not); ``slow`` sleeps ``seconds`` then lets the call proceed (a
    straggler); ``transient`` raises a RESOURCE_EXHAUSTED-classed error;
    ``crash`` raises :class:`InjectedCrash`; ``kill`` raises ``SystemExit``
    — which intentionally propagates through every guard layer, simulating
    process death in-process for resume tests."""

    kind: str
    site: str = "cost"
    match: Optional[object] = None
    calls: Optional[Tuple[int, ...]] = None
    times: int = 1
    seconds: float = 0.05
    message: str = "RESOURCE_EXHAUSTED: injected transient failure"

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; known: {_KINDS}")
        if self.calls is not None:
            self.calls = tuple(int(c) for c in self.calls)
        self.times = int(self.times)

    def matches(self, key) -> bool:
        if self.match is None:
            return True
        if isinstance(self.match, dict):
            if not isinstance(key, dict):
                return False
            return all(key.get(k) == v for k, v in self.match.items())
        return str(self.match) in str(key)


class FaultPlan:
    """An ordered set of fault specs with per-site call counters."""

    def __init__(self, specs) -> None:
        self.specs: List[FaultSpec] = [
            s if isinstance(s, FaultSpec) else FaultSpec(**s) for s in specs
        ]
        self._site_calls: Dict[str, int] = {}
        self._fired_counts: Dict[int, int] = {}
        self.fired: list = []  # (site, call#, spec index, key) log for tests

    def fire(self, site: str, key=None) -> None:
        """One pass through an injection seam; applies every matching spec's
        effect in declaration order."""
        n = self._site_calls.get(site, 0) + 1
        self._site_calls[site] = n
        for i, spec in enumerate(self.specs):
            if spec.site != site:
                continue
            if self._fired_counts.get(i, 0) >= spec.times:
                continue
            if spec.calls is not None and n not in spec.calls:
                continue
            if not spec.matches(key):
                continue
            self._fired_counts[i] = self._fired_counts.get(i, 0) + 1
            self.fired.append((site, n, i, key))
            self._apply(spec, site, key)

    def _apply(self, spec: FaultSpec, site: str, key) -> None:
        if spec.kind in ("hang", "slow"):
            time.sleep(spec.seconds)
            return  # hang relies on the caller's watchdog firing first
        if spec.kind == "transient":
            raise RuntimeError(spec.message)
        if spec.kind == "crash":
            raise InjectedCrash(
                f"injected hard crash at {site} (key={key!r})"
            )
        if spec.kind == "kill":
            raise SystemExit(f"injected kill at {site} (key={key!r})")

    def count(self, site: Optional[str] = None) -> int:
        """Fired effects so far (optionally restricted to one site)."""
        if site is None:
            return len(self.fired)
        return sum(1 for s, *_ in self.fired if s == site)

    def stats(self) -> dict:
        return {
            "site_calls": dict(self._site_calls),
            "fired": len(self.fired),
        }


def parse_plan(text: str) -> FaultPlan:
    """Build a plan from JSON: a list of spec dicts, or ``{"specs": [...]}``."""
    blob = json.loads(text)
    if isinstance(blob, dict):
        blob = blob.get("specs", [])
    if not isinstance(blob, list):
        raise ValueError("fault plan JSON must be a list of specs")
    return FaultPlan(blob)


_active: Dict[str, FaultPlan] = {}  # env value -> live plan (counters persist)


def active_plan() -> Optional[FaultPlan]:
    """The process's env-configured plan, or ``None``.  One plan instance
    per distinct ``REPRO_FAULT_PLAN`` value — its counters span every
    ``tune_call`` of the process, so call-indexed specs count globally."""
    text = os.environ.get(ENV_FAULT_PLAN, "").strip()
    if not text:
        return None
    plan = _active.get(text)
    if plan is None:
        plan = parse_plan(text)
        _active[text] = plan
    return plan


def tear_file(path: str, keep_bytes: Optional[int] = None) -> int:
    """Simulate a torn write: truncate ``path`` mid-record.  Keeps
    ``keep_bytes`` (default: half, landing inside the final line) and
    returns the new size — loaders must treat the dangling tail as absent,
    not as corruption of the whole file."""
    size = os.path.getsize(path)
    keep = size // 2 if keep_bytes is None else int(keep_bytes)
    keep = max(0, min(keep, size))
    with open(path, "r+b") as f:
        f.truncate(keep)
    return keep
