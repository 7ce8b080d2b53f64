"""Resilience layer — guard every compile and measurement against the ways
live hardware misbehaves.

PATSMA tunes *on the target*, where candidate configurations routinely go
wrong in ways a static legality check cannot see: a tile that hangs the
backend, a build that exhausts memory only under concurrent compile load, a
kernel that hard-crashes the process.  This module is the dynamic complement
to the illegal-candidate classifier — one bad candidate must never cost more
than its own budget:

* :class:`FaultPolicy` — the per-run knobs: per-stage watchdog timeouts,
  transient-retry counts with exponential backoff (deterministically
  jittered, so two shards never sync up their retry storms), and the
  max-failures threshold behind :class:`Quarantine`.
* :func:`guarded_call` — run a callable under a watchdog deadline, retrying
  transient failures with backoff.  Hang detection is thread-based: the
  callable runs on a daemon worker and the caller waits ``timeout``; a hung
  worker is abandoned (it cannot be killed from Python) and the candidate is
  charged ``inf`` by the classification layers above.
* :func:`sandboxed_probe` — optional subprocess sandbox for the *first touch*
  of a never-seen candidate: a hard crash (segfault, ``os._exit``) is
  contained in the child and surfaces as :class:`SandboxCrash` instead of
  killing the tuning run.
* :class:`Quarantine` — per-candidate failure counting; a candidate that
  fails ``max_failures`` times stops being offered a build at all and is
  charged ``inf`` through the existing ``Autotuning.skip()`` path.
* :class:`CircuitBreaker` — per-context explore gating for the online tuner:
  a context whose explores keep failing stops burning ε-credits and serves
  the incumbent, with half-open probes to recover.  Count-based (cooldown
  measured in denied calls, not wall time) so tests and replays are
  deterministic.

Transient-vs-permanent classification lives here (:func:`is_transient_failure`)
so both the core measurement layers and the kernel layer share one notion of
"worth retrying"; the kernel layer's ``classify_failure`` builds on it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Any, Callable, Dict, Hashable, Optional, Set

from repro_torch.obs import events as _events
from repro_torch.obs import metrics as _metrics

__all__ = [
    "GuardTimeout",
    "SandboxCrash",
    "SandboxUnavailable",
    "FaultPolicy",
    "is_transient_failure",
    "deterministic_backoff",
    "guarded_call",
    "sandboxed_probe",
    "Quarantine",
    "CircuitBreaker",
]


class GuardTimeout(Exception):
    """A guarded call exceeded its watchdog deadline (a hang, as far as the
    tuner is concerned).  Classified *transient* — a hang can be an artifact
    of load, so a revisited candidate gets a fresh attempt — but never
    retried in-band by :func:`guarded_call`: each retry would cost another
    full deadline, so the charge is immediate and the retry happens only if
    the search ever revisits the candidate."""


class SandboxCrash(Exception):
    """A sandboxed first-touch probe died without reporting a result (e.g.
    segfault / ``os._exit``): the candidate hard-crashes and must be charged
    ``inf`` — but thanks to the sandbox, in a child process, not ours."""

    def __init__(self, message: str, exitcode: Optional[int] = None) -> None:
        super().__init__(message)
        self.exitcode = exitcode


class SandboxUnavailable(RuntimeError):
    """The crash sandbox cannot run here (CUDA already initialized in the
    parent of the fork): a configuration error, never a candidate cost."""


#: substrings marking failures that may be artifacts of the moment (memory
#: pressure from concurrent compiles, a busy allocator) rather than of the
#: candidate itself.  Shared with the kernel layer's failure classifier —
#: this is the RESOURCE_EXHAUSTED class ``classify_failure`` distinguishes.
TRANSIENT_MARKERS = ("resource_exhausted", "resource exhausted", "out of memory")


def is_transient_failure(exc: BaseException) -> bool:
    """Whether ``exc`` is worth retrying: resource exhaustion (which can be
    load-induced) and watchdog timeouts qualify; everything else — illegal
    tiles, programmer errors — is deterministic for a fixed context."""
    if isinstance(exc, GuardTimeout):
        return True  # maybe load-induced; retried on *revisit*, not in-band
    if isinstance(exc, SandboxCrash):
        return False
    msg = f"{type(exc).__name__}: {exc}".lower()
    return any(m in msg for m in TRANSIENT_MARKERS)


def deterministic_backoff(
    attempt: int,
    base: float,
    mult: float,
    jitter: float,
    token: str = "",
) -> float:
    """Exponential backoff with *deterministic* jitter.

    ``base * mult**attempt``, stretched by up to ``jitter`` fraction where
    the stretch is a hash of ``(token, attempt)`` — same token, same delays
    on every run (testable; replayable), different tokens (different
    candidates, different shards) desynchronized so a fleet's retries do not
    stampede in lockstep."""
    delay = float(base) * float(mult) ** int(attempt)
    if jitter > 0.0:
        h = hashlib.sha256(f"{token}\x00{attempt}".encode()).digest()
        frac = int.from_bytes(h[:8], "big") / float(1 << 64)  # [0, 1)
        delay *= 1.0 + float(jitter) * frac
    return delay


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Per-run resilience knobs, threaded through ``tune_call`` and the
    measurement engine.

    ``compile_timeout`` / ``measure_timeout`` are per-*stage* watchdog
    deadlines in seconds (``None`` disables the watchdog for that stage;
    ``measure_timeout`` covers one cost evaluation — one repetition under the
    adaptive engine, the whole warmup+repeats loop under a ``RuntimeCost``).
    ``compile_deadline`` bounds a whole fan-out round
    (:func:`repro_torch.core.costs.compile_fanout`).  ``retries`` transient
    failures are retried in place with ``backoff * backoff_mult**attempt``
    seconds of deterministically-jittered sleep between attempts.
    ``max_failures`` is the :class:`Quarantine` threshold.  ``fail_fast``
    makes the compile fan-out cancel the round and raise on the first
    *non-transient unexpected* error (a poisoned executor — e.g. a TypeError
    that would hit every candidate identically) instead of draining it.
    ``sandbox_first_touch`` probes each never-seen candidate in a forked
    child first, so a hard crash is contained and charged ``inf``."""

    compile_timeout: Optional[float] = None
    measure_timeout: Optional[float] = None
    compile_deadline: Optional[float] = None
    retries: int = 2
    backoff: float = 0.05
    backoff_mult: float = 2.0
    jitter: float = 0.25
    max_failures: int = 3
    fail_fast: bool = False
    sandbox_first_touch: bool = False
    sandbox_timeout: float = 60.0

    def __post_init__(self) -> None:
        if self.retries < 0:
            raise ValueError("retries must be >= 0")
        if self.backoff < 0 or self.backoff_mult < 1.0:
            raise ValueError("backoff must be >= 0 and backoff_mult >= 1")
        if self.max_failures < 1:
            raise ValueError("max_failures must be >= 1")

    def timeout_for(self, stage: str) -> Optional[float]:
        return self.compile_timeout if stage == "compile" else self.measure_timeout

    def wrap(
        self,
        fn: Callable[[], Any],
        *,
        stage: str = "measure",
        label: str = "",
        on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
        sleep: Callable[[float], None] = time.sleep,
    ) -> Callable[[], Any]:
        """A zero-arg callable running ``fn`` under this policy's guard for
        ``stage`` — drop-in wherever a build/rep thunk is expected."""
        return lambda: guarded_call(
            fn,
            timeout=self.timeout_for(stage),
            retries=self.retries,
            backoff=self.backoff,
            backoff_mult=self.backoff_mult,
            jitter=self.jitter,
            label=label or stage,
            on_retry=on_retry,
            sleep=sleep,
        )


def _call_with_deadline(fn: Callable[[], Any], timeout: float, label: str) -> Any:
    """Run ``fn`` on a watchdog-supervised daemon thread; raise
    :class:`GuardTimeout` if it has not finished within ``timeout``.

    A hung worker thread cannot be killed from Python — it is abandoned as a
    daemon (it will not block interpreter exit) and its eventual result, if
    any, is discarded.  Acceptable for the short hangs the tuner guards
    against; a candidate that wedges a thread forever is exactly what the
    quarantine then keeps from being built again."""
    box: Dict[str, Any] = {}
    done = threading.Event()

    def runner() -> None:
        try:
            box["value"] = fn()
        except BaseException as e:  # delivered to the caller below
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(
        target=runner, daemon=True, name=f"patsma-guard-{label or 'call'}"
    )
    t.start()
    if not done.wait(timeout):
        raise GuardTimeout(
            f"{label or 'guarded call'} exceeded watchdog deadline of {timeout:.3g}s"
        )
    if "error" in box:
        raise box["error"]
    return box["value"]


def guarded_call(
    fn: Callable[[], Any],
    *,
    timeout: Optional[float] = None,
    retries: int = 0,
    backoff: float = 0.05,
    backoff_mult: float = 2.0,
    jitter: float = 0.25,
    transient: Callable[[BaseException], bool] = is_transient_failure,
    label: str = "",
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Run ``fn()`` under a watchdog deadline, retrying transient failures.

    * ``timeout`` (seconds, ``None`` = no watchdog): a call still running at
      the deadline raises :class:`GuardTimeout`; the worker thread is
      abandoned.  Timeouts are never retried in-band (each retry would cost
      another full deadline) — the layers above charge ``inf`` and move on.
    * ``retries``: failed attempts for which ``transient(exc)`` is true are
      retried up to this many times, sleeping
      ``deterministic_backoff(attempt, backoff, backoff_mult, jitter, label)``
      between attempts.  ``on_retry(attempt, exc, delay)`` observes each
      retry (tests assert the schedule; callers count them in stats).
    * Control-flow exceptions (``KeyboardInterrupt``, ``SystemExit``) always
      propagate immediately — a user interrupt is never a candidate failure.

    The final failure is raised; callers that want returned-not-raised
    failures (the executable cache) already convert at their boundary."""
    attempt = 0
    while True:
        try:
            if timeout is not None and timeout > 0:
                return _call_with_deadline(fn, float(timeout), label)
            return fn()
        except (KeyboardInterrupt, SystemExit):
            raise
        except GuardTimeout:
            _metrics.counter("guard.timeouts").inc()
            raise
        except Exception as e:
            if attempt >= retries or not transient(e):
                raise
            delay = deterministic_backoff(attempt, backoff, backoff_mult, jitter, label)
            _metrics.counter("guard.retries").inc()
            if on_retry is not None:
                on_retry(attempt, e, delay)
            if delay > 0:
                sleep(delay)
            attempt += 1


def sandboxed_probe(
    fn: Callable[[], Any],
    *,
    timeout: float = 60.0,
    label: str = "",
) -> bool:
    """Run ``fn`` once in a forked child process; return True iff it
    completed without dying.

    The probe's *result* does not cross the process boundary (executables
    are not picklable) — this is purely a crash canary for the first touch
    of a never-seen candidate: if the child survives, the real in-process
    build proceeds; if it dies, :class:`SandboxCrash` is raised here and the
    candidate is charged ``inf`` without taking the run down.  A child still
    alive at ``timeout`` is terminated and reported as :class:`GuardTimeout`.

    Uses ``fork`` (POSIX) so arbitrary closures need no pickling; on
    platforms without ``fork`` the probe is skipped (returns True) — the
    sandbox is an opt-in belt-and-braces layer, never a hard dependency.

    A forked child cannot use CUDA once the parent has initialized it: its
    first CUDA call raises, and the probe would pass without having run
    anything.  So with CUDA initialized in this process the probe raises
    :class:`SandboxUnavailable` instead of passing silently."""
    import multiprocessing as mp

    import torch

    if torch.cuda.is_initialized():
        raise SandboxUnavailable(
            f"sandboxed probe {label or 'candidate'}: CUDA is initialized in "
            "this process and a forked child cannot use it; tune CUDA kernels "
            "without sandbox_first_touch"
        )

    try:
        ctx = mp.get_context("fork")
    except ValueError:  # pragma: no cover - non-POSIX: no fork, no sandbox
        return True

    def child(fn=fn):  # pragma: no cover - runs in the forked child
        try:
            fn()
        except BaseException:
            import os

            os._exit(17)  # ordinary failure: not a crash, let the parent build

    proc = ctx.Process(target=child, daemon=True)
    proc.start()
    proc.join(timeout)
    if proc.is_alive():
        proc.terminate()
        proc.join(5.0)
        raise GuardTimeout(
            f"sandboxed probe {label or 'candidate'} exceeded {timeout:.3g}s"
        )
    # exit 0: clean run.  exit 17: the probe raised a Python exception — the
    # real build will raise it in-process where it can be classified.  Any
    # other exit (negative = killed by signal, e.g. SIGSEGV) is a hard crash.
    if proc.exitcode not in (0, 17):
        raise SandboxCrash(
            f"sandboxed probe {label or 'candidate'} died with exit code "
            f"{proc.exitcode} (hard crash contained)",
            exitcode=proc.exitcode,
        )
    return True


class Quarantine:
    """Per-candidate failure bookkeeping: a key that fails ``max_failures``
    times is quarantined — callers stop offering it builds/measurements and
    charge it ``inf`` outright (via ``Autotuning.skip``).  A success clears
    the key's count (transient storms should not accumulate forever)."""

    def __init__(self, max_failures: int = 3) -> None:
        if max_failures < 1:
            raise ValueError("max_failures must be >= 1")
        self.max_failures = int(max_failures)
        self._failures: Dict[Hashable, int] = {}
        self._quarantined: Set[Hashable] = set()
        self.strikes = _metrics.Counter()  # lifetime note_failure calls

    def __contains__(self, key: Hashable) -> bool:
        return key in self._quarantined

    def note_failure(self, key: Hashable) -> bool:
        """Record one failure of ``key``; returns True iff it is (now)
        quarantined."""
        n = self._failures.get(key, 0) + 1
        self._failures[key] = n
        self.strikes.inc()
        if n >= self.max_failures:
            if key not in self._quarantined:
                _metrics.counter("guard.quarantined").inc()
            self._quarantined.add(key)
        return key in self._quarantined

    def note_success(self, key: Hashable) -> None:
        self._failures.pop(key, None)
        self._quarantined.discard(key)

    def stats(self) -> dict:
        return {
            "quarantined": len(self._quarantined),
            "failing": len(self._failures),
            "max_failures": self.max_failures,
        }

    def snapshot(self) -> dict:
        """The live view between summary dumps: lifetime strike count plus
        the *current* states — which keys are out, which are accumulating
        failures (and how many strikes each has).  Cheap (no measurement,
        no lock): safe to poll from serving threads."""
        return {
            "strikes": self.strikes.value,
            "quarantined": sorted(map(str, self._quarantined)),
            "failing": {str(k): n for k, n in self._failures.items()},
            "max_failures": self.max_failures,
        }


class CircuitBreaker:
    """Count-based circuit breaker for a context's exploration.

    States: **closed** (normal), **open** (explores denied), **half-open**
    (probing).  ``threshold`` consecutive recorded failures open the
    breaker; while open, each :meth:`allow` call ticks a cooldown counter
    and answers False, and after ``cooldown`` denials the breaker goes
    half-open — :meth:`allow` grants probes again, and the *next recorded
    outcome* decides: success closes the breaker (exploration resumes),
    failure re-opens it for another cooldown.  Everything is counted in
    calls, not wall time, so schedules are deterministic and testable.

    Single-threaded by contract, like ``OnlineTuner.begin``/``observe``."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, threshold: int = 3, cooldown: int = 8) -> None:
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        if cooldown < 1:
            raise ValueError("cooldown must be >= 1")
        self.threshold = int(threshold)
        self.cooldown = int(cooldown)
        self.state = self.CLOSED
        self._consecutive_failures = 0
        self._cooldown_ticks = 0
        # counted on the obs metric primitive; stats()/snapshot() read them
        self.opens = _metrics.Counter()  # trips (incl. re-opens from probes)
        self.denied = _metrics.Counter()  # allow() calls answered False
        self.probes = _metrics.Counter()  # allow() calls granted half-open

    def allow(self) -> bool:
        """May this call explore?  Ticks the cooldown while open."""
        if self.state == self.CLOSED:
            return True
        if self.state == self.OPEN:
            self._cooldown_ticks += 1
            if self._cooldown_ticks < self.cooldown:
                self.denied.inc()
                return False
            self._transition(self.HALF_OPEN)
        # half-open: grant the probe; the recorded outcome decides the state
        self.probes.inc()
        return True

    def record_success(self) -> None:
        self._consecutive_failures = 0
        if self.state != self.CLOSED:
            self._transition(self.CLOSED)
            self._cooldown_ticks = 0

    def record_failure(self) -> None:
        if self.state == self.HALF_OPEN:
            self._trip()
            return
        self._consecutive_failures += 1
        if self.state == self.CLOSED and self._consecutive_failures >= self.threshold:
            self._trip()

    def _trip(self) -> None:
        self._transition(self.OPEN)
        self.opens.inc()
        self._cooldown_ticks = 0
        self._consecutive_failures = 0

    def _transition(self, to_state: str) -> None:
        _metrics.counter("guard.breaker_transitions").inc()
        _events.emit(
            "breaker_transition", from_state=self.state, to_state=to_state
        )
        self.state = to_state

    def stats(self) -> dict:
        return {
            "state": self.state,
            "opens": self.opens.value,
            "denied": self.denied.value,
            "probes": self.probes.value,
        }

    def snapshot(self) -> dict:
        """Alias of :meth:`stats` under the live-introspection name the
        online tuner and quarantine share."""
        return self.stats()
