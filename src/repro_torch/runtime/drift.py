"""Drift detection for online-tuned contexts.

A tuned configuration is only optimal for the environment it was measured
in; live systems drift away from that environment (input-distribution shift,
thermal throttling, co-tenant contention).  :class:`DriftDetector` watches
the stream of *exploit* costs — the cost of serving requests at the
current-best knobs — with sliding-window statistics and reports an
escalation level when the recent costs degrade beyond a threshold relative
to the post-tuning baseline.  The consumer (``repro_torch.runtime.online
.OnlineTuner``) answers a non-zero level with ``Autotuning.reset(level)``
plus a half-budget warm re-search.

Everything here is sample-count based — no wall clock, no RNG — so drift
behaviour is exactly reproducible from a cost sequence (the deterministic
test seam required by the fast CI lane).

Protocol::

    dd = DriftDetector(window=16, min_samples=6, factor=1.5)
    dd.rebaseline()              # after (re)tuning converges
    level = dd.observe(cost)     # per served request at the tuned knobs
    # level 0: fine; 1: degraded (> factor x baseline median);
    # 2: severe  (> severe_factor x baseline median)
"""
from __future__ import annotations

import math
from collections import deque

from repro_torch.obs import metrics as _metrics
from typing import Optional

__all__ = ["DriftDetector"]


def _median(values) -> Optional[float]:
    vals = sorted(values)
    if not vals:
        return None
    n = len(vals)
    mid = n // 2
    if n % 2:
        return float(vals[mid])
    return 0.5 * (vals[mid - 1] + vals[mid])


def _stat(values, q: float) -> Optional[float]:
    """Window statistic at quantile ``q`` (0.5 delegates to :func:`_median`
    so the default detector is bit-identical to the pre-quantile one)."""
    if q == 0.5:
        return _median(values)
    vals = list(values)
    if not vals:
        return None
    from repro_torch.core.measure import quantile

    return quantile(vals, q)


class DriftDetector:
    """Sliding-window cost monitor with a frozen baseline.

    The first ``window`` finite observations after :meth:`rebaseline` form
    the **baseline** (the healthy, just-tuned cost distribution).  Later
    observations roll through a **recent** window of the same length; once
    at least ``min_samples`` recent costs exist, their median is compared to
    the baseline median:

    * ``recent > severe_factor * baseline`` → level 2 (severe drift),
    * ``recent > factor        * baseline`` → level 1 (degraded),
    * otherwise level 0.

    Medians (not means) so a single straggler request cannot trigger a
    re-tune.  A trigger clears the recent window, so a consumer that ignores
    the signal is not re-triggered on every subsequent sample.  Non-finite
    costs (crashed requests) are excluded from the statistics.
    """

    def __init__(
        self,
        *,
        window: int = 16,
        min_samples: int = 6,
        factor: float = 1.5,
        severe_factor: Optional[float] = None,
        atol: float = 0.0,
        quantile: float = 0.5,
    ) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if min_samples < 1 or min_samples > window:
            raise ValueError(f"min_samples must be in [1, window], got {min_samples}")
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1, got {factor}")
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.factor = float(factor)
        self.severe_factor = float(severe_factor) if severe_factor is not None else 2.0 * factor
        if self.severe_factor < self.factor:
            raise ValueError("severe_factor must be >= factor")
        self.atol = float(atol)
        if not (0.0 < quantile < 1.0):
            raise ValueError(f"quantile must be in (0, 1), got {quantile}")
        # which window statistic detection compares — 0.5 is the classic
        # median detector; a p99-objective context watches 0.99 so drift is
        # judged on the same statistic the tuner minimizes
        self.quantile = float(quantile)
        self._baseline: deque = deque(maxlen=self.window)
        self._recent: deque = deque(maxlen=self.window)
        self.observed = 0  # finite samples since the last rebaseline
        self.events: list = []

    # -------------------------------------------------------------- state
    @property
    def ready(self) -> bool:
        """Whether the baseline is established (detection can fire)."""
        return len(self._baseline) >= self.window

    def baseline_median(self) -> Optional[float]:
        """Baseline window statistic (at :attr:`quantile`; the name predates
        non-median detectors)."""
        return _stat(self._baseline, self.quantile)

    def recent_median(self) -> Optional[float]:
        """Statistic of the freshest costs — the detector's current estimate
        of what the deployed configuration costs *now* (falls back to the
        baseline while the recent window is still empty)."""
        if self._recent:
            return _stat(self._recent, self.quantile)
        return _stat(self._baseline, self.quantile)

    def rebaseline(self) -> None:
        """Forget everything measured so far: the next ``window`` samples
        define the new healthy baseline.  Call after a (re)tune converges."""
        self._baseline.clear()
        self._recent.clear()
        self.observed = 0

    # ----------------------------------------------------------- observe
    def observe(self, cost: float) -> int:
        """Feed one exploit-cost sample; returns the escalation level."""
        cost = float(cost)
        if not math.isfinite(cost):
            return 0
        self.observed += 1
        if not self.ready:
            self._baseline.append(cost)
            return 0
        self._recent.append(cost)
        if len(self._recent) < self.min_samples:
            return 0
        base = _stat(self._baseline, self.quantile)
        recent = _stat(self._recent, self.quantile)
        level = 0
        if recent > self.severe_factor * base + self.atol:
            level = 2
        elif recent > self.factor * base + self.atol:
            level = 1
        if level:
            _metrics.counter("drift.events").inc()
            # report the freshest min_samples' median: the rolling window that
            # *detects* drift still contains pre-drift samples, but consumers
            # (the warm re-search noting the incumbent's live cost) want the
            # best estimate of what the deployed point costs now
            fresh = _stat(list(self._recent)[-self.min_samples:], self.quantile)
            self.events.append(
                {"sample": self.observed, "level": level,
                 "baseline": base, "recent": fresh, "window_median": recent}
            )
            self._recent.clear()  # one signal per degradation episode
        return level

    def stats(self) -> dict:
        return {
            "observed": self.observed,
            "ready": self.ready,
            "baseline_median": self.baseline_median(),
            "recent_median": _stat(self._recent, self.quantile) if self._recent else None,
            "events": len(self.events),
        }

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"DriftDetector(window={self.window}, factor={self.factor}, "
            f"observed={self.observed}, events={len(self.events)})"
        )
