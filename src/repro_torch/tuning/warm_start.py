"""Warm-start policy: turn a stored tuning record into optimizer state.

Two tiers (wired into :class:`repro_torch.core.autotuning.Autotuning`):

* **Exact hit** — same fingerprint: adopt the stored best outright, zero
  re-measurements (handled by Autotuning; nothing to do here).
* **Near miss** — a neighbor record (same computation + hardware, different
  shapes): seed the optimizer's initial state around the stored point
  (CSA population / NM simplex) and shrink the evaluation budget — starting
  next to a known-good solution is what makes a half-budget search converge.
"""
from __future__ import annotations

from typing import Optional

from .records import TuningRecord

__all__ = ["apply_warm_start", "DEFAULT_BUDGET_FRAC", "DEFAULT_SPREAD"]

#: warm-started searches get half the cold budget (acceptance: ≤ 50% evals)
DEFAULT_BUDGET_FRAC = 0.5
#: normalized-coords radius of the seeded population around the stored point
DEFAULT_SPREAD = 0.2
#: cap on the space-resolution-widened spread (never seed near-globally)
MAX_SPREAD = 0.6


def effective_spread(space, spread: float = DEFAULT_SPREAD) -> float:
    """Widen ``spread`` to at least ~one grid step of the coarsest discrete
    dimension: on a 6-octave ``LogIntDim`` a 0.2 radius is *sub-step* — the
    seeded population would collapse onto the stored point and a half-budget
    re-search could never reach an optimum two octaves away."""
    try:
        step = space.resolution()
    except Exception:
        return spread
    return max(spread, min(MAX_SPREAD, 1.1 * step))


def apply_warm_start(
    space,
    optimizer,
    record: TuningRecord,
    *,
    budget_frac: float = DEFAULT_BUDGET_FRAC,
    spread: float = DEFAULT_SPREAD,
) -> bool:
    """Seed ``optimizer`` around ``record.point`` and shrink its budget.

    Must run before the optimizer's first ``run`` call.  The stored point may
    come from a neighboring context whose space had different bounds —
    ``space.encode`` clips it into the current domain.  Returns True iff the
    optimizer accepted the seed (budget is only shrunk then; a blind search
    keeps its full budget).
    """
    try:
        missing = [n for n in space.names if n not in record.point]
        if missing:
            return False
        z0 = space.encode(record.point)
    except Exception:
        return False  # incompatible point (e.g. renamed dims) → cold start
    if not optimizer.seed(z0, spread=effective_spread(space, spread)):
        return False
    if budget_frac < 1.0:
        optimizer.shrink_budget(budget_frac)
    return True


def record_from(autotuner, key, *, source: str = "online") -> Optional[TuningRecord]:
    """Snapshot an Autotuning run's result as a record (None if nothing found)."""
    import numpy as np

    cost = autotuner.best_cost
    if not np.isfinite(cost):
        # every candidate crashed / was never measured: storing this would
        # replay a broken point as an exact hit forever
        return None
    # measurement confidence of the best point, when the measurement engine
    # delivered it (None for plain-float costs and pre-engine drivers)
    cost_std = repeats_spent = None
    meta_of = getattr(autotuner, "measurement_meta", None)
    if callable(meta_of):
        meta = meta_of()
        if meta is not None:
            cost_std = meta.get("cost_std")
            repeats_spent = meta.get("repeats_spent")
    return TuningRecord(
        key=key,
        point=dict(autotuner.best_point),
        cost=float(cost),
        evals=int(autotuner.num_evals),
        source=source,
        crashed=int(getattr(autotuner, "num_crashed", 0)),
        cost_std=cost_std,
        repeats_spent=repeats_spent,
        strategy=getattr(autotuner, "strategy", None),
        objective=getattr(autotuner, "objective", None),
    )
