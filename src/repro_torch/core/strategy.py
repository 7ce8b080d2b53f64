"""Composable search strategies — the paper's CSA→NM hybrid as a first-class
multi-stage pipeline.

PATSMA's central design point (§1, §2.2) is the *coupling* of CSA's global
exploration with Nelder–Mead's local refinement, yet a single
:class:`~repro_torch.core.optimizer.NumericalOptimizer` can only express one method.
This module turns the hybrid into a first-class object: a **search strategy**
is anything speaking the optimizer's batch ``ask()``/``tell(costs)`` surface
(:data:`SearchStrategy` is that protocol — every ``NumericalOptimizer``
already satisfies it), and two combinators compose existing optimizers into
richer strategies while *remaining* optimizers themselves, so the
``Autotuning`` driver, the batched evaluation and the adaptive
measurement engine all work on them unchanged:

* :class:`Pipeline` — staged search with an explicit budget split.  Stage
  ``i+1`` is warm-seeded from the pipeline's incumbent best (for the
  canonical ``CSA → NM`` hybrid: NM's initial simplex is built in a
  simplex-radius neighborhood of CSA's best).  ``reset`` is stage-aware:
  level 0 restarts the *current stage* only, level ≥ 1 restarts the whole
  pipeline warm at the incumbent's coordinates, and
  :meth:`Pipeline.enter_refinement` re-enters through the final
  (refinement) stage alone — the online tuner's answer to environment
  drift, where the optimum moved a little but the basin did not.
* :class:`Portfolio` — interleaved rounds of several optimizers racing on
  the same cost, with successive-halving budget reallocation toward the
  leader.  A member is culled only when its best is *statistically
  separated* from the leader's, reusing the measurement engine's
  noise-floor machinery (:class:`~repro_torch.core.measure.NoiseEstimate`);
  a culled member's remaining budget flows to the survivors.

Budgets are counted in **tells** (cost evaluations delivered), the unit of
paper Eq. (1)/(2), so ``Pipeline([CSA, NM], budget=B)`` and a pure
``CSA(max_iter=B/num_opt)`` consume exactly the same number of measurements.

:func:`make_strategy` parses the user-facing string specs (``"csa+nm"``,
``"csa:0.7+nm:0.3"``, ``"csa|nm"``) into strategy objects, and
:func:`strategy_label` derives the canonical spec back from any optimizer
tree — the provenance string stamped on persisted ``TuningRecord``s.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.obs import metrics as _metrics

from .csa import CSA
from .grid_random import GridSearch, RandomSearch
from .measure import NoiseEstimate
from .nelder_mead import NelderMead
from .optimizer import NumericalOptimizer

__all__ = [
    "SearchStrategy",
    "Pipeline",
    "Portfolio",
    "cull_laggards",
    "make_strategy",
    "strategy_label",
]

#: The strategy protocol *is* the optimizer's batch surface: anything with
#: ask()/tell()/is_end()/reset(level)/seed()/shrink_budget().  Combinators
#: subclass NumericalOptimizer so they satisfy it by construction and drop
#: into every existing driver (Autotuning, OnlineTuner, ContextRouter).
SearchStrategy = NumericalOptimizer

def cull_laggards(
    active: Sequence[int],
    member_bests: Sequence[float],
    noise: NoiseEstimate,
    margin: float = 0.5,
) -> List[int]:
    """The successive-halving cull decision, as a pure function.

    Given the indices of the members still racing and every member's best
    cost so far, return the indices to cull *now*: members whose best is
    statistically separated from the leader's — beyond the noise floor
    widened by ``margin`` — worst first, at most half the field per check,
    never the leader.  Shared verbatim by :class:`Portfolio` (serial
    round-robin driver) and :class:`repro_torch.tuning.fleet.ShardedPortfolio`
    (one worker per member), so the two drivers make identical cull
    decisions from identical scoreboards.
    """
    if len(active) < 2:
        return []
    order = sorted(active, key=lambda i: member_bests[i])
    leader_best = member_bests[order[0]]
    if not np.isfinite(leader_best):
        return []
    line = leader_best + noise.floor(leader_best) * (1.0 + margin)
    may_cull = len(active) // 2  # successive halving: keep ⌈n/2⌉
    culled: List[int] = []
    for i in reversed(order[1:]):  # worst first; never the leader
        if len(culled) >= may_cull:
            break
        if member_bests[i] > line:
            culled.append(i)
    return culled


#: default seeding radius when a stage hands off to the next (normalized
#: coords) — the "simplex-radius neighborhood" of the incumbent.  Wider than
#: the DB warm-start spread (0.2) on purpose: the global stage's best may sit
#: one basin off on a multimodal landscape, and the refinement simplex must
#: straddle the neighboring basin to correct it (empirically the difference
#: between losing and beating pure CSA on rastrigin at small budgets).
DEFAULT_HANDOFF_SPREAD = 0.5


class Pipeline(NumericalOptimizer):
    """Staged search: run ``stages[0]``, seed ``stages[1]`` at its best, ...

    Parameters
    ----------
    stages:
        The stage optimizers, in order (same dimension).  The canonical
        instance is ``[CSA(...), NelderMead(...)]`` — the paper's hybrid.
    budget_fracs:
        Per-stage share of ``budget`` (normalized; default: equal split).
        A stage that converges early donates its unspent share downstream.
    budget:
        Total tell budget across all stages.  ``None`` lets every stage run
        to its own intrinsic end (``budget_fracs`` must then be None too).
    seed_spread:
        Normalized radius of the warm seed handed to the next stage.

    Budget enforcement is exact: the final batch of a stage (and of the
    pipeline) is truncated to the remaining allowance.  A truncated round's
    costs still update the pipeline-level incumbent but are *not* fed to the
    stage optimizer — its round contract (m probes in, m costs back) stays
    intact, the stage is simply abandoned at the boundary.
    """

    def __init__(
        self,
        stages: Sequence[NumericalOptimizer],
        budget_fracs: Optional[Sequence[float]] = None,
        *,
        budget: Optional[int] = None,
        seed_spread: float = DEFAULT_HANDOFF_SPREAD,
    ) -> None:
        stages = list(stages)
        if not stages:
            raise ValueError("Pipeline needs at least one stage")
        dims = {s.get_dimension() for s in stages}
        if len(dims) != 1:
            raise ValueError(f"stage dimensions differ: {sorted(dims)}")
        if budget is None:
            if budget_fracs is not None:
                raise ValueError("budget_fracs requires an explicit budget")
        else:
            if budget < 1:
                raise ValueError(f"budget must be >= 1, got {budget}")
        if budget_fracs is None:
            fracs = [1.0 / len(stages)] * len(stages)
        else:
            fracs = [float(f) for f in budget_fracs]
            if len(fracs) != len(stages):
                raise ValueError(
                    f"{len(fracs)} budget_fracs for {len(stages)} stages"
                )
            if any(f < 0 for f in fracs) or sum(fracs) <= 0:
                raise ValueError(f"budget_fracs must be >= 0 and sum > 0: {fracs}")
            total = sum(fracs)
            fracs = [f / total for f in fracs]
        self._stages = stages
        self._fracs = fracs
        self._budget0 = int(budget) if budget is not None else None
        self._budget = self._budget0  # live episode budget (shrink_budget)
        self._dim = stages[0].get_dimension()
        self._seed_spread = float(seed_spread)
        self._si = 0
        self._spent = 0  # tells delivered this episode
        self._entry_spent = 0  # tells at entry into the current stage
        self._refining = False  # episode = final stage only (enter_refinement)
        self._truncated = False  # pending round not forwarded to the stage
        self._done = False
        self._best_x = np.zeros(self._dim)
        self._best_e = np.inf

    # ------------------------------------------------------------- interface
    def get_num_points(self) -> int:
        return max(s.get_num_points() for s in self._stages)

    def get_dimension(self) -> int:
        return self._dim

    def is_end(self) -> bool:
        return self._done

    @property
    def stages(self) -> list:
        return list(self._stages)

    @property
    def stage_index(self) -> int:
        """Index of the stage currently being driven."""
        return self._si

    @property
    def refining(self) -> bool:
        """Whether this episode runs the final (refinement) stage alone."""
        return self._refining

    @property
    def spent(self) -> int:
        """Tells delivered this episode (== the measurement budget consumed)."""
        return self._spent

    @property
    def best_solution(self) -> np.ndarray:
        if np.isfinite(self._best_e):
            return self._best_x.copy()
        return self._stages[self._si].best_solution

    @property
    def best_cost(self) -> float:
        return float(self._best_e)

    def print(self) -> None:  # noqa: A003 - paper API name
        print(
            f"Pipeline(stage {self._si + 1}/{len(self._stages)}"
            f"{', refining' if self._refining else ''}) spent={self._spent}"
            f"/{self._budget if self._budget is not None else '∞'} "
            f"best={self._best_e:.6g}"
        )
        self._stages[self._si].print()

    # --------------------------------------------------------------- budget
    def _boundary(self, si: int) -> Optional[float]:
        """Cumulative tell allowance through stage ``si`` this episode.
        Unspent earlier allocation rolls forward automatically (the boundary
        is cumulative, not per-stage)."""
        if self._budget is None:
            return None
        if self._refining or si >= len(self._stages) - 1:
            return self._budget
        cum = sum(self._fracs[: si + 1])
        return int(round(cum * self._budget))

    def seed(self, z0, spread: float = 0.2) -> bool:
        """Warm start the *current* stage (stage 0 at cold construction — a
        DB warm start seeds only the first stage; after
        :meth:`enter_refinement`, the refinement stage)."""
        return self._stages[self._si].seed(z0, spread=spread)

    def shrink_budget(self, frac: float) -> bool:
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"frac must be in (0, 1], got {frac}")
        if self._budget is not None:
            self._budget = max(1, int(math.ceil(self._budget * frac)))
            return True
        applied = False
        for s in self._stages:
            applied = s.shrink_budget(frac) or applied
        return applied

    # ---------------------------------------------------------------- resets
    def reset(self, level: int = 0) -> None:
        """Stage-aware reset (paper §2.2, lifted to the pipeline):

        * level 0 — restart the **current stage** only: its tell allowance is
          restored and it re-anneals keeping its found solutions; earlier
          stages' work (and the pipeline incumbent) is retained.
        * level 1 — restart the **whole pipeline warm at the incumbent**:
          every stage resets, stage 0 is re-seeded at the best coordinates
          found so far, and the stale energy is dropped (the point must
          re-prove itself — the drift-reset contract shared with CSA/NM).
        * level ≥ 2 — complete cold reset of every stage.

        Every level restores the cold episode budget (a shrunk warm-start
        budget never compounds across resets); level >= 1 also leaves
        refinement mode (level 0 inside a refinement episode restarts that
        episode at its own cold allowance, not the full pipeline's).
        """
        self._truncated = False
        self._done = False
        if level == 0:
            if self._refining and self._budget0 is not None:
                self._budget = max(1, int(round(self._fracs[-1] * self._budget0)))
            else:
                self._budget = self._budget0
            self._stages[self._si].reset(0)
            self._spent = self._entry_spent
            self._clear_batch_state()
            return
        self._budget = self._budget0
        keep = self._best_x.copy() if np.isfinite(self._best_e) else None
        for s in self._stages:
            s.reset(level)
        self._si = 0
        self._spent = 0
        self._entry_spent = 0
        self._refining = False
        if level == 1 and keep is not None:
            self._stages[0].seed(keep, spread=self._seed_spread)
            self._best_x = keep  # coordinates survive, energy must re-prove
        self._best_e = np.inf
        if level >= 2:
            self._best_x = np.zeros(self._dim)
        self._clear_batch_state()

    def enter_refinement(self) -> bool:
        """Re-enter the search through the final stage alone — the response
        to *environment drift* (the optimum's basin is unchanged, its floor
        moved): a full global re-exploration would waste the budget the
        refinement stage can spend walking downhill from the deployed point.

        The final stage is cold-reset and the episode budget becomes that
        stage's nominal share of the cold total; the caller then seeds it at
        the incumbent (``seed`` targets the current — now final — stage) and
        may shrink the episode further.  Returns True (the strategy supports
        level-aware refinement; drivers fall back to ``reset`` when absent).
        """
        last = len(self._stages) - 1
        self._stages[last].reset(1)
        self._si = last
        self._refining = True
        self._spent = 0
        self._entry_spent = 0
        if self._budget0 is not None:
            self._budget = max(1, int(round(self._fracs[last] * self._budget0)))
        else:
            self._budget = None
        self._best_e = np.inf  # incumbent coordinates kept, energy re-proves
        self._truncated = False
        self._done = False
        self._clear_batch_state()
        return True

    # -------------------------------------------------------- batch protocol
    def _advance(self) -> None:
        """Move to the next stage, warm-seeding it at the incumbent."""
        self._si += 1
        _metrics.counter("strategy.stage_transitions").inc()
        if self._si >= len(self._stages):
            return
        self._entry_spent = self._spent
        if np.isfinite(self._best_e):
            self._stages[self._si].seed(self._best_x, spread=self._seed_spread)

    def _next_batch(self) -> Optional[List[np.ndarray]]:
        while True:
            if self._budget is not None and self._spent >= self._budget:
                self._done = True
                return None
            if self._si >= len(self._stages):
                self._done = True
                return None
            st = self._stages[self._si]
            bound = self._boundary(self._si)
            if st.is_end() or (bound is not None and self._spent >= bound):
                if self._si == len(self._stages) - 1:
                    self._done = True
                    return None
                self._advance()
                continue
            batch = st.ask()
            if not batch:
                if self._si == len(self._stages) - 1:
                    self._done = True
                    return None
                self._advance()
                continue
            allowed = None if bound is None else bound - self._spent
            if self._budget is not None:
                rem = self._budget - self._spent
                allowed = rem if allowed is None else min(allowed, rem)
            if allowed is not None and len(batch) > allowed:
                batch = batch[:allowed]
                self._truncated = True
            else:
                self._truncated = False
            return batch

    def _consume_batch(self, points: List[np.ndarray], costs: List[float]) -> None:
        for p, c in zip(points, costs):
            if np.isfinite(c) and c < self._best_e:
                self._best_e = float(c)
                self._best_x = np.array(p, dtype=float, copy=True)
        self._spent += len(costs)
        if not self._truncated:
            # a full round: the stage's own accept/anneal step runs
            self._stages[self._si].tell(costs)
        self._truncated = False


class Portfolio(NumericalOptimizer):
    """Interleaved optimizer rounds with successive-halving reallocation.

    Members take turns receiving **rung-sized chunks** of the shared tell
    budget (a member whose natural round is larger than one rung — a grid's
    whole sweep, CSA's m probes — has its round drip-fed across turns: the
    chunk costs buffer until the full round is delivered, exactly like the
    sequential ``run`` adapter, so no member can monopolize the budget in a
    single ask).  Once every active member has consumed a rung since the
    last check, members whose best cost is **statistically separated** from
    the leader's — beyond the measurement noise floor, the same
    :class:`~repro_torch.core.measure.NoiseEstimate` machinery the adaptive
    measurement engine races candidates with — are culled, at most half of
    the field per check (successive halving).  A culled member stops
    consuming turns, so with a shared ``budget`` its remaining allowance
    flows toward the leader.

    ``noise`` defaults to the measurement engine's priors; a driver that has
    calibrated a real noise floor can tighten the separation test via
    :meth:`set_noise` (``tune_call`` wires the engine's calibration in).
    """

    def __init__(
        self,
        optimizers: Sequence[NumericalOptimizer],
        *,
        budget: Optional[int] = None,
        noise: Optional[NoiseEstimate] = None,
        margin: float = 0.5,
        rung: Optional[int] = None,
    ) -> None:
        opts = list(optimizers)
        if len(opts) < 2:
            raise ValueError("Portfolio needs at least two optimizers")
        dims = {o.get_dimension() for o in opts}
        if len(dims) != 1:
            raise ValueError(f"member dimensions differ: {sorted(dims)}")
        if budget is not None and budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        self._opts = opts
        self._dim = opts[0].get_dimension()
        self._budget0 = int(budget) if budget is not None else None
        self._budget = self._budget0
        self._noise = noise if noise is not None else NoiseEstimate(0.0, 0.02)
        self._margin = float(margin)
        if rung is not None and int(rung) < 1:
            raise ValueError(f"rung must be >= 1, got {rung}")
        if rung is not None:
            self._rung = int(rung)
        else:
            # one rung = one natural round of the widest member — but capped
            # at a fair share of the budget: a sweep-style member whose
            # "round" is its whole grid (get_num_points == sweep size) must
            # not swallow the entire budget in its first chunk
            self._rung = max(o.get_num_points() for o in opts)
            if budget is not None:
                self._rung = max(1, min(self._rung, int(budget) // (2 * len(opts))))
        self._active: List[int] = list(range(len(opts)))
        self._turn = 0  # position in the active list
        self._spent = 0
        self._member_best = [np.inf] * len(opts)
        self._since_check = [0] * len(opts)  # tells since the last cull check
        self._round: List[Optional[list]] = [None] * len(opts)  # pending round
        self._fed: List[list] = [[] for _ in opts]  # costs buffered for it
        self._cur: Optional[int] = None  # member owning the pending chunk
        self._done = False
        self._best_x = np.zeros(self._dim)
        self._best_e = np.inf

    # ------------------------------------------------------------- interface
    def get_num_points(self) -> int:
        return max(o.get_num_points() for o in self._opts)

    def get_dimension(self) -> int:
        return self._dim

    def is_end(self) -> bool:
        return self._done

    @property
    def members(self) -> list:
        return list(self._opts)

    @property
    def active(self) -> list:
        """Indices of members still racing (culled members are dropped)."""
        return list(self._active)

    @property
    def member_bests(self) -> list:
        """Best finite cost seen per member (inf if none yet)."""
        return [float(b) for b in self._member_best]

    @property
    def spent(self) -> int:
        return self._spent

    @property
    def best_solution(self) -> np.ndarray:
        if np.isfinite(self._best_e):
            return self._best_x.copy()
        return self._opts[self._active[0] if self._active else 0].best_solution

    @property
    def best_cost(self) -> float:
        return float(self._best_e)

    def set_noise(self, noise: NoiseEstimate) -> None:
        """Adopt a calibrated noise floor for the separation test (the
        measurement engine's calibration supersedes the priors)."""
        self._noise = noise

    def print(self) -> None:  # noqa: A003 - paper API name
        bests = ", ".join(
            f"#{i}={self._member_best[i]:.4g}{'' if i in self._active else '†'}"
            for i in range(len(self._opts))
        )
        print(
            f"Portfolio({len(self._active)}/{len(self._opts)} active) "
            f"spent={self._spent}/{self._budget if self._budget is not None else '∞'} "
            f"[{bests}]"
        )

    def seed(self, z0, spread: float = 0.2) -> bool:
        applied = False
        for o in self._opts:
            applied = o.seed(z0, spread=spread) or applied
        return applied

    def shrink_budget(self, frac: float) -> bool:
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"frac must be in (0, 1], got {frac}")
        if self._budget is not None:
            self._budget = max(1, int(math.ceil(self._budget * frac)))
            return True
        applied = False
        for o in self._opts:
            applied = o.shrink_budget(frac) or applied
        return applied

    def reset(self, level: int = 0) -> None:
        """Portfolio resets re-activate every member (a culled method may be
        the right one for the drifted environment).  Level semantics follow
        the shared contract: 0 keeps found solutions, 1 keeps the incumbent's
        coordinates but drops stale energies, ≥ 2 is a complete reset.  Every
        level restores the cold budget."""
        self._budget = self._budget0
        keep = self._best_x.copy() if np.isfinite(self._best_e) else None
        for o in self._opts:
            o.reset(level)
        self._active = list(range(len(self._opts)))
        self._turn = 0
        self._spent = 0
        self._member_best = [np.inf] * len(self._opts)
        self._since_check = [0] * len(self._opts)
        self._round = [None] * len(self._opts)
        self._fed = [[] for _ in self._opts]
        self._cur = None
        self._done = False
        if level >= 1:
            self._best_e = np.inf
            if level >= 2 or keep is None:
                self._best_x = np.zeros(self._dim)
            else:
                self._best_x = keep
                for o in self._opts:  # every member restarts at the incumbent
                    o.seed(keep, spread=DEFAULT_HANDOFF_SPREAD)
        self._clear_batch_state()

    # -------------------------------------------------------- batch protocol
    def _member_live(self, i: int) -> bool:
        """A member is live if it has a round in flight or can still ask."""
        return self._round[i] is not None or not self._opts[i].is_end()

    def _next_batch(self) -> Optional[List[np.ndarray]]:
        for _ in range(len(self._opts) + 1):
            if self._budget is not None and self._spent >= self._budget:
                self._done = True
                return None
            if not any(self._member_live(i) for i in self._active):
                self._done = True
                return None
            if self._turn >= len(self._active):
                self._turn = 0
            i = self._active[self._turn]
            if self._round[i] is None:
                if self._opts[i].is_end():
                    self._turn += 1
                    continue
                r = self._opts[i].ask()
                if not r:
                    self._turn += 1
                    continue
                self._round[i] = r
                self._fed[i] = []
            # the next rung-sized chunk of the member's pending round
            allowed = self._rung
            if self._budget is not None:
                allowed = min(allowed, self._budget - self._spent)
            done_n = len(self._fed[i])
            chunk = self._round[i][done_n:done_n + max(1, allowed)]
            self._cur = i
            return [np.asarray(p, dtype=float).copy() for p in chunk]
        self._done = True
        return None

    def _consume_batch(self, points: List[np.ndarray], costs: List[float]) -> None:
        i = self._cur
        for p, c in zip(points, costs):
            if np.isfinite(c):
                if c < self._member_best[i]:
                    self._member_best[i] = float(c)
                if c < self._best_e:
                    self._best_e = float(c)
                    self._best_x = np.array(p, dtype=float, copy=True)
        self._spent += len(costs)
        self._since_check[i] += len(costs)
        self._fed[i].extend(costs)
        if len(self._fed[i]) >= len(self._round[i]):
            # the member's full round is in: its accept/anneal step runs
            self._opts[i].tell(self._fed[i])
            self._round[i] = None
            self._fed[i] = []
        self._cur = None
        self._turn += 1
        self._maybe_halve()

    def _maybe_halve(self) -> None:
        """Cull statistically separated laggards once every active member has
        consumed its check quota since the last check (at most half the
        field).  The quota is the member's own natural round size, capped by
        the rung — a small-round member (CSA's m probes) must not wait for a
        sweep-style member's full rung before the race is scored."""
        if len(self._active) < 2:
            return

        def quota(i: int) -> int:
            return min(self._rung, max(1, self._opts[i].get_num_points()))

        if not all(
            self._since_check[i] >= quota(i) or not self._member_live(i)
            for i in self._active
        ):
            return
        for i in self._active:
            self._since_check[i] = 0
        for i in cull_laggards(
            self._active, self._member_best, self._noise, self._margin
        ):
            self._active.remove(i)
        if self._turn >= len(self._active):
            self._turn = 0


# ------------------------------------------------------------------- parsing
_STAGE_NAMES = ("csa", "nm", "random", "grid")


def strategy_label(opt: NumericalOptimizer) -> str:
    """Canonical spec string of an optimizer tree (provenance for
    ``TuningRecord.strategy``).  Inverse of :func:`make_strategy` up to
    budget fractions, which are printed only when non-uniform."""
    if isinstance(opt, Pipeline):
        stages = opt.stages
        fracs = opt._fracs
        # elide fractions only when they are exactly the parser's default
        # split — any other split (including a uniform one built directly)
        # must round-trip through make_strategy to the same budget shares
        default = all(
            abs(f - d) < 1e-9 for f, d in zip(fracs, _default_fracs(len(fracs)))
        )
        parts = []
        for s, f in zip(stages, fracs):
            lbl = strategy_label(s)
            parts.append(lbl if default else f"{lbl}:{f:g}")
        return "+".join(parts)
    if isinstance(opt, Portfolio):
        return "|".join(strategy_label(o) for o in opt.members)
    if isinstance(opt, CSA):
        return "csa"
    if isinstance(opt, NelderMead):
        return "nm"
    if isinstance(opt, RandomSearch):
        return "random"
    if isinstance(opt, GridSearch):
        return "grid"
    return type(opt).__name__.lower()


def _parse_stage(token: str):
    """``name[:frac]`` -> (name, frac-or-None)."""
    token = token.strip().lower()
    frac = None
    if ":" in token:
        token, _, f = token.partition(":")
        token = token.strip()
        try:
            frac = float(f)
        except ValueError:
            raise ValueError(f"bad budget fraction in stage spec {token!r}:{f!r}")
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"stage fraction must be in (0, 1], got {frac}")
    if token not in _STAGE_NAMES:
        raise ValueError(
            f"unknown stage {token!r}; known stages: {', '.join(_STAGE_NAMES)}"
        )
    return token, frac


def _build_stage(
    name: str, dim: int, budget: int, *, num_opt: int, seed: int
) -> NumericalOptimizer:
    """One stage optimizer sized to ``budget`` tells."""
    if name == "csa":
        m = max(2, min(num_opt, budget))
        return CSA(dim, num_opt=m, max_iter=max(1, int(round(budget / m))), seed=seed)
    if name == "nm":
        return NelderMead(dim, error=0.0, max_iter=max(dim + 2, budget), seed=seed)
    if name == "random":
        return RandomSearch(dim, max_iter=max(1, budget), seed=seed)
    if name == "grid":
        ppd = max(2, int(round(budget ** (1.0 / dim))))
        return GridSearch(dim, points_per_dim=ppd)
    raise ValueError(f"unknown stage {name!r}")


#: default pipeline split: each stage takes this share of the *remaining*
#: budget, the final stage takes the rest — exploration-heavy (a 2-stage
#: "csa+nm" gets 0.7/0.3: the global stage does the paper's heavy lifting,
#: local refinement converges in far fewer tells).  Chosen empirically on
#: the strategy_shootout cost models: an even split lets the global stage
#: hand off from the wrong basin on multimodal landscapes (rastrigin).
EXPLORE_FRAC = 0.7


def _default_fracs(n: int) -> List[float]:
    out, rem = [], 1.0
    for _ in range(n - 1):
        out.append(rem * EXPLORE_FRAC)
        rem *= 1.0 - EXPLORE_FRAC
    out.append(rem)
    return out


def _resolve_fracs(fracs: List[Optional[float]]) -> List[float]:
    """Fill unspecified fractions; all-unspecified uses the exploration-heavy
    default split, a partial spec splits the remainder equally."""
    if all(f is None for f in fracs):
        return _default_fracs(len(fracs))
    fixed = sum(f for f in fracs if f is not None)
    free = [i for i, f in enumerate(fracs) if f is None]
    if fixed > 1.0 + 1e-9:
        raise ValueError(f"stage fractions sum to {fixed:g} > 1")
    if free:
        share = max(0.0, 1.0 - fixed) / len(free)
        if share <= 0.0:
            raise ValueError(
                "explicit stage fractions leave no budget for the unspecified stages"
            )
        out = [share if f is None else f for f in fracs]
    else:
        out = [float(f) for f in fracs]
    total = sum(out)
    return [f / total for f in out]


def make_strategy(
    spec: str,
    dim: int,
    *,
    num_opt: int = 4,
    max_iter: int = 20,
    seed: int = 0,
    budget: Optional[int] = None,
    seed_spread: float = DEFAULT_HANDOFF_SPREAD,
    noise: Optional[NoiseEstimate] = None,
) -> NumericalOptimizer:
    """Parse a strategy spec into an optimizer.

    Grammar: ``pipeline ('|' pipeline)*`` builds a :class:`Portfolio`;
    ``stage ('+' stage)*`` builds a :class:`Pipeline`; a ``stage`` is
    ``name[:frac]`` with names ``csa | nm | random | grid``.  Examples::

        "csa"            # plain CSA — identical to the default optimizer
        "csa+nm"         # the paper's hybrid, exploration-heavy 0.7/0.3 split
        "csa:0.5+nm:0.5" # explicit budget fractions
        "csa|nm"         # portfolio: CSA and NM race, loser is halved away

    The total tell budget is ``budget`` (default ``num_opt * max_iter`` —
    exactly what the default CSA consumes per paper Eq. (1), so swapping
    ``strategy=`` for ``optimizer=`` never changes the measurement count).
    A single bare stage name returns the raw optimizer, not a one-stage
    wrapper, so ``strategy="csa"`` is bit-for-bit the default search.

    The built object carries the normalized spec on ``.spec`` for
    provenance (``TuningRecord.strategy``).
    """
    if not isinstance(spec, str) or not spec.strip():
        raise ValueError(f"strategy spec must be a non-empty string, got {spec!r}")
    total = int(budget) if budget is not None else max(1, int(num_opt) * int(max_iter))
    arms = [a.strip() for a in spec.split("|")]
    if any(not a for a in arms):
        raise ValueError(f"empty portfolio arm in strategy spec {spec!r}")

    def parse_arm(arm: str):
        tokens = [t for t in arm.split("+")]
        if any(not t.strip() for t in tokens):
            raise ValueError(f"empty stage in strategy spec {arm!r}")
        return [_parse_stage(t) for t in tokens]

    def build_arm(parsed, arm_budget: int) -> NumericalOptimizer:
        if len(parsed) == 1 and parsed[0][1] is None:
            return _build_stage(
                parsed[0][0], dim, arm_budget, num_opt=num_opt, seed=seed
            )
        fracs = _resolve_fracs([f for _, f in parsed])
        # every stage is sized to the FULL arm budget: the pipeline's
        # cumulative boundaries enforce the per-stage shares, and a stage
        # that converges early rolls its unspent share downstream — which an
        # intrinsic per-share stage budget could never absorb
        stages = [
            _build_stage(name, dim, arm_budget, num_opt=num_opt, seed=seed)
            for name, _ in parsed
        ]
        return Pipeline(
            stages, fracs, budget=arm_budget, seed_spread=seed_spread
        )

    parsed_arms = [parse_arm(a) for a in arms]
    if len(parsed_arms) == 1:
        out = build_arm(parsed_arms[0], total)
    else:
        # members are sized to the FULL budget: successive halving means the
        # surviving arm inherits the culled arms' allowance, so each must be
        # able to spend it; the portfolio's own cap bounds the total.
        members = [build_arm(p, total) for p in parsed_arms]
        out = Portfolio(members, budget=total, noise=noise)
    # the normalized spec (whitespace/case folded away) is the provenance
    # string — identical strategies must stamp identical specs on records
    out.spec = "|".join(
        "+".join(n if f is None else f"{n}:{f:g}" for n, f in p)
        for p in parsed_arms
    )
    return out
