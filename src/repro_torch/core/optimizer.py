"""NumericalOptimizer interface — faithful port of PATSMA Algorithm 1.

The paper's interface (C++):

    class NumericalOptimizer {
      virtual double* run(double cost) = 0;
      virtual int getNumPoints() const = 0;
      virtual int getDimension() const = 0;
      virtual bool isEnd() const = 0;
      virtual void reset(int level) {};
      virtual void print() const {}
    };

The key contract (paper §2.2): ``run`` is a *staged* state machine.  Each call
delivers the cost of the **previously returned** candidate and receives the
next candidate to test.  The first call's cost argument is ignored.  Once the
optimization has ended, ``run`` keeps returning the final solution (which does
not require further testing) and ``is_end()`` is True.

Batch protocol (beyond-paper): the staged machine is now built on an
``ask()``/``tell(costs)`` pair so a driver can evaluate a whole round of
candidates concurrently (compile fan-out, within-round dedup):

* :meth:`ask` returns the full list of candidates whose costs the optimizer
  needs next — CSA's m coupled probes, NM's initial simplex, a grid's sweep.
  Calling it again before :meth:`tell` returns the same batch; once the
  optimization has ended it returns ``[]``.
* :meth:`tell` delivers the costs, in order, for the batch `ask` returned,
  advancing the optimizer exactly as the equivalent sequence of sequential
  ``run`` calls would — same RNG draws, same accept decisions, same budget
  accounting.  The protocols may be switched at round boundaries; a direct
  ``tell`` mid-way through a drip-fed ``run`` round discards the costs
  ``run`` had buffered (the whole round's costs must come through ``tell``).

``run`` itself is implemented *on top of* ask/tell: it hands out the pending
batch one candidate per call and buffers the incoming costs until the round
completes.  Subclasses implement the primitives :meth:`_next_batch` /
:meth:`_consume_batch` and inherit ``run``/``ask``/``tell``.

Optimizers work in the normalized hypercube ``[-1, 1]^dim``; rescaling to the
user domain (min/max, int/float/log/categorical) is the responsibility of
:class:`repro_torch.core.space.SearchSpace` inside :class:`repro_torch.core.autotuning.Autotuning`.
"""
from __future__ import annotations

import abc
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["NumericalOptimizer"]


class NumericalOptimizer(abc.ABC):
    """Abstract staged optimizer (paper Algorithm 1) with batch ask/tell."""

    #: normalized search bounds
    LO: float = -1.0
    HI: float = 1.0

    # batch-protocol state; instance attributes shadow these class defaults
    _pending_batch: Optional[List[np.ndarray]] = None  # asked, awaiting tell
    _run_batch: Optional[List[np.ndarray]] = None  # being drip-fed via run()
    _run_costs: Optional[List[float]] = None  # costs buffered by run()

    # --------------------------------------------------- batch primitives
    @abc.abstractmethod
    def _next_batch(self) -> Optional[List[np.ndarray]]:
        """Produce the next round of candidates, or None/[] if the search is
        over (implementations set their DONE state before returning None).
        Called exactly once per round — RNG draws happen here."""

    @abc.abstractmethod
    def _consume_batch(self, points: List[np.ndarray], costs: List[float]) -> None:
        """Deliver ``costs[i]`` for ``points[i]`` (the batch `_next_batch`
        produced) and advance the round.  Costs are already sanitized
        (non-finite → inf)."""

    # --------------------------------------------------------- batch API
    def ask(self) -> List[np.ndarray]:
        """Candidates whose costs the optimizer needs next ([] once ended).

        Idempotent: repeated calls return (copies of) the same batch until
        :meth:`tell` delivers its costs."""
        if self.is_end():
            return []
        if self._pending_batch is None:
            batch = self._next_batch()
            if not batch:
                return []
            self._pending_batch = [np.asarray(p, dtype=float).copy() for p in batch]
        return [p.copy() for p in self._pending_batch]

    def tell(self, costs: Sequence[float]) -> None:
        """Deliver the costs for the batch returned by :meth:`ask`."""
        if self.is_end():
            return
        if self._pending_batch is None:
            raise RuntimeError("tell() before ask(): no batch is pending")
        if len(costs) != len(self._pending_batch):
            raise ValueError(
                f"tell() got {len(costs)} costs for a batch of {len(self._pending_batch)}"
            )
        batch = self._pending_batch
        self._pending_batch = None
        clean = [float(c) if np.isfinite(c) else np.inf for c in costs]
        self._consume_batch(batch, clean)
        # a direct tell() supersedes any half-delivered run() round
        self._run_batch = None
        self._run_costs = None

    def _clear_batch_state(self) -> None:
        """Drop pending ask/run bookkeeping (call from reset())."""
        self._pending_batch = None
        self._run_batch = None
        self._run_costs = None

    # ----------------------------------------------------- sequential run
    def run(self, cost: float) -> np.ndarray:
        """Deliver ``cost`` of the last returned candidate; return the next one.

        Returns an array of shape ``(dimension,)`` in ``[-1, 1]``.  After
        :meth:`is_end` becomes True, returns the final solution.  Implemented
        over :meth:`ask`/:meth:`tell`: costs buffer until the pending round is
        complete, then the round advances in one step.
        """
        if self.is_end():
            return self.best_solution
        if self._run_batch is None:
            self._run_batch = self.ask()  # first call: cost is ignored
            self._run_costs = []
            if not self._run_batch:
                return self.best_solution
        else:
            self._run_costs.append(float(cost) if np.isfinite(cost) else np.inf)
            if len(self._run_costs) == len(self._run_batch):
                self.tell(self._run_costs)  # resets _run_batch/_run_costs
                if self.is_end():
                    return self.best_solution
                self._run_batch = self.ask()
                self._run_costs = []
                if not self._run_batch:
                    return self.best_solution
        return self._run_batch[len(self._run_costs)].copy()

    # ------------------------------------------------------------- interface
    @abc.abstractmethod
    def get_num_points(self) -> int:
        """Number of solutions the algorithm maintains (``num_opt`` for CSA)."""

    @abc.abstractmethod
    def get_dimension(self) -> int:
        """Dimensionality of the solutions."""

    @abc.abstractmethod
    def is_end(self) -> bool:
        """Whether the optimization has finished."""

    def reset(self, level: int = 0) -> None:  # optional (paper line 10)
        """Reset the optimization.  ``level`` semantics (paper §2.2):
        0 → light reset retaining found solutions; higher levels discard
        progressively more, up to a complete reset."""

    # --- warm-start hooks (beyond-paper; used by repro_torch.tuning) --------------
    def seed(self, z0: np.ndarray, spread: float = 0.2) -> bool:
        """Bias the initial state toward ``z0`` (normalized coords).

        Called before the first :meth:`run` by the warm-start machinery when a
        persisted tuning record for a *nearby* context exists.  Implementations
        should concentrate their initial population / simplex around ``z0``
        with the given ``spread``.  Returns True if applied; the default is a
        no-op (optimizers without a useful notion of seeding stay faithful)."""
        return False

    def shrink_budget(self, frac: float) -> bool:
        """Scale the remaining evaluation budget by ``frac`` (0 < frac <= 1).

        Warm-started searches begin near a known-good solution, so they are
        granted a reduced budget (the point of persisting tuning results).
        Returns True if applied; default no-op."""
        return False

    def print(self) -> None:  # optional (paper line 11); keep the paper's name
        """Print debug/verbose optimizer state."""

    # --- conveniences shared by all implementations -------------------------
    @property
    def best_solution(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def best_cost(self) -> float:
        raise NotImplementedError

    @staticmethod
    def _wrap(z: np.ndarray) -> np.ndarray:
        """Wrap into [-1, 1] (toroidal, as PATSMA's CSA does with fmod)."""
        return np.mod(z + 1.0, 2.0) - 1.0

    @staticmethod
    def _clip(z: np.ndarray) -> np.ndarray:
        return np.clip(z, -1.0, 1.0)
