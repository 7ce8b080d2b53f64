"""Staged Nelder–Mead simplex optimizer (paper's second method).

Nelder & Mead, "A Simplex Method for Function Minimization", Comput J 1965.

Implements the standard reflection/expansion/contraction/shrink moves over
the batch ``ask()``/``tell()`` protocol, matching PATSMA's constructor
``NelderMead(int dim, double error, int max_iter = 0)``:

  * ``error``    — stop when the simplex cost spread ``max_i |E_i - E_best|``
                   falls below it;
  * ``max_iter`` — maximum number of cost evaluations (0 = unbounded), so that
                   paper Eq. (2) holds: ``num_eval = max_iter * (ignore + 1)``.

Natural batches: the initial simplex (``dim + 1`` vertices) and a shrink round
(``dim`` vertices) are emitted whole; reflect/expand/contract probes are
single-point batches because each depends on the previous cost.  The
sequential ``run(cost)`` staging (one cost per call) is the base-class adapter
over ask/tell and emits the identical candidate sequence.

``speculative=True`` (beyond-paper, default off) widens the reflect batch to
``[x_r, x_e, x_c_out, x_c_in]`` — all four are computable before the
reflection cost is known — so a batched driver can compile/measure them
concurrently.  ``tell`` then *consumes* only the costs the sequential
algorithm would have looked at (the rest are discarded), keeping the simplex
trajectory, best point, and the ``evaluations`` budget bit-identical to the
non-speculative run; the extra measurements are pure compile/measure overlap
paid by the driver (whose own measurement/eval counters do record them).

Solutions live in ``[-1, 1]^dim`` and are clipped (NM is a local method; PATSMA
wraps only CSA).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .optimizer import NumericalOptimizer

__all__ = ["NelderMead"]

# stages
_INIT, _REFLECT, _EXPAND, _CONTRACT, _SHRINK, _DONE = range(6)


class NelderMead(NumericalOptimizer):
    def __init__(
        self,
        dim: int,
        error: float = 1e-6,
        max_iter: int = 0,
        *,
        alpha: float = 1.0,
        gamma: float = 2.0,
        beta: float = 0.5,
        sigma: float = 0.5,
        init_scale: float = 0.5,
        seed: int = 0,
        speculative: bool = False,
    ) -> None:
        if dim < 1:
            raise ValueError(f"dim must be >= 1, got {dim}")
        self._dim = dim
        self._error = float(error)
        self._max_evals = int(max_iter)  # paper calls it max_iter; it counts evals
        self._cold_max_evals = int(max_iter)  # shrink_budget narrows the live value
        self._alpha, self._gamma, self._beta, self._sigma = alpha, gamma, beta, sigma
        self._init_scale = init_scale
        self._seed = seed
        self._speculative = bool(speculative)
        self._rng = np.random.default_rng(seed)
        self._full_init()

    # ------------------------------------------------------------------ state
    def _full_init(self) -> None:
        n = self._dim
        x0 = self._rng.uniform(-self._init_scale, self._init_scale, size=n)
        self._simplex = np.tile(x0, (n + 1, 1))
        for i in range(n):
            self._simplex[i + 1, i] = self._clip(
                self._simplex[i + 1, i] + self._init_scale
            )[()]
        self._costs = np.full(n + 1, np.inf)
        self._stage = _INIT
        self._init_idx = 0  # vertices whose cost is known (INIT staging)
        self._evals = 0
        self._x_r: Optional[np.ndarray] = None  # reflection point in flight
        self._e_r: float = np.inf
        self._centroid_c: Optional[np.ndarray] = None  # centroid for _x_r
        self._x_e: Optional[np.ndarray] = None  # staged expansion point
        self._x_c: Optional[np.ndarray] = None  # staged contraction point
        self._shrink_queue: list = []
        self._best_x = self._simplex[0].copy()
        self._best_e = np.inf
        self._clear_batch_state()

    # ------------------------------------------------------------- interface
    def get_num_points(self) -> int:
        return self._dim + 1

    def get_dimension(self) -> int:
        return self._dim

    def is_end(self) -> bool:
        return self._stage == _DONE

    @property
    def best_solution(self) -> np.ndarray:
        return self._best_x.copy()

    @property
    def best_cost(self) -> float:
        return float(self._best_e)

    @property
    def evaluations(self) -> int:
        return self._evals

    @property
    def speculative(self) -> bool:
        return self._speculative

    def print(self) -> None:  # noqa: A003 - paper API name
        print(
            f"NelderMead(dim={self._dim}) evals={self._evals} stage={self._stage} "
            f"spread={self._spread():.3g} best={self._best_e:.6g}"
        )

    def seed(self, z0, spread: float = 0.2) -> bool:
        """Warm start: build the initial simplex around ``z0`` instead of a
        random point.  Only valid before the first candidate is emitted."""
        if self._stage != _INIT or self._init_idx != 0 or self._pending_batch is not None:
            return False
        z0 = np.asarray(z0, dtype=float).reshape(-1)
        if z0.shape[0] != self._dim:
            raise ValueError(f"seed dim {z0.shape[0]} != {self._dim}")
        self._simplex = np.tile(self._clip(z0), (self._dim + 1, 1))
        for i in range(self._dim):
            base = self._simplex[i + 1, i]
            # perturb toward the interior when the seed sits at the upper
            # bound, else the vertex collapses onto the base point and the
            # simplex has zero extent in that dimension
            step = spread if self._clip(base + spread)[()] != base else -spread
            self._simplex[i + 1, i] = self._clip(base + step)[()]
        self._best_x = self._simplex[0].copy()
        return True

    def shrink_budget(self, frac: float) -> bool:
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"frac must be in (0, 1], got {frac}")
        if self._max_evals > 0:
            # keep at least one full simplex evaluation worth of budget
            self._max_evals = max(self._dim + 2, int(np.ceil(self._max_evals * frac)))
        return True

    def reset(self, level: int = 0) -> None:
        """level 0: rebuild the simplex around the best-known solution;
        level >= 1: complete reset from a fresh random simplex.  Both levels
        restore the cold evaluation budget — a reset starts a new search
        episode, so a warm-start-shrunk budget does not compound."""
        if level >= 1:
            self._rng = np.random.default_rng(self._seed)
            self._max_evals = self._cold_max_evals
            self._full_init()
            return
        best_x, best_e = self._best_x.copy(), self._best_e
        self._full_init()
        self._max_evals = self._cold_max_evals
        self._simplex[0] = best_x
        self._best_x = best_x
        self._best_e = best_e  # level 0 retains the solutions found (§2.2)

    # -------------------------------------------------------- batch protocol
    def _remaining(self) -> Optional[int]:
        return (self._max_evals - self._evals) if self._max_evals > 0 else None

    def _exhausted(self) -> bool:
        return self._max_evals > 0 and self._evals >= self._max_evals

    def _spread(self) -> float:
        finite = self._costs[np.isfinite(self._costs)]
        if finite.size < 2:
            return np.inf
        return float(np.max(finite) - np.min(finite))

    def _next_batch(self) -> Optional[List[np.ndarray]]:
        rem = self._remaining()
        if rem is not None and rem <= 0:
            self._stage = _DONE
            return None
        if self._stage == _INIT:
            pts = [self._simplex[i].copy() for i in range(self._init_idx, self._dim + 1)]
            return pts if rem is None else pts[:rem]
        if self._stage == _SHRINK:
            pts = [self._simplex[i].copy() for i in self._shrink_queue]
            return pts if rem is None else pts[:rem]
        if self._stage == _EXPAND:
            return [self._x_e.copy()]
        if self._stage == _CONTRACT:
            return [self._x_c.copy()]
        # _REFLECT: start a fresh NM iteration — order simplex, reflect worst
        self._order()
        if self._spread() < self._error:
            self._stage = _DONE
            return None
        c = self._centroid()
        self._centroid_c = c
        self._x_r = self._clip(c + self._alpha * (c - self._simplex[-1]))
        self._e_r = np.inf
        if self._speculative and (rem is None or rem >= 2):
            # expansion and both contraction candidates depend only on the
            # simplex and x_r — compute them now so the driver can overlap
            # their compilation/measurement with the reflection's
            x_e = self._clip(c + self._gamma * (self._x_r - c))
            x_co = self._clip(c + self._beta * (self._x_r - c))
            x_ci = self._clip(c - self._beta * (c - self._simplex[-1]))
            return [self._x_r.copy(), x_e, x_co, x_ci]
        return [self._x_r.copy()]

    def _consume_batch(self, points: List[np.ndarray], costs: List[float]) -> None:
        if self._stage == _INIT:
            for x, c in zip(points, costs):
                self._consume_one(x, c)
                self._costs[self._init_idx] = c
                self._init_idx += 1
                if self._exhausted():
                    self._stage = _DONE
                    return
            if self._init_idx > self._dim:
                self._begin_iteration()
            return

        if self._stage == _SHRINK:
            for x, c in zip(points, costs):
                i = self._shrink_queue.pop(0)
                self._consume_one(x, c)
                self._costs[i] = c
                if self._exhausted():
                    self._stage = _DONE
                    return
            if not self._shrink_queue:
                self._begin_iteration()
            return

        if self._stage == _EXPAND:
            c = costs[0]
            self._consume_one(points[0], c)
            if c < self._e_r:
                self._accept(self._x_e, c)
            else:
                self._accept(self._x_r, self._e_r)
            self._begin_iteration()
            self._check_budget()
            return

        if self._stage == _CONTRACT:
            c = costs[0]
            self._consume_one(points[0], c)
            self._contract_decide(self._x_c, c)
            self._check_budget()
            return

        # _REFLECT (single or speculative batch)
        c_r = costs[0]
        self._consume_one(points[0], c_r)
        self._e_r = c_r
        if self._exhausted():
            self._stage = _DONE
            return
        spec = len(points) > 1
        c = self._centroid_c
        if c_r < self._costs[0]:
            # try expansion
            x_e = self._clip(c + self._gamma * (self._x_r - c))
            if np.allclose(x_e, self._x_r):
                self._accept(self._x_r, c_r)
                self._begin_iteration()
            elif spec:
                c_e = costs[1]
                self._consume_one(points[1], c_e)
                if c_e < self._e_r:
                    self._accept(x_e, c_e)
                else:
                    self._accept(self._x_r, self._e_r)
                self._begin_iteration()
                self._check_budget()
            else:
                self._x_e = x_e
                self._stage = _EXPAND
            return
        if c_r < self._costs[-2]:
            self._accept(self._x_r, c_r)
            self._begin_iteration()
            return
        # contraction (outside if reflect better than worst, else inside)
        outside = c_r < self._costs[-1]
        if outside:
            x_c = self._clip(c + self._beta * (self._x_r - c))
        else:
            x_c = self._clip(c - self._beta * (c - self._simplex[-1]))
        if spec:
            i = 2 if outside else 3
            c_c = costs[i]
            self._consume_one(points[i], c_c)
            self._contract_decide(x_c, c_c)
            self._check_budget()
        else:
            self._x_c = x_c
            self._stage = _CONTRACT
        return

    # ------------------------------------------------------------ transitions
    def _consume_one(self, x: np.ndarray, cost: float) -> None:
        self._evals += 1
        if cost < self._best_e:
            self._best_e = cost
            self._best_x = np.array(x, dtype=float, copy=True)

    def _check_budget(self) -> None:
        if self._exhausted():
            self._stage = _DONE

    def _contract_decide(self, x_c: np.ndarray, cost: float) -> None:
        if cost < min(self._e_r, self._costs[-1]):
            self._accept(x_c, cost)
            self._begin_iteration()
            return
        # shrink toward the best vertex
        for i in range(1, self._dim + 1):
            self._simplex[i] = self._clip(
                self._simplex[0] + self._sigma * (self._simplex[i] - self._simplex[0])
            )
            self._costs[i] = np.inf
        self._shrink_queue = list(range(1, self._dim + 1))
        self._stage = _SHRINK

    def _accept(self, x: np.ndarray, cost: float) -> None:
        """Replace the worst vertex."""
        self._simplex[-1] = x
        self._costs[-1] = cost

    def _begin_iteration(self) -> None:
        """Mark that the next batch starts a fresh order/reflect cycle."""
        self._stage = _REFLECT
        self._x_r = None
        self._e_r = np.inf
        self._x_e = None
        self._x_c = None
        self._centroid_c = None

    def _order(self) -> None:
        order = np.argsort(self._costs, kind="stable")
        self._simplex = self._simplex[order]
        self._costs = self._costs[order]

    def _centroid(self) -> np.ndarray:
        return np.mean(self._simplex[:-1], axis=0)
