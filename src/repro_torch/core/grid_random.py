"""Beyond-paper baseline optimizers sharing the NumericalOptimizer interface.

The paper's interface (§2.2) is explicitly designed so "other optimization
methods can be incorporated as a new class".  These two are used as controls
in the benchmarks (exhaustive truth for small spaces; random-search baseline
for the CSA-vs-NM comparisons).

Both have trivially perfect batch shapes: the whole remaining sweep is one
``ask()`` round (no point depends on another's cost), so a batched driver can
build every candidate concurrently.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .optimizer import NumericalOptimizer

__all__ = ["GridSearch", "RandomSearch"]


class GridSearch(NumericalOptimizer):
    """Exhaustive scan of a regular grid over [-1,1]^dim."""

    def __init__(self, dim: int, points_per_dim: int = 8) -> None:
        self._dim = dim
        self._ppd = int(points_per_dim)
        axes = [np.linspace(-1.0, 1.0, self._ppd) for _ in range(dim)]
        grid = np.meshgrid(*axes, indexing="ij")
        self._pts = np.stack([g.reshape(-1) for g in grid], axis=-1)
        self._i = 0  # next unevaluated grid index
        self._done = False
        self._best_x = self._pts[0].copy()
        self._best_e = np.inf

    def get_num_points(self) -> int:
        return len(self._pts)

    def get_dimension(self) -> int:
        return self._dim

    def is_end(self) -> bool:
        return self._done

    @property
    def best_solution(self) -> np.ndarray:
        return self._best_x.copy()

    @property
    def best_cost(self) -> float:
        return float(self._best_e)

    def reset(self, level: int = 0) -> None:
        """Reset contract parity with CSA: every level
        restarts the sweep with the full cold budget; level 0 retains the
        found solution, level 1 keeps the best *coordinates* but drops the
        stale energy (CSA's drift-reset semantics — the point must re-prove
        itself post-drift; NM instead rebuilds cold at level >= 1), and
        level >= 2 is complete."""
        self._i = 0
        self._done = False
        if level == 1:
            self._best_e = np.inf  # coordinates kept, stale energy dropped
        elif level >= 2:
            self._best_x = self._pts[0].copy()
            self._best_e = np.inf
        self._clear_batch_state()

    def _next_batch(self) -> Optional[List[np.ndarray]]:
        if self._i >= len(self._pts):
            self._done = True
            return None
        return [p.copy() for p in self._pts[self._i:]]

    def _consume_batch(self, points: List[np.ndarray], costs: List[float]) -> None:
        for p, c in zip(points, costs):
            self._i += 1
            if np.isfinite(c) and c < self._best_e:
                self._best_e = float(c)
                self._best_x = p.copy()
        if self._i >= len(self._pts):
            self._done = True


class RandomSearch(NumericalOptimizer):
    """Uniform random sampling for ``max_iter`` evaluations."""

    def __init__(self, dim: int, max_iter: int = 64, seed: int = 0) -> None:
        self._dim = dim
        self._max = int(max_iter)
        self._cold_max = int(max_iter)  # shrink_budget narrows the live value
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._i = 0
        self._done = False
        self._best_x = np.zeros(dim)
        self._best_e = np.inf

    def get_num_points(self) -> int:
        return 1

    def get_dimension(self) -> int:
        return self._dim

    def is_end(self) -> bool:
        return self._done

    @property
    def best_solution(self) -> np.ndarray:
        return self._best_x.copy()

    @property
    def best_cost(self) -> float:
        return float(self._best_e)

    def shrink_budget(self, frac: float) -> bool:
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"frac must be in (0, 1], got {frac}")
        self._max = max(1, int(np.ceil(self._max * frac)))
        return True

    def reset(self, level: int = 0) -> None:
        """Reset contract parity with CSA: every level
        restores the cold sample budget (a warm-start-shrunk budget never
        compounds); level 0 retains the found solution, level 1 keeps the
        best coordinates but drops the stale energy (CSA's drift-reset
        semantics; NM instead rebuilds cold at level >= 1), and level >= 2
        additionally replays the seed's RNG stream from the start."""
        self._i = 0
        self._done = False
        self._max = self._cold_max
        if level == 1:
            self._best_e = np.inf  # coordinates kept, stale energy dropped
        elif level >= 2:
            self._rng = np.random.default_rng(self._seed)
            self._best_x = np.zeros(self._dim)
            self._best_e = np.inf
        self._clear_batch_state()

    def _next_batch(self) -> Optional[List[np.ndarray]]:
        if self._i >= self._max:
            self._done = True
            return None
        # draw the remaining samples in sequence order (same stream as the
        # one-per-call staging)
        return [
            self._rng.uniform(-1.0, 1.0, size=self._dim)
            for _ in range(self._max - self._i)
        ]

    def _consume_batch(self, points: List[np.ndarray], costs: List[float]) -> None:
        for p, c in zip(points, costs):
            self._i += 1
            if np.isfinite(c) and c < self._best_e:
                self._best_e = float(c)
                self._best_x = p.copy()
        if self._i >= self._max:
            self._done = True
