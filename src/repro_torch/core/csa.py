"""Coupled Simulated Annealing (CSA) — PATSMA's primary optimizer.

Faithful implementation of CSA with modified (coupled) acceptance and
acceptance-variance control, after

    Xavier-de-Souza, Suykens, Vandewalle, Bollé,
    "Coupled Simulated Annealing", IEEE Trans. SMC-B 40(2), 2010.

``m = num_opt`` SA solvers run in parallel.  Each solver ``i`` holds a current
solution ``x_i`` with energy ``E_i``.  Probes are generated with a Cauchy-like
kernel scaled by the generation temperature ``T_gen`` (schedule
``T_gen_k = T_gen0 / k``).  Acceptance of an *uphill* probe is coupled across
solvers through

    gamma   = sum_j exp((E_j - max_j E_j) / T_ac)
    A_i     = exp((E_i - max_j E_j) / T_ac) / gamma

and the acceptance temperature ``T_ac`` is steered so that the variance of
``A`` approaches ``sigma_D^2 = 0.99 * (m-1)/m^2`` (99% of its maximum), the
rule recommended in the CSA paper: variance below target → multiply ``T_ac``
by ``(1 - alpha)``, above → ``(1 + alpha)``.

Rounds are natural batches — the CSA paper runs its m solvers in parallel by
construction — so the batch protocol maps directly:

    ask()  : the m initial random solutions (INIT round) or the m probes of
             the current iteration, generated in solver order;
    tell() : store the m costs, perform the coupled acceptance step, update
             temperatures, advance the iteration counter.

The sequential ``run(cost)`` staging (paper §2.2) is the base-class adapter
over ask/tell and emits the exact same candidate sequence.  Evaluation count
therefore still matches paper Eq. (1):
``num_eval = max_iter * (ignore + 1) * num_opt`` (the INIT round counts as
iteration 1; ``ignore`` is applied by the Autotuning driver).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .optimizer import NumericalOptimizer

__all__ = ["CSA"]

_INIT, _PROBE, _DONE = 0, 1, 2


class CSA(NumericalOptimizer):
    def __init__(
        self,
        dim: int,
        num_opt: int = 4,
        max_iter: int = 100,
        *,
        tgen0: float = 1.0,
        tac0: float = 0.9,
        alpha: float = 0.05,
        seed: int = 0,
    ) -> None:
        if dim < 1:
            raise ValueError(f"dim must be >= 1, got {dim}")
        if num_opt < 2:
            raise ValueError(f"CSA needs num_opt >= 2 coupled solvers, got {num_opt}")
        if max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {max_iter}")
        self._dim = dim
        self._m = num_opt
        self._max_iter = max_iter
        self._tgen0 = float(tgen0)
        # cold-start configuration; seed()/shrink_budget() narrow the live
        # values, a complete reset must restore these
        self._cold_max_iter = max_iter
        self._cold_tgen0 = float(tgen0)
        self._tac0 = float(tac0)
        self._alpha = float(alpha)
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._full_init()

    # ------------------------------------------------------------------ state
    def _full_init(self) -> None:
        self._x = self._rng.uniform(self.LO, self.HI, size=(self._m, self._dim))
        self._e = np.full(self._m, np.inf)
        self._probes = np.zeros_like(self._x)
        self._probe_e = np.full(self._m, np.inf)
        self._tgen = self._tgen0
        self._tac = self._tac0
        self._iter = 1  # INIT round is iteration 1 (keeps Eq.1 exact)
        self._phase = _INIT
        self._best_x = self._x[0].copy()
        self._best_e = np.inf
        # target acceptance-probability variance (99% of max, CSA paper §V)
        self._sigma_d2 = 0.99 * (self._m - 1) / self._m**2
        self._clear_batch_state()

    # ------------------------------------------------------------- interface
    def get_num_points(self) -> int:
        return self._m

    def get_dimension(self) -> int:
        return self._dim

    def is_end(self) -> bool:
        return self._phase == _DONE

    @property
    def best_solution(self) -> np.ndarray:
        return self._best_x.copy()

    @property
    def best_cost(self) -> float:
        return float(self._best_e)

    @property
    def iteration(self) -> int:
        return self._iter

    @property
    def temperatures(self) -> tuple:
        return (self._tgen, self._tac)

    def print(self) -> None:  # noqa: A003 - paper API name
        print(
            f"CSA(m={self._m}, dim={self._dim}) iter={self._iter}/{self._max_iter} "
            f"phase={self._phase} Tgen={self._tgen:.4g} Tac={self._tac:.4g} "
            f"best={self._best_e:.6g} @ {np.array2string(self._best_x, precision=3)}"
        )

    def seed(self, z0, spread: float = 0.2) -> bool:
        """Warm start: place solver 0 exactly at ``z0`` and scatter the other
        coupled solvers around it (Cauchy-free gaussian cloud, wrapped into the
        toroidal domain).  Only valid before the first candidate is emitted."""
        if self._phase != _INIT or self._pending_batch is not None:
            return False
        z0 = np.asarray(z0, dtype=float).reshape(-1)
        if z0.shape[0] != self._dim:
            raise ValueError(f"seed dim {z0.shape[0]} != {self._dim}")
        self._x[0] = self._clip(z0)
        for i in range(1, self._m):
            self._x[i] = self._wrap(z0 + self._rng.normal(0.0, spread, size=self._dim))
        # a tight start wants a cooler generation schedule than a blind one
        self._tgen = self._tgen0 = min(self._tgen0, max(spread, 1e-3))
        return True

    def shrink_budget(self, frac: float) -> bool:
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"frac must be in (0, 1], got {frac}")
        self._max_iter = max(1, int(np.ceil(self._max_iter * frac)))
        return True

    def reset(self, level: int = 0) -> None:
        """level 0: re-anneal keeping all current solutions (and their
        energies — found solutions are retained, paper §2.2);
        level 1: keep only the best solution's *coordinates* as solver 0,
        randomize the rest, and forget all stored energies — the point
        survives but must re-prove itself in the new environment (this is
        the drift-reset level: stale pre-drift costs must not outbid fresh
        measurements);
        level >= 2: complete reset (paper §2.2: 'a complete reset').

        Every level restores the cold generation temperature and iteration
        budget: a reset starts a new annealing episode, so a budget shrunk
        by an earlier warm start does not compound across resets (the caller
        re-applies ``seed()``/``shrink_budget()`` if the new episode should
        be warm too)."""
        if level >= 2:
            self._rng = np.random.default_rng(self._seed)
            self._tgen0 = self._cold_tgen0
            self._max_iter = self._cold_max_iter
            self._full_init()
            return
        self._tgen0 = self._cold_tgen0
        self._max_iter = self._cold_max_iter
        if level == 1:
            keep = self._best_x.copy()
            self._x = self._rng.uniform(self.LO, self.HI, size=(self._m, self._dim))
            self._x[0] = keep
            self._best_e = np.inf  # coordinates kept, stale energy dropped
        # level 0 and 1 share: restart the annealing schedule + re-evaluate
        self._e = np.full(self._m, np.inf)
        self._tgen = self._tgen0
        self._tac = self._tac0
        self._iter = 1
        self._phase = _INIT
        self._clear_batch_state()

    # -------------------------------------------------------- batch protocol
    def _next_batch(self) -> Optional[List[np.ndarray]]:
        if self._phase == _INIT:
            return [self._x[i].copy() for i in range(self._m)]
        # _PROBE: one probe per solver, generated in solver order (the same
        # RNG draw order the sequential staging used)
        return [self._gen_probe(i) for i in range(self._m)]

    def _consume_batch(self, points: List[np.ndarray], costs: List[float]) -> None:
        if self._phase == _INIT:
            for i in range(self._m):
                self._e[i] = costs[i]
                self._note_best(self._x[i], costs[i])
        else:
            for i in range(self._m):
                self._probe_e[i] = costs[i]
                self._note_best(self._probes[i], costs[i])
            self._coupled_acceptance()
        self._iter += 1
        if self._iter > self._max_iter:
            self._phase = _DONE
            return
        self._phase = _PROBE
        self._tgen = self._tgen0 / self._iter  # T_gen_k = T_gen0 / k

    def _note_best(self, x: np.ndarray, e: float) -> None:
        if e < self._best_e:
            self._best_e = e
            self._best_x = x.copy()

    def _gen_probe(self, i: int) -> np.ndarray:
        u = self._rng.uniform(size=self._dim)
        step = self._tgen * np.tan(np.pi * (u - 0.5))  # Cauchy kernel
        y = self._wrap(self._x[i] + step)
        self._probes[i] = y
        return y.copy()

    def _coupled_acceptance(self) -> None:
        """Vectorized coupled-acceptance step (numpy masks, no solver loop).

        RNG-stream compatible with the historical per-solver staging: a
        uniform is drawn only for finite, *uphill* probes (downhill moves are
        accepted unconditionally; crashed configurations are never adopted),
        in solver order — ``uniform(size=k)`` yields the same doubles as k
        sequential draws, so trajectories for a given seed are unchanged.
        """
        e = self._e
        emax = float(np.max(e[np.isfinite(e)])) if np.any(np.isfinite(e)) else 0.0
        ex = np.exp((np.where(np.isfinite(e), e, emax) - emax) / max(self._tac, 1e-300))
        gamma = float(np.sum(ex))
        probs = ex / gamma  # A_i, sum to 1
        finite = np.isfinite(self._probe_e)  # never move onto a crashed config
        downhill = self._probe_e < self._e
        need_u = finite & ~downhill  # uphill probes gamble on coupled A_i
        u = np.full(self._m, np.inf)
        u[need_u] = self._rng.uniform(size=int(np.count_nonzero(need_u)))
        accept = finite & (downhill | (u < probs))
        self._x[accept] = self._probes[accept]
        self._e[accept] = self._probe_e[accept]
        # variance steering of T_ac toward sigma_D^2 = 0.99*(m-1)/m^2
        sigma2 = float(np.mean(probs**2) - (1.0 / self._m) ** 2)
        if sigma2 < self._sigma_d2:
            self._tac *= 1.0 - self._alpha
        else:
            self._tac *= 1.0 + self._alpha
