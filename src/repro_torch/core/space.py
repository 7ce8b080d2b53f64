"""Search-space codec: optimizer hypercube [-1,1]^d  <->  user parameter domain.

PATSMA's C++ API exposes scalar ``min``/``max`` bounds and templated point
types (int / floating).  We reproduce that (``SearchSpace.uniform``) and extend
it with log-scaled and categorical dimensions, which are the natural domains
for the JAX knobs this framework tunes (block sizes are powers of two, remat
policies are categorical, ...).  The extension is additive: a plain
``Autotuning(min, max, ignore, dim, ...)`` behaves exactly like the paper.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np

__all__ = ["IntDim", "FloatDim", "LogIntDim", "ChoiceDim", "Constraint", "SearchSpace"]


@dataclasses.dataclass(frozen=True)
class IntDim:
    """Integer in [lo, hi] (inclusive), linear scale."""

    name: str
    lo: int
    hi: int

    def decode(self, z: float) -> int:
        t = (z + 1.0) / 2.0  # [-1,1] -> [0,1]
        v = self.lo + t * (self.hi - self.lo)
        return int(np.clip(round(v), self.lo, self.hi))

    def encode(self, v: Any) -> float:
        if self.hi == self.lo:
            return 0.0
        t = (float(v) - self.lo) / (self.hi - self.lo)
        return float(np.clip(2.0 * t - 1.0, -1.0, 1.0))


@dataclasses.dataclass(frozen=True)
class FloatDim:
    """Float in [lo, hi], linear scale."""

    name: str
    lo: float
    hi: float

    def decode(self, z: float) -> float:
        t = (z + 1.0) / 2.0
        return float(np.clip(self.lo + t * (self.hi - self.lo), self.lo, self.hi))

    def encode(self, v: Any) -> float:
        if self.hi == self.lo:
            return 0.0
        t = (float(v) - self.lo) / (self.hi - self.lo)
        return float(np.clip(2.0 * t - 1.0, -1.0, 1.0))


@dataclasses.dataclass(frozen=True)
class LogIntDim:
    """Integer sampled on a log2 grid: {lo, 2*lo, 4*lo, ..., hi}.

    The canonical domain for tile/block sizes (MXU-aligned powers of two).
    """

    name: str
    lo: int
    hi: int

    def __post_init__(self) -> None:
        if self.lo <= 0 or self.hi < self.lo:
            raise ValueError(f"bad LogIntDim bounds [{self.lo}, {self.hi}]")

    @property
    def _steps(self) -> int:
        return int(math.floor(math.log2(self.hi / self.lo)))

    def decode(self, z: float) -> int:
        t = (z + 1.0) / 2.0
        k = int(np.clip(round(t * self._steps), 0, self._steps))
        return self.lo * (2**k)

    def encode(self, v: Any) -> float:
        k = math.log2(max(float(v), self.lo) / self.lo)
        if self._steps == 0:
            return 0.0
        return float(np.clip(2.0 * (k / self._steps) - 1.0, -1.0, 1.0))


@dataclasses.dataclass(frozen=True)
class ChoiceDim:
    """Categorical over an ordered tuple of python values."""

    name: str
    values: tuple

    def __post_init__(self) -> None:
        if len(self.values) < 1:
            raise ValueError("ChoiceDim needs at least one value")

    def decode(self, z: float) -> Any:
        n = len(self.values)
        t = (z + 1.0) / 2.0
        i = int(np.clip(round(t * (n - 1)), 0, n - 1))
        return self.values[i]

    def encode(self, v: Any) -> float:
        i = self.values.index(v)
        n = len(self.values)
        if n == 1:
            return 0.0
        return float(np.clip(2.0 * (i / (n - 1)) - 1.0, -1.0, 1.0))


@dataclasses.dataclass(frozen=True)
class Constraint:
    """Declarative validity predicate over decoded points.

    ``predicate(point) -> bool`` receives the decoded ``{name: value}`` dict
    and returns True for legal points.  Constraints are evaluated *before*
    compile/measure: the Autotuning driver charges failing candidates ``inf``
    via the ``skip(reason="constraint")`` path at zero compile cost, so an
    intractable product space (mesh factorizations × microbatches × remat ×
    flags) collapses to its feasible region for free — the model-checking
    style pruning of "Auto-Tuning HPC Programs Using Model Checking"
    (PAPERS.md), expressed as plain python predicates.
    """

    name: str
    predicate: Any  # Callable[[dict], bool]
    describe: str = ""  # human-readable clause for docs / `pretune --list`

    def ok(self, point: dict) -> bool:
        try:
            return bool(self.predicate(point))
        except Exception:
            # a predicate that cannot even evaluate the point rejects it
            return False


class SearchSpace:
    """Ordered collection of dimensions with vector encode/decode.

    ``constraints`` (optional) are :class:`Constraint` validity predicates
    over decoded points; see :meth:`check`.  Spaces without constraints are
    byte-identical to the pre-constraint era (fingerprints, codec, keys).
    """

    def __init__(self, dims: Sequence[Any], constraints: Sequence[Constraint] = ()) -> None:
        if not dims:
            raise ValueError("empty search space")
        self.dims = list(dims)
        names = [d.name for d in self.dims]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate dim names: {names}")
        self.constraints = tuple(constraints)
        cnames = [c.name for c in self.constraints]
        if len(set(cnames)) != len(cnames):
            raise ValueError(f"duplicate constraint names: {cnames}")

    @classmethod
    def uniform(cls, lo, hi, dim: int, integer: bool = True) -> "SearchSpace":
        """The paper's (min, max, dim) constructor.  ``lo``/``hi`` may be
        scalars or length-``dim`` sequences."""
        lo = np.broadcast_to(np.asarray(lo, dtype=float), (dim,))
        hi = np.broadcast_to(np.asarray(hi, dtype=float), (dim,))
        mk = IntDim if integer else FloatDim
        cast = int if integer else float
        return cls([mk(f"p{i}", cast(lo[i]), cast(hi[i])) for i in range(dim)])

    def __len__(self) -> int:
        return len(self.dims)

    @property
    def names(self) -> list:
        return [d.name for d in self.dims]

    def decode(self, z: np.ndarray) -> dict:
        z = np.asarray(z, dtype=float).reshape(-1)
        if z.shape[0] != len(self.dims):
            raise ValueError(f"point has dim {z.shape[0]}, space has {len(self.dims)}")
        return {d.name: d.decode(z[i]) for i, d in enumerate(self.dims)}

    def decode_vector(self, z: np.ndarray) -> list:
        return list(self.decode(z).values())

    def encode(self, values) -> np.ndarray:
        if isinstance(values, dict):
            vals = [values[d.name] for d in self.dims]
        else:
            vals = list(values)
        return np.array([d.encode(v) for d, v in zip(self.dims, vals)], dtype=float)

    def key(self, values) -> tuple:
        """Hashable cache key for a decoded point."""
        if isinstance(values, dict):
            return tuple(values[d.name] for d in self.dims)
        return tuple(values)

    def check(self, point) -> "str | None":
        """Name of the first violated constraint for a decoded point, or None.

        Accepts a ``{name: value}`` dict or an ordered value sequence."""
        if not self.constraints:
            return None
        if not isinstance(point, dict):
            point = {d.name: v for d, v in zip(self.dims, point)}
        for c in self.constraints:
            if not c.ok(point):
                return c.name
        return None

    def _dim_values(self, d) -> "list | None":
        """All representable values of one dim, or None if continuous."""
        if isinstance(d, ChoiceDim):
            return list(d.values)
        if isinstance(d, LogIntDim):
            return [d.lo * (2**k) for k in range(d._steps + 1)]
        if isinstance(d, IntDim):
            return list(range(d.lo, d.hi + 1))
        return None  # FloatDim and friends: continuous

    def size(self) -> "int | None":
        """Cardinality of the raw product space (None if any dim is
        continuous)."""
        n = 1
        for d in self.dims:
            vals = self._dim_values(d)
            if vals is None:
                return None
            n *= len(vals)
        return n

    def grid_points(self):
        """Iterate every representable point (dicts).  Raises for continuous
        spaces — guard with :meth:`size`."""
        import itertools

        per_dim = []
        for d in self.dims:
            vals = self._dim_values(d)
            if vals is None:
                raise ValueError(f"dim {d.name!r} is continuous; no finite grid")
            per_dim.append(vals)
        names = self.names
        for combo in itertools.product(*per_dim):
            yield dict(zip(names, combo))

    def constrained_size(self, cap: int = 1_000_000) -> "int | None":
        """Count of points that satisfy every constraint — the feasible-region
        size operators see in ``pretune --list``.  None if the space is
        continuous or its raw size exceeds ``cap`` (enumeration too big)."""
        raw = self.size()
        if raw is None or raw > cap:
            return None
        if not self.constraints:
            return raw
        return sum(1 for p in self.grid_points() if self.check(p) is None)

    def resolution(self) -> float:
        """Coarsest normalized grid step across dims (0.0 if all continuous).

        The distance in ``[-1, 1]`` between adjacent representable values of
        the coarsest discrete dimension — what a warm-start spread must
        exceed for a seeded population to straddle neighboring grid points
        instead of collapsing onto the seed (a ``LogIntDim`` with 6 octaves
        has steps of 1/3; a 4-way ``ChoiceDim`` has steps of 2/3)."""
        step = 0.0
        for d in self.dims:
            if isinstance(d, LogIntDim):
                n = d._steps
            elif isinstance(d, ChoiceDim):
                n = len(d.values) - 1
            elif isinstance(d, IntDim):
                n = d.hi - d.lo
            else:  # FloatDim and friends: continuous
                continue
            if n > 0:
                step = max(step, 2.0 / n)
        return step
