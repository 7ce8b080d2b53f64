"""Fleet tuning, the pure part: sharded pretuning and order-independent DB
merging.

Every tuning context carries a stable fingerprint
(:class:`~repro_torch.tuning.records.TuningKey`), so a stable hash partitions
the pretune grid with **zero coordination**: ``pretune --shard i/n`` on n
hosts covers the grid exactly once, each host writing its own DB, and
:func:`merge_dbs` folds the shard DBs into one.  The merge resolver is a
*total order* over records (min by :func:`record_rank`), so merging is
associative and order-independent — any fold tree over any arrival order
yields the same DB.

Merge semantics mirror ``Autotuning.commit()``'s keep-better guard: lower
cost wins, and inside the noise band the better-*measured* record wins, not
the luckier one.  The pairwise guard alone is not transitive (three records
can cycle under "near-tie keeps lower variance"), which would make a fold
order-dependent; :func:`record_rank` linearizes it by scoring every record
with its *noise-penalized* cost — ``cost + known_std`` when the record
carries real measurement confidence, ``cost + 0.02·|cost|`` (the measurement
engine's relative-noise prior) when it does not — then breaking exact ties
deterministically.

Across devices, :class:`ShardedPortfolio` runs a Portfolio race with one
worker per member instead of round-robin turns: each member's rung-sized
ask-batches are measured concurrently, costs are gathered at a rung
barrier, and the cull decision is the *same pure function*
(:func:`repro_torch.core.strategy.cull_laggards`) the serial Portfolio
applies — so with deterministic costs the surviving members and their
bests match the serial race.  :func:`device_bound_measure` pins each
member's measurements to a card of a
:func:`~repro_torch.parallel.devices.local_device_pool`, so a host with
several cards measures the whole field at once, one member per card.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.trace import tracer as _tracer

from .records import TuningKey, TuningRecord

__all__ = [
    "REL_NOISE_PRIOR",
    "parse_shard",
    "shard_of",
    "in_shard",
    "record_rank",
    "better_record",
    "merge_records",
    "MergeStats",
    "merge_dbs",
    "journal_to_db",
    "FleetResult",
    "ShardedPortfolio",
    "device_bound_measure",
]

#: relative noise prior applied to records with *unknown* measurement
#: variance when ranking merge candidates — the same 2% relative floor the
#: measurement engine (:class:`repro_torch.core.measure.NoiseEstimate`) assumes
#: before calibration, so an unconfident record is penalized exactly as wide
#: as the noise band the racing engine would grant it.
REL_NOISE_PRIOR = 0.02


# ------------------------------------------------------------------ sharding
def parse_shard(spec: str) -> Tuple[int, int]:
    """``"i/n"`` → ``(i, n)`` with ``0 <= i < n`` — the CLI form of a fleet
    worker's identity (shard 2 of 8 is ``"2/8"``)."""
    s = str(spec).strip()
    try:
        i_s, _, n_s = s.partition("/")
        index, num = int(i_s), int(n_s)
    except ValueError:
        raise ValueError(f"bad shard spec {spec!r}: expected 'i/n', e.g. '0/4'")
    if num < 1:
        raise ValueError(f"bad shard spec {spec!r}: need at least one shard")
    if not 0 <= index < num:
        raise ValueError(
            f"bad shard spec {spec!r}: index must be in [0, {num})"
        )
    return index, num


def shard_of(key: TuningKey, num_shards: int) -> int:
    """The shard owning ``key`` — delegates to :meth:`TuningKey.shard`."""
    return key.shard(num_shards)


def in_shard(key: TuningKey, index: int, num_shards: int) -> bool:
    """Whether ``key`` belongs to shard ``index`` of ``num_shards``."""
    return key.shard(num_shards) == index


# ----------------------------------------------------------- merge resolver
def _penalized_cost(rec: TuningRecord) -> float:
    """The record's cost widened by its measurement uncertainty: the real
    std when known, else the engine's relative prior.  This is the scalar
    the total order primarily sorts by — a well-measured record beats a
    lucky single-rep near-tie, mirroring ``commit()``'s guard."""
    cost = float(rec.cost)
    if not math.isfinite(cost):
        return math.inf
    std = rec.known_std()
    if std is None:
        std = REL_NOISE_PRIOR * abs(cost)
    return cost + std


def record_rank(rec: TuningRecord) -> tuple:
    """Total-order score of a record — **lower is better**.

    Sort keys, in order: finite cost first; lower noise-penalized cost
    (:data:`REL_NOISE_PRIOR` stands in for unknown variance); lower raw
    cost; known variance beats unknown; more repetitions behind the
    measurement; earlier ``created`` (the incumbent stands on an exact tie);
    finally the canonical JSON of the point, so the order is total even for
    byte-identical measurements of different points.  Every component is a
    pure function of the record, so ``min`` by this key over any subset of
    records — in any order, any fold tree — picks the same winner: the
    property :func:`merge_dbs` needs for shard merges to be associative.
    """
    cost = float(rec.cost)
    finite = math.isfinite(cost)
    std = rec.known_std()
    return (
        0 if finite else 1,
        _penalized_cost(rec),
        cost if finite else math.inf,
        0 if std is not None else 1,
        -(rec.repeats_spent or 0),
        float(rec.created),
        json.dumps(rec.point, sort_keys=True, default=repr),
    )


def better_record(a: TuningRecord, b: TuningRecord) -> TuningRecord:
    """The winner of two records for the same key under :func:`record_rank`
    (returns ``a`` on an exact rank tie, but ranks tie only for
    indistinguishable records)."""
    return a if record_rank(a) <= record_rank(b) else b


def merge_records(records: Sequence[TuningRecord]) -> TuningRecord:
    """The winner among any number of records for the same key."""
    recs = list(records)
    if not recs:
        raise ValueError("merge_records needs at least one record")
    return min(recs, key=record_rank)


@dataclasses.dataclass
class MergeStats:
    """What a :func:`merge_dbs` fold did: ``seen`` source records, of which
    ``new`` filled empty keys, ``replaced`` beat the destination's record,
    and ``kept`` lost to it."""

    sources: int = 0
    seen: int = 0
    new: int = 0
    replaced: int = 0
    kept: int = 0

    @property
    def adopted(self) -> int:
        return self.new + self.replaced

    def __str__(self) -> str:
        return (
            f"{self.seen} records from {self.sources} sources: "
            f"{self.new} new, {self.replaced} replaced, {self.kept} kept"
        )


def merge_dbs(dest, sources) -> MergeStats:
    """Fold shard DBs into ``dest``, resolving per-key conflicts with the
    total-order winner (:func:`better_record`).  ``sources`` are
    :class:`~repro_torch.tuning.db.TuningDB` instances; ``dest`` may be empty or
    already hold records (they compete like any shard's).  Saves once at the
    end when ``dest`` is file-backed with autosave.  Associative and
    order-independent: merging shards pairwise, in any order, or all at once
    yields the identical destination."""
    stats = MergeStats()
    for src in sources:
        stats.sources += 1
        for rec in src.records():
            stats.seen += 1
            mine = dest.get(rec.key)
            if mine is None:
                dest.put(rec, save=False)
                stats.new += 1
            elif better_record(mine, rec) is rec:
                dest.put(rec, save=False)
                stats.replaced += 1
            else:
                stats.kept += 1
    if dest.autosave and dest.path is not None:
        dest.save()
    return stats


def journal_to_db(path: str):
    """The committed records of a run journal (``<db>.journal``) as an
    in-memory :class:`~repro_torch.tuning.db.TuningDB` — the shape
    :func:`merge_dbs` folds.  This is how a fleet merge adopts the completed
    work of a shard that died mid-sweep: committed cases count, the
    interrupted case it was measuring is simply absent (and re-measured by
    that shard's ``pretune --resume``)."""
    from .db import RunJournal

    return RunJournal(path).to_db()


# ------------------------------------------------------- sharded portfolio
@dataclasses.dataclass
class FleetResult:
    """Outcome of a :meth:`ShardedPortfolio.run` race."""

    best_x: np.ndarray  # normalized coordinates of the overall best
    best_cost: float
    member_bests: List[float]  # best finite cost per member (inf if none)
    member_best_x: List[Optional[np.ndarray]]
    survivors: List[int]  # members still active when the race ended
    spent: int  # total tells delivered
    member_spent: List[int]
    wall_s: float


class ShardedPortfolio:
    """A Portfolio race with one concurrent worker per member.

    The serial :class:`~repro_torch.core.strategy.Portfolio` interleaves its
    members' rung-sized chunks on a single measurement thread, so the race's
    wall-clock is the *sum* of every member's measurements.  This driver
    runs the same race as lockstep **passes**: every active member takes one
    rung-sized turn of its own ask→measure→tell loop *concurrently* — each
    turn touches only its own optimizer and its own state slots, so workers
    never contend — then a **rung barrier** gathers the scoreboard.  The
    cull check fires under the serial driver's exact gating rule (every
    active member has consumed its ``min(rung, natural round)`` check quota
    since the last check) and applies the identical pure decision
    (:func:`~repro_torch.core.strategy.cull_laggards`): statistically separated
    laggards are dropped, at most half the field per check, never the
    leader.  A culled member's worker goes idle, so with a shared budget
    its remaining allowance flows to the survivors — and the wall-clock of
    the whole race collapses to that of its slowest surviving member.

    With deterministic costs each member's search trajectory is identical
    to the serial race by construction (a member's tells depend only on its
    own costs), and the cull decisions match exactly whenever quota
    crossings land on pass boundaries — every member crosses its quota
    within one turn, which holds when member round sizes are either one
    natural round ≤ rung (CSA's m probes, a random stream) or drip-fed
    sweeps ≥ rung (a grid).  A member that needs *several* turns to
    accumulate its quota (a simplex asking fewer points per round than its
    ``get_num_points``) may see checks land one turn later than the serial
    mid-pass firing — both are valid successive-halving schedules over the
    same trajectories.

    ``measure(member_index, points) -> costs`` is the caller's measurement
    hook; it runs on the member's worker thread.
    """

    def __init__(
        self,
        optimizers: Sequence,
        *,
        budget: Optional[int] = None,
        noise=None,
        margin: float = 0.5,
        rung: Optional[int] = None,
    ) -> None:
        from repro_torch.core.measure import NoiseEstimate

        opts = list(optimizers)
        if len(opts) < 2:
            raise ValueError("ShardedPortfolio needs at least two optimizers")
        dims = {o.get_dimension() for o in opts}
        if len(dims) != 1:
            raise ValueError(f"member dimensions differ: {sorted(dims)}")
        if budget is not None and budget < 1:
            raise ValueError(f"budget must be >= 1, got {budget}")
        self._opts = opts
        self._dim = opts[0].get_dimension()
        self._budget = int(budget) if budget is not None else None
        self._noise = noise if noise is not None else NoiseEstimate(0.0, 0.02)
        self._margin = float(margin)
        if rung is not None and int(rung) < 1:
            raise ValueError(f"rung must be >= 1, got {rung}")
        if rung is not None:
            self._rung = int(rung)
        else:
            # same sizing rule as the serial Portfolio: one natural round of
            # the widest member, capped at a fair share of the budget
            self._rung = max(o.get_num_points() for o in opts)
            if budget is not None:
                self._rung = max(1, min(self._rung, int(budget) // (2 * len(opts))))
        n = len(opts)
        self._active: List[int] = list(range(n))
        self._spent = 0
        self._member_spent = [0] * n
        self._member_best = [np.inf] * n
        self._member_best_x: List[Optional[np.ndarray]] = [None] * n
        self._since_check = [0] * n  # tells since the last cull check
        # per-member round buffering, mirroring the serial driver: a round
        # larger than one turn's allowance is drip-fed, its costs buffered
        # until the member's full round is in and its accept/anneal runs
        self._round: List[Optional[list]] = [None] * n
        self._fed: List[list] = [[] for _ in opts]

    # ------------------------------------------------------------- interface
    @property
    def members(self) -> list:
        return list(self._opts)

    @property
    def active(self) -> list:
        return list(self._active)

    @property
    def member_bests(self) -> list:
        return [float(b) for b in self._member_best]

    @property
    def spent(self) -> int:
        return self._spent

    def set_noise(self, noise) -> None:
        """Adopt a calibrated noise floor for the separation test."""
        self._noise = noise

    def _quota(self, i: int) -> int:
        """Per-cycle allowance: the member's own check quota (its natural
        round size, capped by the rung) — the serial driver's scoring unit."""
        return min(self._rung, max(1, self._opts[i].get_num_points()))

    def _member_live(self, i: int) -> bool:
        return self._round[i] is not None or not self._opts[i].is_end()

    def _turn(self, i: int, allowance: int, measure: Callable) -> int:
        """Member ``i``'s turn: measure **one** chunk of up to ``allowance``
        tells from its pending round (asking a fresh round when none is in
        flight), exactly like one serial-driver turn.  Touches only
        index-``i`` state slots, so concurrent workers need no locks."""
        if self._round[i] is None:
            if self._opts[i].is_end():
                return 0
            r = self._opts[i].ask()
            if not r:
                return 0
            self._round[i] = [np.asarray(p, dtype=float).copy() for p in r]
            self._fed[i] = []
        done_n = len(self._fed[i])
        chunk = self._round[i][done_n : done_n + max(1, allowance)]
        costs = [float(c) for c in measure(i, [p.copy() for p in chunk])]
        if len(costs) != len(chunk):
            raise ValueError(
                f"measure returned {len(costs)} costs for {len(chunk)} points"
            )
        for p, c in zip(chunk, costs):
            if np.isfinite(c) and c < self._member_best[i]:
                self._member_best[i] = float(c)
                self._member_best_x[i] = np.array(p, dtype=float, copy=True)
        self._fed[i].extend(costs)
        if len(self._fed[i]) >= len(self._round[i]):
            # the member's full round is in: its accept/anneal step runs
            self._opts[i].tell(self._fed[i])
            self._round[i] = None
            self._fed[i] = []
        return len(costs)

    def run(
        self,
        measure: Callable[[int, List[np.ndarray]], Sequence[float]],
        *,
        max_workers: Optional[int] = None,
    ) -> FleetResult:
        """Race the members to completion (every member finished or culled,
        or the shared budget exhausted) and return the scoreboard."""
        from repro_torch.core.strategy import cull_laggards

        t0 = time.perf_counter()
        workers = min(len(self._opts), max_workers or len(self._opts))
        with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
            while True:
                if self._budget is not None and self._spent >= self._budget:
                    break
                live = [i for i in self._active if self._member_live(i)]
                if not live:
                    break
                # one lockstep pass: every live member takes one rung-sized
                # turn, all turns concurrent (each touches only its own
                # member's state); the shared budget is reserved in member
                # order, as the serial round-robin would spend it
                allow = {}
                rem = (
                    None if self._budget is None else self._budget - self._spent
                )
                for i in live:
                    a = self._rung
                    if rem is not None:
                        a = min(a, rem)
                        rem -= a
                    if a > 0:
                        allow[i] = a
                if not allow:
                    break
                # worker turns open member_turn spans attached to *this*
                # thread's current span, so a fleet run nests under the
                # caller's search/pretune span in the trace
                futs = {
                    pool.submit(
                        _tracer().wrap(self._turn, "member_turn", member=i),
                        i, a, measure,
                    ): i
                    for i, a in allow.items()
                }
                for f, i in futs.items():
                    n_tells = f.result()
                    self._spent += n_tells
                    self._member_spent[i] += n_tells
                    self._since_check[i] += n_tells
                # rung barrier: the cull check fires only once every active
                # member has consumed its check quota since the last check —
                # the serial driver's gating rule, applied at pass boundaries
                if len(self._active) >= 2 and all(
                    self._since_check[i] >= self._quota(i)
                    or not self._member_live(i)
                    for i in self._active
                ):
                    for i in self._active:
                        self._since_check[i] = 0
                    for i in cull_laggards(
                        self._active, self._member_best, self._noise, self._margin
                    ):
                        self._active.remove(i)
        best_i = min(
            range(len(self._opts)), key=lambda i: self._member_best[i]
        )
        best_cost = float(self._member_best[best_i])
        best_x = (
            self._member_best_x[best_i]
            if self._member_best_x[best_i] is not None
            else np.zeros(self._dim)
        )
        return FleetResult(
            best_x=np.array(best_x, dtype=float, copy=True),
            best_cost=best_cost,
            member_bests=self.member_bests,
            member_best_x=[
                None if x is None else np.array(x, dtype=float, copy=True)
                for x in self._member_best_x
            ],
            survivors=list(self._active),
            spent=self._spent,
            member_spent=list(self._member_spent),
            wall_s=time.perf_counter() - t0,
        )


def device_bound_measure(measure: Callable, slots: Sequence) -> Callable:
    """Pin each member's evaluations to its device slot: member ``i`` runs
    ``measure`` under ``torch.cuda.device(slots[i % len(slots)].device)``,
    so a host with several cards measures the whole field concurrently —
    one member per card — instead of queueing on card 0.  The current card
    is per host thread, so the context is entered in the thread that calls
    the wrapper: :class:`ShardedPortfolio` calls it on the member's worker
    thread.  Slots with no device (hosts without a card) pass through
    unchanged."""
    slots = list(slots)
    if not slots:
        return measure

    def wrapped(i: int, points):
        slot = slots[i % len(slots)]
        device = getattr(slot, "device", None)
        if device is None:
            return measure(i, points)
        import torch

        with torch.cuda.device(device):
            return measure(i, points)

    return wrapped
