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

The device-parallel half of the JAX package's fleet (``ShardedPortfolio``,
``device_bound_measure``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Sequence, Tuple

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
