"""The tuning surface: persistence, warm starts, and the pure fleet layer.

Counterpart of the JAX package's ``repro.tuning``, with the same on-disk
format: results are keyed by a context fingerprint — (name, input
shapes+dtypes, search-space hash, backend, device kind) — and stored in a
versioned JSON DB with atomic writes.  Either package reads the other's
files.

* :mod:`repro_torch.tuning.records`    — fingerprints + record schema
* :mod:`repro_torch.tuning.db`         — the on-disk database
* :mod:`repro_torch.tuning.warm_start` — exact-hit replay / neighbor seeding
* :mod:`repro_torch.tuning.fleet`      — shard assignment and DB merging
* :mod:`repro_torch.tuning.pretune`    — offline sweep CLI
  (``python -m repro_torch.tuning.pretune``)
"""
from .db import ENV_DB_PATH, RunJournal, TuningDB, default_db
from .fleet import (
    MergeStats,
    better_record,
    merge_dbs,
    merge_records,
    parse_shard,
    record_rank,
)
from .records import (
    SCHEMA_VERSION,
    TuningKey,
    TuningRecord,
    default_device,
    make_key,
    signature_of,
    space_fingerprint,
)
from .warm_start import apply_warm_start, record_from

__all__ = [
    "SCHEMA_VERSION",
    "ENV_DB_PATH",
    "RunJournal",
    "TuningDB",
    "TuningKey",
    "TuningRecord",
    "default_db",
    "default_device",
    "make_key",
    "signature_of",
    "space_fingerprint",
    "apply_warm_start",
    "record_from",
    "MergeStats",
    "better_record",
    "merge_dbs",
    "merge_records",
    "parse_shard",
    "record_rank",
]
