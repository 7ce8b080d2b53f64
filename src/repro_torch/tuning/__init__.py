"""The tuning surface: persistence, warm starts, and the fleet layer.

Counterpart of the JAX package's ``repro.tuning``, with the same on-disk
format: results are keyed by a context fingerprint — (name, input
shapes+dtypes, search-space hash, backend, device kind) — and stored in a
versioned JSON DB with atomic writes.  Either package reads the other's
files.

* :mod:`repro_torch.tuning.records`    — fingerprints + record schema
* :mod:`repro_torch.tuning.db`         — the on-disk database
* :mod:`repro_torch.tuning.warm_start` — exact-hit replay / neighbor seeding
* :mod:`repro_torch.tuning.fleet`      — shard assignment, order-independent
  DB merging, and the :class:`~repro_torch.tuning.fleet.ShardedPortfolio` race
* :mod:`repro_torch.tuning.pretune`    — offline sweep CLI
  (``python -m repro_torch.tune pretune`` or ``python -m
  repro_torch.tuning.pretune``)

This module is also the package's *facade*: the handful of names a tuning
user needs — :class:`Autotuning`, :func:`tune_call`, :func:`autotuned`,
:func:`make_strategy`, :class:`MeasurePolicy`, and the fleet entry points —
are importable from ``repro_torch.tuning`` directly, whichever layer defines
them.  Cross-layer names resolve lazily (PEP 562):
``repro_torch.kernels`` itself imports ``repro_torch.tuning``, so eager
re-exports would cycle.
"""
from .db import ENV_DB_PATH, RunJournal, TuningDB, default_db
from .fleet import (
    FleetResult,
    MergeStats,
    ShardedPortfolio,
    better_record,
    device_bound_measure,
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
    # fleet layer
    "FleetResult",
    "MergeStats",
    "ShardedPortfolio",
    "better_record",
    "device_bound_measure",
    "merge_dbs",
    "merge_records",
    "parse_shard",
    "record_rank",
    # facade re-exports (lazy: see __getattr__)
    "Autotuning",
    "tune_call",
    "autotuned",
    "make_strategy",
    "MeasurePolicy",
    "local_device_pool",
]

#: facade name -> defining module (resolved on first attribute access —
#: ``repro_torch.kernels.autotuned`` imports this package at its own top
#: level, so these must not be imported eagerly here)
_FACADE = {
    "Autotuning": "repro_torch.core",
    "make_strategy": "repro_torch.core",
    "MeasurePolicy": "repro_torch.core",
    "tune_call": "repro_torch.kernels.autotuned",
    "autotuned": "repro_torch.kernels.autotuned",
    "local_device_pool": "repro_torch.parallel.devices",
}


def __getattr__(name: str):
    mod = _FACADE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(mod), name)
    globals()[name] = value  # cache: next access skips the indirection
    return value


def __dir__():
    return sorted(set(__all__) | set(globals()))
