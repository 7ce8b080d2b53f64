"""repro_torch.runtime — keep a *running* program tuned.

Copies of the JAX package's ``repro.runtime`` modules on the port's
``core``:

* :mod:`repro_torch.runtime.context` — :class:`ContextRouter`: buckets live
  calls into tuning contexts (name × pow2 shape-bucket × caller extra,
  reusing ``TuningKey`` fingerprints) and dispatches each at its current
  best.
* :mod:`repro_torch.runtime.online` — :class:`OnlineTuner`: streams an
  ε-rationed fraction of real request timings into the ask/tell search,
  building candidates off-thread so serving never blocks on a build.
* :mod:`repro_torch.runtime.drift` — :class:`DriftDetector`: sliding-window
  cost statistics over the exploit stream; degradation triggers a
  half-budget warm re-search.
* :mod:`repro_torch.runtime.driver` — the fault-tolerant training driver
  (:class:`TrainJob`, :class:`Watchdog`), with a ``runtime="adaptive"`` mode
  that delegates drift handling to the online tuner.

``TrainJob``/``Watchdog`` import the whole model stack, so they load
lazily; the online-tuning classes above are light.
"""
from .context import ContextRouter, RouteSpec, bucket_args, pow2_bucket
from .drift import DriftDetector
from .online import EXPLOIT, EXPLORE, Decision, OnlineTuner

__all__ = [
    "ContextRouter",
    "RouteSpec",
    "pow2_bucket",
    "bucket_args",
    "DriftDetector",
    "OnlineTuner",
    "Decision",
    "EXPLORE",
    "EXPLOIT",
    "TrainJob",
    "Watchdog",
]

_DRIVER_NAMES = ("TrainJob", "Watchdog")


def __getattr__(name):  # lazy: the driver pulls in models/optim/train
    if name in _DRIVER_NAMES:
        from . import driver

        return getattr(driver, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
