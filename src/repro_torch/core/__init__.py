"""repro_torch.core — PATSMA (Parameter Auto-Tuning for Shared Memory
Algorithms) on PyTorch: staged numerical optimizers (CSA, Nelder–Mead), the
Autotuning driver with Single-Iteration / Entire-Execution × Runtime /
user-cost modes, search-space codecs, and the cost backends.

Counterpart of the JAX package's ``repro.core``.  The optimizers and search
spaces are copies (same trajectories, bit for bit); measurement synchronizes
CUDA instead of blocking on JAX arrays; the roofline bound comes from
analytic FLOP and byte counts over :data:`H100_SXM`.  The search
strategies (``strategy.py``: pipelines, portfolios and the spec grammar;
``grid_random.py``) are copies too, and ``tuned_jit.py`` wires the loop
into a step function (:class:`TunedStep`).
"""
from .autotuning import Autotuning
from .costs import (
    H100_SXM,
    CachePartition,
    ExecutableCache,
    HardwareSpec,
    RooflineTerms,
    RuntimeCost,
    compile_fanout,
    roofline_terms,
)
from .csa import CSA
from .grid_random import GridSearch, RandomSearch
from .guard import (
    CircuitBreaker,
    FaultPolicy,
    GuardTimeout,
    Quarantine,
    SandboxCrash,
    SandboxUnavailable,
    deterministic_backoff,
    guarded_call,
    is_transient_failure,
    sandboxed_probe,
)
from .measure import (
    MeasureEngine,
    MeasurePolicy,
    MeasureResult,
    NoiseEstimate,
    block_until_ready,
    resolve_measure_policy,
    time_rep,
)
from .nelder_mead import NelderMead
from .optimizer import NumericalOptimizer
from .space import ChoiceDim, Constraint, FloatDim, IntDim, LogIntDim, SearchSpace
from .strategy import (
    Pipeline,
    Portfolio,
    SearchStrategy,
    cull_laggards,
    make_strategy,
    strategy_label,
)
from .tuned_jit import TunedStep

__all__ = [
    "Autotuning",
    "CSA",
    "NelderMead",
    "GridSearch",
    "RandomSearch",
    "NumericalOptimizer",
    "SearchStrategy",
    "Pipeline",
    "Portfolio",
    "cull_laggards",
    "make_strategy",
    "strategy_label",
    "SearchSpace",
    "Constraint",
    "IntDim",
    "FloatDim",
    "LogIntDim",
    "ChoiceDim",
    "TunedStep",
    "RuntimeCost",
    "MeasurePolicy",
    "MeasureResult",
    "MeasureEngine",
    "NoiseEstimate",
    "resolve_measure_policy",
    "time_rep",
    "block_until_ready",
    "ExecutableCache",
    "CachePartition",
    "compile_fanout",
    "FaultPolicy",
    "GuardTimeout",
    "SandboxCrash",
    "SandboxUnavailable",
    "CircuitBreaker",
    "Quarantine",
    "guarded_call",
    "sandboxed_probe",
    "is_transient_failure",
    "deterministic_backoff",
    "HardwareSpec",
    "RooflineTerms",
    "H100_SXM",
    "roofline_terms",
]
