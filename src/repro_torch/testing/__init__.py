"""repro_torch.testing — deterministic fault injection for the resilience layer."""
from .faults import (
    ENV_FAULT_PLAN,
    FaultPlan,
    FaultSpec,
    InjectedCrash,
    active_plan,
    parse_plan,
    tear_file,
)

__all__ = [
    "ENV_FAULT_PLAN",
    "FaultPlan",
    "FaultSpec",
    "InjectedCrash",
    "active_plan",
    "parse_plan",
    "tear_file",
]
