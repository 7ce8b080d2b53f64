"""Deterministic synthetic data pipeline (resumable), a copy of the JAX
package's ``repro.data``.

Real deployments swap in a tokenized corpus reader behind the same iterator
contract: ``(step) -> batch dict``, with exact resume (the pipeline is a
pure function of (seed, step), so checkpoint/restart replays identically).
"""
from .pipeline import SyntheticLM, make_batch_for

__all__ = ["SyntheticLM", "make_batch_for"]
