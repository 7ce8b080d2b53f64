"""Hand-written CUDA kernels for Hopper with plain PyTorch oracles in ref.py.

Ports of the JAX package's Pallas TPU kernels, one module each, with the
same tunable block shapes as PATSMA targets.  Each kernel module holds the
CUDA wrapper (sources in ``csrc/``, built with nvcc at first use), a plain
PyTorch version of the same arithmetic that CPU tensors take under
``interpret=True``, and a launch counter.  ``autotuned`` is the
tuning-DB-backed dispatch layer (stored best block shapes per call context),
and ``routed`` / ``kernel_router`` its online-adaptive form.
"""
from . import ops, ref
from .autotuned import autotuned, kernel_router, routed, tune_call

__all__ = ["ops", "ref", "autotuned", "tune_call", "routed", "kernel_router"]
