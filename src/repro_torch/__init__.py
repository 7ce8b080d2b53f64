"""repro_torch — PATSMA (Parameter Auto-Tuning for Shared Memory Algorithms)
on PyTorch and hand-written CUDA kernels for NVIDIA Hopper.

The port of the JAX package ``repro``, laid out module for module like it
and held against it by the ``tests/test_torch_*.py`` suite.  It imports
neither JAX nor ``repro``.  Entry points run on the card unless the caller
asks for the CPU (``interpret=True`` / ``--interpret``).
"""
