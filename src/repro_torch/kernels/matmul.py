"""Tiled matmul — the canonical block-size auto-tuning demo (paper §2.3:
"block size (or loop granularity)" as the tunable), as a hand-written CUDA
kernel for Hopper.

Replaces the JAX package's ``kernels/matmul.py::matmul_tiled`` (Pallas TPU
kernel ``_kernel``).  The CUDA source is ``csrc/matmul.cu``: one thread block
per (bm, bn) output tile, a loop over K in ``bk`` steps through shared
memory, a 4×4 micro-tile of fp32 accumulators per thread, and the result
cast to the input dtype.  The product is compute-bound at FFN shapes; this
first kernel runs its FMAs on the CUDA cores, far below the tensor-core
peak (its measured times are in PERF.md).

``(bm, bn, bk)`` are the PATSMA tunables.  Tiles the simple design cannot
run raise ``ValueError`` before any launch (see :func:`check_tiles`), so the
tuner charges them ``inf`` quietly and the CUDA context never sees a
refused launch.

:func:`matmul_plain` repeats the kernel's arithmetic in plain PyTorch; the
wrapper takes it only for CPU tensors with ``interpret=True``.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _cuda

__all__ = ["matmul_tiled", "matmul_plain", "check_tiles", "legal_tiles", "flops_bytes", "launches"]

#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
MAX_THREADS = 1024
TM = TN = 4  # accumulators per thread along M and N (csrc/matmul.cu)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: kernel launches so far (the plain version does not count)
launches = 0
_count_lock = threading.Lock()


def _tiles(M: int, N: int, K: int, bm: int, bn: int, bk: int) -> tuple:
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    if M % bm or N % bn or K % bk:
        raise ValueError(f"dims {(M, N, K)} not divisible by tiles {(bm, bn, bk)}")
    return bm, bn, bk


def smem_bytes(bm: int, bn: int, bk: int, itemsize: int) -> int:
    """Shared memory of one block: the transposed A tile (one padding word
    per row) and the B tile, in the input dtype."""
    pad = 2 if itemsize == 2 else 1
    return (bk * (bm + pad) + bk * bn) * itemsize


def check_tiles(bm: int, bn: int, bk: int, itemsize: int) -> None:
    """Raise ``ValueError`` for tiles the CUDA kernel cannot run."""
    if bm % TM or bn % TN:
        raise ValueError(f"tile bm={bm} bn={bn}: the CUDA kernel needs multiples of {TM}")
    threads = (bm // TM) * (bn // TN)
    if threads > MAX_THREADS:
        raise ValueError(
            f"tile bm={bm} bn={bn} needs {threads} threads of {TM}x{TN} accumulators "
            f"per block (max {MAX_THREADS}): too many accumulators per block"
        )
    smem = smem_bytes(bm, bn, bk, itemsize)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"tile bm={bm} bn={bn} bk={bk} needs {smem} bytes of shared memory "
            f"(max {SMEM_LIMIT})"
        )


def legal_tiles(M: int, N: int, K: int, bm: int, bn: int, bk: int, itemsize: int,
                on_card: bool) -> tuple:
    """The tiles a call runs with (clamped to the dims), or ``ValueError``:
    they must divide the dims, and on the card fit the CUDA kernel."""
    tiles = _tiles(M, N, K, bm, bn, bk)
    if on_card:
        check_tiles(*tiles, itemsize)
    return tiles


def flops_bytes(a, b) -> tuple:
    """(FLOP, bytes each input read once and the output written once)."""
    M, K = a.shape
    N = b.shape[1]
    return 2.0 * M * N * K, float((M * K + K * N + M * N) * a.element_size())


def matmul_plain(a, b, *, bm: int, bn: int, bk: int):
    """The kernel's arithmetic in plain PyTorch: fp32 products summed into an
    fp32 accumulator one ``bk`` slice of K at a time, cast to ``a.dtype``."""
    M, K = a.shape
    N = b.shape[1]
    bm, bn, bk = _tiles(M, N, K, bm, bn, bk)
    acc = torch.zeros((M, N), dtype=torch.float32, device=a.device)
    for k0 in range(0, K, bk):
        acc += a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float()
    return acc.to(a.dtype)


def _check_cuda(a, b) -> None:
    for name, t in (("a", a), ("b", b)):
        if not t.is_cuda:
            raise ValueError(
                f"matmul_tiled: {name} is on {t.device}; the CUDA kernel needs CUDA "
                "tensors (interpret=True runs the plain version on CPU tensors)"
            )
        if t.dtype not in _SUFFIX:
            raise ValueError(f"matmul_tiled: {name} has dtype {t.dtype}; supported: {list(_SUFFIX)}")
        if not t.is_contiguous():
            raise ValueError(f"matmul_tiled: {name} must be contiguous")
    if a.device != b.device or a.dtype != b.dtype:
        raise ValueError(
            f"matmul_tiled: a ({a.dtype}, {a.device}) and b ({b.dtype}, {b.device}) differ"
        )


def _launch(a, b, out, bm: int, bn: int, bk: int) -> None:
    global launches
    lib = _cuda.load("matmul")
    fn = getattr(lib, f"repro_matmul_{_SUFFIX[a.dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    M, K = a.shape
    N = b.shape[1]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, bm, bn, bk, stream)
    if rc != 0:
        lib.repro_matmul_error_string.restype = ctypes.c_char_p
        msg = lib.repro_matmul_error_string(rc).decode()
        raise RuntimeError(f"matmul kernel launch failed (tile {bm}x{bn}x{bk}): CUDA error {rc}: {msg}")
    with _count_lock:
        launches += 1


def matmul_tiled(a, b, *, bm: int = 128, bn: int = 128, bk: int = 32, interpret: bool = False):
    """a: (M,K) @ b: (K,N) -> (M,N) with fp32 accumulation, in ``a.dtype``.

    CUDA tensors launch the kernel; ``interpret=True`` runs the plain
    version, which takes CPU tensors only.  Anything else raises."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_tiled: shapes {tuple(a.shape)} @ {tuple(b.shape)} do not chain")
    M, K = a.shape
    N = b.shape[1]
    bm, bn, bk = legal_tiles(M, N, K, bm, bn, bk, a.element_size(), on_card=not interpret)
    if interpret:
        if a.is_cuda or b.is_cuda:
            raise ValueError("matmul_tiled: interpret=True runs the plain version on CPU tensors only")
        return matmul_plain(a, b, bm=bm, bn=bn, bk=bk)
    _check_cuda(a, b)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    _launch(a, b, out, bm, bn, bk)
    return out
