"""Tiled matmul — the canonical block-size auto-tuning demo (paper §2.3:
"block size (or loop granularity)" as the tunable), as a hand-written CUDA
kernel for Hopper.

Replaces the JAX package's ``kernels/matmul.py::matmul_tiled`` (Pallas TPU
kernel ``_kernel``) with two designs, chosen before launch by the pure
function :func:`design` from the dtype and the tile:

* ``"wgmma"`` (``csrc/matmul_wgmma.cu``), bf16 tiles with bm in 64/128/256,
  bn a power of two from 16 to 256 and bk 16, 32 or a multiple of 64 up to
  256 (whole 32-, 64- or 128-byte swizzle rows of A): a producer warp
  feeds a ring of shared-memory stages with TMA, one or two consumer
  warpgroups multiply on the tensor cores (``wgmma``) into fp32 registers;
  the stage count is the most that fits the block's 227 KB
  (:func:`ring_stages`).
* ``"simt"`` (``csrc/matmul.cu``), fp32 and every other tile: one thread
  block per (bm, bn) output tile, a loop over K in ``bk`` steps through
  shared memory, a 4×4 micro-tile of fp32 accumulators per thread on the
  CUDA cores.

Both accumulate in fp32 and cast to the input dtype; their measured times
are in PERF.md.  ``(bm, bn, bk)`` are the PATSMA tunables.  Tiles neither
design can run raise ``ValueError`` before any launch (see
:func:`check_tiles`), so the tuner charges them ``inf`` quietly and the CUDA
context never sees a refused launch.

:func:`matmul_plain` repeats the kernel's arithmetic in plain PyTorch; the
wrapper takes it only for CPU tensors with ``interpret=True``.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _cuda

__all__ = ["matmul_tiled", "matmul_plain", "design", "ring_stages", "check_tiles", "legal_tiles",
           "default_tiles", "aligned", "flops_bytes", "launches", "launches_by_design"]

#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
MAX_THREADS = 1024
TM = TN = 4  # accumulators per thread along M and N (csrc/matmul.cu)
#: tiles of the tensor-core design (csrc/matmul_wgmma.cu)
WGMMA_BM = (64, 128, 256)
WGMMA_BN = (16, 32, 64, 128, 256)
#: a swizzle row of A holds 16, 32 or 64 values of K; wider bk is whole rows
WGMMA_BK = (16, 32, 64, 128, 192, 256)
WGMMA_MAX_ACC = 128  # fp32 accumulators one consumer thread may hold
MAX_STAGES = 8
#: the default tile where the tensor-core design runs it (its best at
#: qwen2-7b's FFN, PERF.md: bk 64 is one 128-byte swizzle row of A), and the
#: tile the SIMT design runs at any size, for every other call
WGMMA_DEFAULT = (128, 256, 64)
SIMT_DEFAULT = (128, 128, 32)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: kernel launches so far, in total and by design (the plain version does not count)
launches = 0
launches_by_design = {"wgmma": 0, "simt": 0}
_count_lock = threading.Lock()


def _tiles(M: int, N: int, K: int, bm: int, bn: int, bk: int) -> tuple:
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    if M % bm or N % bn or K % bk:
        raise ValueError(f"dims {(M, N, K)} not divisible by tiles {(bm, bn, bk)}")
    return bm, bn, bk


def smem_bytes(bm: int, bn: int, bk: int, itemsize: int) -> int:
    """Shared memory of one block of the SIMT design: the transposed A tile
    (one padding word per row) and the B tile, in the input dtype."""
    pad = 2 if itemsize == 2 else 1
    return (bk * (bm + pad) + bk * bn) * itemsize


def _round1024(n: int) -> int:
    return (n + 1023) // 1024 * 1024


def ring_smem_bytes(bm: int, bn: int, bk: int, stages: int) -> int:
    """Shared memory of the tensor-core design: ``stages`` stages of an A
    and a B tile (bf16, each rounded up to the 128-byte swizzle's 1024-byte
    period), their two mbarriers, and 1024 bytes to align the ring."""
    stage = _round1024(2 * bm * bk) + _round1024(2 * bk * bn)
    return 1024 + stages * (stage + 16)


def ring_stages(bm: int, bn: int, bk: int) -> int:
    """Stages of the tensor-core design's ring: the most, up to
    ``MAX_STAGES``, that fit ``SMEM_LIMIT`` (0 when not even one does)."""
    for stages in range(MAX_STAGES, 0, -1):
        if ring_smem_bytes(bm, bn, bk, stages) <= SMEM_LIMIT:
            return stages
    return 0


def design(bm: int, bn: int, bk: int, itemsize: int, aligned: bool = True) -> str:
    """``"wgmma"`` when the tensor-core kernel runs this (clamped) tile,
    else ``"simt"``.  A pure function of the dtype (``itemsize`` 2: bf16),
    the tile and whether the operands start on 16-byte boundaries (TMA)."""
    if itemsize != 2 or not aligned:
        return "simt"
    if bm not in WGMMA_BM or bn not in WGMMA_BN or bk not in WGMMA_BK:
        return "simt"
    slices = 2 if bm > 128 else 1  # 64-row slices per consumer warpgroup (at most two warpgroups)
    if slices * bn // 2 > WGMMA_MAX_ACC or ring_stages(bm, bn, bk) < 2:
        return "simt"
    return "wgmma"


def check_tiles(bm: int, bn: int, bk: int, itemsize: int, aligned: bool = True) -> str:
    """The design that runs these tiles; ``ValueError`` for tiles neither
    CUDA kernel can run."""
    if design(bm, bn, bk, itemsize, aligned) == "wgmma":
        return "wgmma"
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
    return "simt"


def legal_tiles(M: int, N: int, K: int, bm: int, bn: int, bk: int, itemsize: int,
                on_card: bool, aligned: bool = True) -> tuple:
    """The tiles a call runs with (clamped to the dims), or ``ValueError``:
    they must divide the dims, and on the card fit the CUDA kernel that
    :func:`design` picks for them."""
    tiles = _tiles(M, N, K, bm, bn, bk)
    if on_card:
        check_tiles(*tiles, itemsize, aligned)
    return tiles


def aligned(a, b) -> bool:
    """Whether both operands start on 16-byte boundaries (TMA's rule)."""
    return a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0


def default_tiles(M: int, N: int, K: int, itemsize: int, aligned: bool = True) -> tuple:
    """The tile of a call without knobs, clamped to the dims:
    ``WGMMA_DEFAULT`` where it divides them and :func:`design` runs it on
    the tensor cores, else ``SIMT_DEFAULT``."""
    tiles = tuple(min(t, n) for t, n in zip(WGMMA_DEFAULT, (M, N, K)))
    if not (M % tiles[0] or N % tiles[1] or K % tiles[2]) and design(*tiles, itemsize, aligned) == "wgmma":
        return tiles
    return tuple(min(t, n) for t, n in zip(SIMT_DEFAULT, (M, N, K)))


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


def _launch(a, b, out, bm: int, bn: int, bk: int, kind: str) -> None:
    global launches
    M, K = a.shape
    N = b.shape[1]
    if kind == "wgmma":
        source, fn_name = "matmul_wgmma", "repro_matmul_wgmma_bf16"
        extra = [ring_stages(bm, bn, bk)]
    else:
        source, fn_name = "matmul", f"repro_matmul_{_SUFFIX[a.dtype]}"
        extra = []
    lib = _cuda.load(source)
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * (6 + len(extra)) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, bm, bn, bk, *extra, stream)
    if rc != 0:
        err = getattr(lib, f"repro_{source}_error_string")
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"matmul kernel ({kind}) launch failed (tile {bm}x{bn}x{bk}): "
                           f"CUDA error {rc}: {err(rc).decode()}")
    with _count_lock:
        launches += 1
        launches_by_design[kind] += 1


def matmul_tiled(a, b, *, bm: int | None = None, bn: int | None = None, bk: int | None = None,
                 interpret: bool = False):
    """a: (M,K) @ b: (K,N) -> (M,N) with fp32 accumulation, in ``a.dtype``.

    A tile dim left ``None`` comes from :func:`default_tiles`.  CUDA tensors
    launch the kernel; ``interpret=True`` runs the plain version, which
    takes CPU tensors only.  Anything else raises."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_tiled: shapes {tuple(a.shape)} @ {tuple(b.shape)} do not chain")
    M, K = a.shape
    N = b.shape[1]
    on_16 = aligned(a, b)
    if None in (bm, bn, bk):
        tiles = zip((bm, bn, bk), default_tiles(M, N, K, a.element_size(), on_16))
        bm, bn, bk = (d if t is None else t for t, d in tiles)
    bm, bn, bk = legal_tiles(M, N, K, bm, bn, bk, a.element_size(), on_card=not interpret, aligned=on_16)
    if interpret:
        if a.is_cuda or b.is_cuda:
            raise ValueError("matmul_tiled: interpret=True runs the plain version on CPU tensors only")
        return matmul_plain(a, b, bm=bm, bn=bn, bk=bk)
    _check_cuda(a, b)
    kind = design(bm, bn, bk, a.element_size(), on_16)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    _launch(a, b, out, bm, bn, bk, kind)
    return out
