"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C interface.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch/`` at the root of the source tree, named by a hash of
the source, the shared headers ``csrc/*.cuh`` (``hopper.cuh``: TMA,
mbarriers, ``wgmma``) and the flags (so an edited source or header
rebuilds and an unchanged one is reused), and loaded with :mod:`ctypes`.
The tensor-core sources find ``cuTensorMapEncodeTiled`` through the CUDA
runtime, so nothing links against ``libcuda``.  The ptxas report (registers,
shared memory and spills per kernel) is kept beside it as ``.log``.

Builds happen once per process under a lock — the tuner's thread pool asks
for the same library from several threads at once.  :func:`build` starts
one ``nvcc`` per source, all at once.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "BUILD_DIR", "build", "load", "ptxas_report"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("matmul", "matmul_wgmma", "flash_attention", "flash_attention_wgmma", "flash_attention_bwd",
           "linear_scan", "rwkv_subchunk", "decode_attention", "adamw", "rwkv_decode")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
            "kernels are compiled at first use and need the CUDA toolkit"
        )
    return path


def _lib_path(name: str, csrc: Path = CSRC) -> Path:
    """The library of ``name``, keyed by its source, every shared header of
    ``csrc`` and the flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _build_locked(names: Iterable[str]) -> Dict[str, float]:
    import time

    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    seconds: Dict[str, float] = {}
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return seconds


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named kernel sources that are not built yet, one ``nvcc``
    process each, all started together.  Returns the wall seconds until each
    finished (empty when everything was built already)."""
    with _lock:
        return _build_locked(list(names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def ptxas_report(name: str) -> str:
    """ptxas' per-kernel lines (registers, shared memory, spills, and its
    warnings that wgmma was serialized or fenced) of the last build of
    ``name``."""
    log = _lib_path(name).with_suffix(".log")
    if not log.exists():
        return ""
    keep = ("registers", "spill", "smem", "Compiling entry", "Performance Loss", "injected")
    return "\n".join(ln for ln in log.read_text().splitlines() if any(k in ln for k in keep))
