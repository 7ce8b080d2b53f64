"""Flash-attention forward: online softmax over KV tiles, as a hand-written
CUDA kernel for Hopper.

Replaces the JAX package's ``kernels/flash_attention.py::flash_attention_fwd``
(Pallas TPU kernel ``_kernel``) with two designs, chosen before launch by
the pure function :func:`design` from the dtype, head dim, tile and
strides.  Both run one thread block per (query tile, query head, batch)
that loops over the KV tiles up to the causal bound with the fp32 m/l/acc
carry in registers:

* ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``), bf16 with block_q 64 or
  128 and block_kv 16 to 128 at every head dim, strides TMA can describe:
  K/V tiles stream through a TMA-fed ring of shared-memory stages, S = Q Kᵀ
  and O += P V run on the tensor cores (``wgmma``; P split into bf16 hi
  and lo parts), one warpgroup per 64 query rows;
* ``"simt"`` (``csrc/flash_attention.cu``), fp32 and every other tile: 8
  threads per query row, the K/V/score tiles in shared memory, the FMAs on
  the CUDA cores.

Causal prefill at head dim 128 is compute-bound on the card; the measured
times are in PERF.md.

Same conventions as the TPU kernel: q/k/v are cast to fp32 and q is scaled
by 1/√hd before the dot; causal masking keeps ``qi >= kj`` aligned top-left
(the oracle in ``ref.py`` aligns bottom-right — they agree for Sq == Skv);
KV tiles wholly in the future are skipped; rows with ``l == 0`` give 0; GQA
query head h reads KV head h // (H // Kh).

``block_q`` / ``block_kv`` are the PATSMA tunables.  Tiles neither design
can run raise ``ValueError`` before any launch (:func:`check_blocks`).
:func:`flash_attention_plain` repeats the kernel's arithmetic in plain
PyTorch; the wrapper takes it only for CPU tensors with ``interpret=True``.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import _cuda

__all__ = [
    "flash_attention_fwd",
    "flash_attention_plain",
    "design",
    "ring_stages",
    "check_blocks",
    "legal_blocks",
    "flops_bytes",
    "launches",
    "launches_by_design",
]

NEG_INF = -1e30
#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
MAX_THREADS = 1024
TPR = 8  # threads per query row (csrc/flash_attention.cu)
HEAD_DIMS = (16, 32, 64, 128)
#: tiles of the tensor-core design (csrc/flash_attention_wgmma.cu): one
#: consumer warpgroup per 64 query rows, block_kv up to what its registers
#: hold (a thread's scores, output and P's two halves: block_kv / 2 + hd / 2
#: + 2 block_kv / 4 values)
WGMMA_BLOCK_Q = (64, 128)
WGMMA_BLOCK_KV = (16, 32, 64, 128)
MAX_STAGES = 4

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: kernel launches so far, in total and by design (the plain version does not count)
launches = 0
launches_by_design = {"wgmma": 0, "simt": 0}
_count_lock = threading.Lock()


def _blocks(Sq: int, Skv: int, block_q: int, block_kv: int) -> tuple:
    block_q, block_kv = min(block_q, Sq), min(block_kv, Skv)
    if Sq % block_q or Skv % block_kv:
        raise ValueError(f"seq ({Sq},{Skv}) not divisible by blocks ({block_q},{block_kv})")
    return block_q, block_kv


def smem_bytes(hd: int, block_q: int, block_kv: int, itemsize: int) -> int:
    """Shared memory of one block of the SIMT design: scaled fp32 q and
    score tiles (one padding word per row), K (padded) and V tiles in the
    input dtype."""
    pad = 2 if itemsize == 2 else 1
    return 4 * (block_q * (hd + 1) + block_q * (block_kv + 1)) + itemsize * (
        block_kv * (hd + pad) + block_kv * hd
    )


def _round1024(n: int) -> int:
    return (n + 1023) // 1024 * 1024


def ring_smem_bytes(hd: int, block_q: int, block_kv: int, stages: int) -> int:
    """Shared memory of the tensor-core design: the Q tile, ``stages``
    stages of a K and a V tile (bf16, each rounded up to the 128-byte
    swizzle's 1024-byte period), the mbarriers, and 1024 bytes to align."""
    return (1024 + _round1024(2 * block_q * hd) + stages * 2 * _round1024(2 * block_kv * hd)
            + 8 * (1 + 2 * stages))


def ring_stages(hd: int, block_q: int, block_kv: int) -> int:
    """Stages of the tensor-core design's K/V ring: the most, up to
    ``MAX_STAGES``, that fit ``SMEM_LIMIT`` (0 when not even one does)."""
    for stages in range(MAX_STAGES, 0, -1):
        if ring_smem_bytes(hd, block_q, block_kv, stages) <= SMEM_LIMIT:
            return stages
    return 0


def design(itemsize: int, hd: int, block_q: int, block_kv: int, strides=(), aligned: bool = True) -> str:
    """``"wgmma"`` when the tensor-core kernel runs this call, else
    ``"simt"``.  A pure function of the dtype (``itemsize`` 2: bf16), the
    head dim, the (clamped) tile, the batch/head/sequence strides of q, k, v
    and o in elements (TMA needs multiples of 16 bytes) and whether the
    tensors start on 16-byte boundaries."""
    if itemsize != 2 or not aligned or hd not in HEAD_DIMS:
        return "simt"
    if block_q not in WGMMA_BLOCK_Q or block_kv not in WGMMA_BLOCK_KV:
        return "simt"
    if any(st % 8 for st in strides) or ring_stages(hd, block_q, block_kv) < 2:
        return "simt"
    return "wgmma"


def check_blocks(hd: int, block_q: int, block_kv: int, itemsize: int, strides=(),
                 aligned: bool = True) -> str:
    """The design that runs this call; ``ValueError`` for shapes and tiles
    neither CUDA kernel can run."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not instantiated (have {HEAD_DIMS})")
    if design(itemsize, hd, block_q, block_kv, strides, aligned) == "wgmma":
        return "wgmma"
    if block_q * TPR > MAX_THREADS:
        raise ValueError(
            f"block_q={block_q} needs {block_q * TPR} threads per block (max {MAX_THREADS})"
        )
    if block_kv % TPR:
        raise ValueError(f"block_kv={block_kv} must be a multiple of {TPR}")
    smem = smem_bytes(hd, block_q, block_kv, itemsize)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"block_q={block_q} block_kv={block_kv} (hd {hd}) needs {smem} bytes of "
            f"shared memory (max {SMEM_LIMIT})"
        )
    return "simt"


def legal_blocks(hd: int, Sq: int, Skv: int, block_q: int, block_kv: int, itemsize: int,
                 on_card: bool) -> tuple:
    """The blocks a call runs with (clamped to the sequences), or
    ``ValueError``: they must divide them, and on the card fit the kernel."""
    blocks = _blocks(Sq, Skv, block_q, block_kv)
    if on_card:
        check_blocks(hd, *blocks, itemsize)
    return blocks


def flops_bytes(q, k, v, causal: bool = True) -> tuple:
    """(FLOP, bytes) of one call, q: (B,H,Sq,hd), k/v: (B,Kh,Skv,hd).

    FLOP count the two products over the (query, key) pairs the causal mask
    keeps (top-left: row i sees keys 0..i), 4·hd per pair; bytes read q, k,
    v once and write o once."""
    B, H, Sq, hd = q.shape
    Skv = k.shape[2]
    if causal:
        pairs = sum(min(i + 1, Skv) for i in range(Sq))
    else:
        pairs = Sq * Skv
    flops = 4.0 * B * H * pairs * hd
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return flops, float(nbytes)


def flash_attention_plain(q, k, v, *, causal: bool = True, block_q: int = 128, block_kv: int = 128):
    """The kernel's arithmetic in plain PyTorch, tile by tile: fp32 m/l/acc
    carry, -1e30 in masked slots, causal tiles in the future skipped."""
    B, H, Sq, hd = q.shape
    Kh, Skv = k.shape[1], k.shape[2]
    g = H // Kh
    block_q, block_kv = _blocks(Sq, Skv, block_q, block_kv)
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=1)  # query head h reads KV head h // g
    vf = v.float().repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    for q0 in range(0, Sq, block_q):
        qt = qf[:, :, q0:q0 + block_q]
        m = torch.full((B, H, block_q, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, block_q, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, block_q, hd), dtype=torch.float32, device=q.device)
        for kv0 in range(0, Skv, block_kv):
            if causal and kv0 > q0 + block_q - 1:
                break  # this and every later tile lie wholly in the future
            s = qt @ kf[:, :, kv0:kv0 + block_kv].transpose(-1, -2)
            if causal:
                qi = q0 + torch.arange(block_q, device=q.device)[:, None]
                kj = kv0 + torch.arange(block_kv, device=q.device)[None, :]
                s = torch.where(qi >= kj, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, :, kv0:kv0 + block_kv]
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)  # fully masked rows -> 0
        out[:, :, q0:q0 + block_q] = (acc / l).to(q.dtype)
    return out


def _check_cuda(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(
                f"flash_attention_fwd: {name} is on {t.device}; the CUDA kernel needs "
                "CUDA tensors (interpret=True runs the plain version on CPU tensors)"
            )
        if t.dtype not in _SUFFIX:
            raise ValueError(
                f"flash_attention_fwd: {name} has dtype {t.dtype}; supported: {list(_SUFFIX)}"
            )
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention_fwd: {name} must be contiguous in its last dim")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("flash_attention_fwd: q, k and v must share device and dtype")


def _strides(q, k, v, out) -> tuple:
    """Batch, head and sequence strides of q, k, v and o, in elements."""
    return tuple(t.stride(i) for t in (q, k, v, out) for i in range(3))


def _launch(q, k, v, out, causal: bool, block_q: int, block_kv: int, kind: str) -> None:
    global launches
    B, H, Sq, hd = q.shape
    Kh, Skv = k.shape[1], k.shape[2]
    if kind == "wgmma":
        source, fn_name = "flash_attention_wgmma", "repro_flash_attention_wgmma_bf16"
        extra = [ring_stages(hd, block_q, block_kv)]
    else:
        source, fn_name = "flash_attention", f"repro_flash_attention_{_SUFFIX[q.dtype]}"
        extra = []
    lib = _cuda.load(source)
    fn = getattr(lib, fn_name)
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        + [ctypes.c_int] * (3 + len(extra)) + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    strides = (ctypes.c_longlong * 12)(*_strides(q, k, v, out))
    scale = float(torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Kh, Sq, Skv, hd,
                ctypes.cast(strides, ctypes.c_void_p), block_q, block_kv, *extra, int(causal), scale,
                stream)
    if rc != 0:
        err = getattr(lib, f"repro_{source}_error_string")
        err.restype = ctypes.c_char_p
        raise RuntimeError(
            f"flash_attention kernel ({kind}) launch failed (blocks {block_q}x{block_kv}): "
            f"CUDA error {rc}: {err(rc).decode()}"
        )
    with _count_lock:
        launches += 1
        launches_by_design[kind] += 1


def flash_attention_fwd(
    q, k, v, *, causal: bool = True, block_q: int = 128, block_kv: int = 128,
    interpret: bool = False,
):
    """q: (B,H,Sq,hd); k/v: (B,Kh,Skv,hd) -> o: (B,H,Sq,hd) in ``q.dtype``.

    Any strides are taken as long as the last dim is contiguous; the output
    has q's layout.  CUDA tensors launch the kernel; ``interpret=True`` runs
    the plain version, which takes CPU tensors only.  Anything else raises."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_fwd: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    Kh, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % Kh:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} and k {tuple(k.shape)} do not match")
    block_q, block_kv = legal_blocks(hd, Sq, Skv, block_q, block_kv, q.element_size(),
                                     on_card=not interpret)
    if interpret:
        if q.is_cuda or k.is_cuda or v.is_cuda:
            raise ValueError(
                "flash_attention_fwd: interpret=True runs the plain version on CPU tensors only"
            )
        return flash_attention_plain(q, k, v, causal=causal, block_q=block_q, block_kv=block_kv)
    _check_cuda(q, k, v)
    out = torch.empty_like(q)  # keeps q's strides when q is a transposed view
    kind = design(q.element_size(), hd, block_q, block_kv, _strides(q, k, v, out),
                  aligned=all(t.data_ptr() % 16 == 0 for t in (q, k, v, out)))
    _launch(q, k, v, out, causal, block_q, block_kv, kind)
    return out
