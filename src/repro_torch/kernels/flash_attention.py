"""Flash attention as hand-written CUDA kernels for Hopper: the forward
(online softmax over KV tiles) and its backward.

Replaces the JAX package's ``kernels/flash_attention.py::flash_attention_fwd``
(Pallas TPU kernel ``_kernel``) with two designs, chosen before launch by
the pure function :func:`design` from the dtype, head dim, tile and
strides.  Both run one thread block per (query tile, query head, batch)
that loops over the KV tiles up to the causal bound with the fp32 m/l/acc
carry in registers:

* ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``), bf16 with block_q 64 or
  128 and block_kv 16 to 128 at every head dim, and at query/key heads of
  192 with value heads of 128 (latent attention's prefill,
  ``models/mla.py``; :data:`WIDE_HEADS`), strides TMA can describe:
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
On request (``return_lse``) both designs and the plain version also write
each row's logsumexp of the scaled scores, which the backward reads.

The backward (:func:`flash_attention_bwd`, ``csrc/flash_attention_bwd.cu``;
the JAX package has no Pallas kernel for it: its ``custom_vjp`` takes
``jax.vjp`` of the oracle) is FlashAttention-2's recompute without the S²
buffer, in passes whose sums are deterministic: one block per (query tile,
query head, batch row) computes D = rowsum(dO ⊙ O) and dQ, then one block
per (KV tile, KV head, batch row, head split) walks its split's query heads
and tiles for dK and dV, writing each once (GQA needs no atomics).  P is
recomputed as exp(S·scale − lse).  Two designs, chosen by the pure function
:func:`bwd_design`: ``"wgmma"`` (bf16, sequences that are multiples of 64,
strides of 16-byte rows) streams tiles through TMA rings to one or two
consumer warpgroups that run every product on ``wgmma`` with fp32
accumulators, P and dS rounded to bf16 as operands; its dK/dV pass splits a
group's heads over :func:`bwd_head_splits` blocks when the KV tiles alone
do not fill the SMs, writes fp32 partials, and a third launch sums them in
split order (three kernels a call at every split); ``"simt"`` (fp32, and
every other shape) runs the same arithmetic on the CUDA cores in two
kernels.  Its tiles follow from the shape (:func:`bwd_blocks`);
``block_q`` / ``block_kv`` only order the plain version's sums.
:func:`flash_attention_bwd_plain` is its arithmetic in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from . import _cuda
from .decode_attention import sm_count

__all__ = [
    "flash_attention_fwd",
    "flash_attention_plain",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "bwd_design",
    "bwd_blocks",
    "bwd_ring_stages",
    "bwd_head_splits",
    "bwd_scratch_bytes",
    "bwd_flops_bytes",
    "design",
    "WIDE_HEADS",
    "ring_stages",
    "check_blocks",
    "legal_blocks",
    "flops_bytes",
    "launches",
    "bwd_launches",
    "launches_by_design",
]

NEG_INF = -1e30
#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
MAX_THREADS = 1024
TPR = 8  # threads per query row (csrc/flash_attention.cu)
HEAD_DIMS = (16, 32, 64, 128)
#: (query/key width, value width) pairs of the tensor-core design besides
#: the equal widths of ``HEAD_DIMS``; the CUDA-core design has none
WIDE_HEADS = ((192, 128),)
#: tiles of the tensor-core design (csrc/flash_attention_wgmma.cu): one
#: consumer warpgroup per 64 query rows, block_kv up to what its registers
#: hold (a thread's scores, output and P's two halves: block_kv / 2 + hd / 2
#: + 2 block_kv / 4 values)
WGMMA_BLOCK_Q = (64, 128)
WGMMA_BLOCK_KV = (16, 32, 64, 128)
MAX_STAGES = 4

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: the backward's tiles (csrc/flash_attention_bwd.cu): its tensor-core
#: design takes sequences that are multiples of this, streams tiles of this
#: many rows, and gives each consumer warpgroup this many rows
BWD_TILE = 64
#: device kernels a backward call launches, by design (the tensor-core
#: design's third sums the head splits' partials, at every split count)
BWD_KERNELS = {"wgmma": 3, "simt": 2}
#: lse of a row whose softmax sum is 0: its recomputed P is 0
LSE_EMPTY = math.inf

#: kernel launches so far: the forward's in total, the backward's (one a
#: call, ``BWD_KERNELS`` device kernels) in total, and both by design (the
#: plain versions do not count)
launches = 0
bwd_launches = 0
launches_by_design = {"wgmma": 0, "simt": 0, "bwd_wgmma": 0, "bwd_simt": 0}
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


def ring_smem_bytes(hd: int, block_q: int, block_kv: int, stages: int,
                    hd_v: Optional[int] = None) -> int:
    """Shared memory of the tensor-core design: the Q tile, ``stages``
    stages of a K and a V tile (bf16, each rounded up to the 128-byte
    swizzle's 1024-byte period; V ``hd_v`` wide, default ``hd``), the
    mbarriers, and 1024 bytes to align."""
    hd_v = hd if hd_v is None else hd_v
    stage = _round1024(2 * block_kv * hd) + _round1024(2 * block_kv * hd_v)
    return 1024 + _round1024(2 * block_q * hd) + stages * stage + 8 * (1 + 2 * stages)


def ring_stages(hd: int, block_q: int, block_kv: int, hd_v: Optional[int] = None) -> int:
    """Stages of the tensor-core design's K/V ring: the most, up to
    ``MAX_STAGES``, that fit ``SMEM_LIMIT`` (0 when not even one does)."""
    for stages in range(MAX_STAGES, 0, -1):
        if ring_smem_bytes(hd, block_q, block_kv, stages, hd_v) <= SMEM_LIMIT:
            return stages
    return 0


def _instantiated(hd: int, hd_v: int) -> bool:
    return (hd == hd_v and hd in HEAD_DIMS) or (hd, hd_v) in WIDE_HEADS


def design(itemsize: int, hd: int, block_q: int, block_kv: int, strides=(), aligned: bool = True,
           hd_v: Optional[int] = None) -> str:
    """``"wgmma"`` when the tensor-core kernel runs this call, else
    ``"simt"``.  A pure function of the dtype (``itemsize`` 2: bf16), the
    query/key head dim and the value head dim ``hd_v`` (default ``hd``),
    the (clamped) tile, the batch/head/sequence strides of q, k, v and o in
    elements (TMA needs multiples of 16 bytes) and whether the tensors
    start on 16-byte boundaries."""
    hd_v = hd if hd_v is None else hd_v
    if itemsize != 2 or not aligned or not _instantiated(hd, hd_v):
        return "simt"
    if block_q not in WGMMA_BLOCK_Q or block_kv not in WGMMA_BLOCK_KV:
        return "simt"
    if any(st % 8 for st in strides) or ring_stages(hd, block_q, block_kv, hd_v) < 2:
        return "simt"
    return "wgmma"


def check_blocks(hd: int, block_q: int, block_kv: int, itemsize: int, strides=(),
                 aligned: bool = True, hd_v: Optional[int] = None) -> str:
    """The design that runs this call; ``ValueError`` for shapes and tiles
    neither CUDA kernel can run (unequal widths run only on the tensor
    cores)."""
    hd_v = hd if hd_v is None else hd_v
    if not _instantiated(hd, hd_v):
        raise ValueError(f"flash_attention: head dims ({hd}, {hd_v}) not instantiated (have "
                         f"{HEAD_DIMS} and {WIDE_HEADS})")
    if design(itemsize, hd, block_q, block_kv, strides, aligned, hd_v) == "wgmma":
        return "wgmma"
    if hd_v != hd:
        raise ValueError(f"flash_attention: head dims ({hd}, {hd_v}) run only the tensor-core "
                         f"design (bf16, block_q {WGMMA_BLOCK_Q}, block_kv {WGMMA_BLOCK_KV}, "
                         f"16-byte strides); got block_q={block_q} block_kv={block_kv}, "
                         f"{itemsize}-byte elements")
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
                 on_card: bool, hd_v: Optional[int] = None) -> tuple:
    """The blocks a call runs with (clamped to the sequences), or
    ``ValueError``: they must divide them, and on the card fit the kernel."""
    blocks = _blocks(Sq, Skv, block_q, block_kv)
    if on_card:
        check_blocks(hd, *blocks, itemsize, hd_v=hd_v)
    return blocks


def flops_bytes(q, k, v, causal: bool = True) -> tuple:
    """(FLOP, bytes) of one call, q: (B,H,Sq,hd), k: (B,Kh,Skv,hd), v:
    (B,Kh,Skv,hd_v).

    FLOP count the two products over the (query, key) pairs the causal mask
    keeps (top-left: row i sees keys 0..i), 2·(hd + hd_v) per pair; bytes
    read q, k, v once and write o once."""
    B, H, Sq, hd = q.shape
    Skv, hd_v = k.shape[2], v.shape[3]
    flops = 2.0 * B * H * _pairs(Sq, Skv, causal) * (hd + hd_v)
    nbytes = (q.numel() + B * H * Sq * hd_v + k.numel() + v.numel()) * q.element_size()
    return flops, float(nbytes)


def _pairs(Sq: int, Skv: int, causal: bool) -> int:
    return sum(min(i + 1, Skv) for i in range(Sq)) if causal else Sq * Skv


def bwd_flops_bytes(q, k, v, causal: bool = True) -> tuple:
    """(FLOP, bytes) of one backward call, shapes as :func:`flops_bytes`.

    FLOP count FlashAttention-2's five products (S, dP, dV, dQ, dK) over
    the pairs the causal mask keeps, 10·hd per pair (the kernel's split
    recomputes S and dP once more: seven); bytes read q, k, v, o, dO and
    lse once and write dq, dk and dv once."""
    B, H, Sq, hd = q.shape
    flops = 10.0 * B * H * _pairs(Sq, k.shape[2], causal) * hd
    nbytes = (4 * q.numel() + 2 * (k.numel() + v.numel())) * q.element_size() + 4 * B * H * Sq
    return flops, float(nbytes)


def flash_attention_plain(q, k, v, *, causal: bool = True, block_q: int = 128, block_kv: int = 128,
                          return_lse: bool = False):
    """The kernel's arithmetic in plain PyTorch, tile by tile: fp32 m/l/acc
    carry, -1e30 in masked slots, causal tiles in the future skipped.  With
    ``return_lse`` also each row's m + log l, (B,H,Sq) fp32.  v and the
    output may be narrower than q and k (``hd_v``)."""
    B, H, Sq, hd = q.shape
    Kh, Skv, hd_v = k.shape[1], k.shape[2], v.shape[3]
    g = H // Kh
    block_q, block_kv = _blocks(Sq, Skv, block_q, block_kv)
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    qf = q.float() * scale
    kf = k.float().repeat_interleave(g, dim=1)  # query head h reads KV head h // g
    vf = v.float().repeat_interleave(g, dim=1)
    out = _output_like(q, hd_v)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, block_q):
        qt = qf[:, :, q0:q0 + block_q]
        m = torch.full((B, H, block_q, 1), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, block_q, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, block_q, hd_v), dtype=torch.float32, device=q.device)
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
        lse[:, :, q0:q0 + block_q] = torch.where(l == 0.0, LSE_EMPTY, m + torch.log(l))[..., 0]
        l = torch.where(l == 0.0, torch.ones_like(l), l)  # fully masked rows -> 0
        out[:, :, q0:q0 + block_q] = (acc / l).to(q.dtype)
    return (out, lse) if return_lse else out


def _output_like(q, hd_v: int):
    """An empty output (B,H,Sq,hd_v) in q's layout: ``empty_like(q)`` at
    q's width (it keeps q's strides when q is a transposed view), else the
    same order of dims with the last ``hd_v`` wide."""
    if hd_v == q.shape[3]:
        return torch.empty_like(q)
    order = sorted(range(3), key=lambda i: -q.stride(i)) + [3]
    shape = [q.shape[i] for i in order[:3]] + [hd_v]
    out = torch.empty(shape, dtype=q.dtype, device=q.device)
    return out.permute([order.index(i) for i in range(4)])


def _check_cuda(what: str, **named) -> None:
    q = named["q"]
    for name, t in named.items():
        if not t.is_cuda:
            raise ValueError(
                f"{what}: {name} is on {t.device}; the CUDA kernel needs "
                "CUDA tensors (interpret=True runs the plain version on CPU tensors)"
            )
        if t.dtype not in _SUFFIX:
            raise ValueError(f"{what}: {name} has dtype {t.dtype}; supported: {list(_SUFFIX)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must be contiguous in its last dim")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{what}: {', '.join(named)} must share device and dtype")


def _strides(q, k, v, out) -> tuple:
    """Batch, head and sequence strides of q, k, v and o, in elements."""
    return tuple(t.stride(i) for t in (q, k, v, out) for i in range(3))


def _launch(q, k, v, out, lse, causal: bool, block_q: int, block_kv: int, kind: str) -> None:
    global launches
    B, H, Sq, hd = q.shape
    Kh, Skv, hd_v = k.shape[1], k.shape[2], v.shape[3]
    if kind == "wgmma":
        source, fn_name = "flash_attention_wgmma", "repro_flash_attention_wgmma_bf16"
        widths = [hd, hd_v]
        extra = [ring_stages(hd, block_q, block_kv, hd_v)]
    else:
        source, fn_name = "flash_attention", f"repro_flash_attention_{_SUFFIX[q.dtype]}"
        widths, extra = [hd], []
    lib = _cuda.load(source)
    fn = getattr(lib, fn_name)
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * (5 + len(widths)) + [ctypes.c_void_p]
        + [ctypes.c_int] * (3 + len(extra)) + [ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    strides = (ctypes.c_longlong * 12)(*_strides(q, k, v, out))
    scale = float(torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), B, H, Kh, Sq, Skv, *widths,
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
    interpret: bool = False, return_lse: bool = False,
):
    """q: (B,H,Sq,hd); k: (B,Kh,Skv,hd); v: (B,Kh,Skv,hd_v) -> o:
    (B,H,Sq,hd_v) in ``q.dtype``, and with ``return_lse`` (o, lse (B,H,Sq)
    fp32), lse the natural log of each row's softmax sum of the scaled
    scores (``LSE_EMPTY`` where it is 0).  ``hd_v`` is ``hd`` or, on the
    card, one of :data:`WIDE_HEADS`; the scale is 1/√hd.

    Any strides are taken as long as the last dim is contiguous; the output
    has q's layout.  CUDA tensors launch the kernel; ``interpret=True`` runs
    the plain version, which takes CPU tensors only.  Anything else raises."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention_fwd: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    Kh, Skv, hd_v = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != hd or H % Kh:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} and k {tuple(k.shape)} do not match")
    block_q, block_kv = legal_blocks(hd, Sq, Skv, block_q, block_kv, q.element_size(),
                                     on_card=not interpret, hd_v=hd_v)
    if interpret:
        if q.is_cuda or k.is_cuda or v.is_cuda:
            raise ValueError(
                "flash_attention_fwd: interpret=True runs the plain version on CPU tensors only"
            )
        return flash_attention_plain(q, k, v, causal=causal, block_q=block_q, block_kv=block_kv,
                                     return_lse=return_lse)
    _check_cuda("flash_attention_fwd", q=q, k=k, v=v)
    out = _output_like(q, hd_v)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    kind = check_blocks(hd, block_q, block_kv, q.element_size(), _strides(q, k, v, out),
                        aligned=all(t.data_ptr() % 16 == 0 for t in (q, k, v, out)), hd_v=hd_v)
    _launch(q, k, v, out, lse, causal, block_q, block_kv, kind)
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------- backward
def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True, block_q: int = 128,
                              block_kv: int = 128):
    """The backward kernel's arithmetic in plain PyTorch, tile by tile, fp32
    accumulation: D = rowsum(dO ⊙ O); P = exp(S·scale − lse) (0 in masked
    slots, top-left causal); dV = Pᵀ dO with P rounded to the input dtype
    (as the oracle rounds p before P·V); dP = dO Vᵀ; dS = P ⊙ (dP − D),
    rounded to the input dtype as the kernel's operand; dQ = dS K · scale
    and dK = dSᵀ Q · scale.  GQA: dK and dV sum over each group's heads.

    q, o, do: (B,H,Sq,hd); k, v: (B,Kh,Skv,hd); lse: (B,H,Sq) fp32 ->
    (dq, dk, dv) in the dtypes and layouts of (q, k, v)."""
    B, H, Sq, hd = q.shape
    Kh, Skv = k.shape[1], k.shape[2]
    g = H // Kh
    block_q, block_kv = _blocks(Sq, Skv, block_q, block_kv)
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    qf, dof = q.float(), do.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    D = (dof * o.float()).sum(dim=-1)
    lsef = lse.float()
    dq = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, H, Skv, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, Sq, block_q):
        qs = slice(q0, q0 + block_q)
        for kv0 in range(0, Skv, block_kv):
            if causal and kv0 > q0 + block_q - 1:
                break  # this and every later tile lie wholly in the future
            ks = slice(kv0, kv0 + block_kv)
            s = (qf[:, :, qs] @ kf[:, :, ks].transpose(-1, -2)) * scale
            p = torch.exp(s - lsef[:, :, qs, None])
            if causal:
                qi = q0 + torch.arange(block_q, device=q.device)[:, None]
                kj = kv0 + torch.arange(block_kv, device=q.device)[None, :]
                p = torch.where(qi >= kj, p, torch.zeros_like(p))
            dv[:, :, ks] += p.to(q.dtype).float().transpose(-1, -2) @ dof[:, :, qs]
            dp = dof[:, :, qs] @ vf[:, :, ks].transpose(-1, -2)
            ds = (p * (dp - D[:, :, qs, None])).to(q.dtype).float()
            dq[:, :, qs] += ds @ kf[:, :, ks]
            dk[:, :, ks] += ds.transpose(-1, -2) @ qf[:, :, qs]
    dk = dk.reshape(B, Kh, g, Skv, hd).sum(dim=2) * scale
    dv = dv.reshape(B, Kh, g, Skv, hd).sum(dim=2)
    return tuple(torch.empty_like(like).copy_(grad) for grad, like in ((dq * scale, q), (dk, k), (dv, v)))


def bwd_design(itemsize: int, hd: int, Sq: int, Skv: int, strides=(), aligned: bool = True) -> str:
    """``"wgmma"`` when the tensor-core backward runs this call, else
    ``"simt"``: a pure function of the dtype (``itemsize`` 2: bf16), the
    head dim, the sequence lengths (multiples of ``BWD_TILE``), the
    batch/head/sequence strides in elements of every tensor it reads or
    writes (16-byte rows: multiples of 8) and whether they start on 16-byte
    boundaries."""
    if itemsize != 2 or not aligned or hd not in HEAD_DIMS:
        return "simt"
    if Sq % BWD_TILE or Skv % BWD_TILE or any(st % 8 for st in strides):
        return "simt"
    return "wgmma"


def bwd_blocks(Sq: int, Skv: int) -> tuple:
    """(block_q, block_kv) of the tensor-core backward: the rows of a dq
    pass block and of a dK/dV pass block, two consumer warpgroups of
    ``BWD_TILE`` rows (128) where the sequence is a multiple of 128, else
    one (64).  A pure function of the shape, not a knob."""
    return tuple(2 * BWD_TILE if n % (2 * BWD_TILE) == 0 else BWD_TILE for n in (Sq, Skv))


def bwd_dq_smem_bytes(hd: int, block_q: int, stages: int) -> int:
    """Shared memory of a dq pass block: the Q and dO tiles of ``block_q``
    rows, ``stages`` ring stages of a K and a V tile of ``BWD_TILE`` rows
    (bf16, each rounded up to the 128-byte swizzle's 1024-byte period), the
    mbarriers, and 1024 bytes to align."""
    return (1024 + 2 * _round1024(2 * block_q * hd) + stages * 2 * _round1024(2 * BWD_TILE * hd)
            + 8 * (1 + 2 * stages))


def bwd_dkdv_smem_bytes(hd: int, block_kv: int, stages: int) -> int:
    """Shared memory of a dK/dV pass block: the K and V tiles of
    ``block_kv`` rows, ``stages`` ring stages of a Q and a dO tile of
    ``BWD_TILE`` rows and that tile's fp32 lse and D, the mbarriers, and
    1024 bytes to align."""
    return (1024 + 2 * _round1024(2 * block_kv * hd)
            + stages * (2 * _round1024(2 * BWD_TILE * hd) + 2 * 4 * BWD_TILE) + 8 * (1 + 2 * stages))


def bwd_ring_stages(hd: int, block_q: int, block_kv: int) -> tuple:
    """(dq pass stages, dK/dV pass stages) of the tensor-core backward's
    rings: the most, up to ``MAX_STAGES``, that fit ``SMEM_LIMIT`` (0 when
    not even one does)."""
    fits = (lambda n: bwd_dq_smem_bytes(hd, block_q, n), lambda n: bwd_dkdv_smem_bytes(hd, block_kv, n))
    return tuple(next((n for n in range(MAX_STAGES, 0, -1) if f(n) <= SMEM_LIMIT), 0) for f in fits)


def bwd_head_splits(B: int, Kh: int, g: int, Skv: int, sm_count: int) -> int:
    """Blocks over which the tensor-core backward's dK/dV pass splits the g
    query heads of a group: 1 when the B·Kh·(Skv / block_kv) KV tiles fill
    the card's ``sm_count`` SMs, else the smallest divisor of g that does,
    or g.  Each split writes fp32 partials that the third launch sums in
    split order.  A pure function of the shape, not a knob."""
    tiles = B * Kh * (Skv // bwd_blocks(Skv, Skv)[1])
    return next((n for n in range(1, g + 1) if g % n == 0 and tiles * n >= sm_count), g)


def bwd_scratch_bytes(B: int, Kh: int, Skv: int, hd: int, splits: int) -> int:
    """Bytes of the tensor-core backward's fp32 dK and dV partials,
    (splits, B, Kh, Skv, hd) each: at most two (B, H, Skv, hd) fp32 arrays,
    since the split divides g = H / Kh."""
    return 2 * 4 * splits * B * Kh * Skv * hd


def _bwd_launch(q, k, v, o, lse, do, D, dq, dk, dv, causal: bool, kind: str) -> None:
    global bwd_launches
    B, H, Sq, hd = q.shape
    Kh, Skv = k.shape[1], k.shape[2]
    lib = _cuda.load("flash_attention_bwd")
    fn = getattr(lib, f"repro_flash_attention_bwd_{_SUFFIX[q.dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    splits, plan, part = 1, None, None
    if kind == "wgmma":
        block_q, block_kv = bwd_blocks(Sq, Skv)
        splits = bwd_head_splits(B, Kh, H // Kh, Skv, sm_count(q.device))
        plan = (ctypes.c_int * 5)(block_q, block_kv, splits, *bwd_ring_stages(hd, block_q, block_kv))
        part = torch.empty(bwd_scratch_bytes(B, Kh, Skv, hd, splits) // 4, dtype=torch.float32,
                           device=q.device).view(2, -1)
    scratch = (None, None) if part is None else (part[0].data_ptr(), part[1].data_ptr())
    ptrs = (ctypes.c_void_p * 12)(*[t.data_ptr() for t in (q, k, v, o, do, lse, D, dq, dk, dv)], *scratch)
    strides = (ctypes.c_longlong * 24)(*(t.stride(i) for t in (q, k, v, o, do, dq, dk, dv)
                                         for i in range(3)))
    scale = float(torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(ctypes.addressof(ptrs), ctypes.addressof(strides), B, H, Kh, Sq, Skv, hd, int(causal),
                None if plan is None else ctypes.addressof(plan), scale, stream)
    if rc != 0:
        err = lib.repro_flash_attention_bwd_error_string
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"flash_attention_bwd kernel ({kind}) launch failed (hd {hd}, Sq {Sq}, "
                           f"Skv {Skv}, {splits} head splits): CUDA error {rc}: {err(rc).decode()}")
    with _count_lock:
        bwd_launches += 1
        launches_by_design[f"bwd_{kind}"] += 1


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True, block_q: int = 128,
                        block_kv: int = 128, interpret: bool = False):
    """The gradient of :func:`flash_attention_fwd`: q, k, v as it took them,
    its output o and lse (``return_lse``), do = dL/do (o's shape) ->
    (dq, dk, dv) in the dtypes and layouts of (q, k, v).

    CUDA tensors launch the backward kernel (its design from
    :func:`bwd_design`; any strides with the last dim contiguous);
    ``interpret=True`` runs the plain version, which takes CPU tensors only.
    Anything else raises.  ``block_q`` / ``block_kv`` must divide the
    sequences, as the forward's did; they order the plain version's sums."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} o {tuple(o.shape)} do {tuple(do.shape)}")
    B, H, Sq, hd = q.shape
    Kh, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % Kh or lse.shape != (B, H, Sq):
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, k {tuple(k.shape)} and lse "
                         f"{tuple(lse.shape)} do not match")
    block_q, block_kv = _blocks(Sq, Skv, block_q, block_kv)
    if interpret:
        if any(t.is_cuda for t in (q, k, v, o, lse, do)):
            raise ValueError(
                "flash_attention_bwd: interpret=True runs the plain version on CPU tensors only"
            )
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, block_q=block_q,
                                         block_kv=block_kv)
    _check_cuda("flash_attention_bwd", q=q, k=k, v=v, o=o, do=do)
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {hd} not instantiated (have {HEAD_DIMS})")
    if not lse.is_cuda or lse.device != q.device or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be a contiguous fp32 CUDA tensor on q's device")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    D = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    tensors = (q, k, v, o, do, dq, dk, dv)
    kind = bwd_design(q.element_size(), hd, Sq, Skv, [t.stride(i) for t in tensors for i in range(3)],
                      aligned=all(t.data_ptr() % 16 == 0 for t in (*tensors, lse, D)))
    _bwd_launch(q, k, v, o, lse, do, D, dq, dk, dv, causal, kind)
    return dq, dk, dv
