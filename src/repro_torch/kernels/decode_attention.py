"""Flash-decode: one query token per head against a long KV cache, as a
hand-written CUDA kernel for Hopper.

Replaces the JAX package's ``kernels/decode_attention.py::decode_attention_fwd``
(Pallas TPU kernel ``_kernel``).  The CUDA source is
``csrc/decode_attention.cu``: one thread block per (KV head, batch row)
walks the cache in ``block_kv`` tiles with the whole GQA group of
g = H / Kh query heads sharing each streamed K/V slot, and carries the fp32
m/l/acc of the online softmax across tiles.  Decode reads every cache byte
once for a few FLOP per byte, so it is bound by memory on the card; this
first kernel has only B·Kh blocks in flight, far too few to draw the card's
bandwidth (its measured times are in PERF.md; a split-KV form is later work).

Same conventions as the TPU kernel: q/k/v are cast to fp32 and q is scaled
by 1/√hd before the dot; a slot whose ``valid`` entry is not > 0 gets the
finite ``-1e30`` (so a row with no valid slot averages V uniformly, as the
oracle's softmax over all ``-1e30`` does, instead of giving 0 or NaN);
m, l and acc are fp32 and the output is written in q's dtype; query head h
reads KV head h // g.

``block_kv`` is the PATSMA tunable: the tile over which each softmax
rescale is taken.  K and V are read from device memory slot by slot and
never staged whole, so a tile of 1024 slots runs at head dim 256; only the
fp32 score tile (g × block_kv) lives in shared memory, and tiles whose
scores, q and accumulators exceed a block's 227 KB raise ``ValueError``
before any launch (:func:`check_tile`).  :func:`decode_attention_plain`
repeats the kernel's arithmetic in plain PyTorch; the wrapper takes it only
for CPU tensors with ``interpret=True``.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import _cuda

__all__ = [
    "decode_attention_fwd",
    "decode_attention_plain",
    "check_tile",
    "legal_tile",
    "default_block_kv",
    "flops_bytes",
    "launches",
]

NEG_INF = -1e30
#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
THREADS = 512  # threads per block (csrc/decode_attention.cu)
HEAD_DIMS = (16, 32, 64, 128, 256)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: kernel launches so far (the plain version does not count)
launches = 0
_count_lock = threading.Lock()


def _tile(S: int, block_kv: int) -> int:
    block_kv = min(block_kv, S)
    if S % block_kv:
        raise ValueError(f"cache length {S} not divisible by block_kv {block_kv}")
    return block_kv


def smem_bytes(g: int, hd: int, block_kv: int) -> int:
    """Shared memory of one block, all fp32: the scaled q of the group
    (g × hd), the score tile (g × block_kv), m, l and alpha per head, and
    the accumulators of every thread's slot phase (g × THREADS)."""
    return 4 * (g * hd + g * block_kv + 3 * g + g * THREADS)


def check_tile(g: int, hd: int, block_kv: int) -> None:
    """Raise ``ValueError`` for shapes and tiles the CUDA kernel cannot run."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {hd} not supported (have {HEAD_DIMS})")
    smem = smem_bytes(g, hd, block_kv)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"decode_attention: block_kv={block_kv} with {g} query heads per KV head "
            f"(hd {hd}) needs {smem} bytes of shared memory (max {SMEM_LIMIT})"
        )


def legal_tile(g: int, hd: int, S: int, block_kv: int, on_card: bool) -> int:
    """The tile a call runs with (clamped to the cache), or ``ValueError``:
    it must divide the cache, and on the card fit the kernel."""
    tile = _tile(S, block_kv)
    if on_card:
        check_tile(g, hd, tile)
    return tile


def default_block_kv(q, k) -> int:
    """The JAX package's default ``min(512, pow2_floor(S))``, halved while
    the tile does not fit a block (the CUDA kernel's largest legal tile)."""
    S = k.shape[2]
    g = q.shape[1] // k.shape[1]
    bkv = min(512, S & (-S))
    while bkv > 1 and smem_bytes(g, q.shape[2], bkv) > SMEM_LIMIT:
        bkv //= 2
    return bkv


def flops_bytes(q, k, v, valid) -> tuple:
    """(FLOP, bytes) of one call: 4·hd FLOP per (query head, cache slot) for
    the two products; q, k, v and valid read once and o written once."""
    B, H, hd = q.shape
    S = k.shape[2]
    flops = 4.0 * B * H * S * hd
    nbytes = (2 * q.numel() * q.element_size() + k.numel() * k.element_size()
              + v.numel() * v.element_size() + valid.numel() * valid.element_size())
    return flops, float(nbytes)


def decode_attention_plain(q, k, v, valid, *, block_kv: int = 512):
    """The kernel's arithmetic in plain PyTorch, tile by tile: fp32 m/l/acc
    carry and fp32 p, ``-1e30`` in invalid slots, rows with ``l == 0`` give 0."""
    B, H, hd = q.shape
    Kh, S = k.shape[1], k.shape[2]
    g = H // Kh
    block_kv = _tile(S, block_kv)
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    qf = q.reshape(B, Kh, g, hd).float() * scale
    m = torch.full((B, Kh, g, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Kh, g, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Kh, g, hd), dtype=torch.float32, device=q.device)
    for kv0 in range(0, S, block_kv):
        kt = k[:, :, kv0:kv0 + block_kv].float()
        s = torch.einsum("bkgh,bksh->bkgs", qf, kt)
        ok = (valid[:, kv0:kv0 + block_kv] > 0)[:, None, None, :]
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgs,bksh->bkgh", p, v[:, :, kv0:kv0 + block_kv].float())
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l).to(q.dtype).reshape(B, H, hd)


def _check_cuda(q, k, v, valid) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        if not t.is_cuda:
            raise ValueError(
                f"decode_attention_fwd: {name} is on {t.device}; the CUDA kernel needs "
                "CUDA tensors (interpret=True runs the plain version on CPU tensors)"
            )
        if t.device != q.device:
            raise ValueError("decode_attention_fwd: q, k, v and valid must share a device")
        if t.stride(-1) != 1:
            raise ValueError(f"decode_attention_fwd: {name} must be contiguous in its last dim")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _SUFFIX:
            raise ValueError(
                f"decode_attention_fwd: {name} has dtype {t.dtype}; supported: {list(_SUFFIX)}"
            )
        if t.dtype != q.dtype:
            raise ValueError("decode_attention_fwd: q, k and v must share a dtype")
    if valid.dtype != torch.int32:
        raise ValueError(f"decode_attention_fwd: valid has dtype {valid.dtype}; the kernel takes int32")


def _launch(q, k, v, valid, out, block_kv: int) -> None:
    global launches
    B, H, hd = q.shape
    Kh, S = k.shape[1], k.shape[2]
    lib = _cuda.load("decode_attention")
    fn = getattr(lib, f"repro_decode_attention_{_SUFFIX[q.dtype]}")
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    # (batch, head) of q, (batch, head, slot) of k and v, batch of valid
    strides = (ctypes.c_longlong * 9)(
        q.stride(0), q.stride(1), *(t.stride(i) for t in (k, v) for i in range(3)), valid.stride(0),
    )
    scale = float(torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(), out.data_ptr(),
                B, H, Kh, S, hd, ctypes.cast(strides, ctypes.c_void_p), block_kv, scale, stream)
    if rc != 0:
        lib.repro_decode_attention_error_string.restype = ctypes.c_char_p
        msg = lib.repro_decode_attention_error_string(rc).decode()
        raise RuntimeError(
            f"decode_attention kernel launch failed (block_kv {block_kv}): CUDA error {rc}: {msg}"
        )
    with _count_lock:
        launches += 1


def decode_attention_fwd(q, k, v, valid, *, block_kv: int = 512, interpret: bool = False):
    """q: (B,H,hd); k/v: (B,Kh,S,hd); valid: (B,S) int32 -> o: (B,H,hd) in ``q.dtype``.

    Any strides are taken as long as the last dim is contiguous.  CUDA
    tensors launch the kernel; ``interpret=True`` runs the plain version,
    which takes CPU tensors only.  Anything else raises."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape or valid.dim() != 2:
        raise ValueError(f"decode_attention_fwd: bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} valid {tuple(valid.shape)}")
    B, H, hd = q.shape
    Kh, S = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or H % Kh or tuple(valid.shape) != (B, S):
        raise ValueError(f"decode_attention_fwd: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"valid {tuple(valid.shape)} do not match")
    block_kv = legal_tile(H // Kh, hd, S, block_kv, on_card=not interpret)
    if interpret:
        if any(t.is_cuda for t in (q, k, v, valid)):
            raise ValueError(
                "decode_attention_fwd: interpret=True runs the plain version on CPU tensors only"
            )
        return decode_attention_plain(q, k, v, valid, block_kv=block_kv)
    _check_cuda(q, k, v, valid)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    _launch(q, k, v, valid, out, block_kv)
    return out
