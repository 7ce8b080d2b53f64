"""Split-KV flash-decode: one query token per head against a long KV
cache, as a hand-written CUDA kernel for Hopper.

Replaces the JAX package's ``kernels/decode_attention.py::decode_attention_fwd``
(Pallas TPU kernel ``_kernel``).  The CUDA source is
``csrc/decode_attention.cu``: one thread block per (head group, KV head,
batch row, split) walks a contiguous run of whole ``block_kv`` tiles of the
cache, streaming K and V through a ``cp.async`` ring of shared-memory stages,
with up to eight query heads of the GQA group sharing each staged slot, and
writes fp32 (m, l, acc) partials that a second small kernel merges.  Decode
reads every cache byte once for a few FLOP per byte, so it is bound by
memory on the card; the split count (:func:`num_splits`, from the shape and
the card's SM count, not a knob) puts about two blocks or more on every SM.
Its measured times are in PERF.md.

Same conventions as the TPU kernel: q/k/v are cast to fp32 and q is scaled
by 1/√hd before the dot; a slot whose ``valid`` entry is not > 0 gets the
finite ``-1e30`` (so a row with no valid slot averages V uniformly, as the
oracle's softmax over all ``-1e30`` does, instead of giving 0 or NaN; a
split with no valid slot is wiped by the merge when another split has one);
m, l and acc are fp32 and the output is written in q's dtype; query head h
reads KV head h // g.

``block_kv`` is the PATSMA tunable: the tile over which each softmax
rescale is taken, and the granularity of the splits.  Only the fp32 score
tile of a block's heads lives in shared memory beside the ring, so every
tile of the JAX space runs; larger tiles whose scores, q and ring exceed a
block's 227 KB raise ``ValueError`` before any launch (:func:`check_tile`).
Views whose pointers or strides are not multiples of 16 bytes run the same
kernel with element loads instead of 16-byte copies (:func:`load_width`;
``launches_by_design`` counts both).  :func:`decode_attention_plain`
repeats the kernel's arithmetic in plain PyTorch, split by split when given
``splits``; the wrapper takes it only for CPU tensors with ``interpret=True``.
"""
from __future__ import annotations

import ctypes
import functools
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
    "heads_per_block",
    "num_splits",
    "grid",
    "load_width",
    "flops_bytes",
    "launches",
    "launches_by_design",
]

NEG_INF = -1e30
#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
GMAX = 8  # query heads per block: larger GQA groups split into head groups
RING_BYTES = 2 * 32768  # NSTAGE x CH_BYTES of the K/V ring
BLOCKS_PER_SM = 2  # the split count aims for at least this many blocks per SM
HEAD_DIMS = (16, 32, 64, 128, 256)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: kernel launches so far (one per call, whatever number of CUDA launches
#: the call makes), in total and by load width (the plain version does not count)
launches = 0
launches_by_design = {"vec16": 0, "narrow": 0}
_count_lock = threading.Lock()


def _tile(S: int, block_kv: int) -> int:
    block_kv = min(block_kv, S)
    if S % block_kv:
        raise ValueError(f"cache length {S} not divisible by block_kv {block_kv}")
    return block_kv


def heads_per_block(g: int) -> int:
    """Query heads one block serves: the GQA group split into the fewest
    head groups of at most ``GMAX`` heads, as even as they come."""
    groups = -(-g // GMAX)
    return -(-g // groups)


def smem_bytes(g: int, hd: int, block_kv: int) -> int:
    """Shared memory of one block: the K/V ring, and in fp32 the scaled q of
    the block's heads, their score tile (heads × block_kv) and m, l, alpha."""
    gc = heads_per_block(g)
    return RING_BYTES + 4 * (gc * hd + gc * block_kv + 3 * gc)


def check_tile(g: int, hd: int, block_kv: int) -> None:
    """Raise ``ValueError`` for shapes and tiles the CUDA kernel cannot run."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {hd} not supported (have {HEAD_DIMS})")
    smem = smem_bytes(g, hd, block_kv)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"decode_attention: block_kv={block_kv} with {heads_per_block(g)} query heads per "
            f"block (hd {hd}) needs {smem} bytes of shared memory (max {SMEM_LIMIT})"
        )


def legal_tile(g: int, hd: int, S: int, block_kv: int, on_card: bool) -> int:
    """The tile a call runs with (clamped to the cache), or ``ValueError``:
    it must divide the cache, and on the card fit the kernel (at either load
    width: the two differ only in how a stage is filled)."""
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


def num_splits(B: int, Kh: int, g: int, S: int, block_kv: int, sm_count: int) -> int:
    """Splits of the cache per (batch row, KV head): the fewest that give
    ``BLOCKS_PER_SM`` blocks per SM or more, rounded up to a divisor of the
    tile count so that every split holds as many whole tiles; all tiles when
    the cache has fewer.  Not a knob: ``block_kv`` stays the one tunable."""
    tiles = S // block_kv
    blocks = B * Kh * -(-g // heads_per_block(g))
    want = max(1, -(-BLOCKS_PER_SM * sm_count // blocks))
    if want >= tiles:
        return tiles
    return next(n for n in range(want, tiles + 1) if tiles % n == 0)


def grid(B: int, Kh: int, g: int, S: int, block_kv: int, sm_count: int) -> tuple:
    """The split kernel's grid: (head groups × KV heads, batch rows, splits)."""
    groups = -(-g // heads_per_block(g))
    return (Kh * groups, B, num_splits(B, Kh, g, S, block_kv, sm_count))


def load_width(tensors, itemsize: int, strides) -> int:
    """Bytes per copy of the ring's loads: 16 (``cp.async``) when K and V
    start on 16-byte boundaries and their batch, head and slot strides are
    multiples of 16 bytes, else the element size (element loads)."""
    ok = all(t.data_ptr() % 16 == 0 for t in tensors) and all(
        (st * itemsize) % 16 == 0 for st in strides)
    return 16 if ok else itemsize


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of the card ``device`` lies on."""
    idx = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if idx is None else idx)


def flops_bytes(q, k, v, valid) -> tuple:
    """(FLOP, bytes) of one call: 4·hd FLOP per (query head, cache slot) for
    the two products; q, k, v and valid read once and o written once."""
    B, H, hd = q.shape
    S = k.shape[2]
    flops = 4.0 * B * H * S * hd
    nbytes = (2 * q.numel() * q.element_size() + k.numel() * k.element_size()
              + v.numel() * v.element_size() + valid.numel() * valid.element_size())
    return flops, float(nbytes)


def _partials(qf, kt, vt, ok):
    """fp32 (m, l, acc) of one run of whole tiles: the online softmax over
    the tiles in ``kt``/``vt`` (lists), as one block of the kernel walks them."""
    B, Kh, g, hd = qf.shape
    m = torch.full((B, Kh, g, 1), NEG_INF, dtype=torch.float32, device=qf.device)
    l = torch.zeros((B, Kh, g, 1), dtype=torch.float32, device=qf.device)
    acc = torch.zeros((B, Kh, g, hd), dtype=torch.float32, device=qf.device)
    for kk, vv, mask in zip(kt, vt, ok):
        s = torch.einsum("bkgh,bksh->bkgs", qf, kk.float())
        s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bkgs,bksh->bkgh", p, vv.float())
        m = m_new
    return m, l, acc


def decode_attention_plain(q, k, v, valid, *, block_kv: int = 512, splits: int = 1):
    """The kernel's arithmetic in plain PyTorch: each of ``splits`` runs of
    whole tiles takes the tile-by-tile online softmax (fp32 m/l/acc and p,
    ``-1e30`` in invalid slots), then the runs are merged with weights
    e^(m_s − max m); rows with ``l == 0`` give 0.  One split is the one-pass
    computation (the merge's weight is exactly 1)."""
    B, H, hd = q.shape
    Kh, S = k.shape[1], k.shape[2]
    g = H // Kh
    block_kv = _tile(S, block_kv)
    tiles = S // block_kv
    if splits < 1 or tiles % splits:
        raise ValueError(f"decode_attention: {splits} splits do not divide {tiles} tiles")
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    qf = q.reshape(B, Kh, g, hd).float() * scale
    per = tiles // splits
    parts = []
    for sp in range(splits):
        rng = [slice((sp * per + t) * block_kv, (sp * per + t + 1) * block_kv) for t in range(per)]
        parts.append(_partials(qf, [k[:, :, r] for r in rng], [v[:, :, r] for r in rng],
                               [valid[:, r] > 0 for r in rng]))
    m_all = torch.stack([p[0] for p in parts])
    w = torch.exp(m_all - m_all.amax(dim=0))
    l = (torch.stack([p[1] for p in parts]) * w).sum(dim=0)
    acc = (torch.stack([p[2] for p in parts]) * w).sum(dim=0)
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
    nsplit = num_splits(B, Kh, H // Kh, S, block_kv, sm_count(q.device))
    width = load_width((k, v), k.element_size(), [t.stride(i) for t in (k, v) for i in range(3)])
    part_acc = torch.empty((B, H, nsplit, hd), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, H, nsplit, 2), dtype=torch.float32, device=q.device)
    lib = _cuda.load("decode_attention")
    fn = getattr(lib, f"repro_decode_attention_{_SUFFIX[q.dtype]}")
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
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
                part_acc.data_ptr(), part_ml.data_ptr(), B, H, Kh, S, hd,
                ctypes.cast(strides, ctypes.c_void_p), block_kv, nsplit, int(width == 16), scale,
                stream)
    if rc != 0:
        lib.repro_decode_attention_error_string.restype = ctypes.c_char_p
        msg = lib.repro_decode_attention_error_string(rc).decode()
        raise RuntimeError(
            f"decode_attention kernel launch failed (block_kv {block_kv}, {nsplit} splits): "
            f"CUDA error {rc}: {msg}"
        )
    with _count_lock:
        launches += 1
        launches_by_design["vec16" if width == 16 else "narrow"] += 1


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
