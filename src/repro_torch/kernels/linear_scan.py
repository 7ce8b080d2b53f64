"""Linear-recurrence scans — RG-LRU and RWKV-6 WKV — as hand-written CUDA
kernels for Hopper.

Replace the JAX package's ``kernels/linear_scan.py::lru_scan_chunked`` and
``::rwkv_scan_chunked`` (Pallas TPU kernels ``_lru_kernel`` and
``_rwkv_kernel``).

* ``lru_scan_chunked`` (``csrc/linear_scan.cu``): h_t = a_t ⊙ h_{t−1} + b_t
  over (B, T, D), memory-bound (a and b read, hs written once).  A segmented
  scan: T is cut into :func:`lru_segments` segments of whole chunks (derived
  from the shape and the SM count, not a knob), one block per (batch row,
  ``block_d`` channels, segment).  A block stages its segment's a and b in
  shared memory chunk by chunk (``chunk`` is the staging granularity),
  scans them, takes the preceding segment's final state as its carry,
  publishes its own, and rescans from the carry writing hs once.
  :func:`lru_scan_segmented_plain` is its arithmetic in plain PyTorch.
* ``rwkv_scan_chunked``: one block per (batch, head), which owns its whole
  time axis with the fp32 state on chip; two designs chosen
  before launch by the pure function :func:`rwkv_design`:

  - ``"tc"`` (``csrc/rwkv_subchunk.cu``), bf16 r, k, v at head dim 64 where
    T is a multiple of max(chunk, 16): per sub-chunk of 16 tokens the
    inter-chunk product r·e^{c}·S and the state update run on the tensor
    cores (TF32 ``mma.sync``, the state's operand split into a high and a
    low part to keep fp32 accuracy), the intra-chunk scores exactly per
    channel on the CUDA cores, with c the decay's cumulative sum restarted
    at each sub-chunk so that no exponent is positive;
    :func:`rwkv_scan_subchunk_plain` is its arithmetic in plain PyTorch;
  - ``"per_token"`` (``csrc/linear_scan.cu``), every other call: the exact
    per-token recurrence, one thread per state column, about 5·hd² fp32
    FLOP per token and head on the CUDA cores; head dims 8, 16, 32, 64.

Knobs the kernels cannot run raise ``ValueError`` naming the knob before
any launch (the tuner charges them ``inf``).  :func:`lru_scan_plain` and
:func:`rwkv_scan_plain` check the knobs and run the exact oracles of
``ref.py``; the wrappers take them only for CPU tensors with ``interpret=True``.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _cuda, ref
from .decode_attention import sm_count

__all__ = [
    "lru_scan_chunked",
    "lru_scan_plain",
    "lru_scan_segmented_plain",
    "lru_segments",
    "rwkv_scan_chunked",
    "rwkv_scan_plain",
    "legal_lru",
    "legal_rwkv",
    "rwkv_design",
    "rwkv_scan_subchunk_plain",
    "rwkv_tc_flops",
    "lru_flops_bytes",
    "rwkv_flops_bytes",
    "launches",
    "launches_by_design",
]

#: shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
MAX_THREADS = 1024
HEAD_DIMS = (8, 16, 32, 64)
#: channels per block unless the caller picks (the TPU kernel's 512 is a
#: lane width; on the card smaller blocks give more blocks to the SMs)
LRU_BLOCK_D = 128
#: the lru kernel's segments: staged a and b of at most this many bytes (three
#: blocks per SM), and at least this many blocks per SM
LRU_SEG_BYTES = 64 * 1024
LRU_BLOCKS_PER_SM = 2
#: the lru block's shared memory beyond its staged segment (the ticket)
LRU_FIXED_BYTES = 16

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

#: the tensor-core RWKV design (csrc/rwkv_subchunk.cu): head dim, tokens
#: per sub-chunk, bytes staged per token (bf16 r, k, v rows of 144 bytes,
#: an fp32 lw row of 272), ring stages and its fixed fp32 arrays
TC_HEAD_DIM = 64
TC_SUBCHUNK = 16
TC_TOKEN_BYTES = 3 * 144 + 272
TC_STAGES = 2
TC_FIXED_BYTES = 4 * (64 * 72 + 16 * 68 + 16 * 72 + 16 * 20 + 2 * 64)

#: kernel launches so far, per kernel, and the rwkv scan's by design (the
#: plain versions do not count)
launches = {"lru_scan": 0, "rwkv_scan": 0}
launches_by_design = {"tc": 0, "per_token": 0}
_count_lock = threading.Lock()


def _count(name: str, design: str = "") -> None:
    with _count_lock:
        launches[name] += 1
        if design:
            launches_by_design[design] += 1


def _chunk(T: int, chunk: int) -> int:
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be positive")
    L = min(chunk, T)
    if T % L:
        raise ValueError(f"T={T} not divisible by chunk={L}")
    return L


def _lru_block_d(D: int, block_d: int) -> int:
    if block_d < 1:
        raise ValueError(f"block_d={block_d} must be positive")
    bd = min(block_d, D)
    if D % bd:
        raise ValueError(f"D={D} not divisible by block_d={bd}")
    return bd


def lru_smem_bytes(chunk: int, block_d: int, itemsize: int = 4) -> int:
    """Shared memory of an lru block whose segment is one chunk, the least a
    segment holds: a and b tiles of (chunk, block_d) in the input dtype
    (``itemsize`` bytes), and the block's ticket."""
    return 2 * chunk * block_d * itemsize + LRU_FIXED_BYTES


def lru_segments(B: int, T: int, D: int, chunk: int, block_d: int, itemsize: int,
                 sm_count: int) -> int:
    """Segments of T per (batch row, channel block) the lru kernel runs: the
    fewest whose staged a and b fit ``LRU_SEG_BYTES`` and that give
    ``LRU_BLOCKS_PER_SM`` blocks per SM or more, rounded up to a divisor of
    the chunk count so that every segment holds as many whole chunks; one
    chunk each when there are fewer.  Not a knob: (``chunk``, ``block_d``)
    stay the tunables."""
    chunks = T // chunk
    fit = -(-T * 2 * block_d * itemsize // LRU_SEG_BYTES)
    fill = -(-LRU_BLOCKS_PER_SM * sm_count // (B * (D // block_d)))
    want = max(1, fit, fill)
    if want >= chunks:
        return chunks
    return next(n for n in range(want, chunks + 1) if chunks % n == 0)


def lru_channels_per_thread(D: int, block_d: int, aligned: bool) -> int:
    """Channels each thread of the lru kernel stages and scans: 4 (one 16-byte
    fp32 or 8-byte bf16 copy per row) when D and ``block_d`` are multiples
    of 4 and a, b and hs start on 4-element boundaries, else 1 (element
    copies)."""
    return 4 if aligned and D % 4 == 0 and block_d % 4 == 0 else 1


def rwkv_smem_bytes(chunk: int, hd: int) -> int:
    """Shared memory of one rwkv block: five fp32 (chunk, hd) tiles (r, k, v,
    exp(lw), u·k)."""
    return 5 * chunk * hd * 4


def rwkv_tc_smem_bytes(chunk: int) -> int:
    """Shared memory of one block of the tensor-core design: two ring
    stages of max(chunk, 16) tokens and the fixed fp32 arrays (the state,
    the decay-weighted r and k, the intra scores, e^{c})."""
    return TC_STAGES * max(chunk, TC_SUBCHUNK) * TC_TOKEN_BYTES + TC_FIXED_BYTES


def rwkv_design(itemsize: int, hd: int, T: int, chunk: int, aligned: bool = True) -> str:
    """``"tc"`` when the sub-chunked tensor-core kernel runs this call, else
    ``"per_token"``: a pure function of the dtype (``itemsize`` 2: bf16),
    the head dim, the sequence length, the (clamped) chunk and whether the
    tensors start on 16-byte boundaries.  The tensor-core kernel stages
    max(chunk, 16) tokens per load, which must divide T."""
    staged = max(chunk, TC_SUBCHUNK)
    if itemsize != 2 or hd != TC_HEAD_DIM or not aligned or T % staged:
        return "per_token"
    if rwkv_tc_smem_bytes(chunk) > SMEM_LIMIT:
        return "per_token"
    return "tc"


def check_lru(chunk: int, block_d: int, itemsize: int = 4) -> None:
    """Raise ``ValueError`` for (chunk, block_d) the CUDA kernel cannot run:
    more channels than a block has threads (one per channel when the copies
    are element-wide), or a one-chunk segment over a block's shared memory."""
    if block_d > MAX_THREADS:
        raise ValueError(f"block_d={block_d} needs {block_d} threads per block (max {MAX_THREADS})")
    smem = lru_smem_bytes(chunk, block_d, itemsize)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"chunk={chunk} block_d={block_d} needs {smem} bytes of shared memory (max {SMEM_LIMIT})"
        )


def check_rwkv(chunk: int, hd: int) -> None:
    """Raise ``ValueError`` for (chunk, head dim) the CUDA kernel cannot run."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv_scan: head dim {hd} not instantiated (have {HEAD_DIMS})")
    smem = rwkv_smem_bytes(chunk, hd)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"chunk={chunk} (hd {hd}) needs {smem} bytes of shared memory (max {SMEM_LIMIT})"
        )


def legal_lru(T: int, D: int, chunk: int, block_d: int, on_card: bool, itemsize: int = 4) -> tuple:
    """(chunk, block_d) a call runs with (clamped), or ``ValueError``: they
    must divide (T, D), and on the card fit the kernel."""
    L, bd = _chunk(T, chunk), _lru_block_d(D, block_d)
    if on_card:
        check_lru(L, bd, itemsize)
    return L, bd


def legal_rwkv(T: int, hd: int, chunk: int, on_card: bool, itemsize: int = 4,
               aligned: bool = True) -> int:
    """The chunk a call runs with (clamped), or ``ValueError``: it must
    divide T, and on the card fit the design that will launch."""
    L = _chunk(T, chunk)
    if on_card and rwkv_design(itemsize, hd, T, L, aligned) == "per_token":
        check_rwkv(L, hd)
    return L


# ------------------------------------------------------------------ work
def lru_flops_bytes(a, b, h0) -> tuple:
    """(FLOP, bytes) of one call: a multiply and an add per element (fp32);
    a, b and h0 read once, hs and hT written once."""
    n = a.numel()
    nbytes = (2 * n + n) * a.element_size() + 2 * h0.numel() * 4
    return 2.0 * n, float(nbytes)


def rwkv_flops_bytes(r, k, v, lw, u, s0) -> tuple:
    """(FLOP, bytes) of one call.  Per (token, head) the
    recurrence needs r·S (2·hd² FLOP) and the state update e^{lw}⊙S + k vᵀ
    (3·hd²), in fp32 on the CUDA cores; the u bonus is O(hd).  Bytes: r, k,
    v, lw, u, s0 read once, y and sT written once."""
    B, T, H, hd = r.shape
    flops = 5.0 * B * T * H * hd * hd
    nbytes = (
        (r.numel() + k.numel() + v.numel() + r.numel()) * r.element_size()  # r, k, v in; y out
        + lw.numel() * lw.element_size()
        + u.numel() * 4
        + 2 * s0.numel() * 4
    )
    return flops, float(nbytes)


def rwkv_tc_flops(B: int, T: int, H: int) -> tuple:
    """(tensor-core TF32 FLOP, CUDA-core fp32 FLOP) the tensor-core design
    does for one call at head dim 64.  Per (batch, head) and sub-chunk of
    16 tokens: on the tensor cores the inter product (16·64·64 multiply-adds),
    A @ v (16·16·64) and the state update twice (high and low part,
    2·64·64·16); on the CUDA cores the decay scan (16·64 adds), the
    decay-weighted r and k (16·64 · 2 exps and 2 multiplies), the 120 intra
    pairs (64 channels · a subtract, an exp, a multiply and a multiply-add),
    the diagonal (16·64 · 3) and the state's row scale (64·64)."""
    n = B * H * (T // TC_SUBCHUNK)
    tensor = 2.0 * (16 * 64 * 64 + 16 * 16 * 64 + 2 * 64 * 64 * 16)
    cuda = 16 * 64 + 16 * 64 * 4 + 120 * 64 * 5 + 16 * 64 * 3 + 64 * 64
    return n * tensor, float(n * cuda)


# --------------------------------------------------------- plain versions
def lru_scan_plain(a, b, h0, *, chunk: int = 128, block_d: int = LRU_BLOCK_D):
    """The lru kernel in plain PyTorch: the knobs are checked as the kernel
    checks them (they do not change the arithmetic), then the exact fp32
    oracle runs; hs in ``a.dtype``, hT fp32."""
    _chunk(a.shape[1], chunk)
    _lru_block_d(a.shape[2], block_d)
    hs, hT = ref.lru_scan_ref(a.float(), b.float(), h0.float())
    return hs.to(a.dtype), hT


def lru_scan_segmented_plain(a, b, h0, *, segments: int):
    """The lru kernel's arithmetic in plain fp32 PyTorch (tests and
    ``chip_smoke.py`` only): T cut into ``segments`` equal segments; each
    forms P = ∏a and its state hloc from 0 (segment 0 from h0); the carry
    into segment s + 1 is P_s · carry_s + hloc_s, with carry_1 segment 0's
    last state; then every segment reruns h_t = a_t h_{t−1} + b_t from its
    carry.  hs in ``a.dtype``, hT fp32."""
    B, T, D = a.shape
    if segments < 1 or T % segments:
        raise ValueError(f"T={T} not divisible into {segments} segments")
    L = T // segments
    af = a.float().reshape(B, segments, L, D)
    bf = b.float().reshape(B, segments, L, D)
    h = torch.zeros(B, segments, D, dtype=torch.float32, device=a.device)
    h[:, 0] = h0.float()
    P = torch.ones_like(h)
    for t in range(L):
        P = P * af[:, :, t]
        h = af[:, :, t] * h + bf[:, :, t]
    carries = [h0.float(), h[:, 0]]
    for s in range(1, segments - 1):
        carries.append(P[:, s] * carries[-1] + h[:, s])
    h = torch.stack(carries[:segments], dim=1)
    hs = torch.empty(B, segments, L, D, dtype=torch.float32, device=a.device)
    for t in range(L):
        h = af[:, :, t] * h + bf[:, :, t]
        hs[:, :, t] = h
    return hs.reshape(B, T, D).to(a.dtype), h[:, -1]


def rwkv_scan_plain(r, k, v, lw, u, s0, *, chunk: int = 64):
    """The rwkv kernel in plain PyTorch: ``chunk`` is checked as the kernel
    checks it (it does not change the arithmetic), then the exact fp32
    oracle runs; y in ``r.dtype``, sT fp32."""
    _chunk(r.shape[1], chunk)
    return ref.rwkv_scan_ref(r, k, v, lw, u, s0)


def rwkv_scan_subchunk_plain(r, k, v, lw, u, s0, *, sub: int = TC_SUBCHUNK):
    """The tensor-core design's decomposition in plain fp32 PyTorch (tests
    and ``chip_smoke.py`` only): per sub-chunk of ``sub`` tokens, with c the
    cumulative sum of lw restarted at the sub-chunk's start,
    y = (r ⊙ e^{c_{t−1}}) @ S + A @ v with A[t,s] = Σ_i r_t k_s e^{c_{t−1} − c_s}
    for s < t and A[t,t] = Σ_i r_t u k_t, then S ← e^{c_L} ⊙ S +
    (k ⊙ e^{c_L − c})ᵀ @ v.  Every exponent is ≤ 0.  y in ``r.dtype``, sT fp32."""
    B, T, H, hd = r.shape
    if T % sub:
        raise ValueError(f"T={T} not divisible by the sub-chunk {sub}")
    rf, kf, vf, wf = (x.float().permute(0, 2, 1, 3) for x in (r, k, v, lw))  # (B, H, T, hd)
    S = s0.float().clone()
    ys = []
    below = torch.tril(torch.ones(sub, sub, dtype=torch.bool, device=r.device), diagonal=-1)
    for t0 in range(0, T, sub):
        rr, kk, vv = rf[:, :, t0:t0 + sub], kf[:, :, t0:t0 + sub], vf[:, :, t0:t0 + sub]
        c = torch.cumsum(wf[:, :, t0:t0 + sub], dim=2)
        cprev = torch.cat([torch.zeros_like(c[:, :, :1]), c[:, :, :-1]], dim=2)
        diff = cprev[:, :, :, None, :] - c[:, :, None, :, :]  # [t, s, i], <= 0 below the diagonal
        dec = torch.exp(torch.where(below[:, :, None], diff, torch.full_like(diff, -float("inf"))))
        scores = torch.einsum("bhti,bhsi,bhtsi->bhts", rr, kk, dec)
        scores = scores + torch.diag_embed(torch.einsum("bhti,hi,bhti->bht", rr, u.float(), kk))
        ys.append((rr * torch.exp(cprev)) @ S + scores @ vv)
        cl = c[:, :, -1]
        S = torch.exp(cl)[..., None] * S + (kk * torch.exp(cl[:, :, None] - c)).transpose(-1, -2) @ vv
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)
    return y.to(r.dtype), S


# ----------------------------------------------------------- CUDA launch
def _check_cuda(kernel: str, named: dict, dtypes: dict) -> None:
    dev = None
    for name, t in named.items():
        if not t.is_cuda:
            raise ValueError(
                f"{kernel}: {name} is on {t.device}; the CUDA kernel needs CUDA tensors "
                "(interpret=True runs the plain version on CPU tensors)"
            )
        if t.dtype not in dtypes[name]:
            raise ValueError(f"{kernel}: {name} has dtype {t.dtype}; supported: {dtypes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if dev is not None and t.device != dev:
            raise ValueError(f"{kernel}: inputs lie on different devices")
        dev = t.device


def _raise_launch(lib, rc: int, what: str) -> None:
    lib.repro_linear_scan_error_string.restype = ctypes.c_char_p
    msg = lib.repro_linear_scan_error_string(rc).decode()
    raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}: {msg}")


def lru_scan_chunked(a, b, h0, *, chunk: int = 128, block_d: int = LRU_BLOCK_D,
                     interpret: bool = False):
    """a, b: (B,T,D); h0: (B,D) -> (hs (B,T,D) in ``a.dtype``, hT (B,D) fp32).

    CUDA tensors launch the kernel; ``interpret=True`` runs the plain
    version, which takes CPU tensors only.  Anything else raises."""
    if a.dim() != 3 or a.shape != b.shape or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"lru_scan: bad shapes a {tuple(a.shape)} b {tuple(b.shape)} "
                         f"h0 {tuple(h0.shape)}")
    B, T, D = a.shape
    L, bd = legal_lru(T, D, chunk, block_d, on_card=not interpret, itemsize=a.element_size())
    if interpret:
        if a.is_cuda or b.is_cuda or h0.is_cuda:
            raise ValueError("lru_scan: interpret=True runs the plain version on CPU tensors only")
        return lru_scan_plain(a, b, h0, chunk=L, block_d=bd)
    h0 = h0.float()
    io = (torch.float32, torch.bfloat16)
    _check_cuda("lru_scan", {"a": a, "b": b, "h0": h0},
                {"a": io, "b": (a.dtype,), "h0": (torch.float32,)})
    nseg = lru_segments(B, T, D, L, bd, a.element_size(), sm_count(a.device))
    return _lru_launch(a, b, h0, L, bd, nseg)


def _lru_launch(a, b, h0, chunk: int, block_d: int, nseg: int):
    """Launch the lru kernel with ``nseg`` segments on checked CUDA tensors
    (h0 fp32).  ``scripts/probe_lru.py`` also calls it at other segment
    counts."""
    B, T, D = a.shape
    hs = torch.empty_like(a)  # the caching allocator's blocks start on 512-byte boundaries
    hT = torch.empty((B, D), dtype=torch.float32, device=a.device)
    ncols = B * (D // block_d)
    flags = torch.empty(1 + ncols * nseg, dtype=torch.int32, device=a.device)  # zeroed by the launch
    carry = torch.empty(max(1, ncols * nseg * block_d), dtype=torch.float32, device=a.device)
    vec = 4 * a.element_size()
    cpt = lru_channels_per_thread(D, block_d, all(x.data_ptr() % vec == 0 for x in (a, b, hs)))
    lib = _cuda.load("linear_scan")
    fn = getattr(lib, f"repro_lru_scan_{_SUFFIX[a.dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), hs.data_ptr(), hT.data_ptr(),
                flags.data_ptr(), carry.data_ptr(), B, T, D, chunk, block_d, nseg, cpt, stream)
    if rc != 0:
        _raise_launch(lib, rc, f"lru_scan (chunk {chunk}, block_d {block_d}, {nseg} segments)")
    _count("lru_scan")
    return hs, hT


def rwkv_scan_chunked(r, k, v, lw, u, s0, *, chunk: int = 64, interpret: bool = False):
    """r, k, v: (B,T,H,hd) in bf16 or fp32; lw: (B,T,H,hd) log decay (≤ 0);
    u: (H,hd); s0: (B,H,hd,hd) -> (y (B,T,H,hd) in ``r.dtype``, sT fp32).

    lw, u and s0 are read as fp32 (the model makes them fp32).  CUDA tensors
    launch the kernel; ``interpret=True`` runs the plain version, which
    takes CPU tensors only.  Anything else raises."""
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == lw.shape):
        raise ValueError(f"rwkv_scan: r, k, v, lw must share a (B,T,H,hd) shape; got "
                         f"{[tuple(x.shape) for x in (r, k, v, lw)]}")
    B, T, H, hd = r.shape
    if u.shape != (H, hd) or s0.shape != (B, H, hd, hd):
        raise ValueError(f"rwkv_scan: u {tuple(u.shape)} / s0 {tuple(s0.shape)} do not match "
                         f"r {tuple(r.shape)}")
    if interpret:
        L = legal_rwkv(T, hd, chunk, on_card=False)
        if any(x.is_cuda for x in (r, k, v, lw, u, s0)):
            raise ValueError("rwkv_scan: interpret=True runs the plain version on CPU tensors only")
        return rwkv_scan_plain(r, k, v, lw, u, s0, chunk=L)
    lw, u, s0 = (x.float().contiguous() for x in (lw, u, s0))
    aligned = all(x.data_ptr() % 16 == 0 for x in (r, k, v, lw, u, s0))
    L = legal_rwkv(T, hd, chunk, on_card=True, itemsize=r.element_size(), aligned=aligned)
    io = (torch.float32, torch.bfloat16)
    f32 = (torch.float32,)
    _check_cuda("rwkv_scan", {"r": r, "k": k, "v": v, "lw": lw, "u": u, "s0": s0},
                {"r": io, "k": (r.dtype,), "v": (r.dtype,), "lw": f32, "u": f32, "s0": f32})
    return _rwkv_launch(r, k, v, lw, u, s0, L, rwkv_design(r.element_size(), hd, T, L, aligned))


def _rwkv_launch(r, k, v, lw, u, s0, L: int, design: str):
    """Launch the named design's C entry point on checked CUDA tensors (lw,
    u, s0 fp32 and contiguous).  ``chip_smoke.py`` also calls it with
    ``"per_token"`` to time the per-token design on the inputs the tensor-core
    design takes."""
    B, T, H, hd = r.shape
    y = torch.empty_like(r)  # the caching allocator's blocks start on 512-byte boundaries
    sT = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    ptrs = [x.data_ptr() for x in (r, k, v, lw, u, s0, y, sT)]
    if design == "tc":
        lib = _cuda.load("rwkv_subchunk")
        fn, err = lib.repro_rwkv_scan_tc_bf16, lib.repro_rwkv_subchunk_error_string
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        dims = (B, T, H, L)
    else:
        lib = _cuda.load("linear_scan")
        fn, err = getattr(lib, f"repro_rwkv_scan_{_SUFFIX[r.dtype]}"), lib.repro_linear_scan_error_string
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        dims = (B, T, H, hd, L)
    fn.restype = ctypes.c_int
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = fn(*ptrs, *dims, stream)
    if rc != 0:
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"rwkv_scan kernel ({design}) launch failed (chunk {L}, hd {hd}): "
                           f"CUDA error {rc}: {err(rc).decode()}")
    _count("rwkv_scan", design)
    return y, sT
