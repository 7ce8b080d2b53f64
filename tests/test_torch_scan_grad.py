"""The scans' backward on the CPU: ``linear_scan.lru_scan_bwd_plain`` and
``rwkv_scan_bwd_plain`` (the arithmetic of the backward kernels, which the
CPU path of ``ops.lru_scan`` / ``ops.rwkv_scan`` runs under autograd) against
autograd through the port's per-token oracles and against ``jax.vjp`` of the
JAX package's ``ops.lru_scan`` / ``ops.rwkv_scan`` with ``interpret=True``
(whose ``custom_vjp`` takes the vjp of its per-token ``lax.scan``), on the
same numpy-seeded inputs and cotangents.

Tolerances (atol = rtol, compared in fp32, every leaf): against the port's
oracle 1e-5 in fp32 (the same recurrence summed in another order) and the
JAX tests' bf16 limits in bf16 (3e-2 lru, 5e-2 rwkv: one rounding of each
output to bf16 either side); against JAX the limits of
``tests/test_torch_scan.py``: lru as against the oracle, rwkv 5e-4 in fp32.
In bf16 the JAX lru op's own ``custom_vjp`` cannot be differentiated: it
hands hs's bf16 cotangent to the vjp of its oracle, whose hs is fp32, and
JAX refuses the mismatch.  There the JAX side is ``jax.vjp`` of that oracle
(``repro.kernels.ref.lru_scan_ref``) with hs rounded to a's dtype, as the
op's forward returns it.  The CUDA kernels are held against these plain
versions on the card by ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import linear_scan as tls
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ORACLE_TOL = {"lru": {"float32": 1e-5, "bfloat16": 3e-2},
              "rwkv": {"float32": 1e-5, "bfloat16": 5e-2}}
JAX_TOL = {"lru": ORACLE_TOL["lru"], "rwkv": {"float32": 5e-4, "bfloat16": 5e-2}}


def _np(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale).astype(np.float32)


def _both(x, dtype):
    """The same values as a JAX array and a torch tensor (bf16 rounds alike)."""
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _close(got, want, tol, what):
    g = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    w = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=what)


def _oracle_grads(oracle, inputs, cotangents):
    """Autograd through the port's per-token oracle."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = oracle(*leaves)
    return torch.autograd.grad(outs, leaves, cotangents)


def _jax_grads(op, inputs, cotangents):
    outs, vjp = jax.vjp(op, *inputs)
    return vjp(tuple(jnp.asarray(c, o.dtype) for c, o in zip(cotangents, outs)))


# ------------------------------------------------------------------ lru scan
def _lru_case(B, T, D, dtype, *, h0=True, only_gT=False, strong=False, seed=0):
    """(JAX inputs, torch inputs, numpy cotangents (g, g_T))."""
    logits = _np(seed, (B, T, D)) - (12.0 if strong else 0.0)  # strong: a ~ 1e-5
    a = 1.0 / (1.0 + np.exp(-logits))
    raw = [a.astype(np.float32), _np(seed + 1, (B, T, D))]
    pairs = [_both(x, dtype) for x in raw]
    h = _np(seed + 2, (B, D)) if h0 else np.zeros((B, D), np.float32)
    g = np.zeros((B, T, D), np.float32) if only_gT else _np(seed + 3, (B, T, D))
    gT = _np(seed + 4, (B, D))
    return ([p[0] for p in pairs] + [jnp.asarray(h)], [p[1] for p in pairs] + [torch.from_numpy(h)],
            (g, gT))


LRU_CASES = {
    "plain": dict(B=2, T=32, D=16, chunk=8, block_d=8),
    "zero_h0": dict(B=2, T=32, D=16, chunk=8, block_d=16, h0=False),
    "only_gT": dict(B=1, T=24, D=8, chunk=8, block_d=8, only_gT=True),
    "strong_decay": dict(B=2, T=16, D=8, chunk=4, block_d=4, strong=True),
    "one_chunk_odd": dict(B=3, T=20, D=6, chunk=20, block_d=3),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(LRU_CASES))
def test_lru_backward_plain_matches_oracle_and_jax(case, dtype):
    kw = dict(LRU_CASES[case])
    chunk, block_d = kw.pop("chunk"), kw.pop("block_d")
    jargs, targs, (g, gT) = _lru_case(dtype=dtype, **kw)
    ghs, ghT = torch.from_numpy(g).to(TDT[dtype]), torch.from_numpy(gT)
    got = tls.lru_scan_bwd_plain(*targs, ghs, ghT, chunk=chunk, block_d=block_d)
    assert [x.dtype for x in got] == [x.dtype for x in targs]
    assert [x.shape for x in got] == [x.shape for x in targs]
    want = _oracle_grads(lambda a, b, h0: tuple(x.to(y) for x, y in zip(
        tref.lru_scan_ref(a, b, h0), (a.dtype, torch.float32))), targs, (ghs, ghT))
    if dtype == "float32":
        jop = lambda a, b, h0: jops.lru_scan(a, b, h0, chunk=chunk, interpret=True)  # noqa: E731
    else:  # see the module docstring
        jop = lambda a, b, h0: (lambda hs, hT: (hs.astype(a.dtype), hT))(  # noqa: E731
            *jref.lru_scan_ref(a, b, h0))
    jwant = _jax_grads(jop, jargs, (g, gT))
    for name, x, w, jw in zip(("da", "db", "dh0"), got, want, jwant):
        _close(x, w, ORACLE_TOL["lru"][dtype], f"{case} {name} vs the port's oracle")
        _close(x, jw, JAX_TOL["lru"][dtype], f"{case} {name} vs jax.vjp")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lru_backward_through_ops_under_autograd(dtype):
    """``ops.lru_scan`` with ``interpret=True`` on CPU tensors: autograd runs
    the backward's plain version (counted here), launches nothing, and gives
    the plain version's gradients, bit for bit."""
    _, targs, (g, gT) = _lru_case(2, 16, 8, dtype, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in targs]
    ghs, ghT = torch.from_numpy(g).to(TDT[dtype]), torch.from_numpy(gT)
    calls, plain = [], tls.lru_scan_bwd_plain

    def counting(*a, **k):
        calls.append(k)
        return plain(*a, **k)

    before = dict(tls.launches)
    tls.lru_scan_bwd_plain = counting
    try:
        hs, hT = tops.lru_scan(*leaves, chunk=4, block_d=8, interpret=True)
        got = torch.autograd.grad((hs, hT), leaves, (ghs, ghT))
    finally:
        tls.lru_scan_bwd_plain = plain
    assert calls == [{"chunk": 4, "block_d": 8}] and tls.launches == before
    for x, w in zip(got, plain(*targs, ghs, ghT, chunk=4, block_d=8)):
        assert x.dtype == w.dtype and torch.equal(x, w)


# ---------------------------------------- the lru backward kernel's arithmetic
_JAX_LRU_GRADS = {}


def _lru_decays(B, T, D, decays, seed):
    """a = sigmoid(N(0, 1)), or the long-memory a = 0.9 + 0.0999·U(0, 1)
    (``scripts/probe_lru.py --sweep``), fp32."""
    if decays == "long_memory":
        return (0.9 + 0.0999 * np.random.RandomState(seed).uniform(size=(B, T, D))).astype(np.float32)
    return (1.0 / (1.0 + np.exp(-_np(seed, (B, T, D))))).astype(np.float32)


def _lru_seg_case(B, T, D, decays, seed=40):
    """numpy (a, b, h0, g, g_T), g and g_T nonzero, and (da, db, dh0) from
    ``jax.vjp`` of the JAX package's ``ops.lru_scan`` with ``interpret=True``
    (computed once per case)."""
    raw = (_lru_decays(B, T, D, decays, seed), _np(seed + 1, (B, T, D)), _np(seed + 2, (B, D)),
           _np(seed + 3, (B, T, D)), _np(seed + 4, (B, D)))
    key = (B, T, D, decays, seed)
    if key not in _JAX_LRU_GRADS:
        jop = lambda a, b, h0: jops.lru_scan(a, b, h0, chunk=T, interpret=True)  # noqa: E731
        _JAX_LRU_GRADS[key] = _jax_grads(jop, [jnp.asarray(x) for x in raw[:3]], raw[3:])
    return raw, _JAX_LRU_GRADS[key]


@pytest.mark.parametrize("tile", [0, 24])
@pytest.mark.parametrize("decays", ["sigmoid", "long_memory"])
@pytest.mark.parametrize("subsegments", [1, 3, 8, "rows"])
@pytest.mark.parametrize("B,T,D", [(2, 64, 8), (1, 96, 12)])
def test_lru_backward_segmented_plain_matches_jax_and_plain(B, T, D, subsegments, decays, tile):
    """The backward kernel's association (sub-segments from 1 to one row
    each, whole or streamed in tiles of 24 rows) in plain fp32 against
    ``jax.vjp`` of the JAX op and against the exact reverse recurrence, at
    1e-5, both decay ranges, g and g_T nonzero."""
    raw, jwant = _lru_seg_case(B, T, D, decays)
    a, b, h0, g, gT = (torch.from_numpy(x) for x in raw)
    S = (tile or T) if subsegments == "rows" else subsegments
    got = tls.lru_scan_bwd_segmented_plain(a, b, h0, g, gT, subsegments=S, tile=tile)
    want = tls.lru_scan_bwd_plain(a, b, h0, g, gT, chunk=T, block_d=D)
    for name, x, w, jw in zip(("da", "db", "dh0"), got, want, jwant):
        assert x.dtype == torch.float32 and x.shape == w.shape
        _close(x, jw, 1e-5, f"{name} vs jax.vjp")
        _close(x, w, 1e-5, f"{name} vs lru_scan_bwd_plain")


@pytest.mark.parametrize("tile", [0, 16])
@pytest.mark.parametrize("subsegments", [1, 5, 32])
def test_lru_backward_segmented_plain_bf16_and_no_final_cotangent(subsegments, tile):
    """bf16 inputs (h kept rounded to bf16 between rows, as the kernel keeps
    it in shared memory) against the exact reverse recurrence at the JAX
    tests' bf16 limit; g_T = None is zero; a ragged last tile (T 40, tiles
    of 16) and sub-segments past the rows (32 of 16 rows: 16 empty)."""
    B, T, D = 2, 40, 8
    a = torch.from_numpy(_lru_decays(B, T, D, "sigmoid", 50)).to(torch.bfloat16)
    b, g = (torch.from_numpy(_np(51 + i, (B, T, D))).to(torch.bfloat16) for i in range(2))
    h0 = torch.from_numpy(_np(53, (B, D)))
    got = tls.lru_scan_bwd_segmented_plain(a, b, h0, g, None, subsegments=subsegments, tile=tile)
    want = tls.lru_scan_bwd_plain(a, b, h0, g, None, chunk=8, block_d=8)
    assert [x.dtype for x in got] == [torch.bfloat16, torch.bfloat16, torch.float32]
    for name, x, w in zip(("da", "db", "dh0"), got, want):
        _close(x, w, ORACLE_TOL["lru"]["bfloat16"], name)
    same = tls.lru_scan_bwd_segmented_plain(a, b, h0, g, torch.zeros(B, D), subsegments=subsegments, tile=tile)
    assert all(torch.equal(x, y) for x, y in zip(got, same))


LRU_BWD_SHAPES = [(256, 2560), (2048, 2560), (2048, 256), (64, 32), (64, 96), (96, 40), (48, 5),
                  (13, 7), (4096, 1024), (65536, 2560), (1, 2560), (300, 6), (600, 36), (1000, 4)]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("T,D", LRU_BWD_SHAPES)
def test_lru_backward_tiling_properties(T, D, itemsize):
    """The kernel's split: its shared memory within a block's (and within
    half an SM's), a channel tile dividing D with 4 channels a thread where D
    allows it (else element copies, as ``lru_channels_per_thread``), at most
    1024 threads even at element copies, the tiles covering T, and T
    streamed exactly when a, b and g of the whole column do not fit."""
    t = tls.lru_bwd_tiling(T, D, itemsize)
    assert t == tls.lru_bwd_tiling.__wrapped__(T, D, itemsize)  # a pure function of its arguments
    smem = tls.lru_bwd_smem_bytes(t.cw, t.nsub, t.tile, itemsize)
    assert smem <= tls.LRU_BWD_SMEM_BYTES <= tls.SMEM_LIMIT
    assert D % t.cw == 0 and t.cw % t.cpt == 0 and t.cw <= max(tls.LRU_BWD_CHANNELS, t.cpt)
    assert t.cpt == (4 if D % 4 == 0 else 1)
    assert all(D % c for c in range(t.cw + t.cpt, min(tls.LRU_BWD_CHANNELS, D) + 1, t.cpt))  # the widest
    assert t.cw * t.nsub <= tls.MAX_THREADS and 1 <= t.nsub <= tls.LRU_BWD_MAX_SUBS
    assert t.tiles == -(-T // t.tile) and t.tile <= T
    if t.tiles == 1:
        assert t.tile == T
    else:
        assert tls.lru_bwd_smem_bytes(t.cw, t.nsub, T, itemsize) > tls.LRU_BWD_SMEM_BYTES
        assert t.tile % t.nsub == 0
        assert tls.lru_bwd_smem_bytes(t.cw, t.nsub, t.tile + t.nsub, itemsize) > tls.LRU_BWD_SMEM_BYTES


@pytest.mark.parametrize("T,D,itemsize,want", [
    (256, 2560, 4, (32, 4, 16, 256, 1)),  # recurrentgemma-2b's training call: 320 blocks of 128 threads
    (256, 2560, 2, (32, 4, 16, 256, 1)),  # bf16
    (2048, 2560, 4, (32, 4, 16, 288, 8)),  # streamed: 7 tiles of 288 rows and one of 32
    (2048, 2560, 2, (32, 4, 16, 576, 4)),
    (64, 32, 4, (32, 4, 4, 64, 1)), (48, 5, 4, (5, 1, 3, 48, 1)),  # element copies
    (96, 40, 4, (20, 4, 6, 96, 1)),
])
def test_lru_backward_tiling_at_known_shapes(T, D, itemsize, want):
    assert tuple(tls.lru_bwd_tiling(T, D, itemsize)) == want


# ----------------------------------------------------------------- rwkv scan
def _rwkv_case(B, T, H, hd, dtype, *, s0=True, only_gsT=False, strong=False, seed=10):
    raw = [_np(seed + i, (B, T, H, hd)) for i in range(3)]
    lw = np.full((B, T, H, hd), -14.0, np.float32) if strong else -np.exp(_np(seed + 3, (B, T, H, hd)))
    pairs = [_both(x, dtype) for x in raw]
    rest = [lw, _np(seed + 4, (H, hd), 0.5),
            _np(seed + 5, (B, H, hd, hd)) if s0 else np.zeros((B, H, hd, hd), np.float32)]
    gy = np.zeros((B, T, H, hd), np.float32) if only_gsT else _np(seed + 6, (B, T, H, hd))
    gsT = _np(seed + 7, (B, H, hd, hd))
    return ([p[0] for p in pairs] + [jnp.asarray(x) for x in rest],
            [p[1] for p in pairs] + [torch.from_numpy(x) for x in rest], (gy, gsT))


RWKV_CASES = {
    "plain": dict(B=2, T=16, H=2, hd=8),
    "zero_s0": dict(B=1, T=16, H=2, hd=16, s0=False),
    "only_gsT": dict(B=1, T=12, H=1, hd=8, only_gsT=True),
    "strong_decay": dict(B=1, T=16, H=2, hd=8, strong=True),
    "odd_T_hd64": dict(B=1, T=36, H=1, hd=64),  # the kernel's chunk: 9, not a power of 2
    "hd32": dict(B=2, T=24, H=1, hd=32),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(RWKV_CASES))
def test_rwkv_backward_plain_matches_oracle_and_jax(case, dtype):
    jargs, targs, (gy, gsT) = _rwkv_case(dtype=dtype, **RWKV_CASES[case])
    tgy, tgs = torch.from_numpy(gy).to(TDT[dtype]), torch.from_numpy(gsT)
    got = tls.rwkv_scan_bwd_plain(*targs, tgy, tgs)
    assert [x.dtype for x in got] == [x.dtype for x in targs]
    assert [x.shape for x in got] == [x.shape for x in targs]
    assert all(bool(torch.isfinite(x.float()).all()) for x in got)
    want = _oracle_grads(tref.rwkv_scan_ref, targs, (tgy, tgs))
    jwant = _jax_grads(lambda *x: jops.rwkv_scan(*x, chunk=4, interpret=True), jargs, (gy, gsT))
    for name, x, w, jw in zip(("dr", "dk", "dv", "dlw", "du", "ds0"), got, want, jwant):
        _close(x, w, ORACLE_TOL["rwkv"][dtype], f"{case} {name} vs the port's oracle")
        _close(x, jw, JAX_TOL["rwkv"][dtype], f"{case} {name} vs jax.vjp")


def test_rwkv_backward_through_ops_under_autograd():
    _, targs, (gy, gsT) = _rwkv_case(1, 8, 2, 8, "bfloat16", seed=20)
    leaves = [t.clone().requires_grad_(True) for t in targs]
    tgy, tgs = torch.from_numpy(gy).to(torch.bfloat16), torch.from_numpy(gsT)
    calls, plain = [], tls.rwkv_scan_bwd_plain

    def counting(*a, **k):
        calls.append(len(a))
        return plain(*a, **k)

    before = dict(tls.launches)
    tls.rwkv_scan_bwd_plain = counting
    try:
        y, sT = tops.rwkv_scan(*leaves, chunk=4, interpret=True)
        got = torch.autograd.grad((y, sT), leaves, (tgy, tgs))
    finally:
        tls.rwkv_scan_bwd_plain = plain
    assert calls == [8] and tls.launches == before
    for x, w in zip(got, plain(*targs, tgy, tgs)):
        assert x.dtype == w.dtype and torch.equal(x, w)


# ------------------------------------------------------------- the wrappers
def test_backward_wrappers_refuse_cpu_tensors_without_interpret():
    _, (a, b, h0), (g, gT) = _lru_case(1, 16, 8, "float32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tls.lru_scan_bwd(a, b, h0, torch.from_numpy(g), torch.from_numpy(gT), chunk=16)
    _, targs, (gy, gsT) = _rwkv_case(1, 16, 1, 8, "float32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tls.rwkv_scan_bwd(*targs, torch.from_numpy(gy), torch.from_numpy(gsT))
    with pytest.raises(ValueError, match="head dim 128"):
        tls.rwkv_scan_bwd(*(torch.zeros(1, 4, 1, 128) for _ in range(4)), torch.zeros(1, 128),
                          torch.zeros(1, 1, 128, 128), torch.zeros(1, 4, 1, 128), None)
    with pytest.raises(ValueError, match="chunk=12"):
        tls.lru_scan_bwd(a, b, h0, torch.from_numpy(g), None, chunk=12, interpret=True)
    assert tls.launches == {"lru_scan": 0, "rwkv_scan": 0, "lru_scan_bwd": 0, "rwkv_scan_bwd": 0}


def test_missing_final_state_cotangent_is_zero():
    _, targs, (g, gT) = _lru_case(1, 16, 8, "float32", seed=5)
    ghs = torch.from_numpy(g)
    for x, w in zip(tls.lru_scan_bwd(*targs, ghs, None, chunk=8, interpret=True),
                    tls.lru_scan_bwd_plain(*targs, ghs, torch.zeros(1, 8), chunk=8)):
        assert torch.equal(x, w)
    _, rargs, (gy, _) = _rwkv_case(1, 8, 1, 8, "float32", seed=6)
    tgy = torch.from_numpy(gy)
    for x, w in zip(tls.rwkv_scan_bwd(*rargs, tgy, None, interpret=True),
                    tls.rwkv_scan_bwd_plain(*rargs, tgy, torch.zeros(1, 1, 8, 8))):
        assert torch.equal(x, w)


@pytest.mark.parametrize("T,hd,want", [(2048, 64, 8), (2048, 32, 32), (2048, 8, 64), (13, 64, 1),
                                       (36, 64, 12), (16, 16, 16)])
def test_rwkv_backward_chunk_is_derived_from_the_shape(T, hd, want):
    """The largest divisor of T up to 64 whose block (staged rows and the
    chunk's states) fits the shared memory."""
    L = tls.rwkv_bwd_chunk(T, hd)
    assert L == want and T % L == 0
    assert tls.rwkv_bwd_smem_bytes(L, hd) <= tls.SMEM_LIMIT
    bigger = [c for c in range(L + 1, min(T, tls.RWKV_BWD_MAX_CHUNK) + 1) if T % c == 0]
    assert all(tls.rwkv_bwd_smem_bytes(c, hd) > tls.SMEM_LIMIT for c in bigger)


@pytest.mark.parametrize("T,hd,seg,states", [(2048, 64, 64, (31, 7)), (4096, 64, 64, (63, 7)),
                                             (2048, 8, 64, (31, 1)), (13, 64, 13, (1, 12)),
                                             (36, 64, 36, (1, 2)), (100, 64, 50, (1, 4))])
def test_rwkv_backward_checkpoints_are_derived_from_the_shape(T, hd, seg, states):
    """The checkpoint segment: the largest multiple of the chunk up to 64
    tokens that divides T; the scratch holds T / segment - 1 checkpoints and
    segment / chunk - 1 chunk starts per (batch row, head), so its chunk
    starts do not grow with T."""
    L = tls.rwkv_bwd_chunk(T, hd)
    assert tls.rwkv_bwd_segment(T, L) == seg and seg % L == 0 and T % seg == 0
    assert tls.rwkv_bwd_scratch(T, L, seg) == states


def test_backward_work_counts():
    """The bounds' FLOP and bytes from the shapes: lru 5 FLOP and five
    passes of the input dtype per element; rwkv 14·hd² FLOP per (token,
    head) and seven passes of r's dtype."""
    a = torch.zeros(4, 256, 2560)
    h0 = torch.zeros(4, 2560)
    flops, nbytes = tls.lru_bwd_flops_bytes(a, a, h0)
    assert flops == 5.0 * a.numel() and nbytes == 5 * a.numel() * 4 + 3 * h0.numel() * 4
    r = torch.zeros(1, 2048, 64, 64, dtype=torch.bfloat16)
    lw = torch.zeros(1, 2048, 64, 64)
    u, s0 = torch.zeros(64, 64), torch.zeros(1, 64, 64, 64)
    flops, nbytes = tls.rwkv_bwd_flops_bytes(r, r, r, lw, u, s0)
    assert flops == 14.0 * 2048 * 64 * 64 * 64
    assert nbytes == 7 * r.numel() * 2 + 2 * lw.numel() * 4 + 2 * u.numel() * 4 + 3 * s0.numel() * 4


@pytest.mark.parametrize("B,H,hd,sms,want", [
    (1, 64, 64, 132, 2),  # rwkv6-7b's training call: 128 blocks
    (2, 64, 64, 132, 1), (3, 64, 64, 132, 1),  # the heads alone fill the card
    (1, 2, 64, 132, 8),  # capped by the cluster's 8 blocks
    (1, 2, 8, 132, 1), (1, 2, 16, 132, 2), (1, 2, 32, 132, 4),  # capped at 8 rows a slice
    (1, 16, 64, 132, 8), (1, 32, 64, 132, 4),
])
def test_rwkv_backward_slices_are_derived_from_the_shape(B, H, hd, sms, want):
    """The row slices a (head, batch row): the largest power of two with at
    most one block per SM, at least 8 state rows a slice and at most 8
    blocks a cluster."""
    n = tls.rwkv_bwd_slices(B, H, hd, sms)
    assert n == want
    assert n & (n - 1) == 0 and hd % n == 0 and hd // n >= tls.RWKV_BWD_MIN_ROWS
    assert n <= tls.RWKV_BWD_MAX_SLICES and (n == 1 or B * H * n <= sms)
    assert 2 * n > min(tls.RWKV_BWD_MAX_SLICES, hd // tls.RWKV_BWD_MIN_ROWS) or B * H * 2 * n > sms


@pytest.mark.parametrize("T,hd,slices,want", [(2048, 64, 1, 8), (2048, 64, 2, 16), (2048, 64, 4, 32),
                                              (2048, 64, 8, 64), (2048, 32, 4, 64), (36, 64, 2, 18),
                                              (13, 64, 2, 13)])
def test_rwkv_backward_split_sizes(T, hd, slices, want):
    """A slice's block holds fewer state rows, so its chunk may be longer
    (the largest divisor of T up to 64 that fits), and its shared memory
    shrinks with the slice; the checkpoint scratch holds hd² values per
    (batch row, head) and state whatever the split."""
    L = tls.rwkv_bwd_chunk(T, hd, slices)
    assert L == want and T % L == 0
    assert tls.rwkv_bwd_smem_bytes(L, hd, slices) <= tls.SMEM_LIMIT
    assert all(tls.rwkv_bwd_smem_bytes(c, hd, slices) > tls.SMEM_LIMIT
               for c in range(L + 1, min(T, tls.RWKV_BWD_MAX_CHUNK) + 1) if T % c == 0)
    assert tls.rwkv_bwd_smem_bytes(8, hd, slices) <= tls.rwkv_bwd_smem_bytes(8, hd, 1)
    assert tls.rwkv_bwd_slot_floats(hd, slices) * slices == hd * hd
    seg = tls.rwkv_bwd_segment(T, L)
    ck, sub = tls.rwkv_bwd_scratch(T, L, seg)
    assert 4 * (ck + sub) * slices * tls.rwkv_bwd_slot_floats(hd, slices) == 4 * (ck + sub) * hd * hd
