"""The plain attention's scores in the reference's product form, and the
dry run's pointwise counts, on the CPU.

* ``models.attention._ScoresFp32``: bf16 q and k multiplied with fp32
  output through ``aten::bmm.dtype``, which has no CPU kernel and no
  derivative.  Its backward, driven here by an fp32 stand-in forward
  (``_bmm_fp32`` patched to the fp32 product), gives the same dq and dk as
  the autograd of the upcast form it replaces (1e-6 of the largest
  gradient); on integer-valued bf16 data, where every sum is exact in
  fp32, the two are bit-equal.
* On meta tensors (the dry run's) the scores are fp32 of the grouped shape,
  autograd runs through them, and ``StepCounter`` counts the product as
  2·B·M·N·K (``flop_counter``'s bmm formula raises on this overload).
* ``core.costs.pointwise_flops`` against XLA's ``cost_analysis``, op by op:
  each op of softmax, LayerNorm, RMSNorm, rope and one AdamW leaf, alone,
  counts what XLA counts for the same op.  Whole functions: softmax and
  RMSNorm equal XLA's count; LayerNorm, rope and AdamW differ where XLA's
  fusion recomputes a cheap op in two consumers or folds constants, which
  an eager program does not do (the differences are asserted as such).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch

from repro import optim as joptim
from repro.models import layers as jlayers
from repro_torch import optim as toptim
from repro_torch.core.costs import StepCounter
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers


def _np(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _xla_flops(fn, *args) -> float:
    c = jax.jit(fn).lower(*args).compile().cost_analysis()
    c = c[0] if isinstance(c, (list, tuple)) else c
    return float(c.get("flops", 0.0))


def _port_flops(fn, *args) -> float:
    with StepCounter() as counter:
        fn(*args)
    return counter.flops


# ------------------------------------------------------------ the scores
SHAPES = {"prefill GQA": (2, 8, 4, 2, 16, 8), "decode": (2, 1, 4, 2, 16, 12),
          "MHA": (1, 6, 3, 3, 8, 6)}  # B, Sq, H, Kh, hd, Skv


def _grads(form, qh, k, g):
    qh = qh.clone().requires_grad_()
    k = k.clone().requires_grad_()
    (form(qh, k) * g).sum().backward()
    return qh.grad, k.grad


def _upcast(qh, k):
    return torch.einsum("bqkgh,bksh->bkgqs", qh.float(), k.float())


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_scores_backward_equals_the_upcast_autograd(shape, monkeypatch):
    monkeypatch.setattr(tattn, "_bmm_fp32", lambda a, b: torch.bmm(a.float(), b.float()))
    B, Sq, H, Kh, hd, Skv = shape
    qh = torch.from_numpy(_np(0, (B, Sq, Kh, H // Kh, hd)))
    k = torch.from_numpy(_np(1, (B, Kh, Skv, hd)))
    g = torch.from_numpy(_np(2, (B, Kh, H // Kh, Sq, Skv)))
    s = tattn._scores_bmm(qh, k)
    assert s.dtype == torch.float32 and s.shape == (B, Kh, H // Kh, Sq, Skv) and not s._is_view()
    torch.testing.assert_close(s, _upcast(qh, k), rtol=1e-6, atol=1e-6)
    (dq, dk), (wq, wk) = _grads(tattn._scores_bmm, qh, k, g), _grads(_upcast, qh, k, g)
    for got, want in ((dq, wq), (dk, wk)):
        assert got.dtype == want.dtype == torch.float32
        assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    # bf16 operands on integer data: every product and sum is exact in fp32,
    # so the bf16 gradients are bit-equal whatever the summation order
    qb = torch.from_numpy(np.random.RandomState(3).randint(-4, 5, qh.shape)).bfloat16()
    kb = torch.from_numpy(np.random.RandomState(4).randint(-4, 5, k.shape)).bfloat16()
    gi = torch.from_numpy(np.random.RandomState(5).randint(-3, 4, g.shape)).float()
    (dq, dk), (wq, wk) = _grads(tattn._scores_bmm, qb, kb, gi), _grads(_upcast, qb, kb, gi)
    assert dq.dtype == dk.dtype == torch.bfloat16
    assert torch.equal(dq, wq) and torch.equal(dk, wk)


def test_scores_scaled_and_masked_in_place_keep_the_gradients(monkeypatch):
    """``_sdpa``'s in-place scale and mask on the Function's output: the
    same output and input gradients as the out-of-place steps."""
    monkeypatch.setattr(tattn, "_bmm_fp32", lambda a, b: torch.bmm(a.float(), b.float()))
    B, Sq, H, Kh, hd, Skv = SHAPES["prefill GQA"]
    qh = torch.from_numpy(_np(6, (B, Sq, Kh, H // Kh, hd)))
    k = torch.from_numpy(_np(7, (B, Kh, Skv, hd)))
    mask = torch.from_numpy(np.random.RandomState(8).rand(Sq, Skv) > 0.3)
    w = torch.from_numpy(_np(9, (B, Kh, H // Kh, Sq, Skv)))

    def in_place(qh_, k_):
        s = tattn._scores_bmm(qh_, k_)
        s.mul_(0.25)
        s.masked_fill_(~mask, tattn.NEG_INF)
        return torch.softmax(s, -1)

    def out_of_place(qh_, k_):
        s = _upcast(qh_, k_) * 0.25
        return torch.softmax(torch.where(mask, s, torch.full((), tattn.NEG_INF)), -1)

    torch.testing.assert_close(in_place(qh, k), out_of_place(qh, k), rtol=1e-6, atol=1e-7)
    for got, want in zip(_grads(in_place, qh, k, w), _grads(out_of_place, qh, k, w)):
        assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def test_scores_on_meta_are_fp32_and_counted():
    B, Sq, H, Kh, hd, Skv = 2, 16, 8, 2, 32, 24
    q = torch.empty((B, Sq, H, hd), dtype=torch.bfloat16, device="meta", requires_grad=True)
    k = torch.empty((B, Kh, Skv, hd), dtype=torch.bfloat16, device="meta", requires_grad=True)
    v = torch.empty((B, Kh, Skv, hd), dtype=torch.bfloat16, device="meta")
    qh = q.reshape(B, Sq, Kh, H // Kh, hd)
    s = tattn._scores("bqkgh,bksh->bkgqs", qh, k)
    assert s.dtype == torch.float32 and s.shape == (B, Kh, H // Kh, Sq, Skv) and s.device.type == "meta"
    with StepCounter() as counter:
        tattn._scores("bqkgh,bksh->bkgqs", qh, k)
    assert counter.flops == 2 * B * Kh * (H // Kh) * Sq * Skv * hd
    out = tattn._sdpa(q, k, v, torch.ones((Sq, Skv), dtype=torch.bool, device="meta"))
    assert out.dtype == torch.bfloat16 and out.shape == (B, Sq, H, hd)
    out.float().sum().backward()
    assert q.grad.shape == q.shape and q.grad.dtype == torch.bfloat16
    assert k.grad.shape == k.shape and k.grad.dtype == torch.bfloat16


# --------------------------------------------------- pointwise op by op
_X = _np(10, (2, 16, 64))
_ROWS = _X.size // 64


def _norm_ops(kind):
    """RMSNorm's ops, alone, at their shapes; LayerNorm adds the mean's
    subtraction and the bias."""
    x, mu = _X, _X.mean(-1, keepdims=True)
    ops = [
        ("convert to fp32", lambda t: t.float(), lambda a: a.astype(jnp.float32), [x], "bfloat16"),
        ("square", torch.square, jnp.square, [x], None),
        ("mean", lambda t: t.mean(-1, keepdim=True), lambda a: jnp.mean(a, -1, keepdims=True), [x], None),
        ("add eps", lambda m: m + 1e-6, lambda m: m + 1e-6, [mu], None),
        ("rsqrt", torch.rsqrt, jax.lax.rsqrt, [np.abs(mu) + 1], None),
        ("times row", lambda t, m: t * m, lambda a, m: a * m, [x, mu], None),
        ("times scale", lambda t, s: t * s, lambda a, s: a * s, [x, x[0, 0]], None),
        ("convert to bf16", lambda t: t.bfloat16(), lambda a: a.astype(jnp.bfloat16), [x], None),
    ]
    if kind == "layernorm":
        ops += [("subtract row", lambda t, m: t - m, lambda a, m: a - m, [x, mu], None),
                ("plus bias", lambda t, s: t + s, lambda a, s: a + s, [x, x[0, 0]], None)]
    return ops


def _rope_ops():
    S, half = 16, 8
    x = _np(11, (2, S, 4, 2 * half))
    ang = _np(12, (1, S, 1, half))
    pos = np.arange(S)
    return [
        ("positions to fp32", lambda p: p.float(), lambda p: p.astype(jnp.float32), [pos], "int"),
        ("angles", lambda p, f: p[:, None] * f[None, :], lambda p, f: p[:, None] * f[None, :],
         [pos.astype(np.float32), ang[0, 0, 0]], None),
        ("cos", torch.cos, jnp.cos, [ang], None),
        ("sin", torch.sin, jnp.sin, [ang], None),
        ("a half to fp32", lambda t: t.float(), lambda a: a.astype(jnp.float32),
         [np.ascontiguousarray(x[..., :half])], "bfloat16"),
        ("half times cos", lambda t, c: t[..., :half] * c, lambda a, c: a[..., :half] * c, [x, ang], None),
        ("difference", lambda t: t[..., :half] - t[..., half:], lambda a: a[..., :half] - a[..., half:],
         [x], None),
        ("sum", lambda t: t[..., :half] + t[..., half:], lambda a: a[..., :half] + a[..., half:], [x], None),
        ("convert back", lambda t: t.bfloat16(), lambda a: a.astype(jnp.bfloat16), [x], None),
    ]


def _softmax_ops():
    return [("softmax", lambda t: torch.softmax(t, -1), lambda a: jax.nn.softmax(a, -1), [_X], None),
            ("max", lambda t: t.amax(-1), lambda a: a.max(-1), [_X], None),
            ("sum", lambda t: t.sum(-1), lambda a: a.sum(-1), [_X], None),
            ("exp", torch.exp, jnp.exp, [_X], None),
            ("divide", lambda t, s: t / s, lambda a, s: a / s, [_X, _X[..., :1]], None)]


def _adamw_ops():
    n = 256
    p, g = _np(13, (n,)), _np(14, (n,))
    s = np.float32(0.5)
    return [
        ("square", torch.square, jnp.square, [g], None),
        ("sum", torch.sum, jnp.sum, [g], None),
        ("scale", lambda t: t * 0.9, lambda a: a * 0.9, [g], None),
        ("times 0-d", lambda t, c: t * c, lambda a, c: a * c, [g, s], None),
        ("add", torch.add, jnp.add, [g, p], None),
        ("divide 0-d", lambda t, c: t / c, lambda a, c: a / c, [g, s], None),
        ("sqrt", torch.sqrt, jnp.sqrt, [np.abs(g)], None),
        ("plus eps", lambda t: t + 1e-8, lambda a: a + 1e-8, [g], None),
        ("divide", torch.div, jnp.divide, [g, np.abs(p) + 1], None),
        ("subtract", torch.sub, jnp.subtract, [p, g], None),
    ]


OPS = {"softmax": _softmax_ops, "layernorm": lambda: _norm_ops("layernorm"),
       "rmsnorm": lambda: _norm_ops("rmsnorm"), "rope": _rope_ops, "adamw leaf": _adamw_ops}


def _to_torch(a, dtype):
    t = torch.from_numpy(np.asarray(a))
    return t.bfloat16() if dtype == "bfloat16" and t.is_floating_point() else t


def _to_jax(a, dtype):
    arr = jnp.asarray(a)
    return arr.astype(jnp.bfloat16) if dtype == "bfloat16" and arr.dtype == jnp.float32 else arr


@pytest.mark.parametrize("fn", list(OPS))
def test_pointwise_counts_equal_xla_op_by_op(fn):
    for name, top, jop, args, dtype in OPS[fn]():
        port = _port_flops(top, *[_to_torch(a, dtype) for a in args])
        xla = _xla_flops(jop, *[_to_jax(a, dtype) for a in args])
        assert port == xla, (fn, name, port, xla)


def test_whole_functions_against_xla():
    """Softmax and RMSNorm: equal.  LayerNorm: XLA one divide more per row
    (its fusion recomputes the mean's divide in both consumers of the
    mean).  Rope: the same count per position (the constant frequencies,
    which XLA folds, aside).  AdamW: XLA one op more per element (its
    fusions recompute the clipped gradient for m and for v)."""
    x = _X
    assert _port_flops(lambda t: torch.softmax(t, -1), torch.from_numpy(x)) == \
        _xla_flops(lambda a: jax.nn.softmax(a, -1), jnp.asarray(x))
    for kind, extra in (("rmsnorm", 0), ("layernorm", _ROWS)):
        pt = {"scale": torch.ones(64), "bias": torch.zeros(64)}
        pj = {"scale": jnp.ones(64), "bias": jnp.zeros(64)}
        port = _port_flops(lambda t: tlayers.norm_apply(kind, pt, t), torch.from_numpy(x).bfloat16())
        xla = _xla_flops(lambda a: jlayers.norm_apply(kind, pj, a), jnp.asarray(x, jnp.bfloat16))
        assert xla - port == extra, (kind, port, xla)

    def rope(S):
        q = _np(15, (2, S, 4, 16))
        pos = np.arange(S)
        return (_port_flops(lambda t, p: tlayers.rope_apply(t, p, 1e4), torch.from_numpy(q).bfloat16(),
                            torch.from_numpy(pos)),
                _xla_flops(lambda a, p: jlayers.rope_apply(a, p, 1e4), jnp.asarray(q, jnp.bfloat16),
                           jnp.asarray(pos, jnp.int32)))

    (p16, x16), (p32, x32) = rope(16), rope(32)
    assert p32 - p16 == x32 - x16

    def adamw(n):
        p0, g0 = _np(16, (n,)), _np(17, (n,))
        jo, to = joptim.AdamW(lr=1e-3), toptim.AdamW(lr=1e-3)
        xla = _xla_flops(lambda p, g, s: jo.update({"w": g}, s, {"w": p}), jnp.asarray(p0), jnp.asarray(g0),
                         jo.init({"w": jnp.asarray(p0)}))
        params = {"w": torch.from_numpy(p0.copy())}
        state = to.init(params)
        port = _port_flops(lambda: to.update({"w": torch.from_numpy(g0.copy())}, state, params))
        return port, xla

    (p1, x1), (p2, x2) = adamw(256), adamw(512)
    assert (p2 - p1) / 256 == 18 and (x2 - x1) / 256 == 19


def test_bmm_dtype_counted_by_its_shape():
    a = torch.empty((3, 5, 7), dtype=torch.bfloat16, device="meta")
    b = torch.empty((3, 7, 11), dtype=torch.bfloat16, device="meta")
    with StepCounter() as counter:
        out = torch.ops.aten.bmm.dtype(a, b, torch.float32)
    assert out.dtype == torch.float32 and counter.flops == 2 * 3 * 5 * 7 * 11
    assert math.isclose(counter.bytes_accessed, 2 * (3 * 5 * 7 + 3 * 7 * 11) + 4 * 3 * 5 * 11)
