"""AdamW's multi-tensor kernel (``kernels/adamw.py``, ``csrc/adamw.cu``) and
``optim.AdamW.update``'s path through it.  This file imports neither JAX
nor ``repro``, so its card tests run on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_adamw.py

On the CPU: the chunks cover every element of ragged trees exactly once; CPU leaves take the plain version, which gives the bits of the
per-leaf loop that ``update`` ran before the kernel (copied below as
``_former_update``), with the clip engaged, not engaged and off; ``update``
returns its metrics as before; the dry run's meta leaves take the plain
version too.

On the card (``cuda`` marker, each test skips without one): the kernel
against the plain version over five steps of a ragged tree (with fp32
state, fp32 tensors within 1e-6 of each leaf's largest magnitude, since the
clip scale comes from a norm summed in another order and the update then
differs by fp32 rounding; bf16 tensors within one bf16 step; with bf16
state, fp32 parameters within a bf16 step of their scale, since a moment
that rounds the other way moves the update by as much; the global norm to
1e-6 relative; the gradients left as they were), the norm repeated bit for
bit, the wrapper's refusals, at most 8 launches an update for 412 leaves,
and no host synchronisation.
"""
import numpy as np
import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch

from repro_torch import optim as toptim
from repro_torch.kernels import adamw as tadamw

#: leaf lengths of the ragged trees: tiny, odd, one chunk less, at and more
#: than one chunk, several chunks with a ragged end, and no elements at all
RAGGED = [1, 3, 4097, 65536 + 5, 16383, 16384, 16385, 3 * 16384, 0]
SHAPES = [(), (3,), (4097,), (65536 + 5,), (127, 129), (0,), (16384,), (16385,), (3, 16384)]
STEPS = 5


def _randn(seed, shape, dtype=torch.float32, scale=1.0):
    x = np.asarray(np.random.RandomState(seed).standard_normal(shape), np.float32) * scale
    return torch.from_numpy(np.asarray(x)).to(dtype)


def _former_update(opt, grads, state, params):
    """``AdamW.update`` as it was before the kernel: the global-norm clip in
    place, then one leaf at a time."""
    state["step"].add_(1)
    step = state["step"]
    lr = opt.lr(step) if callable(opt.lr) else opt.lr
    lr = torch.as_tensor(lr, dtype=torch.float32).to(step.device)
    if opt.clip_norm > 0:
        grads, gnorm = toptim.clip_by_global_norm(grads, opt.clip_norm, inplace=True)
    else:
        gnorm = toptim.global_norm(grads)
    b1, b2 = opt.b1, opt.b2
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), stepf)
    for p, g, m, v in zip(toptim.tree_leaves(params), toptim.tree_leaves(grads),
                          toptim.tree_leaves(state["m"]), toptim.tree_leaves(state["v"])):
        gf = g.float()
        mf = m if m.dtype == torch.float32 else m.float()
        vf = v if v.dtype == torch.float32 else v.float()
        mf.mul_(b1).add_(gf * (1 - b1))
        vf.mul_(b2).add_(torch.square(gf).mul_(1 - b2))
        del gf
        denom = torch.sqrt(vf / c2).add_(opt.eps)
        upd = (mf / c1).div_(denom)
        del denom
        upd.add_(p.float() * opt.weight_decay)
        upd.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(upd)
        else:
            p.copy_(p.float() - upd)
        del upd
        if mf is not m:
            m.copy_(mf)
        if vf is not v:
            v.copy_(vf)
    return params, state, {"grad_norm": gnorm, "lr": lr.to(torch.float32)}


def _tree(seed, dtype=torch.float32, scale=0.02, device="cpu"):
    return {f"leaf{i:02d}": _randn(seed + i, s, dtype, scale).to(device) for i, s in enumerate(SHAPES)}


def _grad_scale(clip):
    """(clip_norm, gradient scale): the trees' gradients have a norm of about
    40 at scale 0.1, so 1.0 clips them and 1e6 does not; 0 turns the clip
    off."""
    return {"engaged": (1.0, 0.1), "not engaged": (1e6, 0.1), "off": (0.0, 0.1)}[clip]


# ------------------------------------------------------------------ the CPU
@pytest.mark.parametrize("numels", [RAGGED, RAGGED[::-1], [65536 + 5], [0, 0, 1], [0, 3, 0, 0, 16385, 0]])
def test_chunks_cover_every_element_once(numels):
    first, total = tadamw.first_chunks(numels)
    assert total == sum(-(-n // tadamw.CHUNK) for n in numels) and first[0] == 0
    spans = tadamw.chunk_spans(numels)
    assert len(spans) == total
    seen = [np.zeros(n, np.int64) for n in numels]
    for leaf, start, end in spans:
        assert 0 <= start < end <= start + tadamw.CHUNK and start % tadamw.CHUNK == 0
        seen[leaf][start:end] += 1
    assert all((s == 1).all() for s in seen)
    assert [s[0] for s in spans] == sorted(s[0] for s in spans)  # leaf after leaf


@pytest.mark.parametrize("clip", ["engaged", "not engaged", "off"])
@pytest.mark.parametrize("param_dtype,state_dtype", [(torch.float32, None),
                                                     (torch.float32, "bfloat16"),
                                                     (torch.bfloat16, None)])
def test_cpu_update_is_the_former_loop_bit_for_bit(param_dtype, state_dtype, clip):
    clip_norm, gscale = _grad_scale(clip)
    kw = dict(weight_decay=0.1, clip_norm=clip_norm, state_dtype=state_dtype)
    new_opt = toptim.AdamW(lr=toptim.cosine_schedule(1e-2, 2, STEPS), **kw)
    old_opt = toptim.AdamW(lr=toptim.cosine_schedule(1e-2, 2, STEPS), **kw)
    p_new, p_old = _tree(0, param_dtype), _tree(0, param_dtype)
    s_new, s_old = new_opt.init(p_new), old_opt.init(p_old)
    for i in range(STEPS):
        g_new, g_old = _tree(100 + 10 * i, param_dtype, gscale), _tree(100 + 10 * i, param_dtype, gscale)
        _, _, m_new = new_opt.update(g_new, s_new, p_new)
        _, _, m_old = _former_update(old_opt, g_old, s_old, p_old)
        assert torch.equal(m_new["grad_norm"], m_old["grad_norm"])
        assert torch.equal(m_new["lr"], m_old["lr"])
        for a, b in zip(toptim.tree_leaves(g_new), toptim.tree_leaves(g_old)):
            assert torch.equal(a, b)  # the plain version clips in place, as the loop did
    if clip == "engaged":
        assert float(m_new["grad_norm"]) > clip_norm
    for part in ("m", "v"):
        for a, b in zip(toptim.tree_leaves(s_new[part]), toptim.tree_leaves(s_old[part])):
            assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(toptim.tree_leaves(p_new), toptim.tree_leaves(p_old)):
        assert a.dtype == param_dtype and torch.equal(a, b)
    assert int(s_new["step"]) == STEPS


@pytest.mark.parametrize("lr", [3e-4, toptim.cosine_schedule(1e-3, 2, 10)])
def test_update_returns_its_metrics_as_before(lr):
    opt = toptim.AdamW(lr=lr)
    params = _tree(1)
    state = opt.init(params)
    grads = _tree(2, scale=0.1)
    p2, s2, metrics = opt.update(grads, state, params)
    assert p2 is params and s2 is state
    assert set(metrics) == {"grad_norm", "lr"}
    for v in metrics.values():
        assert isinstance(v, torch.Tensor) and v.shape == () and v.dtype == torch.float32
        assert v.device == torch.device("cpu")
    want_lr = lr if isinstance(lr, float) else float(lr(torch.tensor(1, dtype=torch.int32)))
    assert float(metrics["lr"]) == float(torch.tensor(want_lr, dtype=torch.float32))


def test_meta_leaves_take_the_plain_version():
    """The launch dry run updates DTensors on the meta device: no kernel."""
    opt = toptim.AdamW(lr=3e-4, state_dtype="float32")
    params = {k: torch.empty(v.shape, device="meta") for k, v in _tree(0).items()}
    state = opt.init(params)
    grads = {k: torch.empty(v.shape, device="meta") for k, v in params.items()}
    before = tadamw.launches
    _, _, metrics = opt.update(grads, state, params)
    assert tadamw.launches == before
    assert metrics["grad_norm"].device.type == "meta"


#: byte offsets of the two leaves carved from one buffer (16-byte aligned),
#: so that trees of other lengths and dtypes share their pointers
CARVE_AT, CARVE_BYTES = (0, 400000), 800000


def _carved(buf, numels, dtype):
    """Leaves of ``numels`` elements of ``dtype``, views of the byte buffer
    ``buf`` at ``CARVE_AT``: the same pointers whatever the lengths."""
    size = torch.empty((), dtype=dtype).element_size()
    return [buf[at:at + n * size].view(dtype) for at, n in zip(CARVE_AT, numels)]


@pytest.mark.parametrize("second", [((20000, 99000), torch.float32), ((70000, 1000), torch.bfloat16),
                                    ((20000, 99000), torch.bfloat16)])
def test_tree_rebuilt_at_a_freed_trees_pointers_gets_its_own_table(second):
    """The checked trees are kept by what the kernel's table holds: a tree
    at the pointers of an earlier one, with other lengths or state dtypes,
    is checked anew and gets its own lengths and dtype codes."""
    dev = torch.device("cpu")
    pbuf, mbuf, vbuf = (torch.zeros(CARVE_BYTES, dtype=torch.uint8) for _ in range(3))

    def tree(numels, state_dtype):
        p = _carved(pbuf, numels, torch.float32)
        return p, [torch.zeros_like(x) for x in p], _carved(mbuf, numels, state_dtype), \
            _carved(vbuf, numels, state_dtype)

    old_p, old_g, old_m, old_v = tree((70000, 1000), torch.float32)
    assert tadamw._tree(old_p, old_g, old_m, old_v, dev).numels == (70000, 1000)
    numels, state_dtype = second
    params, grads, ms, vs = tree(numels, state_dtype)
    assert [x.data_ptr() for x in params + ms + vs] == [x.data_ptr() for x in old_p + old_m + old_v]
    got = tadamw._tree(params, grads, ms, vs, dev)
    assert got.numels == numels and got.nchunks == tadamw.first_chunks(numels)[1]
    code = tadamw._CODE[torch.float32] | tadamw._CODE[torch.float32] << 1 | tadamw._CODE[state_dtype] << 2
    assert got.rows[3::tadamw.LEAF_WORDS] == list(numels)
    assert got.rows[4::tadamw.LEAF_WORDS] == [code] * len(numels)
    # a state of another length at a known tree's pointers is refused
    bad_m = _carved(mbuf, (numels[0], numels[1] - 1), state_dtype)
    with pytest.raises(ValueError, match="do not match"):
        tadamw._tree(params, grads, bad_m, vs, dev)


def test_gradient_of_another_length_than_its_known_tree_is_refused():
    """A step's gradients are held to the lengths of the tree kept for
    their p, m and v, before anything is launched."""
    p = [torch.zeros(5000), torch.zeros(300)]
    m, v = [torch.zeros_like(x) for x in p], [torch.zeros_like(x) for x in p]
    tadamw._tree(p, [torch.zeros_like(x) for x in p], m, v, torch.device("cpu"))
    one = torch.ones((), dtype=torch.float32)
    with pytest.raises(ValueError, match="299 elements, its param 300"):
        tadamw._launch(p, [torch.zeros(5000), torch.zeros(299)], m, v, lr=one, c1=one, c2=one,
                       b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0)


# ----------------------------------------------------------------- the card
def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_tree(seed, dtype, scale, dev):
    """The ragged tree on the card, plus one leaf that starts 4 bytes past
    a 16-byte boundary (element loads only)."""
    tree = _tree(seed, dtype, scale, dev)
    tree["odd"] = _randn(seed + 99, (5000,), dtype, scale).to(dev)
    buf = torch.empty(5001, dtype=dtype, device=dev)
    buf[1:].copy_(tree["odd"])
    tree["odd"] = buf[1:]
    return tree


def _leaves(tree):
    return toptim.tree_leaves(tree)


def _scalars(step, dev):
    lr = toptim.cosine_schedule(1e-2, 2, STEPS)(torch.tensor(step, dtype=torch.int32, device=dev))
    stepf = torch.tensor(float(step), dtype=torch.float32, device=dev)
    c1 = 1.0 - torch.pow(torch.full((), 0.9, dtype=torch.float32, device=dev), stepf)
    c2 = 1.0 - torch.pow(torch.full((), 0.95, dtype=torch.float32, device=dev), stepf)
    return dict(lr=lr.to(torch.float32), c1=c1, c2=c2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _ulps(got, want) -> int:
    """The most bf16 steps between two bf16 tensors, element by element."""
    def key(x):
        bits = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits + 32768), bits)
    return int((key(got) - key(want)).abs().max()) if got.numel() else 0


def _close(got, want, rel):
    """bf16 within one step; fp32 within ``rel`` of the leaf's largest magnitude."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if not got.numel():
        return
    if got.dtype == torch.bfloat16:
        assert _ulps(got, want) <= 1
    else:
        assert float((got - want).abs().max()) <= rel * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("clip", ["engaged", "not engaged", "off"])
@pytest.mark.parametrize("param_dtype,state_dtype", [(torch.float32, torch.float32),
                                                     (torch.float32, torch.bfloat16),
                                                     (torch.bfloat16, torch.bfloat16),
                                                     (torch.bfloat16, torch.float32)])
def test_kernel_matches_plain_over_five_steps(param_dtype, state_dtype, clip):
    dev = _card()
    clip_norm, gscale = _grad_scale(clip)
    pk = _card_tree(0, param_dtype, 0.02, dev)
    pp = {k: v.clone() for k, v in pk.items()}
    mk = {k: _randn(50 + i, v.shape, state_dtype, 0.01).to(dev) for i, (k, v) in enumerate(pk.items())}
    vk = {k: _randn(70 + i, v.shape, torch.float32, 0.01).square().to(state_dtype).to(dev)
          for i, (k, v) in enumerate(pk.items())}
    mp, vp = ({k: v.clone() for k, v in t.items()} for t in (mk, vk))
    for step in range(1, STEPS + 1):
        gk = _card_tree(100 + 10 * step, param_dtype, gscale, dev)
        gp = {k: v.clone() for k, v in gk.items()}
        g0 = {k: v.clone() for k, v in gk.items()}
        before, leaves = tadamw.launches, tadamw.leaves
        nk = tadamw.adamw_update(_leaves(pk), _leaves(gk), _leaves(mk), _leaves(vk),
                                 clip_norm=clip_norm, **_scalars(step, dev))
        assert tadamw.launches == before + 3 and tadamw.leaves == leaves + len(pk)
        np_ = tadamw.adamw_plain(_leaves(pp), _leaves(gp), _leaves(mp), _leaves(vp),
                                 clip_norm=clip_norm, **_scalars(step, dev))
        assert nk.shape == () and nk.dtype == torch.float32 and nk.is_cuda
        torch.testing.assert_close(nk, np_, rtol=1e-6, atol=0)
        if clip == "engaged":
            assert float(np_) > clip_norm
        assert all(torch.equal(gk[k], g0[k]) for k in gk)  # the clipped gradient is not written back
    # with bf16 moments a moment one bf16 step apart moves the update by as
    # much, so fp32 parameters agree to a bf16 step of their scale
    rel = 1e-6 if state_dtype == torch.float32 else 2.0 ** -8
    for got, want in ((pk, pp), (mk, mp), (vk, vp)):
        for k in got:
            _close(got[k], want[k], rel)


@pytest.mark.cuda
def test_kernel_norm_repeats_bit_for_bit():
    dev = _card()
    outs = []
    for _ in range(2):
        p, g = _card_tree(0, torch.float32, 0.02, dev), _card_tree(1, torch.float32, 0.1, dev)
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v_ = {k: torch.zeros_like(v) for k, v in p.items()}
        norm = tadamw.adamw_update(_leaves(p), _leaves(g), _leaves(m), _leaves(v_), clip_norm=1.0,
                                   **_scalars(1, dev))
        outs.append((norm, p))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(outs[0][1][k], outs[1][1][k]) for k in outs[0][1])


@pytest.mark.cuda
def test_kernel_refuses_mixed_devices_and_strided_leaves():
    dev = _card()
    p = _card_tree(0, torch.float32, 0.02, dev)
    g = _card_tree(1, torch.float32, 0.1, dev)
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    kw = dict(clip_norm=1.0, **_scalars(1, dev))
    before = tadamw.launches
    mixed = dict(g, leaf02=g["leaf02"].cpu())
    with pytest.raises(ValueError, match="CUDA device"):
        tadamw.adamw_update(_leaves(p), _leaves(mixed), _leaves(m), _leaves(v), **kw)
    strided = dict(g, leaf04=g["leaf04"].t().contiguous().t())
    with pytest.raises(ValueError, match="contiguous"):
        tadamw.adamw_update(_leaves(p), _leaves(strided), _leaves(m), _leaves(v), **kw)
    halves = dict(g, leaf01=g["leaf01"].half())
    with pytest.raises(ValueError, match="dtype"):
        tadamw.adamw_update(_leaves(p), _leaves(halves), _leaves(m), _leaves(v), **kw)
    assert tadamw.launches == before


@pytest.mark.cuda
def test_update_of_412_leaves_takes_at_most_8_launches():
    dev = _card()
    rng = np.random.RandomState(0)
    opt = toptim.AdamW(lr=toptim.cosine_schedule(1e-3, 2, 10))
    params = {f"w{i:03d}": _randn(i, (int(rng.randint(1, 70000)),)).to(dev) for i in range(412)}
    state = opt.init(params)
    for step in range(2):
        grads = {k: torch.randn_like(v) for k, v in params.items()}
        before, leaves = tadamw.launches, tadamw.leaves
        opt.update(grads, state, params)
        assert tadamw.launches - before <= 8 and tadamw.launches - before == 3
        assert tadamw.leaves - leaves == 412


@pytest.mark.cuda
def test_update_syncs_nothing_with_the_host():
    dev = _card()
    opt = toptim.AdamW(lr=toptim.cosine_schedule(1e-3, 2, 10))
    params = _card_tree(0, torch.float32, 0.02, dev)
    state = opt.init(params)
    grads = [_card_tree(10 + i, torch.float32, 0.1, dev) for i in range(3)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for g in grads:
            _, _, metrics = opt.update(g, state, params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert metrics["grad_norm"].is_cuda and metrics["lr"].is_cuda
    assert np.isfinite(float(metrics["grad_norm"]))


@pytest.mark.cuda
def test_kernel_on_a_tree_rebuilt_at_a_freed_trees_pointers():
    """A tree freed and built again at the same pointers with other lengths
    and a bf16 state: the kernel updates the new leaves as the plain version
    does and writes nothing past their ends."""
    dev = _card()
    bufs = [torch.full((CARVE_BYTES,), 0x7F, dtype=torch.uint8, device=dev) for _ in range(3)]
    for numels, state_dtype in (((70000, 1000), torch.float32), ((20000, 99000), torch.bfloat16)):
        params = _carved(bufs[0], numels, torch.float32)
        ms, vs = _carved(bufs[1], numels, state_dtype), _carved(bufs[2], numels, state_dtype)
        for i, (p, m, v) in enumerate(zip(params, ms, vs)):
            p.copy_(_randn(i, p.shape, scale=0.02))
            m.copy_(_randn(10 + i, p.shape, scale=0.01))
            v.copy_(_randn(20 + i, p.shape, scale=0.01).square())
        before = [b.clone() for b in bufs]
        grads = [_randn(30 + i, p.shape, scale=0.1).to(dev) for i, p in enumerate(params)]
        pp, mp, vp = ([x.clone() for x in xs] for xs in (params, ms, vs))
        tadamw.adamw_plain(pp, [g.clone() for g in grads], mp, vp, clip_norm=1.0, **_scalars(1, dev))
        tadamw.adamw_update(params, grads, ms, vs, clip_norm=1.0, **_scalars(1, dev))
        rel = 1e-6 if state_dtype == torch.float32 else 2.0 ** -8
        for got, exp in ((params, pp), (ms, mp), (vs, vp)):
            for a, b in zip(got, exp):
                _close(a, b, rel)
        for buf, old, xs in zip(bufs, before, (params, ms, vs)):
            untouched = torch.ones(CARVE_BYTES, dtype=torch.bool, device=dev)
            for at, x in zip(CARVE_AT, xs):
                untouched[at:at + x.numel() * x.element_size()] = False
            assert torch.equal(buf[untouched], old[untouched])
        del params, ms, vs, grads
