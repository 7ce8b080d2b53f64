"""The port's serving runtime (OnlineTuner, DriftDetector, ContextRouter)
against the JAX package's, decision for decision.

Both packages are driven by the same deterministic cost stream (no wall
clock, no RNG: the ε-scheduler is a credit counter and the search is seeded)
and must explore and exploit the same points in the same order, fire drift
at the same request, and commit the same point to the tuning DB.
"""
import dataclasses
import itertools

import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import repro.core as jcore
import repro.runtime as jruntime
import repro.tuning as jtuning
import repro_torch.core as tcore
import repro_torch.runtime as truntime
import repro_torch.tuning as ttuning

PKGS = {"jax": (jcore, jruntime, jtuning), "torch": (tcore, truntime, ttuning)}


def _cost(point):
    return float((point["p"] - 11) ** 2 + 1)


def _online_trace(pkg, epsilon):
    core, runtime, tuning = PKGS[pkg]
    space = core.SearchSpace([core.IntDim("p", 1, 32)])
    db = tuning.TuningDB(None)
    key = tuning.make_key("online", space=space, extra={"case": epsilon},
                          backend="cpu", device_kind="cpu")
    at = core.Autotuning(space=space, ignore=0, search=core.CSA(1, num_opt=3, max_iter=4, seed=0),
                         cache=True, db=db, key=key)
    tuner = runtime.OnlineTuner(
        at, epsilon=epsilon, default_point={"p": 4},
        drift=runtime.DriftDetector(window=4, min_samples=2, factor=1.5),
    )
    trace, levels = [], []
    for i in range(160):
        d = tuner.begin()
        cost = _cost(d.point)
        if d.kind == runtime.EXPLOIT and i >= 100:
            cost *= 4.0  # the environment degrades: drift must fire
        levels.append(tuner.observe(d, cost))
        trace.append((d.kind, dict(d.point)))
    rec = db.get(key)
    return trace, levels, tuner.best_point, rec.point if rec else None, tuner.stats()["drift_resets"]


@pytest.mark.parametrize("epsilon", [0.25, 0.5, 1.0])
def test_online_tuner_decides_like_jax(epsilon):
    jt, jl, jbest, jrec, jresets = _online_trace("jax", epsilon)
    tt, tl, tbest, trec, tresets = _online_trace("torch", epsilon)
    assert tt == jt
    assert tl == jl
    assert tbest == jbest and trec == jrec and trec is not None
    assert tresets == jresets


def test_drift_detector_levels_like_jax():
    stream = [1.0] * 8 + [1.2, 1.7, 1.8, 3.5, 3.6, 1.0, float("inf"), 2.0, 2.1, 5.0, 5.5, 0.9]
    out = {}
    for pkg, (_, runtime, _) in PKGS.items():
        dd = runtime.DriftDetector(window=4, min_samples=2, factor=1.5, severe_factor=3.0)
        out[pkg] = ([dd.observe(c) for c in stream], dd.events, dd.stats())
    assert out["torch"] == out["jax"]
    assert any(out["torch"][0])


def _router_trace(pkg):
    core, runtime, tuning = PKGS[pkg]
    db = tuning.TuningDB(None)
    router = runtime.ContextRouter(db=db, jobs=2)
    space = core.SearchSpace([core.ChoiceDim("k", (1, 2, 4, 8))])
    router.register(
        "serve/decode_k", space=lambda: space, build=lambda point: (lambda: point["k"]),
        defaults=lambda: {"k": 1}, epsilon=0.25, num_opt=3, max_iter=4,
        drift={"window": 8, "min_samples": 4, "factor": 1.5}, extra={"arch": "tiny"},
    )
    tuner = router.tuner("serve/decode_k")
    tuner.prewarm([{"k": k} for k in (1, 2, 4, 8)], wait=True)
    trace = []
    for _ in range(80):
        d = router.begin("serve/decode_k")
        k = int(d.point["k"])
        ran = d.executable() if d.executable is not None else None
        router.observe(d, 1.0 / k + 0.05 * k)
        trace.append((d.kind, k, ran))
    stats = router.stats()
    return trace, tuner.best_point, (stats["explores"], stats["exploits"]), [r.point for r in db.records()]


def test_context_router_decides_like_jax():
    jt, jbest, jcounts, jrecs = _router_trace("jax")
    tt, tbest, tcounts, trecs = _router_trace("torch")
    assert tt == jt
    assert tbest == jbest and tcounts == jcounts
    assert trecs == jrecs and trecs


# ----------------------------------------------------------- kernel routing
def test_kernel_router_rejects_conflicting_singleton_config():
    from repro_torch.kernels.autotuned import kernel_router

    r1 = kernel_router(interpret=True, epsilon=0.1)
    assert kernel_router(interpret=True) is r1  # default args: same singleton
    with pytest.raises(ValueError):
        kernel_router(interpret=True, epsilon=0.5)
    with pytest.raises(ValueError):
        kernel_router(interpret=True, db=ttuning.TuningDB(None))
    assert kernel_router(interpret=True, epsilon=0.5, fresh=True) is not r1


def _routed_args(name):
    import numpy as np
    import torch

    def rnd(seed, *shape):
        return torch.from_numpy(np.random.RandomState(seed).standard_normal(shape).astype(np.float32))

    if name == "decode_attention":
        valid = torch.from_numpy((np.arange(256) < 200).astype(np.int32))[None].repeat(2, 1)
        return (rnd(0, 2, 4, 16), rnd(1, 2, 2, 256, 16), rnd(2, 2, 2, 256, 16), valid), {}
    if name == "matmul":
        return (rnd(0, 64, 128), rnd(1, 128, 64)), {}
    if name == "flash_attention":
        return (rnd(0, 1, 64, 2, 16), rnd(1, 1, 2, 64, 16), rnd(2, 1, 2, 64, 16)), {"causal": True}
    if name == "lru_scan":
        return (torch.sigmoid(rnd(0, 2, 64, 32)), rnd(1, 2, 64, 32), rnd(2, 2, 32)), {}
    return ((rnd(0, 1, 32, 2, 8), rnd(1, 1, 32, 2, 8), rnd(2, 1, 32, 2, 8),
             -torch.exp(rnd(3, 1, 32, 2, 8)), rnd(4, 2, 8), rnd(5, 1, 2, 8, 8)), {})


@pytest.mark.parametrize("name", ["decode_attention", "matmul", "flash_attention", "lru_scan",
                                  "rwkv_scan"])
def test_routed_serves_the_kernel_at_the_decided_knobs(name):
    """On the CPU (plain versions): every routed output is the kernel's at
    one point of the space, the output after the search equals the kernel
    at the committed point, and the router's accounting balances."""
    import torch

    from repro_torch.kernels.autotuned import get_spec, kernel_router, routed

    spec = get_spec(name)
    db = ttuning.TuningDB(None)
    router = kernel_router(interpret=True, db=db, epsilon=0.5, fresh=True, jobs=2)
    args, kw = _routed_args(name)
    space = spec.space(*args, **kw)
    axes = [[1 << e for e in range(d.lo.bit_length() - 1, d.hi.bit_length())] for d in space.dims]
    by_point = {}
    for values in itertools.product(*axes):
        p = dict(zip(space.names, values))
        by_point[space.key(p)] = spec.fn(*args, **kw, **p, interpret=True)

    def match(out):
        outs = out if isinstance(out, tuple) else (out,)
        for ref in by_point.values():
            refs = ref if isinstance(ref, tuple) else (ref,)
            if all(torch.equal(a, b) for a, b in zip(outs, refs)):
                return True
        return False

    for _ in range(200):
        out = routed(name, *args, router=router, interpret=True, **kw)
        assert match(out)
        if router.stats()["searches_completed"]:
            break
        router.wait_pending()  # let the pool's knob checks land between calls
    st = router.stats()
    assert st["searches_completed"] == 1 and st["contexts"] == 1
    assert st["calls"] == st["explores"] + st["exploits"]
    assert st["explore_candidates"] == st["explore_reps_decided"] <= st["explores"]
    assert st["inband_builds"] == 0
    (rec,) = db.records()
    final = routed(name, *args, router=router, interpret=True, **kw)
    ref = spec.fn(*args, **kw, **rec.point, interpret=True)
    for a, b in zip(final if isinstance(final, tuple) else (final,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert torch.equal(a, b)


def test_routed_absorbs_knobs_illegal_for_an_off_bucket_shape():
    """S = 96 shares the bucket of 128, whose space holds block_kv 64: the
    pool's knob check refuses it for 96 (not divisible), the tuner charges
    it inf without serving a call on it, and every call still returns."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.autotuned import kernel_router, routed

    (q, k, v, _), _ = _routed_args("decode_attention")
    k, v = k[:, :, :96].contiguous(), v[:, :, :96].contiguous()
    valid = torch.ones(2, 96, dtype=torch.int32)
    router = kernel_router(interpret=True, db=ttuning.TuningDB(None), epsilon=1.0, fresh=True)
    # The same route without drift detection: a slow CPU sample under load
    # would otherwise reset the finished search and start a second one.
    spec = router.spec("decode_attention")
    fields = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    router.register(fields.pop("name"), **{**fields, "drift": None})
    for _ in range(40):
        out = routed("decode_attention", q, k, v, valid, router=router, interpret=True)
        np.testing.assert_allclose(out.numpy(), ref.decode_attention_ref(q, k, v, 96).numpy(),
                                   atol=2e-4, rtol=2e-4)
        router.wait_pending()
    st = router.stats()
    assert st["candidate_failures"] >= 1 and st["searches_completed"] == 1
    assert st["drift_resets"] == 0
    assert st["calls"] == st["explores"] + st["exploits"]


def test_router_context_key_names_the_card_of_the_call(monkeypatch):
    """Bucketing keeps the tensor's device, so a context routed on the card
    is keyed with the card (and exact-hits the card's pretuned records)."""
    import torch

    class OnCard:
        shape, dtype, device = (60, 16), torch.float32, torch.device("cuda", 0)

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "Test Card")
    router = truntime.ContextRouter(db=ttuning.TuningDB(None))
    router.register("k", space=lambda x: tcore.SearchSpace([tcore.IntDim("p", 1, 4)]))
    key = router.context_key("k", (OnCard(),))
    assert (key.backend, key.device_kind) == ("cuda", "Test Card")
    assert key.shapes() == [[64, 16]]
