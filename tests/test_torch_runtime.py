"""The port's serving runtime (OnlineTuner, DriftDetector, ContextRouter)
against the JAX package's, decision for decision.

Both packages are driven by the same deterministic cost stream (no wall
clock, no RNG: the ε-scheduler is a credit counter and the search is seeded)
and must explore and exploit the same points in the same order, fire drift
at the same request, and commit the same point to the tuning DB.
"""
import pytest

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
