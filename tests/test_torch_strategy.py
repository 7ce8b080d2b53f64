"""The port's search strategies (``repro_torch.core.strategy`` and
``grid_random``) follow the JAX package's bit for bit: the same spec, seed
and deterministic costs give the same asked points, the same bests and the
same ``strategy_label``; the ShardedPortfolio race ends as the serial
Portfolio does; and ``tune_call``/``Autotuning`` take spec strings as the
JAX package does.
"""
import math
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch

import repro.core as jcore
import repro.tuning as jtuning
import repro_torch.core as tcore
import repro_torch.tuning as ttuning
from repro.core.measure import NoiseEstimate as JNoise
from repro_torch.core.measure import NoiseEstimate as TNoise

PKGS = {"jax": (jcore, JNoise), "torch": (tcore, TNoise)}
jat = import_module("repro.kernels.autotuned")
tat = import_module("repro_torch.kernels.autotuned")

#: every spec tests/test_strategy.py builds through make_strategy
SPECS = ["csa", "nm", "random", "grid", "csa+nm", "csa:0.6+nm:0.4", "csa:0.7+nm:0.3",
         "csa|nm", "csa+nm|random", "grid|csa"]


def _cost(z) -> float:
    z = np.asarray(z, dtype=float)
    return float(np.sum((z - 0.3) ** 2) + 0.05 * np.cos(8.0 * z[0]))


def _drive(opt, cost=_cost, limit=10_000):
    """Ask/tell to the end; the asked batches, bests and tells."""
    asked = []
    while not opt.is_end() and len(asked) < limit:
        zs = opt.ask()
        if not zs:
            break
        asked.append(np.array(zs))
        opt.tell([cost(z) for z in zs])
    return asked


def _same_run(j, t, jopt, topt):
    assert len(j) == len(t) > 0
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(jopt.best_solution), np.asarray(topt.best_solution))
    assert jopt.best_cost == topt.best_cost


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("spec", SPECS)
def test_make_strategy_trajectory_and_label_bit_identical(spec, dim):
    opts = {p: core.make_strategy(spec, dim, num_opt=4, max_iter=6, seed=5)
            for p, (core, _) in PKGS.items()}
    runs = {p: _drive(o) for p, o in opts.items()}
    _same_run(runs["jax"], runs["torch"], opts["jax"], opts["torch"])
    labels = {p: PKGS[p][0].strategy_label(o) for p, o in opts.items()}
    assert labels["torch"] == labels["jax"]
    assert getattr(opts["torch"], "spec", None) == getattr(opts["jax"], "spec", None)


def _build(core, noise_cls, which):
    if which == "grid":
        return core.GridSearch(2, points_per_dim=5)
    if which == "random":
        return core.RandomSearch(2, max_iter=30, seed=3)
    if which == "pipeline":
        return core.Pipeline([core.CSA(2, num_opt=4, max_iter=10, seed=1),
                              core.NelderMead(2, error=0.0, max_iter=40, seed=2)],
                             (0.75, 0.25), budget=40)
    if which == "pipeline_grid":
        return core.Pipeline([core.GridSearch(1, points_per_dim=4),
                              core.NelderMead(1, error=0.0, max_iter=40, seed=0)],
                             (0.5, 0.5), budget=16)
    if which == "portfolio":
        return core.Portfolio([core.CSA(2, num_opt=4, max_iter=10, seed=0),
                               core.RandomSearch(2, max_iter=1000, seed=0)],
                              budget=60, noise=noise_cls(0.0, 0.0))
    if which == "portfolio_rung":
        return core.Portfolio([core.NelderMead(2, error=0.0, max_iter=40, seed=2),
                               core.RandomSearch(2, max_iter=1000, seed=0)],
                              budget=20, noise=noise_cls(1e9, 0.0), rung=2)
    raise ValueError(which)


@pytest.mark.parametrize("which", ["grid", "random", "pipeline", "pipeline_grid", "portfolio",
                                   "portfolio_rung"])
def test_combinators_bit_identical(which):
    opts = {p: _build(core, noise, which) for p, (core, noise) in PKGS.items()}
    runs = {p: _drive(o) for p, o in opts.items()}
    _same_run(runs["jax"], runs["torch"], opts["jax"], opts["torch"])
    if "portfolio" in which:
        assert opts["torch"].active == opts["jax"].active
        assert opts["torch"].member_bests == opts["jax"].member_bests
        assert opts["torch"].spent == opts["jax"].spent
    assert PKGS["torch"][0].strategy_label(opts["torch"]) == PKGS["jax"][0].strategy_label(opts["jax"])


@pytest.mark.parametrize("level", [0, 1, 2, "refine"])
def test_pipeline_resets_bit_identical(level):
    out = {}
    for p, (core, _) in PKGS.items():
        pipe = core.make_strategy("csa+nm", 2, num_opt=4, max_iter=8, seed=5)
        first = _drive(pipe, limit=5)
        if level == "refine":
            pipe.enter_refinement()
        else:
            pipe.reset(level)
        out[p] = (first, _drive(pipe), pipe)
    _same_run(out["jax"][0] + out["jax"][1], out["torch"][0] + out["torch"][1],
              out["jax"][2], out["torch"][2])


def test_portfolio_set_noise_bit_identical():
    out = {}
    for p, (core, noise) in PKGS.items():
        pf = core.Portfolio([core.RandomSearch(1, max_iter=1000, seed=1),
                             core.RandomSearch(1, max_iter=1000, seed=2)],
                            budget=24, noise=noise(1e9, 0.0))
        pf.set_noise(noise(0.0, 0.0))
        out[p] = (_drive(pf, cost=lambda z: float(z[0]) ** 2), pf)
    _same_run(out["jax"][0], out["torch"][0], out["jax"][1], out["torch"][1])
    assert out["torch"][1].active == out["jax"][1].active


@pytest.mark.parametrize("spec", ["csa+nm", "csa|nm", "random"])
def test_autotuning_with_spec_same_history(spec):
    out = {}
    for p, (core, _) in PKGS.items():
        at = core.Autotuning(space=core.SearchSpace([core.IntDim("p0", -10, 30),
                                                     core.LogIntDim("p1", 8, 512)]),
                             search=spec, num_opt=4, max_iter=5, seed=2, cache=True)
        at.entire_exec_batch(lambda pts: [float((q["p0"] - 4) ** 2 + math.log2(q["p1"]) % 3)
                                          for q in pts])
        out[p] = (at.history, at.best_point, at.best_cost, at.num_evals, at.strategy)
    assert out["torch"] == out["jax"]


def _members(core):
    return [core.CSA(2, num_opt=4, max_iter=10, seed=0), core.CSA(2, num_opt=4, max_iter=10, seed=1),
            core.RandomSearch(2, max_iter=40, seed=3),
            core.NelderMead(2, error=0.0, max_iter=40, seed=2)]


@pytest.mark.parametrize("budget", [80, None])
def test_sharded_portfolio_ends_as_the_serial_race(budget):
    serial = {}
    for p, (core, _) in PKGS.items():
        pf = core.Portfolio(_members(core), budget=budget, rung=4)
        _drive(pf)
        serial[p] = pf
    fleet = ttuning.ShardedPortfolio(_members(tcore), budget=budget, rung=4)
    res = fleet.run(lambda i, pts: [_cost(z) for z in pts])
    jres = jtuning.ShardedPortfolio(_members(jcore), budget=budget, rung=4).run(
        lambda i, pts: [_cost(z) for z in pts])
    for ref in (serial["torch"], serial["jax"]):
        assert res.survivors == ref.active
        assert res.spent == ref.spent
        for a, b in zip(res.member_bests, ref.member_bests):
            assert (np.isinf(a) and np.isinf(b)) or a == b
    assert (res.survivors, res.member_bests, res.member_spent, res.best_cost) == (
        jres.survivors, jres.member_bests, jres.member_spent, jres.best_cost)
    np.testing.assert_array_equal(res.best_x, jres.best_x)


def test_sharded_portfolio_validates():
    with pytest.raises(ValueError):
        ttuning.ShardedPortfolio([tcore.CSA(2, num_opt=2, max_iter=2)])
    with pytest.raises(ValueError):
        ttuning.ShardedPortfolio([tcore.CSA(2, num_opt=2, max_iter=2), tcore.CSA(3, num_opt=2, max_iter=2)])


def _knob_cost(bm, bn, bk) -> float:
    lm, ln, lk = math.log2(bm), math.log2(bn), math.log2(bk)
    return 1.0 + abs(lm - 6) * 1.3 + abs(ln - 5) + 0.7 * abs(lk - 7) + 0.25 * math.cos(lm * ln)


@pytest.fixture
def probe():
    name = "_torch_strategy_probe"

    def fn(a, b, *, bm, bn, bk, interpret=False):
        return a.sum() * 0.0 + _knob_cost(bm, bn, bk)

    jspec, tspec = jat.get_spec("matmul"), tat.get_spec("matmul")
    jat.register(jat.KernelSpec(name, fn, jspec.space, jspec.defaults))
    tat.register(tat.KernelSpec(name, fn, tspec.space, tspec.defaults, lambda a, b: (1.0, 1.0)))
    yield name
    jat._REGISTRY.pop(name, None)
    tat._REGISTRY.pop(name, None)


@pytest.mark.parametrize("measure", ["adaptive", "fixed"])
@pytest.mark.parametrize("spec", ["csa+nm", "csa|nm", "csa:0.7+nm:0.3"])
def test_tune_call_with_a_strategy_commits_what_jax_commits(probe, spec, measure):
    x, y = _np(0), _np(1)
    common = dict(interpret=True, num_opt=3, max_iter=4, seed=1, jobs=1, measure=measure,
                  strategy=spec, cost_fn=lambda ex, *a: float(np.asarray(ex(*a))))
    jrec = jat.tune_call(probe, jnp.asarray(x), jnp.asarray(y), db=jtuning.TuningDB(None), **common)
    trec = tat.tune_call(probe, torch.from_numpy(x), torch.from_numpy(y), db=ttuning.TuningDB(None),
                         **common)
    assert (trec.point, trec.cost, trec.evals, trec.strategy) == (
        jrec.point, jrec.cost, jrec.evals, jrec.strategy)
    assert trec.strategy == spec


def _np(seed):
    return np.random.RandomState(seed).standard_normal((256, 256)).astype(np.float32)


def test_tuning_facade_exports():
    """``repro_torch.tuning`` names what a tuning user needs, as the JAX
    package's facade does, resolving the cross-layer names lazily."""
    from repro_torch.core import Autotuning, MeasurePolicy, make_strategy
    from repro_torch.kernels.autotuned import autotuned, tune_call

    assert ttuning.Autotuning is Autotuning and ttuning.MeasurePolicy is MeasurePolicy
    assert ttuning.make_strategy is make_strategy
    assert ttuning.tune_call is tune_call and ttuning.autotuned is autotuned
    assert {"ShardedPortfolio", "FleetResult", "tune_call", "make_strategy"} <= set(ttuning.__all__)
    missing = set(jtuning.__all__) - set(ttuning.__all__)
    assert missing == {"device_bound_measure", "local_device_pool"}  # the parallel slice's
    with pytest.raises(AttributeError):
        ttuning.no_such_name
