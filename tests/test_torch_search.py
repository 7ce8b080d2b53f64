"""The port's search core (repro_torch.core) follows the JAX package's
(repro.core) trajectories bit for bit: the optimizers' ask()/tell() points,
and the Autotuning driver's history and best point under a deterministic
cost, for several seeds and spaces."""
import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore


def _cost(z) -> float:
    """Deterministic multimodal cost over the optimizer's [-1, 1] domain."""
    z = np.asarray(z, dtype=float)
    return float(np.sum((z - 0.3) ** 2) + 0.1 * np.sum(np.cos(7.0 * z)))


def _point_cost(p: dict) -> float:
    """Deterministic cost of a decoded point (values of any dim kind)."""
    vals = [float(v) if not isinstance(v, str) else float(len(v)) for v in p.values()]
    return _cost(np.log2(np.abs(vals) + 1.0) / 8.0)


def _trajectory(core, kind: str, dim: int, seed: int):
    if kind == "csa":
        opt = core.CSA(dim, num_opt=3, max_iter=6, seed=seed)
    else:
        opt = core.NelderMead(dim, max_iter=25, seed=seed)
    asked = []
    while not opt.is_end():
        zs = opt.ask()
        if not zs:
            break
        asked.append(np.array(zs))
        opt.tell([_cost(z) for z in zs])
    return asked, np.asarray(opt.best_solution), opt.best_cost


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("kind", ["csa", "nm"])
def test_ask_tell_trajectory_bit_identical(kind, dim, seed):
    j_asked, j_best, j_cost = _trajectory(jcore, kind, dim, seed)
    t_asked, t_best, t_cost = _trajectory(tcore, kind, dim, seed)
    assert len(j_asked) == len(t_asked) > 0
    for ja, ta in zip(j_asked, t_asked):
        np.testing.assert_array_equal(ja, ta)
    np.testing.assert_array_equal(j_best, t_best)
    assert j_cost == t_cost


def _space(core, which: str):
    if which == "tiles":
        return core.SearchSpace([core.LogIntDim("bm", 16, 256), core.LogIntDim("bn", 16, 256),
                                 core.IntDim("unroll", 1, 8)])
    if which == "mixed":
        return core.SearchSpace([core.ChoiceDim("impl", ("a", "bb", "ccc")),
                                 core.FloatDim("frac", 0.0, 1.0), core.IntDim("k", -4, 4)])
    return core.SearchSpace.uniform(-8, 8, 2)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("space", ["uniform", "tiles", "mixed"])
@pytest.mark.parametrize("mode", ["entire_exec", "entire_exec_batch"])
def test_autotuning_same_history_and_best(mode, space, seed):
    out = {}
    for name, core in (("jax", jcore), ("torch", tcore)):
        at = core.Autotuning(space=_space(core, space), num_opt=3, max_iter=5, seed=seed, cache=True)
        if mode == "entire_exec":
            at.entire_exec(lambda *vals, at=at: _point_cost(at.point))
        else:
            at.entire_exec_batch(lambda pts: [_point_cost(p) for p in pts])
        out[name] = (at.history, at.best_point, at.best_cost, at.num_evals, at.strategy)
    assert out["jax"] == out["torch"]
    assert len(out["torch"][0]) > 0
