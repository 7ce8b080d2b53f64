"""The port's tuning loop (tune_call -> TuningDB -> autotuned, and the pretune
CLI) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed.  A probe kernel registered in both
packages turns its knobs into a deterministic cost, so both tuning loops
must commit the same record; the DB files of either package load in the
other, and the port's keys equal the JAX package's character for character.
"""
import hashlib
import math
import re
from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch

import repro.tuning as jtuning
import repro_torch.tuning as ttuning
from repro_torch.core import FaultPolicy, SandboxUnavailable, block_until_ready, sandboxed_probe
from repro_torch.kernels import matmul as tmm
from repro_torch.tuning import pretune as tpretune

# the modules (each package's ``kernels.autotuned`` attribute is the function)
jat = import_module("repro.kernels.autotuned")
tat = import_module("repro_torch.kernels.autotuned")

PROBE = "_torch_parity_probe"


def _np(seed, shape):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _knob_cost(bm, bn, bk) -> float:
    """Deterministic multimodal cost of a matmul tile triple."""
    lm, ln, lk = math.log2(bm), math.log2(bn), math.log2(bk)
    return 1.0 + abs(lm - 6) * 1.3 + abs(ln - 5) + 0.7 * abs(lk - 7) + 0.25 * math.cos(lm * ln)


@pytest.fixture
def probe():
    """The matmul search space over a kernel whose output is its knobs' cost
    (tile 256x256 refused as an illegal tile), in both packages."""
    def jfn(a, b, *, bm, bn, bk, interpret=False):
        if bm == bn == 256:
            raise ValueError(f"tile {bm}x{bn} does not fit")
        return a.sum() * 0.0 + _knob_cost(bm, bn, bk)

    def tfn(a, b, *, bm, bn, bk, interpret=False):
        if bm == bn == 256:
            raise ValueError(f"tile {bm}x{bn} does not fit")
        return a.sum() * 0.0 + _knob_cost(bm, bn, bk)

    jspec, tspec = jat.get_spec("matmul"), tat.get_spec("matmul")
    jat.register(jat.KernelSpec(PROBE, jfn, jspec.space, jspec.defaults))
    tat.register(tat.KernelSpec(PROBE, tfn, tspec.space, tspec.defaults, lambda a, b: (1.0, 1.0)))
    yield
    jat._REGISTRY.pop(PROBE, None)
    tat._REGISTRY.pop(PROBE, None)


def _det_cost(ex, *args):
    return float(np.asarray(ex(*args)))


@pytest.mark.parametrize("measure", ["adaptive", "fixed"])
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_tune_call_commits_the_same_point_as_jax(probe, measure, seed):
    x, y = _np(0, (256, 512)), _np(1, (512, 256))
    common = dict(interpret=True, num_opt=3, max_iter=4, seed=seed, jobs=1, measure=measure,
                  cost_fn=_det_cost)
    jrec = jat.tune_call(PROBE, jnp.asarray(x), jnp.asarray(y), db=jtuning.TuningDB(None), **common)
    trec = tat.tune_call(PROBE, torch.from_numpy(x), torch.from_numpy(y), db=ttuning.TuningDB(None),
                         **common)
    assert trec is not None and jrec is not None
    assert trec.point == jrec.point
    assert trec.cost == jrec.cost
    assert (trec.evals, trec.crashed, trec.strategy) == (jrec.evals, jrec.crashed, jrec.strategy)
    assert trec.key.encode() == jrec.key.encode()


def test_tune_call_spec_strings_wait_for_the_strategy_module(probe):
    """The strategy module is ported: a spec string searches as in JAX."""
    x = _np(0, (64, 64))
    common = dict(interpret=True, strategy="csa+nm", cost_fn=_det_cost, jobs=1)
    trec = tat.tune_call(PROBE, torch.from_numpy(x), torch.from_numpy(x), db=ttuning.TuningDB(None),
                         **common)
    jrec = jat.tune_call(PROBE, jnp.asarray(x), jnp.asarray(x), db=jtuning.TuningDB(None), **common)
    assert trec.strategy == jrec.strategy == "csa+nm"
    assert (trec.point, trec.cost, trec.evals) == (jrec.point, jrec.cost, jrec.evals)


@pytest.mark.parametrize("measure", ["fixed", "adaptive"])
def test_every_build_of_a_round_finishes_before_its_first_measurement(measure):
    """A build launches the kernel on the device being timed, so no build may
    still run while a candidate is measured, whatever ``jobs`` is."""
    import threading
    import time

    lock, in_flight, seen = threading.Lock(), [0], []

    def slow(a, b, *, bm, bn, bk, interpret=False):
        with lock:
            in_flight[0] += 1
        time.sleep(0.002 * math.log2(bm * bn * bk))  # builds end at different times
        with lock:
            in_flight[0] -= 1
        return a.sum() * 0.0 + _knob_cost(bm, bn, bk)

    def cost(ex, *args):
        with lock:
            seen.append(in_flight[0])
        return _det_cost(ex, *args)

    name = f"_torch_build_probe_{measure}"
    tspec = tat.get_spec("matmul")
    tat.register(tat.KernelSpec(name, slow, tspec.space, tspec.defaults, lambda a, b: (1.0, 1.0)))
    try:
        a, b = torch.from_numpy(_np(6, (256, 512))), torch.from_numpy(_np(7, (512, 256)))
        rec = tat.tune_call(name, a, b, db=ttuning.TuningDB(None), interpret=True, jobs=4,
                            measure=measure, cost_fn=cost, num_opt=3, max_iter=4, seed=3)
    finally:
        tat._REGISTRY.pop(name, None)
    assert rec is not None and seen
    assert seen == [0] * len(seen)  # no build in flight at any measurement


def _counting_plain(monkeypatch):
    calls = []
    plain = tmm.matmul_plain

    def counted(a, b, **knobs):
        calls.append(dict(knobs))
        return plain(a, b, **knobs)

    monkeypatch.setattr(tmm, "matmul_plain", counted)
    return calls


def test_autotuned_replays_the_tuned_record_with_one_dispatch(tmp_path, monkeypatch):
    a, b = torch.from_numpy(_np(2, (64, 128))), torch.from_numpy(_np(3, (128, 64)))
    db = ttuning.TuningDB(str(tmp_path / "db.json"))
    rec = tat.tune_call("matmul", a, b, db=db, interpret=True, max_iter=2, jobs=1)
    assert rec is not None and math.isfinite(rec.cost)
    assert (rec.key.backend, rec.key.device_kind) == ("cpu", "cpu")
    calls = _counting_plain(monkeypatch)
    out = tat.autotuned("matmul", a, b, db=ttuning.TuningDB(str(tmp_path / "db.json")),
                        interpret=True)
    assert calls == [rec.point]  # one dispatch at the stored knobs, no measurement
    torch.testing.assert_close(out, tmm.matmul_plain(a, b, **rec.point), rtol=0, atol=0)


def test_db_round_trips_between_the_packages(tmp_path):
    x, y = _np(4, (64, 64)), _np(5, (64, 32))
    tpath, jpath = str(tmp_path / "torch.json"), str(tmp_path / "jax.json")
    # port writes, JAX reads
    trec = tat.tune_call("matmul", torch.from_numpy(x), torch.from_numpy(y),
                         db=ttuning.TuningDB(tpath), interpret=True, max_iter=2, jobs=1)
    jdb = jtuning.TuningDB(tpath, autosave=False)
    jspace = jat.get_spec("matmul").space(jnp.asarray(x), jnp.asarray(y))
    jkey = jtuning.make_key("matmul", args=(jnp.asarray(x), jnp.asarray(y)), space=jspace,
                            extra={"interpret": True})
    got, exact = jdb.lookup(jkey)
    assert exact and got.point == trec.point and got.cost == trec.cost
    # JAX writes, port reads
    jrec = jat.tune_call("matmul", jnp.asarray(x), jnp.asarray(y), db=jtuning.TuningDB(jpath),
                         interpret=True, max_iter=2, jobs=1)
    tdb = ttuning.TuningDB(jpath, autosave=False)
    got, exact = tdb.lookup(trec.key)
    assert exact and got.point == jrec.point and got.to_json() == jrec.to_json()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["matmul", "flash", "flash_causal_kwarg"])
def test_make_key_equals_jax_encode(case, dtype):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    shapes = [(128, 64), (64, 32)] if case == "matmul" else [(1, 64, 4, 16), (1, 2, 64, 16),
                                                            (1, 2, 64, 16)]
    arrays = [_np(i, s) for i, s in enumerate(shapes)]
    jargs = tuple(jnp.asarray(v, jdt) for v in arrays)
    targs = tuple(torch.from_numpy(v).to(tdt) for v in arrays)
    name = "matmul" if case == "matmul" else "flash_attention"
    kw = {"causal": True} if case == "flash_causal_kwarg" else {}
    jkey = jtuning.make_key(name, args=jargs, kwargs=kw, space=jat.get_spec(name).space(*jargs, **kw),
                            extra={"interpret": True})
    tkey = ttuning.make_key(name, args=targs, kwargs=kw, space=tat.get_spec(name).space(*targs, **kw),
                            extra={"interpret": True})
    assert tkey.encode() == jkey.encode()


def test_exact_hits_on_the_committed_jax_db_without_writing_it(monkeypatch):
    path = "tuned/cpu.json"
    digest = hashlib.sha256(open(path, "rb").read()).hexdigest()
    db = ttuning.TuningDB(path, autosave=False)
    calls = _counting_plain(monkeypatch)
    hits = 0
    for rec in db.records():
        if rec.key.name != "matmul":
            continue
        (m, k), (_, n) = rec.key.shapes()
        a, b = torch.from_numpy(_np(0, (m, k))), torch.from_numpy(_np(1, (k, n)))
        key = ttuning.make_key("matmul", args=(a, b), space=tat.get_spec("matmul").space(a, b),
                               extra={"interpret": True})
        assert key.encode() == rec.key.encode()
        assert db.lookup(key) == (rec, True)
        tat.autotuned("matmul", a, b, interpret=True, db=db)
        assert calls[-1] == rec.point
        hits += 1
    fa = [r for r in db.records() if r.key.name == "flash_attention"]
    for rec in fa:
        q, k, v = (torch.from_numpy(_np(i, s)) for i, s in enumerate(rec.key.shapes()))
        key = ttuning.make_key("flash_attention", args=(q, k, v),
                               space=tat.get_spec("flash_attention").space(q, k, v),
                               extra={"interpret": True})
        assert db.lookup(key) == (rec, True)
        hits += 1
    assert hits >= 3
    assert hashlib.sha256(open(path, "rb").read()).hexdigest() == digest


def _pretune(argv, capsys):
    rc = tpretune.main(argv)
    out = capsys.readouterr().out
    m = re.search(r"(\d+) contexts tuned \((\d+) exact hits, (\d+) searched\)", out)
    return rc, (int(m.group(1)), int(m.group(2)), int(m.group(3))) if m else None


def test_pretune_interpret_smoke_then_only_exact_hits(tmp_path, capsys):
    db = str(tmp_path / "sub" / "p.json")
    rc, (tuned, hits, searched) = _pretune(["--interpret", "--smoke", "--db", db], capsys)
    assert rc == 0 and tuned == 5 and searched == 5
    rc, (tuned, hits, searched) = _pretune(["--interpret", "--smoke", "--db", db], capsys)
    assert rc == 0 and tuned == hits == 5 and searched == 0
    # the port's file is a DB the JAX package reads
    assert len(jtuning.TuningDB(db, autosave=False)) == 5


def test_pretune_refuses_to_run_without_a_card(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tpretune.main(["--smoke", "--db", str(tmp_path / "p.json")]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "p.json").exists()
    assert tpretune.main(["--interpret", "--kernel", "_no_such_kernel",
                          "--db", str(tmp_path / "q.json")]) == 2


def test_sandbox_refuses_cuda_instead_of_passing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(SandboxUnavailable, match="CUDA"):
        sandboxed_probe(lambda: None)
    a = torch.zeros(64, 64)
    with pytest.raises(SandboxUnavailable):
        tat.tune_call("matmul", a, a, db=ttuning.TuningDB(None), interpret=True,
                      fault_policy=FaultPolicy(sandbox_first_touch=True), jobs=1)


def test_block_until_ready_walks_results():
    t = torch.ones(3)
    nested = {"a": (t, [t * 2]), "b": 3}
    assert block_until_ready(nested) is nested
    assert block_until_ready(t) is t
