"""The port's launch layer against the JAX package's, on the CPU: the
launch search spaces, default points, cost model and model-mode tuning
(``launch/spaces.py``), ``pretune --launch``, the input stand-ins
(``launch/input_specs.py``) and ``launch.train --distributed``.

Held to the JAX package on the same hardware: the port's spaces are built
with a :class:`HardwareSpec` made from the JAX package's ``TPU_V5E`` fields
(its ``ici_bw`` as ``link_bw``, the 4 links of its torus), so sizes,
constraint names and descriptions, default points, costs (bit for bit),
search trajectories, committed records and key fingerprints must be
equal.  The port's own default, the H100 SXM data sheet, is checked apart.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch

from repro import configs as jconfigs
from repro.core.costs import TPU_V5E
from repro.launch import spaces as jspaces
from repro_torch import configs as tconfigs
from repro_torch.core.costs import H100_SXM, HardwareSpec
from repro_torch.launch import spaces as tspaces

from helpers import REPO

#: the JAX package's target, in the port's spec (link_bw counts the link
#: rate the JAX model divides by; 4 links, the v5e torus)
HW = HardwareSpec(TPU_V5E.name, TPU_V5E.peak_flops, TPU_V5E.peak_flops, TPU_V5E.hbm_bw,
                  link_bw=TPU_V5E.ici_bw, links=4, hbm_bytes=TPU_V5E.hbm_bytes)
CASES = tspaces.launch_cases(smoke=False)
DEVICES = (8, 64)


def test_launch_cases_equal_jax():
    assert CASES == jspaces.launch_cases(smoke=False)
    assert tspaces.launch_cases(smoke=True) == jspaces.launch_cases(smoke=True)
    assert {a for a, s in CASES if s == "train_4k"} == set(tconfigs.ARCH_IDS)
    assert tspaces.XLA_PRESETS.keys() == jspaces.XLA_PRESETS.keys()
    for name, preset in tspaces.XLA_PRESETS.items():
        assert preset == {k: jspaces.XLA_PRESETS[name][k] for k in ("overlap", "overhead")}
        assert tspaces.compiler_options_for(name, "cuda") == {}
        assert tspaces.compiler_options_for(name) == jspaces.compiler_options_for(name, "cpu")
    with pytest.raises(KeyError):
        tspaces.compiler_options_for("no-such-preset")


def _spaces(arch, shape_name, n):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    js = jspaces.launch_space(jcfg, jconfigs.SHAPES[shape_name], n)
    ts = tspaces.launch_space(tcfg, tconfigs.SHAPES[shape_name], n, hw=HW)
    return jcfg, tcfg, js, ts


@pytest.mark.parametrize("arch,shape_name", CASES, ids=[f"{a}-{s}" for a, s in CASES])
def test_space_default_point_and_costs_equal_jax(arch, shape_name):
    from repro.tuning.records import space_fingerprint as jfp
    from repro_torch.tuning.records import space_fingerprint as tfp

    for n in DEVICES:
        jcfg, tcfg, js, ts = _spaces(arch, shape_name, n)
        assert (ts.size(), ts.constrained_size()) == (js.size(), js.constrained_size())
        assert [c.name for c in ts.constraints] == [c.name for c in js.constraints]
        assert [c.describe for c in ts.constraints] == [c.describe for c in js.constraints]
        assert tfp(ts) == jfp(js)
        jshape, tshape = jconfigs.SHAPES[shape_name], tconfigs.SHAPES[shape_name]
        jpt = jspaces.default_launch_point(jcfg, jshape, n, js)
        assert tspaces.default_launch_point(tcfg, tshape, n, ts) == jpt
        jcost = jspaces.launch_cost_model(jcfg, jshape, n)
        tcost = tspaces.launch_cost_model(tcfg, tshape, n, HW)
        points = [jpt] + [js.decode(z) for z in
                          np.random.RandomState(n).uniform(-1, 1, (50, len(js.dims)))]
        for pt in points:
            assert tcost(dict(pt)) == jcost(dict(pt)), pt  # bit for bit
            assert ts.check(pt) == js.check(pt)
        jw, jact = jspaces.launch_memory_model(jcfg, jshape, n)
        tw, tact = tspaces.launch_memory_model(tcfg, tshape, n, HW)
        assert tw == jw and all(tact(p) == jact(p) for p in points)
        assert tspaces.apply_launch_point(jpt, n, "cuda") == jspaces.apply_launch_point(jpt, n, "cpu")


def _recording(module, monkeypatch):
    """Record every point the cost model scores, in order."""
    seen = []
    real = module.launch_cost_model

    def wrapped(*a, **kw):
        cost = real(*a, **kw)

        def rec(point):
            seen.append(dict(point))
            return cost(point)

        return rec

    monkeypatch.setattr(module, "launch_cost_model", wrapped)
    return seen


@pytest.mark.parametrize("arch,shape_name", CASES, ids=[f"{a}-{s}" for a, s in CASES])
def test_tune_launch_trajectory_record_and_key_equal_jax(arch, shape_name, tmp_path, monkeypatch):
    from repro.tuning import TuningDB as JDB
    from repro_torch.tuning import TuningDB as TDB

    jseen, tseen = _recording(jspaces, monkeypatch), _recording(tspaces, monkeypatch)
    jdb, tdb = JDB(str(tmp_path / "j.json")), TDB(str(tmp_path / "t.json"))
    js, ts = {}, {}
    jrec = jspaces.tune_launch(arch, shape_name, 8, db=jdb, max_iter=3, warm_start=False, stats=js)
    trec = tspaces.tune_launch(arch, shape_name, 8, db=tdb, max_iter=3, warm_start=False, stats=ts,
                               hw=HW)
    assert tseen == jseen and len(tseen) == js["measured"] + 1  # + the default, noted first
    assert trec.point == jrec.point and trec.cost == jrec.cost
    assert trec.key.encode() == jrec.key.encode() and trec.key.backend == "model"
    assert trec.key.device_kind == TPU_V5E.name
    for k in ("raw_size", "constrained_size", "measured", "pruned", "default_point", "default_cost",
              "best_cost", "replayed", "constraint_violations"):
        assert ts[k] == js[k], k
    jdb.save(), tdb.save()
    # the two DB files hold the same record under the same key
    jfile, tfile = (json.loads((tmp_path / f).read_text()) for f in ("j.json", "t.json"))
    assert list(tfile["records"]) == list(jfile["records"])
    # replay: an exact hit, nothing measured
    tseen.clear()
    again = {}
    rec2 = tspaces.tune_launch(arch, shape_name, 8, db=TDB(str(tmp_path / "t.json")), max_iter=3,
                               stats=again, hw=HW)
    assert again["replayed"] and again["measured"] == 0 and tseen == [dict(again["default_point"])]
    assert rec2.point == trec.point and rec2.cost == trec.cost


def test_h100_is_the_default_target():
    cfg, shape = tconfigs.get("qwen2_7b"), tconfigs.SHAPES["train_4k"]
    space = tspaces.launch_space(cfg, shape, 8)
    weight_bytes, _ = tspaces.launch_memory_model(cfg, shape, 8)
    mem = [c for c in space.constraints if c.name == "memory-feasible"]
    assert len(mem) == 1
    assert mem[0].describe == (f"resident activations ≤ {(80e9 - weight_bytes) / 1e9:.2f} GB HBM "
                               f"headroom (h100-sxm)")
    assert (80e9 - weight_bytes) / 1e9 > 60  # 80 GB, not the 16 GB of the JAX package's target
    key = tspaces.launch_key("qwen2_7b", shape, 8, space)
    assert (key.backend, key.device_kind) == ("model", H100_SXM.name)
    # the collective terms read the card's links: more link bandwidth, less step time
    cost = tspaces.launch_cost_model(cfg, shape, 8)
    slow = tspaces.launch_cost_model(cfg, shape, 8, dataclasses.replace(H100_SXM, links=1))
    pt = tspaces.default_launch_point(cfg, shape, 8, space)
    assert cost(pt) < slow(pt)


def test_dryrun_mode_waits_for_its_slice(tmp_path):
    """(The name dates from before the dry-run slice, when this mode
    raised.)  ``mode="dryrun"`` on a tiny arch over 8 fake ranks: each candidate's
    step is counted by the dry run and charged its roofline bound; the
    committed best is no worse than the default launch, and a second call
    on the same DB replays with nothing measured."""
    from repro_torch.tuning import TuningDB

    db = TuningDB(str(tmp_path / "d.json"))
    stats: dict = {}
    rec = tspaces.tune_launch("qwen2_7b", "train_4k", 8, mode="dryrun", tiny=True, db=db,
                              max_iter=1, warm_start=False, stats=stats)
    assert rec is not None and stats["measured"] > 0 and not stats["replayed"]
    assert 0 < stats["best_cost"] <= stats["default_cost"] < float("inf")
    cost = tspaces._dryrun_cost_fn("qwen2_7b", tconfigs.SHAPES["train_4k"], 8, tiny=True)
    assert cost(rec.point) == rec.cost  # the dry run's counts are deterministic
    again: dict = {}
    rec2 = tspaces.tune_launch("qwen2_7b", "train_4k", 8, mode="dryrun", tiny=True, db=db,
                               max_iter=1, stats=again)
    assert again["replayed"] and again["measured"] == 0 and rec2.point == rec.point
    key = tspaces.launch_key("qwen2_7b", tconfigs.SHAPES["train_4k"], 8,
                             tspaces.launch_space(tconfigs.get_tiny("qwen2_7b"),
                                                  tconfigs.SHAPES["train_4k"], 8), mode="dryrun")
    assert db.get(key) is not None and json.loads(key.extra)["mode"] == "dryrun"
    with pytest.raises(ValueError):
        tspaces.tune_launch("qwen2_7b", "train_4k", 8, mode="measured")


# ------------------------------------------------------------------- the CLI
def test_launch_keys_roundtrip_db_cli(tmp_path, capsys):
    """Knobs-only launch keys survive db merge/diff/list."""
    from repro_torch.tune import main as tune_main
    from repro_torch.tuning import TuningDB

    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    dba, dbb = TuningDB(a), TuningDB(b)
    tspaces.tune_launch("qwen2_7b", "train_4k", 8, db=dba, max_iter=2, warm_start=False)
    tspaces.tune_launch("recurrentgemma_2b", "train_4k", 8, db=dbb, max_iter=2, warm_start=False)
    dba.save(), dbb.save()

    merged = str(tmp_path / "m.json")
    assert tune_main(["db", "merge", "--out", merged, a, b]) == 0
    assert len(TuningDB(merged)) == 2
    assert tune_main(["db", "diff", a, a]) == 0
    assert tune_main(["db", "diff", merged, a]) == 1  # b's record is missing from a
    assert tune_main(["db", "list", "--db", merged]) == 0
    out = capsys.readouterr().out
    assert "launch/qwen2_7b" in out and "launch/recurrentgemma_2b" in out
    assert "shape=train_4k" in out and "None" not in out


def _pretune(*args):
    from repro_torch.tuning import pretune

    return pretune.main(["--launch", *args])


def test_pretune_launch_twice_then_list(tmp_path, capsys):
    db = str(tmp_path / "launch.json")
    assert _pretune("--cost", "analytic", "--smoke", "--db", db) == 0
    out = capsys.readouterr().out
    assert "3 launch contexts tuned (0 exact hits, 3 searched)" in out
    assert "on h100-sxm, 8 cards" in out
    assert _pretune("--cost", "analytic", "--smoke", "--db", db) == 0
    out = capsys.readouterr().out
    assert "3 launch contexts tuned (3 exact hits, 0 searched)" in out and "0 candidates scored" in out
    assert out.count("(replayed)") == 3
    assert _pretune("--cost", "analytic", "--smoke", "--db", db, "--list") == 0
    out = capsys.readouterr().out
    assert out.count(" HIT ") == 3
    assert os.path.exists(db + ".journal")


def test_pretune_launch_resume_and_only(tmp_path, capsys):
    db = str(tmp_path / "launch.json")
    assert _pretune("--cost", "analytic", "--smoke", "--db", db, "--only", "qwen2*") == 0
    out = capsys.readouterr().out
    assert "1 launch contexts tuned" in out and "launch/qwen2_7b/train_4k" in out
    assert _pretune("--cost", "analytic", "--smoke", "--db", db, "--resume") == 0
    out = capsys.readouterr().out
    assert "skipping 1 completed launch cases" in out and "2 launch contexts tuned" in out
    assert _pretune("--cost", "analytic", "--smoke", "--db", db, "--only", "nothing*") == 2


def test_pretune_launch_shards_partition_the_grid(tmp_path, capsys):
    from repro_torch.tuning import TuningDB

    keys = []
    for i in range(3):
        db = str(tmp_path / f"s{i}.json")
        assert _pretune("--cost", "analytic", "--db", db, "--shard", f"{i}/3", "--no-warm-start") == 0
        keys.append({k.encode() for k in TuningDB(db).keys()})
    whole = str(tmp_path / "all.json")
    assert _pretune("--cost", "analytic", "--db", whole, "--no-warm-start") == 0
    assert sum(len(k) for k in keys) == len(set().union(*keys))  # disjoint
    assert set().union(*keys) == {k.encode() for k in TuningDB(whole).keys()}  # complete
    assert len(set().union(*keys)) == len(CASES)


def test_pretune_launch_runtime_cost_exits_nonzero(tmp_path, capsys, monkeypatch):
    """(The name dates from before the dry-run slice, when this exited 1.)
    ``--cost runtime`` (the default) scores launch candidates with the dry
    run; ``--devices`` falls back to REPRO_DRYRUN_DEVICES.  Twice on one DB:
    the second run is 3 exact hits."""
    db = str(tmp_path / "l.json")
    monkeypatch.setenv("REPRO_DRYRUN_DEVICES", "2")
    assert _pretune("--cost", "runtime", "--smoke", "--tiny", "--max-iter", "1", "--db", db) == 0
    out = capsys.readouterr().out
    assert "dry run on h100-sxm, 2 cards" in out
    assert "3 launch contexts tuned (0 exact hits, 3 searched)" in out and "(dryrun)" in out
    assert _pretune("--smoke", "--tiny", "--max-iter", "1", "--db", db) == 0
    out = capsys.readouterr().out
    assert "3 launch contexts tuned (3 exact hits, 0 searched)" in out
    assert out.count("(replayed)") == 3


def test_umbrella_cli_passes_launch_through(tmp_path):
    db = str(tmp_path / "u.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.tune", "pretune", "--launch",
                           "--cost", "analytic", "--smoke", "--db", db],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "3 launch contexts tuned" in proc.stdout


# --------------------------------------------------------------- input specs
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_input_specs_equal_jax(arch):
    """Shapes and dtypes of every stand-in equal JAX's; integer inputs are
    int64 where JAX's are int32 (the port's index dtype), and the decode
    states are per layer where JAX stacks each group."""
    import jax

    from repro.launch.input_specs import input_specs as jinput_specs
    from repro.models import Model as JModel
    from repro_torch.launch.input_specs import input_specs
    from repro_torch.models import Model
    from repro_torch.models.convert import stage_defs

    def same(t, j):
        assert tuple(t.shape) == tuple(j.shape)
        assert t.device.type == "meta"
        if np.issubdtype(np.dtype(j.dtype), np.integer):
            assert np.dtype(j.dtype) == np.int32 and t.dtype == torch.int64
        else:
            assert str(t.dtype) == f"torch.{np.dtype(j.dtype).name}" or (
                t.dtype == torch.bfloat16 and str(j.dtype) == "bfloat16")

    jmodel = JModel(jconfigs.get(arch))
    tmodel = Model(tconfigs.get(arch), device="meta")
    for shape_name in tconfigs.SHAPES:
        got, want = input_specs(tmodel, shape_name), jinput_specs(jmodel, shape_name)
        assert sorted(got) == sorted(want)
        if "batch" in want:
            assert sorted(got["batch"]) == sorted(want["batch"])
            for k in want["batch"]:
                same(got["batch"][k], want["batch"][k])
            continue
        same(got["token"], want["token"])
        same(got["pos"], want["pos"])
        # per layer, in pattern order: JAX's stage s, group g, position i
        layer = 0
        for s, (kinds, n_groups) in enumerate(stage_defs(tmodel.cfg)):
            for g in range(n_groups):
                for i in range(len(kinds)):
                    jst = want["states"][s][f"pos{i}"]
                    tst = got["states"][layer]
                    jl = jax.tree_util.tree_leaves_with_path(jst)
                    tl = {"/".join(map(str, p)): x for p, x in _walk(tst)}
                    assert sorted(tl) == sorted("/".join(str(getattr(k, "key", k)) for k in p)
                                                for p, _ in jl)
                    for p, x in jl:
                        key = "/".join(str(getattr(k, "key", k)) for k in p)
                        assert x.shape[0] == n_groups
                        same(tl[key], jax.ShapeDtypeStruct(x.shape[1:], x.dtype))
                    layer += 1
        assert layer == tmodel.cfg.n_layers == len(got["states"])


def _walk(tree, keys=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, keys + (k,))
    else:
        yield keys, tree


def test_input_specs_of_a_model_off_the_meta_device():
    from repro_torch.launch.input_specs import decode_inputs
    from repro_torch.models import Model

    model = Model(tconfigs.get_tiny("recurrentgemma_2b"), device="cpu")
    token, states, pos = decode_inputs(model, tconfigs.SHAPES["decode_32k"])
    assert token.device.type == "meta" and pos.shape == ()
    assert all(x.device.type == "meta" for st in states for _, x in _walk(st))


# ------------------------------------------------------------------ launcher
def test_train_distributed_on_cpu_equals_the_plain_run():
    """``launch.train --distributed --device cpu`` under torchrun (gloo,
    world 1) trains the same steps as the launcher without the flag."""
    from repro_torch.launch import train

    args = ["--arch", "qwen2_7b", "--tiny", "--device", "cpu", "--steps", "3",
            "--global-batch", "2", "--seq-len", "8"]
    plain = train.train(args)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", "1", "-m", "repro_torch.launch.train",
                           "--distributed", *args],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert got["steps"] == plain["steps"] == 3
    assert got["final_loss"] == plain["final_loss"]  # bit for bit, after three updates
