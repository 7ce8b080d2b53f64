"""The port's umbrella CLI (``python -m repro_torch.tune``) against the JAX
package's (``python -m repro.tune``), on the CPU: ``db merge/list/diff``
give the same exit codes and merged files on the same shard DBs, ``report``
renders the port's own ``--obs-dir`` run with the candidate accounting
balanced, and a sharded ``pretune --strategy csa+nm --cost analytic`` sweep
merges into a DB that ``db diff`` finds equal to the unsharded sweep's.
"""
import json

import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import repro.tuning as jtuning
import repro_torch.tuning as ttuning
from repro.tune import main as jtune
from repro_torch.tune import main as ttune

PKGS = {"jax": (jtuning, jtune), "torch": (ttuning, ttune)}


def _key(tuning, tag):
    return tuning.TuningKey(name="unit", signature=f"sig-{tag}", space_hash="h",
                            backend="cpu", device_kind="cpu")


def _shards(tuning, root):
    """Three shard DBs whose keys overlap: a lower cost, a steadier near-tie
    and an infinite cost each have to win or lose the merge."""
    rec = tuning.TuningRecord
    k1, k2, k3, k4 = (_key(tuning, t) for t in "1234")
    shards = {
        "a": [rec(key=k1, point={"p": 1}, cost=1.0, created=1.0),
              rec(key=k3, point={"p": 3}, cost=1.0, cost_std=0.01, repeats_spent=8, created=1.0)],
        "b": [rec(key=k1, point={"p": 2}, cost=0.5, created=2.0),
              rec(key=k2, point={"p": 5}, cost=3.0, created=1.0),
              rec(key=k3, point={"p": 4}, cost=0.99, cost_std=0.5, repeats_spent=8, created=2.0)],
        "c": [rec(key=k4, point={"p": 7}, cost=float("inf"), created=1.0),
              rec(key=k2, point={"p": 6}, cost=2.0, created=3.0)],
    }
    paths = {}
    for name, recs in shards.items():
        paths[name] = str(root / f"{name}.json")
        db = tuning.TuningDB(paths[name])
        for r in recs:
            db.put(r)
    return paths


def test_db_merge_list_diff_match_jax(tmp_path, capsys):
    codes, merged = {}, {}
    for pkg, (tuning, tune) in PKGS.items():
        root = tmp_path / pkg
        root.mkdir()
        p = _shards(tuning, root)
        out = str(root / "merged.json")
        codes[pkg] = [
            tune(["db", "merge", "--out", out, p["a"], p["b"], p["c"]]),
            tune(["db", "list", "--db", out]),
            tune(["db", "list", "--db", out, "--shard", "1/2"]),
            tune(["db", "diff", out, out]),
            tune(["db", "diff", out, p["a"]]),
            tune(["db", "merge", "--out", out, str(root / "nope.json")]),
            tune(["db", "diff", out, str(root / "nope.json")]),
            tune(["db", "frobnicate"]),
            tune(["nonsense"]),
        ]
        capsys.readouterr()
        merged[pkg] = {k: (v["point"], v["cost"]) for k, v in
                       json.load(open(out))["records"].items()}
    assert codes["torch"] == codes["jax"] == [0, 0, 0, 0, 1, 2, 2, 2, 2]
    assert merged["torch"] == merged["jax"]
    assert sorted(v[0]["p"] for v in merged["torch"].values()) == [2, 3, 6, 7]


def test_db_files_merge_across_the_packages(tmp_path, capsys):
    """A shard written by either package folds into a merge run by the other."""
    j = _shards(jtuning, _mk(tmp_path, "j"))
    t = _shards(ttuning, _mk(tmp_path, "t"))
    assert ttune(["db", "merge", "--out", str(tmp_path / "m1.json"), j["a"], t["b"], j["c"]]) == 0
    assert jtune(["db", "merge", "--out", str(tmp_path / "m2.json"), t["a"], j["b"], t["c"]]) == 0
    assert ttune(["db", "diff", str(tmp_path / "m1.json"), str(tmp_path / "m2.json"), "--costs"]) == 0
    capsys.readouterr()


def _mk(root, name):
    d = root / name
    d.mkdir()
    return d


def test_report_renders_a_port_pretune_run(tmp_path, capsys):
    obs_dir = tmp_path / "obs"
    db = str(tmp_path / "p.json")
    assert ttune(["pretune", "--interpret", "--smoke", "--db", db, "--obs-dir", str(obs_dir),
                  "--kernel", "decode_attention", "--kernel", "matmul"]) == 0
    capsys.readouterr()
    assert ttune(["report", str(obs_dir), "--db", db]) == 0
    out = capsys.readouterr().out
    assert "candidate accounting" in out and "phase breakdown" in out
    lines = [ln for ln in out.splitlines() if "asked=" in ln]
    assert len(lines) == 3 and all(ln.rstrip().endswith("ok") for ln in lines)
    assert any("decode_attention" in ln for ln in lines)
    assert ttune(["report", str(tmp_path / "missing")]) == 2


def _pretune(args, capsys):
    rc = ttune(["pretune", "--interpret", "--smoke", "--no-warm-start", "--strategy", "csa+nm",
                "--cost", "analytic", *args])
    out = capsys.readouterr().out
    assert rc == 0, out
    return out


def test_sharded_analytic_sweep_merges_to_the_unsharded_one(tmp_path, capsys):
    whole = str(tmp_path / "whole.json")
    out = _pretune(["--db", whole], capsys)
    assert "strategy=csa+nm" in out and "5 contexts tuned" in out
    shards = []
    for i in range(2):
        shards.append(str(tmp_path / f"s{i}.json"))
        out = _pretune(["--db", shards[i], "--shard", f"{i}/2"], capsys)
        assert f"shard {i}/2" in out
    merged = str(tmp_path / "merged.json")
    assert ttune(["db", "merge", "--out", merged, *shards]) == 0
    assert ttune(["db", "diff", merged, whole, "--costs"]) == 0
    assert len(ttuning.TuningDB(merged, autosave=False)) == 5
    assert {r.strategy for r in ttuning.TuningDB(merged, autosave=False).records()} == {"csa+nm"}
    capsys.readouterr()


def test_db_list_grid_shows_hits_and_needs_a_card_without_interpret(tmp_path, capsys, monkeypatch):
    db = str(tmp_path / "p.json")
    assert ttune(["pretune", "--interpret", "--smoke", "--db", db, "--kernel", "decode_attention"]) == 0
    capsys.readouterr()
    assert ttune(["db", "list", "--db", db, "--grid", "--smoke", "--interpret"]) == 0
    out = capsys.readouterr().out
    assert "decode_attention/b2h4kh2s128d16" in out and "HIT" in out and "cold" in out
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ttune(["db", "list", "--db", db, "--grid", "--smoke"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("n", [2, 3])
def test_shard_filter_partitions_the_grid(n):
    from repro_torch.tuning.pretune import _cases, _shard_filter

    cases = _cases(True, None, abstract=True)
    ids = sorted((name, label) for name, label, _ in cases)
    shards = [[(name, label) for name, label, _ in
               _shard_filter(cases, True, None, None, (i, n), True, ("cpu", "cpu"))]
              for i in range(n)]
    assert sorted(c for s in shards for c in s) == ids
