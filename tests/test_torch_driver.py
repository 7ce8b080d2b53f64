"""The port's training driver on the CPU: ``TunedStep`` (mirrors of the JAX
package's ``tests/test_autotuning.py`` TunedStep tests), the checkpoint
store (mirrors of ``tests/test_checkpoint.py`` plus the in-place race that
``save_async`` must survive), and ``TrainJob`` (mirrors of
``tests/test_fault_tolerance.py``: resume with an identical trajectory, the
watchdog, the straggler reset) and the train launcher.  Tiny configs, the
kernels' plain versions (``interpret``), fixed seeds."""
import json
import os
import time

import numpy as np
import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, load_checkpoint, save_checkpoint
from repro_torch.core import IntDim, LogIntDim, SearchSpace, TunedStep
from repro_torch.core.space import ChoiceDim
from repro_torch.launch import train as train_launcher
from repro_torch.optim import tree_leaves
from repro_torch.runtime import TrainJob, Watchdog
from repro_torch.tuning import TuningDB


# ---------------------------------------------------------------- TunedStep
def test_tuned_step_single_iteration_mode():
    """TunedStep tunes a build-time knob of a step during the loop."""
    space = SearchSpace([LogIntDim("block", 32, 256)])
    builds = []

    def factory(block):
        builds.append(block)

        def step(x):
            # emulate: smaller blocks do redundant work
            reps = 256 // block
            acc = x
            for _ in range(reps):
                acc = acc + torch.tanh(x)
            return acc

        return step

    ts = TunedStep(factory, space, ignore=1, num_opt=3, max_iter=6, seed=0)
    x = torch.ones((64, 64))
    for _ in range(100):
        ts(x)
        if ts.finished:
            break
    assert ts.finished
    # step cache: at most one build per distinct candidate
    assert len(builds) == len(set(builds))


def test_tuned_step_entire_mode_returns_best():
    space = SearchSpace([IntDim("n", 1, 6)])

    def factory(n):
        def step(x):
            acc = x
            for _ in range(n * 3):
                acc = acc @ x
            return acc

        return step

    ts = TunedStep(factory, space, ignore=1, num_opt=4, max_iter=8, seed=1)
    best = ts.tune(torch.eye(128))
    assert ts.finished
    assert 1 <= best["n"] <= 6


def test_tuned_step_db_warm_start_is_an_exact_hit(tmp_path):
    """name/key_extra fingerprint the step; a second TunedStep on the same
    DB adopts the committed point with no candidate run."""
    space = SearchSpace([ChoiceDim("k", (1, 2, 4))])
    path = str(tmp_path / "db.json")

    def factory(k):
        return lambda x: (x * k).sum()

    first = TunedStep(factory, space, num_opt=2, max_iter=3, db=TuningDB(path), name="step/t",
                      key_extra={"b": 4}, device="cpu")
    x = torch.ones(256)
    while not first.finished:
        first(x)
    rec = TuningDB(path).records()
    assert len(rec) == 1 and rec[0].key.backend == "cpu" and rec[0].point == first.best_knobs
    built = []
    second = TunedStep(lambda k: built.append(k) or factory(k), space, num_opt=2, max_iter=3,
                       db=TuningDB(path), name="step/t", key_extra={"b": 4}, device="cpu")
    assert second.finished and second.knobs == first.best_knobs
    second(x)
    assert built == [first.best_knobs["k"]]
    other = TunedStep(factory, space, db=TuningDB(path), name="step/t", key_extra={"b": 8})
    assert not other.finished


def test_tuned_step_adaptive_runtime_blocks_on_nested_outputs():
    """runtime="adaptive" routes through the OnlineTuner; each call's wall
    time covers a nested (params, state, metrics) output."""
    space = SearchSpace([ChoiceDim("k", (1, 2))])
    seen = []

    def factory(k):
        def step(p, s):
            seen.append(k)
            return p, s, {"loss": (p["w"] * k).sum()}
        return step

    ts = TunedStep(factory, space, num_opt=2, max_iter=2, runtime="adaptive", epsilon=1.0)
    p, s = {"w": torch.ones(8)}, {"m": torch.zeros(8)}
    for _ in range(12):
        p2, s2, m = ts(p, s)
        assert p2 is p and float(m["loss"]) in (8.0, 16.0)
    assert ts.online is not None and ts.online.stats()["calls"] == 12
    assert set(seen) <= {1, 2}
    with pytest.raises(ValueError, match="unknown runtime"):
        TunedStep(factory, space, runtime="eager")


# --------------------------------------------------------------- checkpoints
def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn((16, 8), generator=g),
        "nested": {"b": torch.arange(10, dtype=torch.int32), "c": torch.tensor(3.5)},
    }


def _equal(t1, t2):
    return all(torch.equal(a, b) for a, b in zip(tree_leaves(t1), tree_leaves(t2)))


def test_roundtrip(tmp_path):
    t = tree()
    save_checkpoint(str(tmp_path), 7, t, extra={"note": "x"})
    loaded, step, extra = load_checkpoint(str(tmp_path), t)
    assert step == 7 and extra == {"note": "x"}
    assert _equal(t, loaded) and loaded["nested"]["b"].dtype == torch.int32


def test_latest_and_keep_k(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, tree(s))
    assert m.latest_step() == 4
    kept = sorted(os.listdir(tmp_path))
    assert kept == ["step_0000000003", "step_0000000004"]


def test_corruption_detected(tmp_path):
    t = tree()
    d = save_checkpoint(str(tmp_path), 1, t)
    # flip a byte in the first array file
    manifest = json.load(open(os.path.join(d, "manifest.json")))
    f = os.path.join(d, next(iter(manifest["arrays"].values()))["file"])
    data = bytearray(open(f, "rb").read())
    data[-1] ^= 0xFF
    open(f, "wb").write(bytes(data))
    with pytest.raises(IOError, match="checksum"):
        load_checkpoint(str(tmp_path), t)


def test_incomplete_save_ignored(tmp_path):
    """A tmp dir (crash mid-save) must not be visible as a checkpoint."""
    t = tree()
    save_checkpoint(str(tmp_path), 1, t)
    os.makedirs(tmp_path / "tmp.2")  # simulated crash leftovers
    os.makedirs(tmp_path / "step_0000000003")  # no manifest -> incomplete
    assert latest_step(str(tmp_path)) == 1


def test_async_save(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3)
    m.save_async(5, tree(5))
    m.wait()
    assert m.latest_step() == 5
    loaded, step, _ = m.restore(tree(0))
    assert step == 5
    assert torch.equal(loaded["a"], tree(5)["a"])


def test_dtype_cast_on_restore(tmp_path):
    t = {"w": torch.ones((4,), dtype=torch.float32)}
    save_checkpoint(str(tmp_path), 0, t)
    like = {"w": torch.zeros((4,), dtype=torch.bfloat16)}
    loaded, _, _ = load_checkpoint(str(tmp_path), like)
    assert loaded["w"].dtype == torch.bfloat16


def test_bf16_is_stored_as_its_bits(tmp_path):
    t = {"w": torch.randn(33, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)}
    d = save_checkpoint(str(tmp_path), 0, t)
    meta = next(iter(json.load(open(os.path.join(d, "manifest.json")))["arrays"].values()))
    assert meta["dtype"] == "bfloat16"
    loaded, _, _ = load_checkpoint(str(tmp_path), t)
    assert loaded["w"].dtype == torch.bfloat16
    assert torch.equal(loaded["w"].view(torch.int16), t["w"].view(torch.int16))


def test_async_save_snapshots_before_an_in_place_update(tmp_path):
    """The optimizer updates parameters in place, so ``save_async`` must
    copy the tree before it returns: a write right after the call does not
    reach the checkpoint."""
    m = CheckpointManager(str(tmp_path), keep=3)
    t = tree(3)
    want = {k: (v.clone() if isinstance(v, torch.Tensor) else {n: x.clone() for n, x in v.items()})
            for k, v in t.items()}
    m.save_async(9, t)
    with torch.no_grad():
        t["a"].add_(1.0)
        t["nested"]["b"].mul_(3)
    loaded, step, _ = m.restore(tree(0))
    assert step == 9 and _equal(loaded, want) and not torch.equal(loaded["a"], t["a"])


# ------------------------------------------------------------------ TrainJob
BASE = dict(arch="qwen2_7b", tiny=True, global_batch=4, seq_len=32, device="cpu")


def test_resume_identical_trajectory(tmp_path):
    """Uninterrupted run vs (crash at step 14 -> resume) must produce the
    same losses at the same steps (data is pure(seed, step); the checkpoint
    restores params + optimizer state exactly)."""
    base = dict(BASE, steps=24, ckpt_every=8, ckpt_async=False, seed=3)
    full = TrainJob(**base, ckpt_dir=str(tmp_path / "a")).run()

    class Crash(Exception):
        pass

    def bomb(step):
        if step == 14:
            raise Crash()

    job_b = TrainJob(**base, ckpt_dir=str(tmp_path / "b"), delay_hook=bomb)
    with pytest.raises(Crash):
        job_b.run()
    # resume (fresh driver object: a new process)
    resumed = TrainJob(**base, ckpt_dir=str(tmp_path / "b")).run()
    # the resumed run restarts after the last checkpoint (step 7) -> steps 8..23
    assert resumed["steps"][0] == 8
    full_by_step = dict(zip(full["steps"], full["loss"]))
    for s, l in zip(resumed["steps"], resumed["loss"]):
        np.testing.assert_allclose(l, full_by_step[s], rtol=1e-6)


def test_watchdog_detects_stragglers():
    wd = Watchdog(factor=1.5, warmup=2)
    for i in range(8):
        assert wd.check(0.10, i) == 0
    assert wd.check(0.18, 8) >= 1  # 1.8x EWMA -> flagged
    assert wd.events and wd.events[-1]["step"] == 8
    # EWMA not polluted by the outlier
    assert abs(wd.ewma - 0.10) < 0.01


def test_driver_tunes_and_resets_on_straggler():
    """Single-Iteration tuning rides the loop; an injected slowdown after
    tuning completes triggers reset() and re-tuning (paper §2.2 reset)."""

    seen = []  # the hook runs once a step: the gaps between its calls are step times

    def delay(step):
        seen.append(time.perf_counter())
        if 30 <= step < 33:
            # a straggler several times the step time, however loaded the host
            gaps = sorted(np.diff(seen[:30]))
            time.sleep(max(0.25, 4 * gaps[len(gaps) // 2]))

    job = TrainJob(
        **BASE, steps=40, tune=True, tune_microbatches=(1, 2), tune_max_iter=3, tune_num_opt=2,
        ignore=1, delay_hook=delay, watchdog_factor=1.6,
    )
    hist = job.run()
    assert np.isfinite(hist["loss"]).all()
    assert hist["final_knobs"].get("microbatches") in (1, 2)
    assert len(hist["watchdog_events"]) >= 1  # straggler seen
    assert len(hist["resets"]) >= 1  # tuning re-entered
    assert hist["tuned_at"] is not None and not hist["db_hit"]
    assert {k["microbatches"] for k in hist["knobs"]} <= {1, 2}


def test_async_checkpoints_hold_each_step_snapshot(tmp_path):
    """ckpt_async with ckpt_every=2: every checkpoint restores the
    parameters and optimizer state ``on_step`` saw at its step, bit for bit,
    although the next steps update them in place."""
    job = TrainJob(**BASE, steps=6, ckpt_every=2, ckpt_keep=10, ckpt_async=True,
                   ckpt_dir=str(tmp_path), seed=1)
    snaps = {}
    job.run(on_step=lambda step, m: snaps.__setitem__(
        step, [t.detach().clone() for t in tree_leaves(job.state)]))
    for step in (1, 3, 5):
        loaded, got, _ = load_checkpoint(str(tmp_path), job.state, step=step)
        assert got == step
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(loaded), snaps[step]))
    assert not all(torch.equal(a, b) for a, b in zip(snaps[1], snaps[3]))


def test_adaptive_runtime_and_stop_after_tuned():
    job = TrainJob(**BASE, steps=30, tune=True, runtime="adaptive", tune_microbatches=(1, 2),
                   tune_max_iter=2, tune_num_opt=2, stop_after_tuned=2)
    hist = job.run()
    assert hist["online_stats"]["calls"] == len(hist["loss"])
    assert np.isfinite(hist["loss"]).all()


# ------------------------------------------------------------------ launcher
def test_train_launcher_tunes_then_hits_the_db(tmp_path, capsys):
    db = str(tmp_path / "t.json")
    args = ["--arch", "recurrentgemma_2b", "--tiny", "--device", "cpu", "--steps", "14",
            "--global-batch", "4", "--seq-len", "16", "--tune", "--db", db]
    first = train_launcher.train(args)
    assert "tuning db hit" not in capsys.readouterr().out
    second = train_launcher.train(args)
    out = capsys.readouterr().out
    assert "tuning db hit: train_step/recurrentgemma_2b" in out
    assert second["final_knobs"] == first["final_knobs"] and second["steps"] == 14
    summary = json.loads(out[out.index("{\n"):])
    assert set(summary) == {"final_loss", "steps", "mean_step_s", "final_knobs",
                            "watchdog_events", "resets"}


def test_train_launcher_needs_a_card_or_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train_launcher.main(["--tiny", "--steps", "1"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    # --distributed joins the group torchrun describes; without torchrun's
    # environment the launcher says so and exits 1
    for var in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert train_launcher.main(["--tiny", "--device", "cpu", "--distributed"]) == 1
    assert "no torchrun environment" in capsys.readouterr().err
