"""The port's own tracing (``repro_torch.obs.trace``) on the CPU: spans are
off unless the tracer or ``torch.profiler`` is on; under the profiler each
span is a ``record_function`` range in the exported Chrome trace and is
kept by the tracer; device marks are taken only on the card outside graph
capture; a train step and a routed decode leave the spans the benchmark
reads.  This file imports no JAX."""
import json
import threading

import pytest

pytest.importorskip("torch")  # without torch the whole module skips

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs, obs
from repro_torch.data import make_batch_for
from repro_torch.launch import serve
from repro_torch.models import ExecConfig, TrainModel
from repro_torch.obs import trace as tr
from repro_torch.optim import AdamW
from repro_torch.train import make_train_step


@pytest.fixture(autouse=True)
def fresh_tracer():
    obs.shutdown()
    tr.tracer().disable()
    tr.tracer().reset()
    yield tr.tracer()
    obs.shutdown()
    tr.tracer().disable()
    tr.tracer().reset()


def _annotations(prof, tmp_path) -> list:
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def test_off_without_either_switch(fresh_tracer):
    assert not fresh_tracer.enabled
    ctxs = [tr.span("train.step", "train", device=True), tr.span("ops.rwkv.fwd"),
            fresh_tracer.span("tuner.begin", sampled=True, ctx="x")]
    assert all(c is tr._NULL_SPAN for c in ctxs)
    with ctxs[0] as s:
        assert s is None
    fn = lambda: 1  # noqa: E731
    assert fresh_tracer.wrap(fn, "compile") is fn
    assert fresh_tracer.finished() == []


def test_spans_enter_the_profiler_trace_and_the_tracer(fresh_tracer, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("outer", "test") as outer:
            with tr.span("inner", "test", k=2) as inner:
                torch.ones(4).sum()
    assert inner.parent_id == outer.span_id and inner.args == {"k": 2}
    assert [s.name for s in fresh_tracer.finished()] == ["inner", "outer"]
    ann = {e["name"]: e for e in _annotations(prof, tmp_path)}
    o, i = ann["outer"], ann["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1e-3
    assert o["tid"] == i["tid"]
    # after the session the spans are off again, and the records stay
    assert tr.span("later") is tr._NULL_SPAN
    assert len(fresh_tracer.finished()) == 2


def test_enabled_tracer_alone_makes_no_profiler_range(fresh_tracer, tmp_path):
    obs.configure(str(tmp_path / "obs"))
    with tr.span("alone", "test") as s:
        pass
    assert s is not None and s.dur_ns is not None and s.marks is None
    assert obs.shutdown() is not None
    blob = json.loads((tmp_path / "obs" / obs.TRACE_FILE).read_text())
    names = [e["name"] for e in blob["traceEvents"] if e.get("ph") == "X"]
    assert names == ["alone"]


class _FakeEvent:
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t = _FakeEvent.made

    def record(self):
        pass

    def elapsed_time(self, end):
        return 1.5 * (end.t - self.t)


@pytest.mark.parametrize("initialised,capturing,marked", [
    (False, False, False),  # the CPU: CUDA never initialised
    (True, True, False),  # the stream is capturing a graph
    (True, False, True),
])
def test_device_marks_only_on_the_card_outside_capture(fresh_tracer, monkeypatch, initialised,
                                                       capturing, marked):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: initialised)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    _FakeEvent.made = 0
    fresh_tracer.enable()
    with tr.span("phase", "train", device=True) as s:
        pass
    with tr.span("wrapper", "kernels") as w:  # no device=True: never marked
        pass
    assert w.marks is None and w.device_ms is None
    assert (s.marks is not None) is marked
    assert _FakeEvent.made == (2 if marked else 0)
    if marked:
        assert s.device_ms == 1.5
        spans = {e["name"]: e for e in fresh_tracer.to_chrome()["traceEvents"] if e["ph"] == "X"}
        assert spans["phase"]["args"]["device_ms"] == 1.5
        assert "device_ms" not in spans["wrapper"]["args"]
    else:
        assert s.device_ms is None


def test_other_threads_open_roots_unless_given_a_parent(fresh_tracer):
    fresh_tracer.enable()

    def backward():  # as autograd's own thread runs a wrapper's backward on the card
        with tr.span("ops.rwkv.bwd", "kernels"):
            pass

    with tr.span("train.backward", "train") as phase:
        threads = [threading.Thread(target=backward),
                   threading.Thread(target=fresh_tracer.wrap(lambda: None, "member_turn"))]
        for t in threads:
            t.start()
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    by = {s.name: s for s in fresh_tracer.finished()}
    assert by["ops.rwkv.bwd"].parent_id is None
    assert by["member_turn"].parent_id == phase.span_id


@pytest.mark.parametrize("arch,kernel,calls", [
    ("rwkv6_7b", "rwkv", 2),
    ("recurrentgemma_2b", "lru", 4),
    ("seamless_m4t_large_v2", "flash", 4),
])
def test_train_step_spans(fresh_tracer, tmp_path, arch, kernel, calls):
    cfg = configs.get_tiny(arch)
    model = TrainModel(cfg, ExecConfig(attn_impl="cuda", rec_chunk=4, interpret=True),
                       device="cpu")
    params = model.params()
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    step = make_train_step(model, opt, microbatches=2)
    batch = make_batch_for(cfg, 2, 16, step=0, seed=1, device="cpu")
    step(params, state, batch)  # off: nothing recorded
    assert fresh_tracer.finished() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, state, batch)
    done = fresh_tracer.finished()
    (root,) = [s for s in done if s.name == "train.step"]
    kids = [s.name for s in done if s.parent_id == root.span_id]
    assert sorted(kids) == sorted(["train.forward", "train.backward"] * 2 + ["train.optimizer"])
    assert all(s.marks is None for s in done)  # the CPU takes no device marks
    ids = {s.span_id: s.name for s in done}
    for phase, op in (("train.forward", f"ops.{kernel}.fwd"), ("train.backward",
                                                                f"ops.{kernel}.bwd")):
        ops = [s for s in done if s.name == op]
        assert len(ops) == 2 * calls  # each layer's call, in each of the two microbatches
        assert {ids[s.parent_id] for s in ops} == {phase}
    names = [e["name"] for e in _annotations(prof, tmp_path)]
    assert sorted(names) == sorted(s.name for s in done)


def test_routed_decode_joins_begin_and_observe_by_seq(fresh_tracer, tmp_path):
    out_dir = tmp_path / "obs"
    serve.serve(["--arch", "rwkv6_7b", "--tiny", "--device", "cpu", "--prompt-len", "16",
                 "--gen", "32", "--epsilon", "0.5", "--obs-dir", str(out_dir)])
    blob = json.loads((out_dir / obs.TRACE_FILE).read_text())
    spans = [e for e in blob["traceEvents"] if e.get("ph") == "X"]
    begins = [e["args"]["seq"] for e in spans if e["name"] == "tuner.begin"]
    observes = [e["args"]["seq"] for e in spans if e["name"] == "tuner.observe"]
    assert begins and begins == observes == sorted(set(begins))
    assert not any(e["name"] == "request" for e in spans)
    (ctx,) = {e["args"]["ctx"] for e in spans if e["name"].startswith("tuner.")}
    assert "|serve/decode_k|" in ctx  # the one routed context's tuning key


def test_sampled_begin_takes_its_observe_along(fresh_tracer, tmp_path):
    obs.configure(str(tmp_path / "obs"), sample=0.5)
    from repro_torch.core import ChoiceDim, SearchSpace
    from repro_torch.runtime import ContextRouter
    from repro_torch.tuning import TuningDB

    router = ContextRouter(db=TuningDB(None))
    space = SearchSpace([ChoiceDim("k", (1, 2, 4))])
    router.register("d", space=lambda: space, defaults=lambda: {"k": 1}, epsilon=0.5,
                    num_opt=2, max_iter=2)
    seqs = []
    for _ in range(12):
        d = router.begin("d")
        router.observe(d, 1.0 / int(d.point["k"]))
        seqs.append((d.seq, d.traced))
    done = fresh_tracer.finished()
    begins = [s.args["seq"] for s in done if s.name == "tuner.begin"]
    observes = [s.args["seq"] for s in done if s.name == "tuner.observe"]
    assert begins == observes == [q for q, kept in seqs if kept]
    assert 0 < len(begins) < len(seqs)
