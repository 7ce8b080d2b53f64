"""The serving loop: a closed loop of batches, one at a time, each a
prefill and then greedy decode through the program's CUDA graphs under its
``ContextRouter``, composed as the program's ``launch/serve.py::_serve``
composes them (decode depth ``k`` tuned online from an empty DB, ε from the
traffic, the launcher's search budget and drift settings).

Set-up builds the model, prefills one batch at each prompt length the mix
uses, captures every candidate depth's graph once, and each batch's states
are then loaded into the graphs.  A batch's prefill runs from its start to
its first tokens on the host; its decode from there to its last tokens on
the host, explored chunks included.
"""
from __future__ import annotations

import dataclasses
import gc
import random
import time

import torch

from . import weights
from .inputs import mix_seed, prompt_lengths, serve_batch
from .reference_runs import reference_logits
from .train import program_config

__all__ = ["ServeRun", "build", "serve_one", "run_window", "free", "sample", "gaps"]

ROUTE = "serve/decode_k"
_WARM_INDEX = 1 << 40  # batch indices of set-up's prefills, apart from the window's


@dataclasses.dataclass
class ServeRun:
    cell: object
    seed: int
    device: torch.device
    model: object
    graphs: object = None
    router: object = None
    ks: tuple = ()
    make_multi: object = None
    done: list = dataclasses.field(default_factory=list)  # one dict per served batch

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def _prefill(run: ServeRun, batch: dict):
    model = run.model
    hidden, states = model.prefill(batch)
    logits = model.logits(hidden[:, None])[:, 0]
    return logits.argmax(-1)[:, None], states


def build(cell, seed: int, device) -> ServeRun:
    from repro_torch.core import ChoiceDim, SearchSpace
    from repro_torch.launch.serve import DECODE_KS, DecodeGraphs, decode_extra
    from repro_torch.models import ExecConfig, Model
    from repro_torch.runtime import ContextRouter

    t = cell.traffic
    device = torch.device(device)
    exec_cfg = ExecConfig(attn_impl="cuda", rec_chunk=t["rec_chunk"],
                          interpret=device.type == "cpu")
    model = Model(program_config(cell), exec_cfg, device=device, seed=0)
    weights.load_into(dict(model.named_parameters()), cell.reference().recipe(cell.sizes), seed)
    run = ServeRun(cell, seed, device, model)

    warm = None
    for j, P in enumerate(sorted(set(t["prompt_lens"]))):
        warm = _prefill(run, serve_batch(cell.sizes, t, seed, _WARM_INDEX + j, P, device)) + (P,)
    token, states, P = warm
    if device.type == "cuda":
        run.graphs = DecodeGraphs(model, token, states, P)

    def make_multi(k):
        if run.graphs is not None:
            return run.graphs.build(k)

        def eager(token, states, pos):
            toks = []
            for _ in range(k):
                lg, states = model.decode_step(token, states, pos)
                token = lg.argmax(-1)[:, None]
                toks.append(token)
                pos += 1
            return token, states, pos, torch.cat(toks, dim=1)
        return eager

    gen = t["gen"]
    run.ks = tuple(k for k in DECODE_KS if k <= gen) or (1,)
    run.make_multi = make_multi
    space = SearchSpace([ChoiceDim("k", run.ks)])
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    extra = decode_extra(cell.config["port"]["arch"], bool(cell.config["port"].get("tiny")),
                         t["batch"], card, run.graphs is not None)
    run.router = ContextRouter(db=None, jobs=max(1, len(DECODE_KS)))
    run.router.register(ROUTE, space=lambda: space, build=lambda point: make_multi(point["k"]),
                        defaults=lambda: {"k": 1}, epsilon=t["epsilon"], num_opt=3, max_iter=4,
                        measure=None, drift={"window": 8, "min_samples": 4, "factor": 1.5},
                        extra=extra)
    run.router.tuner(ROUTE).prewarm([{"k": k} for k in run.ks], wait=True)
    del warm, token, states
    run._sync()
    return run


def _decode(run: ServeRun, token, states, pos, gen: int) -> torch.Tensor:
    """``gen`` greedy tokens after ``token``, chunk by chunk as the router
    decides (the launcher's loop); returns them (B, gen) on the device."""
    router, tuner = run.router, run.router.tuner(ROUTE)
    out = torch.empty((token.shape[0], gen), dtype=torch.int64, device=run.device)
    emitted, tail = 0, {}
    while emitted < gen:
        rem = gen - emitted
        if rem < run.ks[-1]:
            k = max(1, min(int(tuner.exploit_point().get("k", 1)), rem))
            fn = tuner.executable_for({"k": k}) if k in run.ks else None
            fn = fn or tail.setdefault(k, run.make_multi(k))
            token, states, pos, toks = fn(token, states, pos)
            out[:, emitted:emitted + k] = toks
            run._sync()
            emitted += k
            continue
        decision = router.begin(ROUTE)
        k = int(decision.point["k"])
        tc = time.perf_counter()
        fn = decision.executable or tail.setdefault(k, run.make_multi(k))
        token, states, pos, toks = fn(token, states, pos)
        out[:, emitted:emitted + k] = toks
        run._sync()
        router.observe(decision, (time.perf_counter() - tc) / k)
        emitted += k
    return out


def serve_one(run: ServeRun, index: int, P: int, gen: int) -> dict:
    """Batch ``index`` of the mix at prompt length ``P``: prefill, then
    ``gen`` decoded tokens; returns its times and served tokens (host)."""
    t = run.cell.traffic
    batch = serve_batch(run.cell.sizes, t, run.seed, index, P, run.device)
    run._sync()
    t0 = time.perf_counter()
    with torch.profiler.record_function("bench.prefill"):
        token, states = _prefill(run, batch)
        first = token.cpu()
    t1 = time.perf_counter()
    with torch.profiler.record_function("bench.decode"):
        out = _decode(run, token, states, P, gen).cpu()
    t2 = time.perf_counter()
    return {"index": index, "P": P, "prefill_s": t1 - t0, "decode_s": t2 - t1,
            "served": torch.cat([first, out], dim=1)}


def run_window(run: ServeRun, seconds: float) -> dict:
    """Batches one after another until ``seconds`` have passed (the batch in
    flight finishes); rates over all of them."""
    t = run.cell.traffic
    lengths = prompt_lengths(t, run.seed, 1 << 16)
    before = run.router.stats()
    t0 = time.perf_counter()
    while True:
        i = len(run.done)
        run.done.append(serve_one(run, i, lengths[i], t["gen"]))
        if time.perf_counter() - t0 >= seconds:
            break
    after = run.router.stats()
    B, F = t["batch"], t.get("frames", 0)
    return {
        "batches": len(run.done),
        "requests": B * len(run.done),
        "prefill_positions": sum(B * (d["P"] + F) for d in run.done),
        "prefill_s": sum(d["prefill_s"] for d in run.done),
        "decode_tokens": B * t["gen"] * len(run.done),
        "decode_s": sum(d["decode_s"] for d in run.done),
        "router": {k: after[k] - before[k] for k in ("explores", "exploits", "inband_builds",
                                                     "drift_resets", "calls")},
    }


def free(run: ServeRun) -> None:
    if run.router is not None:
        run.router.wait_pending()
    run.model = run.graphs = run.router = run.make_multi = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sample(run: ServeRun, n: int) -> list:
    """(batch, row) pairs drawn from the seed among the window's requests,
    one of them from a batch at the longest prompt."""
    rng = random.Random(mix_seed(run.seed, "sample"))
    B = run.cell.traffic["batch"]
    longest = max(d["P"] for d in run.done)
    pairs = [(i, r) for i in range(len(run.done)) for r in range(B)]
    first = rng.choice([p for p in pairs if run.done[p[0]]["P"] == longest])
    rest = [p for p in pairs if p != first]
    return [first] + rng.sample(rest, min(n - 1, len(rest)))


def _sequence(run: ServeRun, i: int, r: int) -> tuple:
    """(reference batch of one row: prompt + served tokens but the last,
    served tokens) of request (batch ``i``, row ``r``)."""
    d = run.done[i]
    t = run.cell.traffic
    batch = serve_batch(run.cell.sizes, t, run.seed, d["index"], d["P"], run.device)
    served = d["served"][r].to(run.device)
    seq = {"tokens": torch.cat([batch["tokens"][r], served[:-1]])[None]}
    if "frames" in batch:
        seq["frames"] = batch["frames"][r:r + 1]
    return seq, served


def gaps(run: ServeRun, pairs: list, controls=()) -> dict:
    """For the requests in ``pairs``: the widest gap by which a served
    token's reference logit lies below the reference's best (``program``),
    and for each precision in ``controls`` the same for the token that the
    reference computed in that precision puts first at each position."""
    out = {p: 0.0 for p in ("program",) + tuple(controls)}
    for i, r in pairs:
        seq, served = _sequence(run, i, r)
        P = run.done[i]["P"]
        ref = reference_logits(run.cell, run.seed, seq, run.device)[0, P - 1:]
        best = ref.max(dim=-1).values
        for name in out:
            toks = served if name == "program" else reference_logits(
                run.cell, run.seed, seq, run.device, name)[0, P - 1:].argmax(-1)
            gap = best - ref.gather(-1, toks[:, None])[:, 0]
            out[name] = max(out[name], float(gap.max()))
        del ref
    return out
