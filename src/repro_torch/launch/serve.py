"""Serving launcher: batched prefill + decode with a KV cache and
PATSMA-tuned decode fusion depth, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma_2b \
        --batch 8 --prompt-len 2048 --gen 64 --db tuned/serve.json
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6_7b --tiny --device cpu

Port of the JAX package's ``launch/serve.py``: the same flags plus
``--device`` (default ``cuda``).  The model runs with
``ExecConfig(attn_impl="cuda", rec_chunk=4)`` — the JAX launcher's
``ExecConfig(rec_chunk=4)`` with the kernel option switched on, so prefill
runs the hand-written CUDA scan kernels (``lru_scan`` in every RG-LRU
layer, ``rwkv_scan`` in every RWKV layer) when ``rec_chunk`` divides the
prompt length.  ``--device cpu`` runs the kernels' plain versions on the
CPU (``interpret=True``); without a card and without ``--device cpu`` the
launcher exits non-zero — there is no fallback.  Weights and the prompt
come from ``torch.Generator`` seeds 0 and 1 on the device; an
encoder–decoder model's ``frames`` and a VLM's ``ctx_embeds`` ((batch,
ctx_tokens, d_model), 0.1 × normals, as the JAX launcher builds them) from
seed 2.  An encoder–decoder prefill runs the encoder on the flash kernel
(bidirectional, ``causal=False``).

Decode is routed through a :class:`repro_torch.runtime.ContextRouter`: each
(arch × batch × device) is its own tuning context, an ε-fraction of decode
chunks explores a candidate fusion depth ``k`` (tokens emitted per
dispatched call), and the rest exploit the best known.  On the card a
candidate's "build" captures ``k`` decode steps and their argmaxes into one
CUDA graph (:class:`DecodeGraphs`), the counterpart of the JAX launcher's
one compiled executable of a ``lax.scan`` over ``k`` steps; a dispatched
call replays it.  A capture that fails raises: there is no eager fallback
on the card.  On the CPU a build is the eager loop of ``k`` steps.  No
build touches the live states.  A ``DriftDetector`` watches the per-token
exploit costs and re-tunes mid-stream when they degrade.  The tuning key's
``extra`` names the decode form (``"decode": "cuda_graph"`` on the card),
so a depth tuned for another form is never replayed as a graph's.

With ``--db`` the tuned ``k`` persists across launches: the second process
with the same context skips tuning and decodes at the stored best from the
first token.  ``--no-tune --db`` replays that stored best statically;
``--no-tune`` without a record decodes at ``k=1``.  ``--db`` is
repeatable: extra paths are fleet shard DBs folded read-only into the first
with the fleet's keep-better resolver.
"""
from __future__ import annotations

import argparse
import sys
import threading
import time

import torch

from repro_torch import configs
from repro_torch.core import ChoiceDim, SearchSpace
from repro_torch.models import ExecConfig, Model
from repro_torch.obs.trace import span
from repro_torch.runtime import ContextRouter
from repro_torch.tuning import TuningDB, make_key

__all__ = ["main", "serve", "replay_decode_k", "decode_extra", "DecodeGraphs", "DECODE_KS",
           "NoCudaDevice"]

#: candidate decode fusion depths (tokens emitted per dispatched call)
DECODE_KS = (1, 2, 4, 8)
#: per-layer state entries decode only reads (a cross block's context K/V)
READ_ONLY = ("xk", "xv")


def replay_decode_k(db, key, *, gen: int, default: int = 1) -> int:
    """Stored-best decode ``k`` for a context, for static (``--no-tune``)
    serving: an exact DB hit replays its point, otherwise ``default``.
    Clamped to the stream length."""
    k = default
    if db is not None and key is not None:
        rec = db.get(key)
        if rec is not None and "k" in rec.point:
            k = int(rec.point["k"])
    return max(1, min(k, gen))


def decode_extra(arch: str, tiny: bool, batch: int, card: str, graphs: bool) -> dict:
    """The ``extra`` of the decode-depth tuning key: the context (arch, tiny,
    batch, the card's name or ``"cpu"``) and, when decode runs as CUDA
    graphs, the form, so that records of the eager loop never hit."""
    extra = {"arch": arch, "tiny": tiny, "batch": batch, "device": card}
    if graphs:
        extra["decode"] = "cuda_graph"
    return extra


def _leaves(states: list) -> list:
    """The tensors of a model's per-layer states, in a fixed order."""
    out = []
    for st in states:
        for name in sorted(st):
            v = st[name]
            if isinstance(v, dict):
                out.extend(v[n] for n in sorted(v))
            else:
                out.append(v)
    return out


class DecodeGraphs:
    """Decode as CUDA graphs over one static set of buffers per served model.

    The set holds the token (B, 1), the position (a 0-d int64 tensor) and
    the per-layer states: the attention rings are the live ones (decode
    writes them in place), and so are a cross block's context K/V
    (``xk``/``xv``, written at prefill and only read by decode: never
    copied, not even for the warm-up), every recurrent state a compact copy
    made once here.  :meth:`build` captures ``k`` decode steps and their argmaxes into
    one ``torch.cuda.CUDAGraph`` against that set, with the new recurrent
    states, the last token and the advanced position copied back into it
    inside the graph; every depth's graph shares the set, so depths can be
    switched between calls.  Capture runs on a side stream with
    ``capture_error_mode="thread_local"`` (builds run on the router's pool
    while the serving thread replays and synchronizes), one capture at a
    time; the warm-up it needs runs a real step, on scratch copies of the
    states, never on the live rings.  A failed capture raises."""

    _capture_lock = threading.Lock()

    def __init__(self, model, token: torch.Tensor, states: list, pos: int):
        if model.device.type != "cuda":
            raise ValueError("DecodeGraphs: CUDA graphs need the model on the card")
        self.model = model
        self.token = token.clone()
        self.pos = torch.tensor(pos, dtype=torch.int64, device=model.device)
        self.states = [
            {name: (v if isinstance(v, dict) or name in READ_ONLY
                    else v.clone(memory_format=torch.contiguous_format))
             for name, v in st.items()}
            for st in states
        ]
        self.captures = 0

    def _steps(self, k: int, token, states, pos):
        """``k`` decode steps from (token, states, pos); pos advances in place."""
        toks = []
        for _ in range(k):
            logits, states = self.model.decode_step(token, states, pos)
            token = logits.argmax(-1)[:, None]
            toks.append(token)
            pos.add_(1)
        return token, states, torch.cat(toks, dim=1), logits

    def load(self, token, states, pos) -> None:
        """Copy a (token, states, pos) that is not the static set into it."""
        if token is not self.token:
            self.token.copy_(token)
        if pos is not self.pos:
            self.pos.copy_(torch.as_tensor(pos, dtype=torch.int64))
        for dst, src in zip(_leaves(self.states), _leaves(states)):
            if dst is not src:
                dst.copy_(src)

    @torch.no_grad()
    def build(self, k: int):
        """Capture ``k`` steps; returns ``run(token, states, pos) -> (token,
        states, pos, toks)``, which replays them (``toks`` (B, k) and the
        runner's ``logits`` of the last step belong to the graph: the next
        replay overwrites them).  A run's loads and replay are the span
        ``graphs.replay``."""
        dev = self.model.device
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(device=dev)
        with DecodeGraphs._capture_lock, torch.cuda.device(dev), torch.cuda.stream(side):
            scratch = [
                {name: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                        else v if name in READ_ONLY else v.clone())
                 for name, v in st.items()}
                for st in self.states
            ]
            self._steps(1, self.token.clone(), scratch, self.pos.clone())
            side.synchronize()
            del scratch
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                token, states, toks, logits = self._steps(k, self.token, self.states, self.pos)
                for dst, src in zip(_leaves(self.states), _leaves(states)):
                    if dst is not src:
                        dst.copy_(src)
                self.token.copy_(token)
            finally:
                graph.capture_end()
            self.captures += 1

        def run(token, states, pos):
            with span("graphs.replay", "serve", k=k):
                self.load(token, states, pos)
                graph.replay()
            return self.token, self.states, self.pos, toks

        run.logits = logits
        return run


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", type=str, default="recurrentgemma_2b",
                    help=f"architecture id; ported: {configs.ARCH_IDS}")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--no-tune", action="store_true")
    ap.add_argument("--db", type=str, default=None, action="append",
                    help="tuning DB path; persists the tuned decode k across "
                         "runs.  Repeatable: extra paths are fleet shard DBs "
                         "merged (keep-better) into the first at startup")
    ap.add_argument("--epsilon", type=float, default=0.25,
                    help="explored fraction of decode chunks while tuning")
    ap.add_argument("--objective", choices=("median", "p95", "p99"), default="median",
                    help="statistic the decode-k search minimizes (p95/p99 "
                         "tune for tail latency; the drift detector watches "
                         "the same quantile)")
    ap.add_argument("--obs-dir", type=str, default=None,
                    help="write observability artifacts (events.jsonl, "
                         "trace.json, metrics.json) into this directory "
                         "(default: the REPRO_OBS env var, else off)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default: the CUDA kernels on the card) or cpu "
                         "(the kernels' plain versions)")
    return ap


class NoCudaDevice(RuntimeError):
    """The server was asked for the card and there is none."""


def main(argv=None) -> int:
    try:
        serve(argv)
    except NoCudaDevice as e:
        print(f"serve: {e}", file=sys.stderr)
        return 1
    return 0


def serve(argv=None) -> dict:
    """Run the launcher; returns what it measured: ``prefill_ms``,
    ``decode_tok_s``, ``k``, ``db_hit``, the prefill's last-token ``hidden``,
    the ``model`` and ``batch`` (for a caller that checks the result), on the
    card the decode ``graphs``, and when tuning online the ``router``'s stats."""
    args = _parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDevice("no CUDA device: the server runs the CUDA kernels on the card "
                           "(pass --device cpu for the plain versions on the CPU)")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda or cpu, got {args.device!r}")

    from repro_torch import obs

    if args.obs_dir:
        obs.configure(args.obs_dir)
    else:
        obs.configure_from_env()
    try:
        with obs.span("serve", gen=args.gen):
            return _serve(args, device)
    finally:
        obs.shutdown()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve(args, device: torch.device) -> dict:
    cfg = configs.get_tiny(args.arch) if args.tiny else configs.get(args.arch)
    exec_cfg = ExecConfig(attn_impl="cuda", rec_chunk=4, interpret=device.type == "cpu")
    model = Model(cfg, exec_cfg, device=device, seed=0)
    B, P = args.batch, args.prompt_len
    max_len = P + args.gen
    gen = torch.Generator(device=device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=device),
             "max_len": max_len}
    if cfg.is_encdec or cfg.family == "vlm":
        gen.manual_seed(2)
        ctx = 0.1 * torch.randn((B, cfg.ctx_tokens, cfg.d_model), generator=gen, device=device)
        batch["frames" if cfg.is_encdec else "ctx_embeds"] = ctx
    out = {"model": model, "batch": batch, "db_hit": False}

    _sync(device)
    t0 = time.perf_counter()
    hidden, states = model.prefill(batch)
    logits = model.logits(hidden[:, None])[:, 0]
    token = logits.argmax(-1)[:, None]
    _sync(device)
    out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    out["hidden"] = hidden
    print(f"prefill {B}x{P}: {out['prefill_ms']:.0f} ms")

    graphs = None
    pos = P
    if device.type == "cuda":
        # the static set: the live rings, the recurrent states copied once
        graphs = DecodeGraphs(model, token, states, P)
        token, states, pos = graphs.token, graphs.states, graphs.pos
        out["graphs"] = graphs

    def make_multi(k):
        if graphs is not None:
            return graphs.build(k)

        def run(token, states, pos):
            toks = []
            for _ in range(k):
                lg, states = model.decode_step(token, states, pos)
                token = lg.argmax(-1)[:, None]
                toks.append(token)
                pos += 1
            return token, states, pos, torch.cat(toks, dim=1)
        return run

    # only depths that fit the stream are candidates: a k > --gen chunk can
    # never run whole, so it could never be measured
    ks = tuple(k for k in DECODE_KS if k <= args.gen) or (1,)
    space = SearchSpace([ChoiceDim("k", ks)])
    db = None
    if args.db:
        db = TuningDB(args.db[0])
        if len(args.db) > 1:
            from repro_torch.tuning.fleet import merge_dbs

            stats = merge_dbs(db, [TuningDB(p, autosave=False) for p in args.db[1:]])
            print(f"merged {len(args.db) - 1} shard DB(s) into {args.db[0]}: {stats}")
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    extra = decode_extra(args.arch, args.tiny, args.batch, card, graphs is not None)
    key = make_key("serve/decode_k", space=space, extra=extra) if db else None
    tail_fns = {}  # final-chunk sizes (k > remaining)

    if args.no_tune:
        # static serving still honours the DB: replay the stored-best k
        k_static = replay_decode_k(db, key, gen=args.gen)
        if db is not None and k_static != 1:
            print(f"--no-tune: replaying stored decode k={k_static} from {args.db[0]}")
        emitted = 0
        t0 = time.perf_counter()
        while emitted < args.gen:
            k = min(k_static, args.gen - emitted)
            fn = tail_fns.setdefault(k, make_multi(k))
            token, states, pos, toks = fn(token, states, pos)
            _sync(device)
            emitted += k
        wall = time.perf_counter() - t0
        print(f"decode: {emitted} tok/seq x {B} in {wall*1e3:.0f} ms "
              f"({B*emitted/wall:.0f} tok/s); static k={k_static}")
        out.update(decode_tok_s=B * emitted / wall, k=k_static)
        return out

    # adaptive serving: per-(arch, batch, device) decode-k context with
    # background candidate builds and mid-stream drift re-tuning
    router = ContextRouter(db=db, jobs=max(1, len(DECODE_KS)))
    router.register(
        "serve/decode_k",
        space=lambda: space,
        build=lambda point: make_multi(point["k"]),
        defaults=lambda: {"k": 1},
        epsilon=args.epsilon,
        num_opt=3,
        max_iter=4,
        # tail objectives need a multi-rep stream per candidate (the p99 of
        # one rep is that rep); the median default keeps the classic
        # one-explore-one-measurement serving loop
        measure=None if args.objective == "median"
        else {"mode": "fixed", "repeats": 8, "objective": args.objective},
        drift={"window": 8, "min_samples": 4, "factor": 1.5},
        extra=extra,
    )
    tuner = router.tuner("serve/decode_k")
    # prewarm every candidate that fits the stream (on a DB hit, just the
    # stored best) so the first token needs no in-band build
    if tuner.finished:
        points = [{"k": min(int(tuner.best_point["k"]), args.gen)}]
        out["db_hit"] = True
        print(f"tuning db hit: decode k={tuner.best_point['k']} (no online tuning)")
    else:
        points = [{"k": k} for k in ks]
    t0 = time.perf_counter()
    tuner.prewarm(points, wait=True)
    print(f"prepared decode variants k={[p['k'] for p in points]} "
          f"in {(time.perf_counter() - t0) * 1e3:.0f} ms")

    emitted = 0
    t0 = time.perf_counter()
    while emitted < args.gen:
        rem = args.gen - emitted
        if rem < ks[-1]:
            # stream tail: not every candidate fits any more, so don't
            # consume a routing decision that might be unmeasurable — serve
            # the clamped best unmeasured
            k = max(1, min(int(tuner.exploit_point().get("k", 1)), rem))
            fn = tuner.executable_for({"k": k}) if k in ks else None
            if fn is None:
                fn = tail_fns.setdefault(k, make_multi(k))
            token, states, pos, toks = fn(token, states, pos)
            _sync(device)
            emitted += k
            continue
        decision = router.begin("serve/decode_k")
        k = int(decision.point["k"])  # always <= ks[-1] <= rem here
        tc = time.perf_counter()
        fn = decision.executable
        if fn is None:  # cold exploit before the background build lands
            fn = tail_fns.setdefault(k, make_multi(k))
        token, states, pos, toks = fn(token, states, pos)
        _sync(device)
        router.observe(decision, (time.perf_counter() - tc) / k)
        emitted += k
    wall = time.perf_counter() - t0
    rs = router.stats()
    print(f"decode: {emitted} tok/seq x {B} in {wall*1e3:.0f} ms "
          f"({B*emitted/wall:.0f} tok/s); tuned k={tuner.best_point.get('k')}")
    print(f"router: {rs['explores']} explore / {rs['exploits']} exploit chunks, "
          f"{rs['drift_resets']} drift re-tunes, "
          f"{rs['cache']['misses']} builds ({rs['inband_builds']} in-band), "
          f"{rs['cache']['recompiles']} rebuilds")
    out.update(decode_tok_s=B * emitted / wall, k=tuner.best_point.get("k"), router=rs)
    return out


if __name__ == "__main__":
    raise SystemExit(main())
