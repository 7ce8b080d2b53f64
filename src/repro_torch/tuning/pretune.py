"""Offline pre-tuning sweep — fill the tuning DB before anyone pays online.

    PYTHONPATH=src python -m repro_torch.tuning.pretune --db tuned/cuda.json --smoke
    PYTHONPATH=src python -m repro_torch.tuning.pretune --db tuned/cuda.json \
        --kernel matmul --kernel flash_attention
    PYTHONPATH=src python -m repro_torch.tuning.pretune --db tuned/cuda.json --list
    PYTHONPATH=src python -m repro_torch.tuning.pretune --db /tmp/p.json --smoke --interpret

The sweep runs the CUDA kernels on the card.  ``--interpret`` asks for the
CPU instead: the kernels' plain PyTorch versions on CPU tensors, keyed
``{"interpret": true}`` like the JAX package's interpret-mode records.
Without ``--interpret`` and without a card the sweep stops with an error;
it never carries on on the CPU.

Sweeps the registered (kernel, shape) grid (the JAX package's: matmul,
flash attention, decode attention and the RG-LRU scan; inputs made from
numpy seeds), runs the PATSMA search per context, and commits every record
atomically.  A context already in the DB is an exact
hit: it replays with zero measurements, and the run summary counts it.
``--measure adaptive`` (the default) races each round's candidates;
``--measure fixed`` keeps the classic ``RuntimeCost`` fixed-repeat loop.

**Fleet sharding**: ``--shard i/n`` keeps only the contexts whose stable
fingerprint hash lands in shard ``i``; n workers with shards 0..n-1
partition the grid exactly, with zero coordination, and
:func:`repro_torch.tuning.fleet.merge_dbs` folds their DBs.
``--no-warm-start`` removes sweep-order dependence.

**Crash resume**: every sweep writes a write-ahead journal next to the DB
(``<db>.journal`` — one fsynced JSONL event per case).  A worker killed
mid-sweep restarts with ``--resume`` and re-measures nothing already
completed.

``--list`` prints the grid with each case's DB status (exact hit / warm
neighbor / cold) without tuning anything, and ``--only <glob>`` restricts a
sweep to matching cases.  ``--strategy csa+nm`` swaps the per-context
search for the paper's CSA→NM hybrid pipeline (or any
:func:`repro_torch.core.strategy.make_strategy` spec) at the same total
measurement budget; the spec is stamped on every committed record.

``--cost analytic`` swaps measurement for a deterministic cost: the call's
roofline lower bound, ``roofline(name, *args).bound_s`` (analytic FLOP and
bytes over the H100's peaks).  It does not depend on the knobs, so every
legal candidate of a context ties and the search trajectory alone decides
the committed point — deterministically, which together with
``--no-warm-start`` makes a sharded sweep reproduce the unsharded one.
Illegal tiles still cost ``inf`` (their build fails first).

``--launch`` tunes the launch-level grid instead of kernel tiles
(:mod:`repro_torch.launch.spaces`: the dp x tp factorization of
``--devices`` cards, else ``REPRO_DRYRUN_DEVICES``, else 8 — one HGX H100
node — microbatches, remat, collective chunking and the XLA preset's cost
terms) with the same journal, ``--shard``, ``--list``, ``--resume`` and
``--only`` handling.  ``--cost analytic`` scores each candidate with the
deterministic launch cost model on the H100 data sheet; ``--cost runtime``
counts each candidate's step with the dry run
(:mod:`repro_torch.launch.dryrun`: a fake process group of that many
ranks, DTensors on the meta device) and charges its roofline bound on the
same data sheet.  Both are host work: no kernel runs and no card is
needed.  ``--tiny`` tunes the reduced configs (the CPU tests).

    PYTHONPATH=src python -m repro_torch.tuning.pretune --launch --cost analytic \
        --smoke --db /tmp/launch.json
    PYTHONPATH=src python -m repro_torch.tuning.pretune --launch --cost runtime \
        --smoke --devices 8 --db /tmp/launch_dryrun.json

``python -m repro_torch.tune pretune`` is the same command behind the
umbrella CLI, which also provides ``db merge`` / ``db list`` / ``db diff`` and
``report``.
"""
from __future__ import annotations

import argparse
import fnmatch
import os
import sys
import time

import numpy as np
import torch


def _cases(smoke: bool, device, abstract: bool = False):
    """(kernel name, case label, thunk building the call args) grid.  Thunks
    defer tensor construction so filtering never materializes unused inputs.
    ``abstract=True`` yields meta tensors — enough for fingerprints and
    search spaces (both read only shape/dtype), so ``--list`` allocates
    nothing."""
    if abstract:
        def rnd(seed, shape):
            return torch.empty(shape, dtype=torch.float32, device="meta")

        def filled(value, shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device="meta")
    else:
        def rnd(seed, shape):
            x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
            return torch.from_numpy(x).to(device)

        def filled(value, shape, dtype=torch.float32):
            return torch.full(shape, value, dtype=dtype, device=device)

    if smoke:
        mm_shapes = [(64, 64, 64), (128, 128, 128)]
        fa_shapes = [(1, 2, 2, 64, 16)]
        da_shapes = [(2, 4, 2, 128, 16)]
        ls_shapes = [(2, 64, 32)]
    else:
        mm_shapes = [(128,) * 3, (256,) * 3, (512, 512, 256)]
        fa_shapes = [(1, 2, 2, 64, 16), (1, 4, 2, 128, 32), (2, 4, 4, 256, 32)]
        da_shapes = [(2, 4, 2, 128, 16), (4, 8, 2, 512, 32)]
        ls_shapes = [(2, 64, 32), (2, 256, 64)]

    cases = []
    for m, n, k in mm_shapes:
        cases.append(
            ("matmul", f"{m}x{n}x{k}",
             lambda m=m, n=n, k=k: (rnd(0, (m, k)), rnd(1, (k, n))))
        )
    for b, h, kh, s, hd in fa_shapes:
        cases.append(
            (
                "flash_attention",
                f"b{b}h{h}kh{kh}s{s}d{hd}",
                lambda b=b, h=h, kh=kh, s=s, hd=hd: (
                    rnd(0, (b, s, h, hd)),
                    rnd(1, (b, kh, s, hd)),
                    rnd(2, (b, kh, s, hd)),
                ),
            )
        )
    for b, h, kh, s, hd in da_shapes:
        cases.append(
            (
                "decode_attention",
                f"b{b}h{h}kh{kh}s{s}d{hd}",
                lambda b=b, h=h, kh=kh, s=s, hd=hd: (
                    rnd(0, (b, h, hd)),
                    rnd(1, (b, kh, s, hd)),
                    rnd(2, (b, kh, s, hd)),
                    filled(1, (b, s), torch.int32),  # every slot valid
                ),
            )
        )
    for b, t, d in ls_shapes:
        cases.append(
            (
                "lru_scan",
                f"b{b}t{t}d{d}",
                lambda b=b, t=t, d=d: (
                    filled(0.9, (b, t, d)),
                    rnd(1, (b, t, d)),
                    rnd(2, (b, d)),
                ),
            )
        )
    return cases


def _case_key(name: str, call_args, interpret: bool, device: tuple):
    """The context fingerprint :func:`tune_call` computes for this case,
    with ``device`` = (backend, device_kind) given explicitly so meta-tensor
    stand-ins key like the real inputs."""
    from repro_torch.kernels.autotuned import get_spec
    from repro_torch.tuning import make_key

    space = get_spec(name).space(*call_args)
    return make_key(name, args=call_args, space=space,
                    extra={"interpret": bool(interpret)},
                    backend=device[0], device_kind=device[1])


def _shard_filter(cases, smoke, wanted, only, shard, interpret: bool, device: tuple):
    """Keep the cases whose fingerprint lands in ``shard`` = (index, num).
    Assignment hashes the full context key (:meth:`TuningKey.shard`) of
    meta-tensor stand-ins, so every fleet worker computes the same
    partition with no coordination and without materializing the grid."""
    from repro_torch.tuning.fleet import in_shard

    index, num = shard
    abstract = {
        (n, label): build
        for n, label, build in _selected(_cases(smoke, None, abstract=True), wanted, only)
    }
    return [
        (n, label, build) for n, label, build in cases
        if in_shard(_case_key(n, abstract[(n, label)](), interpret, device), index, num)
    ]


def _analytic_cost_fn(name: str, call_args):
    """Deterministic stand-in for measurement: the call's roofline lower
    bound (:func:`repro_torch.kernels.autotuned.roofline`).  The same on
    every host and every run — what the fleet's shard-equivalence contract
    needs.  It does not depend on the knobs, so the candidates of a context
    tie and the (equally deterministic) search trajectory decides."""
    from repro_torch.kernels.autotuned import roofline

    bound = float(roofline(name, *call_args).bound_s)

    def cost(ex, *args):
        return bound

    return cost


def _selected(cases, wanted, only):
    """Filter the grid by --kernel names and --only globs (case ids match as
    ``kernel`` or ``kernel/label``)."""
    out = []
    for name, label, build in cases:
        if wanted is not None and name not in wanted:
            continue
        case_id = f"{name}/{label}"
        if only and not any(
            fnmatch.fnmatch(case_id, pat) or fnmatch.fnmatch(name, pat)
            for pat in only
        ):
            continue
        out.append((name, label, build))
    return out


def _space_size_str(space) -> str:
    """`size=raw/feasible` — the resolved product-space size and what is left
    after the validity predicates prune (equal when unconstrained)."""
    raw = space.size()
    if raw is None:
        return "size=∞"
    feas = space.constrained_size()
    return f"size={raw}/{feas if feas is not None else '?'}"


def _list_grid(cases, db, interpret: bool, device: tuple) -> int:
    """Print each case with its resolved space size and DB status: exact
    hit, warm neighbor, or cold."""
    from repro_torch.kernels.autotuned import get_spec

    for name, label, build in cases:
        call_args = build()
        space = get_spec(name).space(*call_args)
        key = _case_key(name, call_args, interpret, device)
        rec, exact = db.lookup(key)
        case_id = f"{name}/{label}"
        case_id = f"{case_id:<28} {_space_size_str(space):<14}"
        if exact:
            # the default CSA search is not news, only a non-default
            # strategy earns the column
            strat = (f" strategy={rec.strategy}"
                     if rec.strategy and rec.strategy != "csa" else "")
            print(f"  {case_id:<42} HIT   best={rec.point} "
                  f"cost={rec.cost * 1e3:.2f}ms source={rec.source}{strat}")
        elif rec is not None and key.distance(rec.key) != float("inf"):
            print(f"  {case_id:<42} warm  neighbor={rec.point} "
                  f"(shapes {rec.key.shapes()})")
        else:
            print(f"  {case_id:<42} cold")
    return 0


def _launch_main(args, db, *, max_iter: int) -> int:
    """The ``--launch`` family: sweep launch-level (arch, shape) contexts
    through :func:`repro_torch.launch.spaces.tune_launch` with the same
    journal / shard / list / resume machinery as the kernel grid."""
    from repro_torch import configs, obs
    from repro_torch.launch.spaces import (
        launch_cases,
        launch_key,
        launch_space,
        tune_launch,
    )
    from repro_torch.tuning import RunJournal

    n_devices = args.devices
    mode = "model" if args.cost == "analytic" else "dryrun"
    get_cfg = configs.get_tiny if args.tiny else configs.get
    cases = launch_cases(smoke=args.smoke)
    if args.only:
        cases = [
            (a, s) for a, s in cases
            if any(fnmatch.fnmatch(f"launch/{a}/{s}", pat)
                   or fnmatch.fnmatch(a, pat) for pat in args.only)
        ]
    if not cases:
        print("pretune: no launch cases match the given filters", file=sys.stderr)
        return 2

    def case_key(arch, shape_name):
        cfg = get_cfg(arch)
        shape = configs.SHAPES[shape_name]
        space = launch_space(cfg, shape, n_devices)
        return launch_key(arch, shape, n_devices, space, mode=mode), space

    if args.shard is not None:
        from repro_torch.tuning.fleet import in_shard, parse_shard

        index, num = parse_shard(args.shard)
        total = len(cases)
        cases = [
            (a, s) for a, s in cases if in_shard(case_key(a, s)[0], index, num)
        ]
        print(f"pretune: shard {index}/{num}: {len(cases)}/{total} launch cases")
        if not cases:
            db.save()
            return 0

    if args.list_grid:
        for arch, shape_name in cases:
            key, space = case_key(arch, shape_name)
            rec, exact = db.lookup(key)
            case_id = f"launch/{arch}/{shape_name}"
            case_id = f"{case_id:<40} {_space_size_str(space):<16}"
            if exact:
                print(f"  {case_id} HIT   best={rec.point} cost={rec.cost:.4g}s "
                      f"source={rec.source}")
            else:
                print(f"  {case_id} cold  devices={n_devices} mode={mode}")
        return 0

    jpath = RunJournal.path_for(args.db)
    done_keys: set = set()
    if args.resume:
        journal = RunJournal(jpath)
        s = journal.summary()
        done_keys = set(s["committed"]) | set(s["failed"])
        if s["committed"]:
            db.merge(journal.to_db())
        journal.resume()
        print(f"pretune: resume from {jpath}: skipping {len(done_keys)} "
              f"completed launch cases")
    else:
        if os.path.exists(jpath):
            os.remove(jpath)
        journal = RunJournal(jpath)

    n_done = n_hits = 0
    t_all = time.perf_counter()
    totals = {"measured": 0, "pruned": 0}
    sweep_span = obs.span("pretune", cases=len(cases), family="launch")
    sweep_span.__enter__()
    try:
        for arch, shape_name in cases:
            key, space = case_key(arch, shape_name)
            if key.encode() in done_keys:
                continue
            t0 = time.perf_counter()
            stats: dict = {}
            journal.start(key)
            rec = tune_launch(
                arch,
                shape_name,
                n_devices,
                db=db,
                mode=mode,
                num_opt=args.num_opt,
                max_iter=max_iter,
                seed=args.seed,
                search=args.strategy,
                warm_start=not args.no_warm_start,
                source="pretune",
                tiny=args.tiny,
                stats=stats,
            )
            dt = time.perf_counter() - t0
            totals["measured"] += int(stats.get("measured", 0))
            totals["pruned"] += int(stats.get("pruned", 0))
            if rec is None:
                journal.failed(key, "every candidate failed")
                print(f"  launch/{arch}/{shape_name}: every candidate failed; "
                      f"nothing stored ({dt:.1f}s)", file=sys.stderr)
                continue
            journal.commit(key, rec)
            n_hits += bool(stats.get("replayed"))
            sz = _space_size_str(space)
            replay = " (replayed)" if stats.get("replayed") else ""
            print(
                f"  launch/{arch}/{shape_name}: best={rec.point} "
                f"cost={rec.cost:.4g}s default={stats.get('default_point')} "
                f"default_cost={stats.get('default_cost'):.4g}s {sz} "
                f"measured={stats.get('measured', 0)} "
                f"pruned={stats.get('pruned', 0)}{replay} ({dt:.1f}s)"
            )
            n_done += 1
        db.save()
        print(
            f"pretune: {n_done} launch contexts tuned ({n_hits} exact hits, "
            f"{n_done - n_hits} searched), {len(db)} records in "
            f"{args.db} ({time.perf_counter() - t_all:.1f}s); "
            f"{totals['measured']} candidates scored ({mode}), "
            f"{totals['pruned']} constraint-pruned at zero cost"
        )
        return 0
    finally:
        sweep_span.__exit__(None, None, None)
        obs.shutdown()


def main(argv=None, prog: str = "repro_torch.tuning.pretune") -> int:
    ap = argparse.ArgumentParser(
        prog=prog, description="offline tuning sweep -> JSON DB"
    )
    ap.add_argument("--db", type=str, default="tuned/cuda.json", help="DB file to fill")
    ap.add_argument("--smoke", action="store_true", help="tiny grid + budget (CI lane)")
    ap.add_argument(
        "--kernel", action="append", default=None, help="restrict to kernel(s); repeatable"
    )
    ap.add_argument(
        "--only", action="append", default=None, metavar="GLOB",
        help="restrict to matching cases, e.g. 'matmul/128*'; repeatable",
    )
    ap.add_argument(
        "--list", action="store_true", dest="list_grid",
        help="print the registered grid with DB hit status; tune nothing",
    )
    ap.add_argument("--num-opt", type=int, default=3, help="CSA coupled solvers")
    ap.add_argument("--max-iter", type=int, default=None, help="CSA iterations (default 2 smoke / 4)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--interpret", action="store_true",
        help="run the kernels' plain PyTorch versions on the CPU instead of the CUDA kernels",
    )
    ap.add_argument(
        "--jobs", type=int, default=None,
        help="concurrent candidate builds per tuning round (default: REPRO_TUNE_JOBS or cpu count)",
    )
    ap.add_argument(
        "--measure", choices=("adaptive", "fixed"), default=None,
        help="measurement policy: adaptive racing + roofline prefilter, or the "
             "classic fixed-repeat loop (default: REPRO_TUNE_MEASURE or adaptive)",
    )
    ap.add_argument(
        "--strategy", type=str, default=None, metavar="SPEC",
        help="search strategy spec per context, e.g. 'csa+nm' (the paper's "
             "CSA→NM hybrid pipeline), 'csa:0.7+nm:0.3', or 'csa|nm' "
             "(portfolio); default: plain CSA — same total tell budget either way",
    )
    ap.add_argument(
        "--cost", choices=("runtime", "analytic"), default="runtime",
        help="candidate cost: measured time (default) or the call's "
             "deterministic roofline lower bound — noise-free, so sharded and "
             "unsharded sweeps land on identical best points",
    )
    ap.add_argument(
        "--objective", choices=("median", "p95", "p99"), default=None,
        help="statistic a candidate's measured repetitions reduce to "
             "(default median — classic PATSMA; p95/p99 tune for tail latency)",
    )
    ap.add_argument(
        "--shard", type=str, default=None, metavar="I/N",
        help="tune only this worker's deterministic slice of the grid "
             "(stable context-fingerprint hash mod N)",
    )
    ap.add_argument(
        "--no-warm-start", action="store_true",
        help="disable DB neighbor seeding: each context's search is "
             "independent of sweep order and of what the DB already holds",
    )
    ap.add_argument(
        "--obs-dir", type=str, default=None, metavar="DIR",
        help="write observability artifacts (events.jsonl, trace.json, "
             "metrics.json) into DIR; 'python -m repro_torch.tune report DIR' "
             "renders them (default: the REPRO_OBS env var, else off)",
    )
    ap.add_argument(
        "--resume", action="store_true",
        help="resume a killed sweep from its run journal (<db>.journal): "
             "cases already committed or failed are skipped",
    )
    ap.add_argument(
        "--launch", action="store_true",
        help="tune the launch-level grid (launch.spaces: mesh dp x tp "
             "factorization, microbatches, remat, collective chunking, XLA "
             "preset) instead of kernel tiles; '--cost analytic' scores "
             "candidates with the deterministic launch cost model, '--cost "
             "runtime' with the dry run's roofline bound (both host work, no card)",
    )
    ap.add_argument(
        "--devices", type=int, default=None,
        help="card count the launch grid factorizes (with --launch; default "
             "REPRO_DRYRUN_DEVICES, else 8, one HGX H100 node)",
    )
    ap.add_argument(
        "--tiny", action="store_true",
        help="with --launch: tune the reduced configs (the CPU tests)",
    )
    args = ap.parse_args(argv)

    if args.launch:
        from repro_torch import obs
        from repro_torch.core.costs import H100_SXM
        from repro_torch.tuning import TuningDB

        if args.obs_dir:
            obs.configure(args.obs_dir)
        else:
            obs.configure_from_env()
        db = TuningDB(args.db)
        args.devices = args.devices or int(os.environ.get("REPRO_DRYRUN_DEVICES") or 8)
        how = "launch model" if args.cost == "analytic" else "dry run"
        print(f"pretune: db={args.db} ({len(db)} records) {how} on {H100_SXM.name}, "
              f"{args.devices} cards")
        max_iter = args.max_iter if args.max_iter is not None else (2 if args.smoke else 4)
        return _launch_main(args, db, max_iter=max_iter)

    from repro_torch import obs
    from repro_torch.kernels.autotuned import exec_cache, registered, tune_call
    from repro_torch.tuning import RunJournal, TuningDB

    interpret = bool(args.interpret)
    if interpret:
        device = torch.device("cpu")
        dev_key = ("cpu", "cpu")
    else:
        if not torch.cuda.is_available():
            print("pretune: no CUDA device: the sweep runs the CUDA kernels on the card "
                  "(pass --interpret for the plain versions on the CPU)", file=sys.stderr)
            return 1
        device = torch.device("cuda", torch.cuda.current_device())
        dev_key = ("cuda", torch.cuda.get_device_name(device))

    wanted = set(args.kernel) if args.kernel else None
    unknown = (wanted or set()) - set(registered())
    if unknown:
        print(f"pretune: unknown kernel(s) {sorted(unknown)}", file=sys.stderr)
        return 2

    if args.obs_dir:
        obs.configure(args.obs_dir)
    else:
        obs.configure_from_env()

    max_iter = args.max_iter if args.max_iter is not None else (2 if args.smoke else 4)
    db = TuningDB(args.db)
    print(f"pretune: db={args.db} ({len(db)} records) device={dev_key[0]}/{dev_key[1]}")

    cases = _selected(_cases(args.smoke, device, abstract=args.list_grid), wanted, args.only)
    if not cases:
        print("pretune: no cases match the given filters", file=sys.stderr)
        return 2
    if args.shard is not None:
        from repro_torch.tuning.fleet import parse_shard

        index, num = parse_shard(args.shard)
        total = len(cases)
        cases = _shard_filter(cases, args.smoke, wanted, args.only, (index, num), interpret,
                              dev_key)
        print(f"pretune: shard {index}/{num}: {len(cases)}/{total} cases")
        if not cases:
            # an empty shard is a fleet worker with nothing to do, not an error
            db.save()
            return 0
    if args.list_grid:
        return _list_grid(cases, db, interpret, dev_key)

    # write-ahead run journal: 'start' before each case's measurement,
    # 'commit'/'failed' after — a killed shard restarts with --resume
    # re-measuring nothing already completed
    jpath = RunJournal.path_for(args.db)
    done_keys: set = set()
    if args.resume:
        journal = RunJournal(jpath)
        s = journal.summary()
        done_keys = set(s["committed"]) | set(s["failed"])
        if s["committed"]:
            db.merge(journal.to_db())  # even a DB save torn by the kill is rebuilt
        journal.resume()
        print(
            f"pretune: resume from {jpath}: {len(s['committed'])} committed, "
            f"{len(s['failed'])} failed, {len(s['interrupted'])} interrupted; "
            f"skipping {len(done_keys)} completed cases"
        )
    else:
        if os.path.exists(jpath):
            os.remove(jpath)  # a fresh sweep owns a fresh journal
        journal = RunJournal(jpath)

    n_done = n_hits = n_skipped = 0
    t_all = time.perf_counter()
    totals = {"reps": 0, "warmup_reps": 0, "calibration_reps": 0,
              "culled": 0, "pruned_roofline": 0, "measured": 0, "failed": 0}
    sweep_span = obs.span("pretune", cases=len(cases))
    sweep_span.__enter__()
    try:
        for name, label, build in cases:
            call_args = build()
            key = _case_key(name, call_args, interpret, dev_key)
            if key.encode() in done_keys:
                n_skipped += 1
                continue
            _, exact = db.lookup(key)
            t0 = time.perf_counter()
            mstats: dict = {}
            journal.start(key)
            rec = tune_call(
                name,
                *call_args,
                db=db,
                interpret=interpret,
                num_opt=args.num_opt,
                max_iter=max_iter,
                seed=args.seed,
                jobs=args.jobs,
                source="pretune",
                measure=args.measure,
                measure_stats=mstats,
                strategy=args.strategy,
                objective=args.objective,
                cost_fn=(_analytic_cost_fn(name, call_args) if args.cost == "analytic"
                         else None),
                warm_start=not args.no_warm_start,
            )
            dt = time.perf_counter() - t0
            for k in totals:
                totals[k] += int(mstats.get(k, 0))
            if rec is None:
                journal.failed(key, "every candidate failed")
                print(f"  {name}/{label}: every candidate failed; nothing stored ({dt:.1f}s)",
                      file=sys.stderr)
                continue
            journal.commit(key, rec)
            n_hits += bool(exact and not args.no_warm_start)
            crashed = f" crashed={rec.crashed}" if rec.crashed else ""
            strat = f" strategy={rec.strategy}" if rec.strategy and rec.strategy != "csa" else ""
            obj = f" objective={rec.objective}" if rec.objective and rec.objective != "median" else ""
            raced = ""
            if mstats.get("mode") == "adaptive" and mstats.get("measured"):
                raced = (f" reps={mstats['reps']}"
                         f" culled={mstats['culled']}"
                         f" pruned={mstats['pruned_roofline']}")
            hit = " exact-hit" if exact and not args.no_warm_start else ""
            print(
                f"  {name}/{label}: best={rec.point} cost={rec.cost * 1e3:.4f}ms "
                f"evals={rec.evals}{crashed}{strat}{obj}{raced}{hit} ({dt:.1f}s)"
            )
            n_done += 1
        db.save()
        cs = exec_cache().stats()
        skipped = f", {n_skipped} resumed-as-done" if n_skipped else ""
        print(
            f"pretune: {n_done} contexts tuned ({n_hits} exact hits, {n_done - n_hits} searched)"
            f"{skipped}, {len(db)} records in {args.db} "
            f"({time.perf_counter() - t_all:.1f}s); exec cache: {cs['misses']} builds, "
            f"{cs['hits']} hits, {cs['recompiles']} rebuilds"
        )
        if totals["measured"] or totals["reps"]:
            print(
                f"pretune: measurement: {totals['reps']} reps "
                f"(+{totals['warmup_reps']} warmup, {totals['calibration_reps']} "
                f"calibration) over {totals['measured']} candidates; "
                f"{totals['culled']} culled by racing, "
                f"{totals['pruned_roofline']} roofline-pruned, "
                f"{totals['failed']} failed"
            )
        return 0
    finally:
        sweep_span.__exit__(None, None, None)
        obs.shutdown()


if __name__ == "__main__":
    raise SystemExit(main())
