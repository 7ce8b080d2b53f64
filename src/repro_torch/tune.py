"""``python -m repro_torch.tune`` — the umbrella CLI for the tuning fleet.

One front door for every offline tuning workflow::

    python -m repro_torch.tune pretune --db tuned/cuda.json --smoke
    python -m repro_torch.tune pretune --db tuned/s0.json --smoke --shard 0/2
    python -m repro_torch.tune db merge --out tuned/all.json tuned/s0.json tuned/s1.json
    python -m repro_torch.tune db list --db tuned/all.json
    python -m repro_torch.tune db list --db tuned/all.json --grid --smoke
    python -m repro_torch.tune db diff tuned/all.json tuned/unsharded.json
    python -m repro_torch.tune report /tmp/obs

* ``pretune`` — the offline sweep (:mod:`repro_torch.tuning.pretune`, every flag
  forwarded unchanged; ``python -m repro_torch.tuning.pretune`` runs the
  same sweep).  Like it, ``db list --grid`` keys the card's contexts and
  needs a card unless ``--interpret`` asks for the CPU's.
* ``db merge`` — fold shard DBs into one, resolving per-key conflicts with
  the fleet's total-order keep-better rule
  (:func:`repro_torch.tuning.fleet.merge_dbs`): associative, order-independent,
  and identical to what ``Autotuning.commit()`` would have kept.  Sources
  may also be run journals (``<db>.journal``) from workers that died
  mid-sweep — their committed records fold, interrupted cases are absent.
* ``db list`` — the records of a DB; ``--grid`` shows the registered
  pretune grid with per-case hit status instead (absorbing the historical
  ``pretune --list``), ``--shard i/n`` restricts either view to one fleet
  shard.
* ``db diff`` — compare two DBs' best points; exit 1 on any mismatch (the
  CI shard-equivalence gate).
* ``report`` — render the observability artifacts a ``pretune --obs-dir``
  run wrote (:mod:`repro_torch.obs.report`): search timeline, per-phase time
  breakdown, candidate accounting, metrics, fleet shard health.  Exit 1
  when the event stream fails schema validation or the candidate
  accounting does not balance.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

__all__ = ["main"]

_USAGE = """usage: python -m repro_torch.tune <command> ...

commands:
  pretune            offline tuning sweep (see: pretune --help)
  db merge           fold shard DBs into one (keep-better conflict resolution)
  db list            show a DB's records (--grid: the pretune grid + hit status)
  db diff            compare two DBs' best points; exit 1 on mismatch
  report             render search forensics from an --obs-dir directory
"""


def _open_db(path: str, *, must_exist: bool = True, autosave: bool = True):
    from repro_torch.tuning import TuningDB

    if must_exist and not os.path.exists(path):
        raise FileNotFoundError(f"no tuning DB at {path}")
    return TuningDB(path, autosave=autosave)


def _open_source(path: str):
    """A merge source: a tuning DB file, or a run journal (``<db>.journal``)
    from a sweep that may have died mid-measurement — its committed records
    fold like any shard DB, interrupted cases are simply absent."""
    from repro_torch.tuning import RunJournal

    if not os.path.exists(path):
        raise FileNotFoundError(f"no tuning DB at {path}")
    if RunJournal.is_journal(path):
        return RunJournal(path).to_db()
    return _open_db(path)


# ------------------------------------------------------------------ db merge
def _db_merge(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.tune db merge",
        description="fold shard DBs into one, keep-better per key",
    )
    ap.add_argument("--out", required=True, help="destination DB (created/updated)")
    ap.add_argument(
        "sources", nargs="+", metavar="SRC",
        help="shard DB file(s) and/or run journals (<db>.journal) from "
             "workers that died mid-sweep — a journal's committed records "
             "fold like any shard DB",
    )
    args = ap.parse_args(argv)

    from repro_torch.tuning import TuningDB
    from repro_torch.tuning.fleet import merge_dbs

    try:
        sources = [_open_source(p) for p in args.sources]
    except FileNotFoundError as e:
        print(f"db merge: {e}", file=sys.stderr)
        return 2
    dest = TuningDB(args.out, autosave=False)
    stats = merge_dbs(dest, sources)
    dest.save()
    print(f"db merge: {stats} -> {args.out} ({len(dest)} records)")
    return 0


def _key_context(key) -> str:
    """Human-readable context column for a record's key.  Kernel keys render
    their argument shapes; launch-level keys have no array arguments
    (``shapes()`` is None) — their context lives in ``extra`` (shape name,
    device count, mode), so render that instead of the literal "None"."""
    shapes = key.shapes()
    if shapes is not None:
        return str(shapes)
    try:
        extra = json.loads(getattr(key, "extra", None) or "{}")
    except (TypeError, ValueError):
        extra = {}
    if extra:
        return "[" + " ".join(f"{k}={extra[k]}" for k in sorted(extra)) + "]"
    return "[no-args]"


# ------------------------------------------------------------------- db list
def _db_list(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.tune db list", description="show a tuning DB's records"
    )
    ap.add_argument("--db", default="tuned/cuda.json", help="DB file to read")
    ap.add_argument(
        "--grid", action="store_true",
        help="list the registered pretune grid with per-case DB hit status "
             "(exact hit / warm neighbor / cold) instead of raw records",
    )
    ap.add_argument("--smoke", action="store_true",
                    help="with --grid: the smoke grid (CI lane)")
    ap.add_argument("--interpret", action="store_true",
                    help="with --grid: fingerprint the CPU (interpret) contexts "
                         "instead of the card's")
    ap.add_argument(
        "--shard", type=str, default=None, metavar="I/N",
        help="restrict to the contexts of one fleet shard",
    )
    args = ap.parse_args(argv)

    from repro_torch.tuning import TuningDB

    db = TuningDB(args.db)
    shard = None
    if args.shard is not None:
        from repro_torch.tuning.fleet import parse_shard

        shard = parse_shard(args.shard)

    if args.grid:
        from repro_torch.tuning.pretune import _cases, _list_grid, _shard_filter

        if args.interpret:
            device = ("cpu", "cpu")
        else:
            import torch

            if not torch.cuda.is_available():
                print("db list --grid: no CUDA device to key the card's contexts "
                      "(pass --interpret for the CPU's)", file=sys.stderr)
                return 1
            device = ("cuda", torch.cuda.get_device_name(torch.cuda.current_device()))
        cases = _cases(args.smoke, None, abstract=True)
        if shard is not None:
            cases = _shard_filter(cases, args.smoke, None, None, shard, args.interpret, device)
        return _list_grid(cases, db, args.interpret, device)

    records = db.records()
    if shard is not None:
        index, num = shard
        records = [r for r in records if r.key.shard(num) == index]
    where = f" shard {shard[0]}/{shard[1]}" if shard is not None else ""
    print(f"{args.db}: {len(records)} records{where}")
    for rec in sorted(records, key=lambda r: r.key.encode()):
        shapes = _key_context(rec.key)
        conf = (f" ±{rec.cost_std * 1e3:.2f}ms(n={rec.repeats_spent})"
                if rec.known_std() is not None else "")
        strat = f" strategy={rec.strategy}" if rec.strategy else ""
        print(
            f"  {rec.key.name:<18} {shapes:<34} best={rec.point} "
            f"cost={rec.cost * 1e3:.3f}ms{conf} source={rec.source}{strat}"
        )
    return 0


# ------------------------------------------------------------------- db diff
def _db_diff(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.tune db diff",
        description="compare two DBs' best points; exit 1 on any mismatch",
    )
    ap.add_argument("a", metavar="A", help="first DB file")
    ap.add_argument("b", metavar="B", help="second DB file")
    ap.add_argument(
        "--costs", action="store_true",
        help="also require equal stored costs (default: points only — costs "
             "are measurement-noisy unless both runs used --cost analytic)",
    )
    args = ap.parse_args(argv)

    try:
        da, db_ = _open_db(args.a), _open_db(args.b)
    except FileNotFoundError as e:
        print(f"db diff: {e}", file=sys.stderr)
        return 2
    ka = {r.key.encode(): r for r in da.records()}
    kb = {r.key.encode(): r for r in db_.records()}
    bad = 0
    for k in sorted(set(ka) | set(kb)):
        ra, rb = ka.get(k), kb.get(k)
        if ra is None or rb is None:
            side = args.b if ra is None else args.a
            rec = rb if ra is None else ra
            print(f"  only in {side}: {rec.key.name} {_key_context(rec.key)}")
            bad += 1
        elif ra.point != rb.point:
            print(
                f"  point mismatch: {ra.key.name} {_key_context(ra.key)}: "
                f"{ra.point} (cost={ra.cost:.6g}) != {rb.point} (cost={rb.cost:.6g})"
            )
            bad += 1
        elif args.costs and ra.cost != rb.cost:
            print(
                f"  cost mismatch: {ra.key.name} {_key_context(ra.key)}: "
                f"{ra.cost:.6g} != {rb.cost:.6g}"
            )
            bad += 1
    if bad:
        print(f"db diff: {bad} mismatch(es) between {args.a} and {args.b}")
        return 1
    print(f"db diff: {args.a} and {args.b} agree on {len(ka)} records")
    return 0


# -------------------------------------------------------------------- report
def _report(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.tune report",
        description="render search forensics from an --obs-dir directory",
    )
    ap.add_argument("obs_dir", metavar="OBS_DIR",
                    help="directory a run wrote via --obs-dir / REPRO_OBS")
    ap.add_argument("--db", default=None,
                    help="tuning DB whose run journal to include as shard health")
    ap.add_argument(
        "--journal", action="append", default=None, metavar="PATH",
        help="run journal(s) to include as fleet shard health; repeatable",
    )
    ap.add_argument(
        "--stale", type=float, default=300.0, metavar="SECONDS",
        help="age of the last journal event past which an interrupted shard "
             "counts as STALLED rather than live (default: 300)",
    )
    args = ap.parse_args(argv)

    if not os.path.isdir(args.obs_dir):
        print(f"report: no obs directory at {args.obs_dir}", file=sys.stderr)
        return 2

    from repro_torch.obs.report import render_report

    text, code = render_report(
        args.obs_dir,
        db_path=args.db,
        journals=args.journal or (),
        stale_s=args.stale,
    )
    print(text, end="")
    return code


def _db(argv) -> int:
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m repro_torch.tune db {merge,list,diff} ...")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "merge":
        return _db_merge(rest)
    if cmd == "list":
        return _db_list(rest)
    if cmd == "diff":
        return _db_diff(rest)
    print(f"repro_torch.tune db: unknown subcommand {cmd!r}", file=sys.stderr)
    print("usage: python -m repro_torch.tune db {merge,list,diff} ...", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(_USAGE, file=sys.stderr)
        return 2
    if argv[0] in ("-h", "--help"):
        print(_USAGE)
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "pretune":
        # forwarded wholesale: the sweep owns its own (large) flag surface
        from repro_torch.tuning.pretune import main as pretune_main

        return pretune_main(rest, prog="repro_torch.tune pretune")
    if cmd == "db":
        return _db(rest)
    if cmd == "report":
        return _report(rest)
    print(f"repro_torch.tune: unknown command {cmd!r}", file=sys.stderr)
    print(_USAGE, file=sys.stderr)
    return 2


if __name__ == "__main__":
    try:
        code = main()
    except BrokenPipeError:  # e.g. `... db list | head` closing the pipe
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        code = 0
    raise SystemExit(code)
