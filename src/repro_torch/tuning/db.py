"""JSON-on-disk tuning database with atomic writes and corrupt-file recovery.

Layout (versioned)::

    {
      "schema": 1,
      "records": { "<key.encode()>": {record json}, ... }
    }

* **Atomic writes** — saves go through a same-directory temp file + fsync +
  ``os.replace`` so a crash mid-save never corrupts an existing DB, and
  concurrent writers leave one winner, not a splice.
* **Corrupt recovery** — an unreadable/garbage file is moved aside to
  ``<path>.corrupt`` and the DB starts empty instead of crashing the host
  program (tuning is an accelerant, never a point of failure).
* **Schema gating** — a future-schema file is left untouched on disk and
  ignored in memory.

:class:`RunJournal` is the write-ahead companion for long sweeps
(``pretune``): an append-only JSONL file next to the DB recording, per case,
a ``start`` event before measurement and a ``commit``/``failed`` event after
— each append fsynced, torn trailing lines tolerated on load.  A killed run
restarts with ``--resume`` re-measuring nothing already committed, and
``python -m repro_torch.tune db merge`` folds a partial journal like any shard DB.

``default_db()`` gives library call sites (the kernels' ``autotuned`` entry
point) a process-wide DB without plumbing: file-backed when the
``REPRO_TUNING_DB`` env var names a path, otherwise in-memory.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Optional, Tuple

from repro_torch.obs.log import get_logger

from .records import SCHEMA_VERSION, TuningKey, TuningRecord

log = get_logger(__name__)

__all__ = ["TuningDB", "RunJournal", "default_db"]


def _fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed/just-created entry is durable —
    without it, a power loss after ``os.replace`` can resurrect the old file
    (the rename lived only in the directory's page cache).  Best-effort:
    platforms that cannot open directories (Windows) skip silently."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - non-POSIX
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - fs without dir fsync
        pass
    finally:
        os.close(fd)

#: env var naming the process-default DB file
ENV_DB_PATH = "REPRO_TUNING_DB"


class TuningDB:
    """Context-keyed store of :class:`TuningRecord`.  ``path=None`` → in-memory."""

    def __init__(self, path: Optional[str] = None, *, autosave: bool = True) -> None:
        self.path = os.fspath(path) if path is not None else None
        self.autosave = autosave
        self._lock = threading.Lock()
        self._records: dict = {}  # encoded key -> TuningRecord
        if self.path is not None:
            self.load()

    # ----------------------------------------------------------------- io
    def load(self) -> int:
        """(Re)load from disk; returns the number of records loaded."""
        if self.path is None or not os.path.exists(self.path):
            return 0
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                blob = json.load(f)
            if not isinstance(blob, dict) or "records" not in blob:
                raise ValueError("not a tuning DB")
            if int(blob.get("schema", -1)) > SCHEMA_VERSION:
                log.warning(
                    "%s: schema %s is newer than supported (%s); ignoring file",
                    self.path, blob.get("schema"), SCHEMA_VERSION,
                )
                return 0
            records = {}
            for k, rj in blob["records"].items():
                records[k] = TuningRecord.from_json(rj)
            with self._lock:
                self._records = records
            return len(records)
        except Exception as e:  # corrupted → quarantine and start fresh
            backup = self.path + ".corrupt"
            try:
                os.replace(self.path, backup)
                note = f"moved to {backup}"
            except OSError:
                note = "could not quarantine"
            log.warning(
                "%s: unreadable (%r); %s; starting empty", self.path, e, note
            )
            with self._lock:
                self._records = {}
            return 0

    def save(self) -> None:
        """Atomic write (temp file in the same directory + os.replace)."""
        if self.path is None:
            return
        with self._lock:
            blob = {
                "schema": SCHEMA_VERSION,
                "records": {k: r.to_json() for k, r in sorted(self._records.items())},
            }
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".tuningdb-", dir=d)
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(blob, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            # durability needs the *rename* on disk too, not just the bytes:
            # fsync the containing directory or a crash can resurrect the
            # old file contents
            _fsync_dir(d)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # ------------------------------------------------------------- queries
    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def keys(self) -> list:
        with self._lock:
            return list(self._records)

    def records(self) -> list:
        with self._lock:
            return list(self._records.values())

    def get(self, key: TuningKey) -> Optional[TuningRecord]:
        with self._lock:
            return self._records.get(key.encode())

    def nearest(self, key: TuningKey) -> Optional[TuningRecord]:
        """Closest warm-start neighbor: same computation + hardware, nearest
        array shapes by log distance (see :meth:`TuningKey.distance`)."""
        best, best_d = None, float("inf")
        for rec in self.records():  # snapshot: concurrent put() must not race
            d = key.distance(rec.key)
            if d < best_d:
                best, best_d = rec, d
        return best

    def lookup(self, key: TuningKey) -> Tuple[Optional[TuningRecord], bool]:
        """(record, exact).  Exact hit → replay with zero re-measurement;
        neighbor hit → seed the search around the stored point."""
        rec = self.get(key)
        if rec is not None:
            return rec, True
        return self.nearest(key), False

    # ------------------------------------------------------------- updates
    def put(self, record: TuningRecord, *, save: Optional[bool] = None) -> None:
        """Insert/overwrite; persists immediately when file-backed (autosave)."""
        with self._lock:
            self._records[record.key.encode()] = record
        if save if save is not None else (self.autosave and self.path is not None):
            self.save()

    def merge(self, other: "TuningDB", *, prefer_lower_cost: bool = True) -> int:
        """Fold another DB in; returns the number of records adopted.

        Conflicts resolve through the fleet merge resolver
        (:func:`repro_torch.tuning.fleet.better_record`): the keep-better rule of
        ``Autotuning.commit()`` linearized into a total order — lower cost
        wins, and inside the noise band the better-measured (lower-variance)
        record stands, so folding shard DBs is associative and
        order-independent.  ``prefer_lower_cost=False`` adopts every
        incoming record unconditionally (a forced overwrite, not a merge)."""
        from .fleet import better_record

        n = 0
        for rec in other.records():
            mine = self.get(rec.key)
            if (
                mine is None
                or not prefer_lower_cost
                or better_record(mine, rec) is rec
            ):
                self.put(rec, save=False)
                n += 1
        if self.autosave and self.path is not None:
            self.save()
        return n


# ----------------------------------------------------------- run journal
class RunJournal:
    """Append-only write-ahead journal for a tuning sweep.

    One JSONL event per line, each append flushed *and fsynced* before the
    sweep proceeds — the journal is the authority on which cases completed,
    so it must hit the disk before the work it describes is assumed done:

    * ``{"event": "start",  "key": <encoded>}`` — measurement is about to
      begin for this case; a start with no matching commit/failed marks a
      run that died mid-measurement (*interrupted*).
    * ``{"event": "commit", "key": <encoded>, "record": {...}}`` — the
      case's committed :class:`TuningRecord` (full JSON, so a journal alone
      can reconstruct a DB — ``python -m repro_torch.tune db merge`` accepts journals as
      sources).
    * ``{"event": "failed", "key": <encoded>, "error": "..."}`` — the case
      completed with no record (e.g. every candidate crashed).  Resumes skip
      it rather than re-dying.
    * ``{"event": "resume"}`` — a ``--resume`` run re-attached.

    Loading tolerates a torn trailing line (power loss mid-append): the
    dangling tail is treated as absent, never as corruption of the whole
    journal.  The conventional location is :meth:`path_for` (``<db>.journal``).
    """

    def __init__(self, path: str) -> None:
        self.path = os.fspath(path)
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)

    @staticmethod
    def path_for(db_path: str) -> str:
        """The conventional journal location for a DB file."""
        return os.fspath(db_path) + ".journal"

    # ------------------------------------------------------------- writing
    def append(self, event: dict) -> None:
        """Durably append one event (fsync before returning; on a fresh
        journal the containing directory is fsynced too so the file itself
        survives a crash)."""
        event = dict(event)
        event.setdefault("ts", time.time())  # shard liveness (obs report)
        line = json.dumps(event, sort_keys=True, default=repr)
        fresh = not os.path.exists(self.path)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
        if fresh:
            _fsync_dir(os.path.dirname(os.path.abspath(self.path)))

    def start(self, key) -> None:
        self.append({"event": "start", "key": self._enc(key)})

    def commit(self, key, record: TuningRecord) -> None:
        self.append(
            {"event": "commit", "key": self._enc(key), "record": record.to_json()}
        )

    def failed(self, key, error: BaseException | str) -> None:
        self.append({"event": "failed", "key": self._enc(key), "error": str(error)})

    def resume(self) -> None:
        self.append({"event": "resume"})

    @staticmethod
    def _enc(key) -> str:
        return key.encode() if isinstance(key, TuningKey) else str(key)

    # ------------------------------------------------------------- reading
    def events(self) -> list:
        """Parsed events, in order.  A line that fails to parse ends the
        journal (append-only: anything after a torn line is unreachable
        anyway); the cut is reported once on stderr."""
        if not os.path.exists(self.path):
            return []
        out: list = []
        with open(self.path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    log.warning(
                        "%s: torn/garbled journal line %d; keeping the %d "
                        "events before it", self.path, i + 1, len(out)
                    )
                    break
                if isinstance(ev, dict) and "event" in ev:
                    out.append(ev)
        return out

    def summary(self) -> dict:
        """Digest of the journal's state::

            {"committed": {key: record_json}, "failed": {key, ...},
             "interrupted": {key, ...}, "resumes": int}

        ``interrupted`` = started but neither committed nor failed — the
        cases a killed run was measuring; a resume re-runs exactly these
        (plus never-started ones) and re-measures nothing committed."""
        committed: dict = {}
        failed: set = set()
        started: set = set()
        resumes = 0
        for ev in self.events():
            kind = ev.get("event")
            key = ev.get("key")
            if kind == "start" and key is not None:
                started.add(key)
            elif kind == "commit" and key is not None:
                committed[key] = ev.get("record")
                failed.discard(key)
            elif kind == "failed" and key is not None:
                if key not in committed:
                    failed.add(key)
            elif kind == "resume":
                resumes += 1
        return {
            "committed": committed,
            "failed": failed,
            "interrupted": started - set(committed) - failed,
            "resumes": resumes,
        }

    @staticmethod
    def is_journal(path: str) -> bool:
        """Sniff: does ``path`` look like a run journal (first non-empty
        line a JSON object with an ``"event"`` key)?  Lets CLI commands
        accept DB files and journals interchangeably."""
        try:
            with open(path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    ev = json.loads(line)
                    return isinstance(ev, dict) and "event" in ev
        except (OSError, ValueError):
            return False
        return False

    def to_db(self) -> TuningDB:
        """An in-memory :class:`TuningDB` of the journal's committed
        records — the shape ``merge_dbs`` folds."""
        db = TuningDB(path=None)
        for rec_json in self.summary()["committed"].values():
            if rec_json is None:
                continue
            try:
                db.put(TuningRecord.from_json(rec_json), save=False)
            except Exception as e:
                log.warning(
                    "%s: unreadable committed record (%r); skipping",
                    self.path, e,
                )
        return db


_default: Optional[TuningDB] = None
_default_lock = threading.Lock()


def default_db() -> TuningDB:
    """Process-wide DB: file-backed iff ``REPRO_TUNING_DB`` is set."""
    global _default
    with _default_lock:
        if _default is None:
            _default = TuningDB(os.environ.get(ENV_DB_PATH) or None)
        return _default
